"""Transformer models, ported from ``repro.models``: the dense stack
(``layers``, ``attention``, ``transformer``, ``model``). The moe, ssm,
hybrid and xlstm stacks are ROADMAP Queue 1 item 9."""
