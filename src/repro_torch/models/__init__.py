"""Transformer models, ported from ``repro.models``: the dense stack
(``layers``, ``attention``, ``transformer``, ``model``), which the vlm
and audio configs run on behind ``stubs``' frontend embeddings, and
the MoE stack (``moe``). The hybrid (``ssm``) and ssm (``xlstm``)
stacks are ROADMAP Queue 1 item 9."""
