"""Optimizers and quantization-aware training, ported from
``repro.optim``: ``adamw`` (AdamW, clipping, schedules) and ``qat``
(the ex-situ QAT trainer). ``grad_compression`` is ROADMAP Queue 1
item 9."""
