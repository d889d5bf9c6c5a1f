"""Optimizers and quantization-aware training, ported from
``repro.optim``: ``adamw`` (AdamW, clipping, schedules), ``qat`` (the
ex-situ QAT trainer) and ``grad_compression`` (int8 error-feedback
gradient reduction over data-parallel ranks). What is left of the
reference's training substrate is its launchers' pipeline, dry run and
roofline (ROADMAP Queue 1 item 9g)."""
