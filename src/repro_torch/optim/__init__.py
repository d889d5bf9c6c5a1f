"""Optimizers and quantization-aware training, ported from
``repro.optim``: ``adamw`` (AdamW, clipping, schedules), ``qat`` (the
ex-situ QAT trainer) and ``grad_compression`` (int8 error-feedback
gradient reduction over data-parallel ranks). The launchers' pipeline,
dry run and roofline are in ``repro_torch.launch``."""
