"""mla_ms.lm: device ms a decode step of the card's kernels and copies
the host queued inside the ``lm.mla`` spans (scores, softmax and the
weighted sum over the latent cache), summed over the layers; from the
traced run's profiled bursts (``generators/lm_decode.py``)."""


def read(run):
    return getattr(run.window, "readings", {}).get("lm.mla")
