"""experts_ms.lm: device ms a decode step of the card's kernels and
copies the host queued inside the ``lm.experts`` spans (the held
experts' grids, their weighting and the scatter), summed over the MoE
layers; from the traced run's profiled bursts
(``generators/lm_decode.py``)."""


def read(run):
    return getattr(run.window, "readings", {}).get("lm.experts")
