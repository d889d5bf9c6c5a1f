"""repro_torch.variability — non-ideal memristor devices, accuracy
observability, and closed-loop recalibration. Port of
``repro.variability``.

  * :class:`NoiseModel` — programming-time lognormal write error,
    persistent stuck-at-G_ON/G_OFF cells, IR-drop attenuation, and
    per-item temporal drift. Compile a chip onto non-ideal devices with
    ``compile_chip(..., noise=...)``; the all-zero model runs the same
    code path as no model at all.
  * :class:`AccuracyMonitor` — canary batches scored against the
    chip's attach-time answers, without aging it.
  * :class:`Recalibrator` / :class:`RecalPolicy` — accuracy-SLO
    breach → a weights-only reprogram (zero compile passes, asserted
    via ``compile_count()``).
"""
from repro_torch.variability.monitor import AccuracyMonitor, CanarySample
from repro_torch.variability.noise import NoiseModel
from repro_torch.variability.recal import (RecalEvent, RecalPolicy,
                                           Recalibrator)

__all__ = [
    "AccuracyMonitor",
    "CanarySample",
    "NoiseModel",
    "RecalEvent",
    "RecalPolicy",
    "Recalibrator",
]
