"""Accuracy observability for chips on non-ideal devices.

Port of ``repro.variability.monitor``. The canary stays a numpy array;
each probe moves it to the chip's device and reads the outputs back
with ``.cpu()``.

Throughput/latency tell you the fabric is streaming; on drifting
devices they say nothing about whether the answers are still right.
:class:`AccuracyMonitor` closes that gap: a fixed per-app *canary
batch* is scored against reference labels periodically during serving
(``on_step`` is a serving step listener), producing the
accuracy-vs-items time-series the closed-loop recalibration policy
(:mod:`repro_torch.variability.recal`) consumes.

Canary probes stream through the chip's CURRENT programmed state at
its current drift age but never advance the drift clock
(``advance_age=False``): observation must not itself age the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CanarySample:
    """One scored canary probe."""
    step: int               # engine step at which the probe ran
    items_streamed: int     # chip drift age at the probe
    accuracy: float


class AccuracyMonitor:
    """Periodic canary scoring over a live chip.

    ``chip_fn`` resolves the CURRENT chip every probe (a live
    reprogram replaces the chip object, so holding a reference would
    silently score stale state). ``reference`` is the ground-truth
    label vector; by default it is the chip's own attach-time argmax
    over the canary — attach before serving starts and accuracy
    begins at 1.0 by construction, reading directly as "fraction of
    canary answers still matching the freshly-programmed chip", the
    paper-relevant drift signal.
    """

    def __init__(self, chip_fn: Callable[[], object], canary, *,
                 reference: Optional[Sequence[int]] = None,
                 every_steps: int = 1, name: str = "app"):
        if every_steps < 1:
            raise ValueError("AccuracyMonitor: every_steps must be >= 1")
        self._chip_fn = chip_fn
        self.canary = np.asarray(canary, np.float32)
        if self.canary.ndim != 2:
            raise ValueError("AccuracyMonitor: canary must be "
                             "(batch, d_in)")
        self.every_steps = int(every_steps)
        self.name = str(name)
        self.samples: List[CanarySample] = []
        self._steps_seen = 0
        if reference is None:
            reference = self._probe_labels()
        self.reference = np.asarray(reference, np.int64).reshape(-1)
        if self.reference.shape[0] != self.canary.shape[0]:
            raise ValueError(
                f"AccuracyMonitor: {self.reference.shape[0]} reference "
                f"label(s) for {self.canary.shape[0]} canary row(s)")

    # ------------------------------------------------------------ #
    def _probe_labels(self) -> np.ndarray:
        chip = self._chip_fn()
        x = torch.from_numpy(self.canary).to(chip.device)
        out = chip.stream(x, advance_age=False)
        return np.argmax(out.cpu().numpy(), axis=-1)

    def score(self, *, step: Optional[int] = None) -> CanarySample:
        """Run one probe now and append it to the series."""
        chip = self._chip_fn()
        labels = self._probe_labels()
        acc = float(np.mean(labels == self.reference))
        sample = CanarySample(
            step=int(step if step is not None else self._steps_seen),
            items_streamed=int(chip.items_streamed),
            accuracy=acc)
        self.samples.append(sample)
        return sample

    def on_step(self, router) -> None:
        """Step listener (``router.add_step_listener(monitor.on_step)``):
        probes every ``every_steps`` engine steps."""
        self._steps_seen += 1
        if self._steps_seen % self.every_steps == 0:
            self.score(step=self._steps_seen)

    # ------------------------------------------------------------ #
    @property
    def latest(self) -> Optional[CanarySample]:
        return self.samples[-1] if self.samples else None

    def series(self) -> dict:
        """The accuracy time-series as plain lists (JSON-ready)."""
        return {
            "step": [s.step for s in self.samples],
            "items_streamed": [s.items_streamed for s in self.samples],
            "accuracy": [s.accuracy for s in self.samples],
        }

    def summary(self) -> dict:
        accs = [s.accuracy for s in self.samples]
        return {
            "app": self.name,
            "probes": len(accs),
            "canary_rows": int(self.canary.shape[0]),
            "latest_accuracy": accs[-1] if accs else None,
            "min_accuracy": min(accs) if accs else None,
            "series": self.series(),
        }
