"""Deterministic, checkpointable data pipelines.

Port of the sensor half of ``repro.data.pipeline``: a batch is a
*pure function* of ``(seed, step)``, so a pipeline carries no hidden
iterator state and its checkpoint is two integers
(:class:`PipelineState`). ``TokenPipeline`` and ``embeds_batch`` are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.data.images import sensor_stream


@dataclasses.dataclass(frozen=True)
class PipelineState:
    seed: int
    step: int

    def as_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d) -> "PipelineState":
        return PipelineState(int(d["seed"]), int(d["step"]))


@dataclasses.dataclass(frozen=True)
class SensorPipeline:
    """The paper's I/O model as a data pipeline: a procedural sensor
    frame stream (:func:`repro_torch.data.images.sensor_stream`),
    windowed and strided into chip-sized items the way the TSV-fed DAC
    cores consume pixels (§II.C) — e.g. 28x28 windows of a 64x64 frame
    at stride 18 are nine 784-feature items per frame, the deep app's
    input shape. Batches are f32 CPU tensors: frames are made on the
    host, as a frame grabber hands them over."""
    window: int = 28
    stride: int = 18
    height: int = 64
    width: int = 64
    frames_per_step: int = 1
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.window <= min(self.height, self.width)):
            raise ValueError(
                f"SensorPipeline: window {self.window} must fit the "
                f"{self.height}x{self.width} frame")
        if self.stride < 1 or self.frames_per_step < 1:
            raise ValueError("SensorPipeline: stride and "
                             "frames_per_step must be >= 1")

    @property
    def d_item(self) -> int:
        """Features per item (window pixels, flattened)."""
        return self.window * self.window

    def _origins(self):
        return range(0, self.height - self.window + 1, self.stride), \
            range(0, self.width - self.window + 1, self.stride)

    @property
    def windows_per_frame(self) -> int:
        rows, cols = self._origins()
        return len(rows) * len(cols)

    @property
    def items_per_step(self) -> int:
        return self.windows_per_frame * self.frames_per_step

    def state(self, step: int) -> PipelineState:
        return PipelineState(self.seed, step)

    def batch(self, step: int) -> torch.Tensor:
        """(items_per_step, d_item) windows for ``step`` — pure,
        deterministic, frames [step·fps, (step+1)·fps) of the stream,
        in frame-major order."""
        frames = sensor_stream(self.seed, self.frames_per_step,
                               self.height, self.width,
                               start=step * self.frames_per_step)
        rows, cols = self._origins()
        wins = [frames[:, r:r + self.window, c:c + self.window]
                for r in rows for c in cols]
        # (fps, wpf, window, window) → frame-major item order
        return torch.stack(wins, dim=1).reshape(self.items_per_step,
                                                self.d_item)
