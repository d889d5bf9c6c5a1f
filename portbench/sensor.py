"""Sensor windows: the items every stream mix hands the chip.

A frozen copy of the port's sensor-frame windowing
(``repro_torch.data.pipeline.SensorPipeline`` over
``repro_torch.data.images.sensor_stream``): a base pattern (a grating
and a blob) rolled by a per-frame velocity drawn from the seed, cut into
28 × 28 windows at stride 18 of each 64 × 64 frame, nine 784-pixel
items a frame in frame-major order, f32 in [0, 1]. Window ``i`` of the
stream is a pure function of ``(seed, i)``. The frames are gathered on
the device from the base pattern, in one call a batch.
"""
from __future__ import annotations

import math

import torch

_MASK64 = (1 << 64) - 1
# purpose separator of the velocity draw in the stream mix
_FOLD_SENSOR = 0x5E45


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(*words: int) -> int:
    """A fixed 64-bit mix of integer words: distinct tuples give
    unrelated generator seeds, for any whole number a word holds."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


def velocity(seed: int) -> torch.Tensor:
    """(2,) f32 per-frame translation in [1, 3) pixels, on a 2⁻²² grid."""
    gen = torch.Generator().manual_seed(stream_seed(seed, _FOLD_SENSOR))
    k = torch.randint(0, 2 ** 23, (2,), generator=gen)
    return 1.0 + k.to(torch.float32) * 2.0 ** -22


def _grid(h: int, w: int):
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.int32),
                          torch.arange(w, dtype=torch.int32),
                          indexing="ij")
    return y.to(torch.float32), x.to(torch.float32)


def base_pattern(h: int, w: int) -> torch.Tensor:
    """(h, w) f32: 0.7 · grating(θ 0.6, 4 cycles) + 0.3 · blob(σ 0.2)."""
    y, x = _grid(h, w)
    th = torch.tensor(0.6, dtype=torch.float32)
    u = (x * torch.cos(th) + y * torch.sin(th)) / max(h, w)
    grating = 0.5 + 0.5 * torch.sin(2 * math.pi * 4.0 * u + 0.0)
    blob = torch.exp(-(((y / h - 0.5) ** 2 + (x / w - 0.5) ** 2)
                       / (2 * 0.2 ** 2)))
    return grating * 0.7 + 0.3 * blob


class Windows:
    """The window stream of one seed, for one source shape
    (``window``, ``stride``, ``height``, ``width`` of a mix's
    ``source``)."""

    def __init__(self, seed: int, source: dict, device):
        self.window = int(source["window"])
        self.stride = int(source["stride"])
        self.height = int(source["height"])
        self.width = int(source["width"])
        self.device = torch.device(device)
        self.velocity = velocity(seed)
        self.base = base_pattern(self.height, self.width).to(self.device)
        self.rows = list(range(0, self.height - self.window + 1,
                               self.stride))
        self.cols = list(range(0, self.width - self.window + 1,
                               self.stride))

    @property
    def per_frame(self) -> int:
        return len(self.rows) * len(self.cols)

    @property
    def d_item(self) -> int:
        return self.window * self.window

    def items(self, start: int, n: int) -> torch.Tensor:
        """Windows [start, start + n) of the stream: (n, d_item) f32 on
        the device."""
        f0 = start // self.per_frame
        f1 = -(-(start + n) // self.per_frame)
        i = torch.arange(f0, f1, dtype=torch.int64)
        off = (i.to(torch.float32)[:, None] *
               self.velocity[None, :]).to(torch.int32).to(torch.int64)
        off = off.to(self.device)
        h, w = self.height, self.width
        rows = (torch.arange(h, device=self.device)[None, :]
                - off[:, :1]) % h
        cols = (torch.arange(w, device=self.device)[None, :]
                - off[:, 1:]) % w
        frames = self.base[rows[:, :, None], cols[:, None, :]]
        k = self.window
        wins = torch.stack([frames[:, r:r + k, c:c + k]
                            for r in self.rows for c in self.cols], dim=1)
        wins = wins.reshape(-1, self.d_item)
        lo = start - f0 * self.per_frame
        return wins[lo:lo + n].contiguous()
