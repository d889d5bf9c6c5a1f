"""Procedural sensor frames: the moving-pattern stream the edge/motion
pipelines and the fleet's sensor frontend consume.

Port of the sensor half of ``repro.data.images`` (``_grating``,
``_blob``, ``sensor_stream``); the MNIST/CIFAR/Chars74K stand-ins are
not ported yet. Frames are made on the host, as a frame grabber hands
them over, as f32 CPU tensors in [0, 1].

The reference draws the stream's velocity with ``jax.random``, which a
``torch.Generator`` cannot replay, so the draw and the frames are split:
:func:`sensor_velocity` draws the velocity from the seed through the
port's fixed splitmix64 stream mix, :func:`sensor_frames` makes frames
from a given velocity, and :func:`sensor_stream` composes the two. A
frame is a pure function of ``(seed, absolute index)``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.variability.noise import stream_seed

# purpose separator of the velocity draw in the stream mix
_FOLD_SENSOR = 0x5E45


def _grid(h: int, w: int):
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.int32),
                          torch.arange(w, dtype=torch.int32),
                          indexing="ij")
    return y.to(torch.float32), x.to(torch.float32)


def _grating(h: int, w: int, theta: float, freq: float,
             phase: float) -> torch.Tensor:
    y, x = _grid(h, w)
    th = torch.tensor(theta, dtype=torch.float32)
    u = (x * torch.cos(th) + y * torch.sin(th)) / max(h, w)
    return 0.5 + 0.5 * torch.sin(2 * math.pi * freq * u + phase)


def _blob(h: int, w: int, cy: float, cx: float, sigma: float
          ) -> torch.Tensor:
    y, x = _grid(h, w)
    return torch.exp(-(((y / h - cy) ** 2 + (x / w - cx) ** 2)
                       / (2 * sigma ** 2)))


def sensor_velocity(seed: int) -> torch.Tensor:
    """The stream's (2,) f32 per-frame translation, in [1, 3) pixels:
    uniform on a 2⁻²² grid (23 random bits a component, so 1 + 2u is
    exact in f32 and never rounds up to 3)."""
    gen = torch.Generator().manual_seed(stream_seed(seed, _FOLD_SENSOR))
    k = torch.randint(0, 2 ** 23, (2,), generator=gen)
    return 1.0 + k.to(torch.float32) * 2.0 ** -22


def frame_offsets(velocity: torch.Tensor, frames: int, start: int = 0
                  ) -> torch.Tensor:
    """(frames, 2) int64 roll offsets of frames [start, start + frames):
    ``int32(f32(i) · velocity)``, truncated as the reference's are."""
    i = torch.arange(start, start + frames, dtype=torch.int64)
    v = velocity.to(torch.float32)
    return (i.to(torch.float32)[:, None] * v[None, :]).to(
        torch.int32).to(torch.int64)


def sensor_frames(velocity: torch.Tensor, frames: int, h: int = 64,
                  w: int = 64, start: int = 0) -> torch.Tensor:
    """(frames, h, w) in [0, 1]: the base pattern rolled by each frame's
    offsets (rows, then columns)."""
    base = _grating(h, w, 0.6, 4.0, 0.0) * 0.7 \
        + 0.3 * _blob(h, w, 0.5, 0.5, 0.2)
    off = frame_offsets(velocity, frames, start)
    rows = (torch.arange(h)[None, :] - off[:, :1]) % h      # (F, h)
    cols = (torch.arange(w)[None, :] - off[:, 1:]) % w      # (F, w)
    return base[rows[:, :, None], cols[:, None, :]]


def sensor_stream(seed: int, frames: int, h: int = 64, w: int = 64,
                  start: int = 0) -> torch.Tensor:
    """A moving-pattern frame stream: (frames, h, w) in [0, 1] with
    per-frame translation. ``sensor_stream(s, n, start=k)`` is exactly
    frames [k, k + n) of the infinite stream, the property
    :class:`repro_torch.data.SensorPipeline` needs to make window
    batches a pure function of (seed, step)."""
    return sensor_frames(sensor_velocity(seed), frames, h, w, start)
