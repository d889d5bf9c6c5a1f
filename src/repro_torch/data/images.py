"""Procedural images: stand-ins for MNIST / CIFAR-10 / Chars74K, and the
moving-pattern sensor stream the edge/motion pipelines and the fleet's
sensor frontend consume.

Port of ``repro.data.images``. Each stand-in makes class-conditional
structured images (an oriented grating and a blob whose placement
depend on the label, per-sample jitter and pixel noise) with the *same
dimensions and class counts* as the original, flat f32 vectors in
[0, 1] and int64 labels. Images and frames are made on the host, as a
frame grabber hands them over, as CPU tensors.

The reference draws with ``jax.random``, which a ``torch.Generator``
cannot replay, so the draws and the images are split:

  * :func:`dataset_draws` draws the labels, the two jitters and the
    noise field from the seed through the port's fixed splitmix64 mix
    (``stream_seed``); :func:`_dataset` makes the images from given
    draws (a pure function of them, :func:`_class_image` vectorised);
    ``mnist_like``/``cifar_like``/``chars_like`` compose the two, so a
    parity test can hand the reference's draws to :func:`_dataset`.
  * :func:`sensor_velocity` draws the stream's velocity,
    :func:`sensor_frames` makes frames from a given velocity and
    :func:`sensor_stream` composes the two. A frame is a pure function
    of ``(seed, absolute index)``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.variability.noise import stream_seed

# purpose separators of the velocity and dataset draws in the stream mix
_FOLD_SENSOR = 0x5E45
_FOLD_IMAGES = 0x1AA6


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


def _class_image(label: torch.Tensor, j_theta: torch.Tensor,
                 j_freq: torch.Tensor, z: torch.Tensor, h: int, w: int,
                 n_classes: int, noise: float) -> torch.Tensor:
    """Images whose structure is a deterministic function of the label,
    with sample-specific jitter and noise: ``label``, ``j_theta`` and
    ``j_freq`` of any shape ``S`` (the two jitters standard-normal),
    ``z`` (*S, h, w) standard-normal → (*S, h, w) in [0, 1]. The
    reference's ``_class_image`` on its draws, for all of them at once."""
    lab = label.to(torch.float32)[..., None, None]
    theta = lab * (math.pi / n_classes) + 0.1 * j_theta[..., None, None]
    freq = 2.0 + torch.remainder(lab, 5.0) + 0.2 * j_freq[..., None, None]
    cy = 0.25 + 0.5 * torch.remainder(lab * 7919.0, n_classes) / n_classes
    cx = 0.25 + 0.5 * torch.remainder(lab * 104729.0, n_classes) \
        / n_classes
    y, x = _grid(h, w)
    u = (x * torch.cos(theta) + y * torch.sin(theta)) / max(h, w)
    grating = 0.5 + 0.5 * torch.sin(2 * math.pi * freq * u + 0.0)
    blob = torch.exp(-(((y / h - cy) ** 2 + (x / w - cx) ** 2)
                       / (2 * 0.12 ** 2)))
    img = 0.6 * grating + 0.4 * blob
    img = img + noise * z
    return torch.clamp(img, 0.0, 1.0)


def dataset_draws(seed: int, n: int, h: int, w: int, channels: int,
                  n_classes: int):
    """The random draws behind a stand-in dataset: labels (n,) int64 in
    [0, n_classes), the two jitters (n, channels) and the noise field
    (n, channels, h, w), standard-normal f32, from one CPU generator
    seeded by the stream mix of ``seed``."""
    gen = torch.Generator().manual_seed(stream_seed(seed, _FOLD_IMAGES))
    labels = torch.randint(0, n_classes, (n,), generator=gen)
    j_theta = torch.randn((n, channels), generator=gen)
    j_freq = torch.randn((n, channels), generator=gen)
    z = torch.randn((n, channels, h, w), generator=gen)
    return labels, j_theta, j_freq, z


def _dataset(labels: torch.Tensor, j_theta: torch.Tensor,
             j_freq: torch.Tensor, z: torch.Tensor, h: int, w: int,
             n_classes: int, noise: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draws (:func:`dataset_draws`'s layout) → (x (n, channels·h·w) f32
    in [0, 1], labels (n,) int64), channel-major per sample as the
    reference's."""
    labels = torch.as_tensor(labels).to(torch.int64)
    imgs = _class_image(labels[:, None], torch.as_tensor(j_theta),
                        torch.as_tensor(j_freq), torch.as_tensor(z), h, w,
                        n_classes, noise)
    return imgs.reshape(labels.shape[0], -1), labels


def _stand_in(seed: int, n: int, h: int, w: int, channels: int,
              n_classes: int, noise: float):
    draws = dataset_draws(seed, n, h, w, channels, n_classes)
    return _dataset(*draws, h, w, n_classes, noise)


def mnist_like(seed: int = 0, n: int = 1024
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """28×28 grayscale, 10 classes → (n, 784) in [0, 1]."""
    return _stand_in(seed, n, 28, 28, 1, 10, noise=0.10)


def cifar_like(seed: int = 0, n: int = 1024
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """32×32×3 color, 10 classes → (n, 3072)."""
    return _stand_in(seed, n, 32, 32, 3, 10, noise=0.15)


def chars_like(seed: int = 0, n: int = 1024
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """50×50 grayscale, 26 classes (subsampled Chars74K) → (n, 2500)."""
    return _stand_in(seed, n, 50, 50, 1, 26, noise=0.08)


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
