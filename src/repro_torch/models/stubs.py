"""Modality frontend stubs.

Port of ``repro.models.stubs``. The [vlm]/[audio] configs model the
transformer BACKBONE only; the frontend (InternViT / EnCodec) is a
stub that supplies precomputed patch/frame embeddings. These helpers
make deterministic stand-in embeddings and batches for tests and
examples.

Draws come from an explicit ``torch.Generator`` on an explicit device
(default ``cuda``, through ``runtime.resolve_device``). They cannot
replay the reference's ``jax.random`` draws, so parity tests carry
embeddings and tokens across as numpy.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.variability.noise import stream_seed

# generator purposes of a batch: the inputs, the labels
_INPUTS, _LABELS = 0, 1


def frontend_embeds(cfg, generator: torch.Generator, batch: int, seq: int,
                    dtype: torch.dtype = torch.bfloat16, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """Stand-in for the (stubbed) vision/audio encoder output:
    (batch, seq, d_model) normals × 0.02, drawn in f32, then cast."""
    dev = resolve_device(device)
    x = torch.randn((batch, seq, cfg.d_model), generator=generator,
                    dtype=torch.float32, device=dev)
    return (x * 0.02).to(dtype)


def make_batch(cfg, seed: int, batch: int, seq: int, *,
               train: bool = True,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A batch dict of the right modality: ``embeds`` for a stub
    frontend, else ``tokens`` in [0, vocab_size); ``labels`` when
    ``train``. One generator on ``device`` for each, seeded by the
    splitmix64 mix of (seed, purpose) (the reference splits one key in
    two)."""
    dev = resolve_device(device)
    g1, g2 = (torch.Generator(device=dev).manual_seed(stream_seed(seed, w))
              for w in (_INPUTS, _LABELS))
    out = {}
    if cfg.frontend != "none":
        out["embeds"] = frontend_embeds(cfg, g1, batch, seq, device=dev)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=g1, dtype=torch.int32,
                                      device=dev)
    if train:
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=g2, dtype=torch.int32,
                                      device=dev)
    return out
