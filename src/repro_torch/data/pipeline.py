"""Deterministic, shardable, checkpointable data pipelines.

Port of ``repro.data.pipeline``. A batch is a *pure function* of
``(seed, step)``: a pipeline carries no hidden iterator state, its
checkpoint is two integers (:class:`PipelineState`), and a restore is
exact on any process count, since a host's share is a slice of the
same global batch (:meth:`TokenPipeline.host_shard`). Batches are made
on the host, as CPU tensors; the train step moves them to its device.

The token stream is procedural: a seeded Zipf unigram mixture with
short-range Markov structure. The reference draws with ``jax.random``,
which a ``torch.Generator`` cannot replay, so :class:`TokenPipeline`
splits the draws (:meth:`~TokenPipeline.draws`: the uniforms and the
Markov mask, from the port's splitmix64 mix of (seed, step)) from the
transform (:meth:`~TokenPipeline.zipf_tokens`,
:meth:`~TokenPipeline.markov_chain`), and a parity test hands the
reference's draws to the transform.

The Zipf trap: the reference casts ``u^(-1/(a-1))`` to int32 before it
clips, and about 1.3 % of the draws (u < 0.0135 at a = 1.2) exceed
2³¹. XLA on the CPU saturates them to 2,147,483,647 (token vocab−1);
``.to(torch.int32)`` on the CPU gives −2,147,483,648 (token 0) and a
CUDA cast saturates. The port clamps in float, at 2³⁰, before the cast,
so it equals the reference on either device. ``u^(-1/(a-1))`` is
computed in f64 and rounded to f32: PyTorch's f32 ``pow`` misses the
correctly rounded value on ~1.8 % of the draws, XLA's on ~0.03 %, and
~1.8e-5 of the draws still truncate to another integer than the
reference's (an f32 ulp across an integer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.data.images import sensor_stream
from repro_torch.variability.noise import stream_seed

# purpose separators of the token and embedding draws in the stream mix
_FOLD_TOKENS = 0x70C3
_FOLD_EMBEDS = 0xE3B5
# any float at or above the vocab truncates to token vocab−1 after the
# clip; 2³⁰ is exact in f32 and below int32's limit
_ZIPF_CAP = 2.0 ** 30


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
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Markov structure: token t+1 ~ mix of Zipf unigram and a shift of t
    markov_mix: float = 0.7
    zipf_a: float = 1.2

    def state(self, step: int) -> PipelineState:
        return PipelineState(self.seed, step)

    def draws(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The random draws of ``step``'s batch: uniforms (B, S+1) f32 in
        [1e-6, 1) and the Markov mask (B, S+1) bool (true with
        probability ``markov_mix``), from one CPU generator seeded by
        the stream mix of (seed, step)."""
        gen = torch.Generator().manual_seed(
            stream_seed(self.seed, _FOLD_TOKENS, step))
        shape = (self.global_batch, self.seq_len + 1)
        u = 1e-6 + (1.0 - 1e-6) * torch.rand(shape, generator=gen)
        mask = torch.rand(shape, generator=gen) < self.markov_mix
        return u, mask

    def zipf_tokens(self, u) -> torch.Tensor:
        """Inverse-CDF bounded Zipf over the vocab: ranks ∝
        u^(-1/(a-1)), truncated, minus one, clipped (int64)."""
        u = torch.as_tensor(u).to(torch.float64)
        e = float(np.float32(-1.0 / (self.zipf_a - 1.0)))
        r = torch.pow(u, e).to(torch.float32)
        r = torch.clamp(r, max=_ZIPF_CAP)
        return torch.clamp(r.to(torch.int64) - 1, 0, self.vocab_size - 1)

    def markov_chain(self, uni, use_markov) -> torch.Tensor:
        """(B, S+1) tokens: the first column as drawn, then each next
        token ``(prev * 31 + 7) mod vocab`` where the mask is set, else
        the Zipf draw."""
        uni = torch.as_tensor(uni).to(torch.int64)
        use_markov = torch.as_tensor(use_markov).to(torch.bool)
        toks = torch.empty_like(uni)
        prev = uni[:, 0]
        toks[:, 0] = prev
        for t in range(1, uni.shape[1]):
            prev = torch.where(use_markov[:, t],
                               (prev * 31 + 7) % self.vocab_size, uni[:, t])
            toks[:, t] = prev
        return toks

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Global batch for ``step`` — pure, deterministic: int32
        ``tokens`` (B, S) and ``labels`` (B, S), the labels shifted by
        one."""
        u, mask = self.draws(step)
        toks = self.markov_chain(self.zipf_tokens(u), mask)
        S = self.seq_len
        return {"tokens": toks[:, :S].to(torch.int32),
                "labels": toks[:, 1:].to(torch.int32)}

    def host_shard(self, batch: Dict[str, torch.Tensor],
                   process_index: int, process_count: int
                   ) -> Dict[str, torch.Tensor]:
        """Slice the deterministic global batch for one host. Elastic
        re-meshing = calling this with a different process_count."""
        B = self.global_batch
        if B % process_count:
            raise ValueError(f"host_shard: global batch {B} does not "
                             f"split over {process_count} processes")
        per = B // process_count
        lo = process_index * per
        return {k: v[lo:lo + per] for k, v in batch.items()}


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


def embeds_batch(seed: int, batch: int, seq: int, d_model: int,
                 vocab: int) -> Dict[str, torch.Tensor]:
    """Frontend-stub batch for vlm/audio architectures: precomputed
    frame/patch embeddings (B, S, d) bf16, standard-normal, and int32
    labels (B, S) in [0, vocab), drawn from the stream mix of ``seed``
    (the reference takes a ``jax.random`` key)."""
    gen = torch.Generator().manual_seed(stream_seed(seed, _FOLD_EMBEDS))
    embeds = torch.randn((batch, seq, d_model), generator=gen)
    labels = torch.randint(0, vocab, (batch, seq), generator=gen)
    return {"embeds": embeds.to(torch.bfloat16),
            "labels": labels.to(torch.int32)}
