"""Shared primitive layers (plain PyTorch on tensors, dict params).

Port of ``repro.models.layers``: the same arithmetic in the same order
and dtypes, and the same logical sharding annotations
(``repro_torch.sharding.shard``: nothing without a mesh).
``dense_init``/``embed_init`` draw a truncated normal on [-2, 2] from a
``torch.Generator``; the reference's ``jax.random`` draws cannot be
replayed, so comparisons hand weights across
(``repro_torch.models.model.params_from_numpy``).

Under a mesh each weight is redistributed whole but for its TP dim
before its product (FSDP's gather of the ``embed`` dim: DTensor would
otherwise split the activations' model dim and sum bf16 partial
products, which rounds otherwise than one product), and one operand is
redistributed where DTensor has no working rule: ``cross_entropy``
gathers the label's logit from logits whose vocab dim is made whole
first (``shard(logits, "batch", None, None)``), since DTensor's gather
on a vocab-sharded dim fails to reduce its masked partial result
(torch 2.13).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.sharding import blockwise, gather_seq, shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``"float32"``, ``"bfloat16"``) → torch."""
    return _DTYPES[name]


def cdtype(cfg) -> torch.dtype:
    return to_dtype(cfg.compute_dtype)


def pdtype(cfg) -> torch.dtype:
    return to_dtype(cfg.param_dtype)


# --------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------- #
def _truncated_normal(shape: Sequence[int], generator: torch.Generator,
                      device: torch.device) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, shape, dtype: torch.dtype,
               fan_in: Optional[int] = None, *,
               device: torch.device) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[-2] \
        if len(shape) > 1 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return (_truncated_normal(shape, generator, device) * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype: torch.dtype, *,
               device: torch.device) -> torch.Tensor:
    return _truncated_normal(shape, generator, device).to(dtype)


# --------------------------------------------------------------------- #
# norms / activations
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


# --------------------------------------------------------------------- #
# RoPE (split halves, as the reference: not interleaved pairs)
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to
    (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (half,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope_pairs(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """RoPE on interleaved pairs, as DeepSeek-V3's modeling code applies
    it: the pairs (x[2i], x[2i+1]) are rotated by position · θ^(−2i/d),
    and the result is laid out in halves (the rotated evens, then the
    rotated odds), so q and k dot as under the interleaved rotation.
    Shapes as :func:`apply_rope`."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------- #
def mlp_init(generators, d_model: int, d_ff: int, dtype: torch.dtype, *,
             device: torch.device) -> dict:
    """``generators``: three ``torch.Generator`` for w1, w3, w2."""
    g1, g3, g2 = generators
    return {
        "w1": dense_init(g1, (d_model, d_ff), dtype, device=device),
        "w3": dense_init(g3, (d_model, d_ff), dtype, device=device),
        "w2": dense_init(g2, (d_ff, d_model), dtype, fan_in=d_ff,
                         device=device),
    }


def mlp_specs() -> dict:
    return {"w1": ("embed", "ff"), "w3": ("embed", "ff"),
            "w2": ("ff", "embed")}


def mlp_apply(p: dict, x: torch.Tensor, act: str,
              compute_dtype: torch.dtype) -> torch.Tensor:
    x = gather_seq(x.to(compute_dtype))
    # FSDP's gather: each weight whole but for its TP dim
    h = torch.matmul(x, shard(p["w1"].to(compute_dtype), None, "ff"))
    g = torch.matmul(x, shard(p["w3"].to(compute_dtype), None, "ff"))
    h = act_fn(act)(h) * g
    h = shard(h, "batch", None, "ff")  # seq unsharded inside the block (SP
    #                                    only at block boundaries)
    return torch.matmul(h, shard(p["w2"].to(compute_dtype), "ff", None))


# --------------------------------------------------------------------- #
# Embedding / LM head
# --------------------------------------------------------------------- #
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Under a mesh each rank looks its own rows' tokens up in the whole
    table (a lookup into a vocab-split table is not laid out by every
    DTensor version)."""
    h = blockwise(lambda t, w: w[t].to(compute_dtype),
                  [(tokens, ("batch", None))], [table],
                  out=("batch", None, None))
    return shard(h, "batch", "seq", None)


def lm_logits(h: torch.Tensor, head_w: torch.Tensor,
              final_cap: float) -> torch.Tensor:
    """h: (..., d); head_w: (d, padded_vocab). The weights are rounded
    to h's dtype and the product accumulates and leaves in f32, as the
    reference's ``preferred_element_type=f32`` (products of bf16 values
    are exact in f32)."""
    f32 = torch.float32
    h = gather_seq(h)
    head_w = shard(head_w.to(h.dtype), None, "vocab")   # FSDP's gather
    logits = torch.matmul(h.to(f32), head_w.to(f32))
    logits = softcap(logits, final_cap)
    return shard(logits, "batch", None, "vocab")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over valid (label >= 0) positions; logits over the padded
    vocab, whose pad columns are masked to -1e30. Returns (loss,
    accuracy), f32 scalars.

    The label's logit is gathered; the reference sums a one-hot
    selection instead (which keeps a TP-sharded vocab dim sharded) —
    the same value, since every other term it adds is zero. Under a
    mesh the labels are cut to the logits' batch rows, and each rank
    gathers (and takes the argmax of) its own rows' logits whole over
    the vocab (``blockwise``): a gather against labels that every rank
    holds whole would gather the whole batch's logits on every rank."""
    logits = logits.to(torch.float32)
    pv = logits.shape[-1]
    labels = shard(labels.to(device=logits.device, dtype=torch.int64),
                   "batch", None)
    if pv > vocab_size:
        vocab_ids = torch.arange(pv, device=logits.device)
        logits = torch.where(vocab_ids < vocab_size, logits,
                             torch.tensor(-1e30, device=logits.device))
    valid = labels >= 0
    safe_labels = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    ll, pred = blockwise(
        lambda lg, lb: (torch.gather(lg, -1, lb[..., None])[..., 0],
                        torch.argmax(lg, -1)),
        [(logits, ("batch", None, None)), (safe_labels, ("batch", None))],
        out=(("batch", None), ("batch", None)))
    nll = (logz - ll) * valid
    denom = torch.clamp(valid.sum(), min=1)
    acc = ((pred == safe_labels) * valid).sum() / denom
    return nll.sum() / denom, acc


# --------------------------------------------------------------------- #
# causal depthwise conv (the Mamba2 / mLSTM stem)
# --------------------------------------------------------------------- #
def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (B, L, C); w: (W, C) depthwise; left-padded causal. W shifted
    products added in the reference's order (W is 4: no conv primitive
    needed). Under a mesh each rank convolves its own rows, every
    channel (``blockwise``)."""
    if b is None:
        return blockwise(lambda x, w: _causal_conv1d(x, w, None),
                         [(x, ("batch", None, None))], [w],
                         out=("batch", None, None))
    return blockwise(_causal_conv1d, [(x, ("batch", None, None))], [w, b],
                     out=("batch", None, None))


def _causal_conv1d(x, w, b):
    W, L = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, [0, 0, W - 1, 0])
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + L, :] * w[i]
    if b is not None:
        out = out + b
    return out


def conv_update(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step causal conv. state: (B, W-1, C) the last W-1 inputs;
    x_t: (B, C). Returns (the new state, the output (B, C))."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)   # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window, w)
    if b is not None:
        out = out + b
    return window[:, 1:, :], out
