"""Mamba2 block — chunked SSD (state-space dual) formulation.

Port of ``repro.models.ssm``: the same parameters, arithmetic,
dtypes and logical sharding annotations (``repro_torch.sharding``:
nothing without a mesh). Training/prefill use the chunked algorithm:
intra-chunk terms are dense products, the inter-chunk state is a short
sequential loop over the chunks. Every exponential is of a
non-positive argument (cumulative log decay); the intra-chunk decay
matrix is masked to -inf above the diagonal *before* ``exp`` (its
upper triangle would overflow, and its gradient would be NaN). The
scan computes in f32 whatever the compute dtype.

Decode is the single-step recurrence ``h <- a h + dt·x ⊗ B``,
``y = C·h + D x`` (:func:`ssd_step`), with a ring conv state for the
width-4 causal conv stem; :func:`ssd_recurrence` runs that step over a
sequence, the plain per-token form the chunked scan is held against.

One deliberate difference: a decode returns each conv state in the
dtype of the cache it was given. The reference's promotes a bf16 state
(the serving engine's) to the compute dtype at the first decode, so
its engine stores a lane's conv state in bf16 or f32 by when the lane
was admitted; here a lane's state is stored alike whenever it came.

The canonical fused in_proj/conv are split into per-stream (z, x, B, C,
dt) projections and per-stream depthwise convs, as the reference splits
them (mathematically identical).

Chunk geometry, as the reference's: ``nc = max(L // chunk, 1)`` chunks
of ``Q = L // nc`` positions. Where ``L`` is not ``nc · Q`` the
reference's reshape fails (ROADMAP R13); here :func:`ssd_chunked`
raises ``ValueError`` naming it, and pads nothing.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (causal_conv1d, conv_update,
                                       dense_init, pdtype, rms_norm)
from repro_torch.sharding import blockwise, gather_seq, reshape, shard

# one generator per drawn leaf of a Mamba2 block, keyed by its index here
MAMBA_LEAVES = ("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj",
                "conv_x_w", "conv_b_w", "conv_c_w", "out_proj", "dt_bias")


def _dims(cfg):
    return (cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_ngroups)


def chunk_geometry(L: int, chunk: int) -> Tuple[int, int]:
    """(nc, Q) of the reference's chunked scans; ``ValueError`` where
    ``L`` does not split into ``nc`` chunks of ``Q`` (ROADMAP R13)."""
    nc = max(L // chunk, 1)
    Q = L // nc
    if nc * Q != L:
        raise ValueError(
            f"a chunked scan of L = {L} at chunk {chunk} takes {nc} chunks "
            f"of {Q}, which do not tile L; the reference's scans take only "
            f"such lengths (ROADMAP R13)")
    return nc, Q


def mamba_init(generator: Callable[[int], torch.Generator], cfg, *,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """``generator(i)``: the ``torch.Generator`` of ``MAMBA_LEAVES[i]``."""
    d = cfg.d_model
    d_in, H, P, N, G = _dims(cfg)
    dt = pdtype(cfg)
    W = cfg.conv_width
    leaf = {name: generator(i) for i, name in enumerate(MAMBA_LEAVES)}

    def dense(name, shape, fan_in=None):
        return dense_init(leaf[name], shape, dt, fan_in, device=device)

    # dt bias so that softplus(dt_bias) spans ~[1e-3, 1e-1] (mamba2)
    u = torch.rand((H,), generator=leaf["dt_bias"], device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))      # inverse softplus
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=device)  # noqa: E731
    return {
        "z_proj": dense("z_proj", (d, d_in)),
        "x_proj": dense("x_proj", (d, d_in)),
        "b_proj": dense("b_proj", (d, G * N)),
        "c_proj": dense("c_proj", (d, G * N)),
        "dt_proj": dense("dt_proj", (d, H)),
        "conv_x_w": dense("conv_x_w", (W, d_in), fan_in=W),
        "conv_x_b": zeros(d_in),
        "conv_b_w": dense("conv_b_w", (W, G * N), fan_in=W),
        "conv_b_b": zeros(G * N),
        "conv_c_w": dense("conv_c_w", (W, G * N), fan_in=W),
        "conv_c_b": zeros(G * N),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).to(dt),
        "D": torch.ones((H,), dtype=dt, device=device),
        "dt_bias": dt_bias.to(dt),
        "norm": torch.ones((d_in,), dtype=dt, device=device),
        "out_proj": dense("out_proj", (d_in, d), fan_in=d_in),
    }


def mamba_specs(cfg) -> Dict:
    return {
        "z_proj": ("embed", "ff"), "x_proj": ("embed", "ff"),
        "b_proj": ("embed", None), "c_proj": ("embed", None),
        "dt_proj": ("embed", "ssm_heads"),
        "conv_x_w": (None, "ff"), "conv_x_b": ("ff",),
        "conv_b_w": (None, None), "conv_b_b": (None,),
        "conv_c_w": (None, None), "conv_c_b": (None,),
        "A_log": ("ssm_heads",), "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("ff",),
        "out_proj": ("ff", "embed"),
    }


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """SSD scan. xh: (B, L, H, P); dt: (B, L, H) (post-softplus); A: (H,)
    positive decay rates; Bm/Cm: (B, L, G, N). Returns y (B, L, H, P)
    and the final state (B, H, P, N), both f32."""
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, Q = chunk_geometry(L, chunk)
    f32 = torch.float32

    la = -A.to(f32) * dt.to(f32)                     # (B, L, H) log decay
    xdt = xh.to(f32) * dt.to(f32)[..., None]         # (B, L, H, P)
    cum = torch.cumsum(reshape(la, Bsz, nc, Q, H), dim=2)
    x_c = reshape(xdt, Bsz, nc, Q, H, P)
    B_c = reshape(Bm.to(f32), Bsz, nc, Q, G, N)
    C_c = reshape(Cm.to(f32), Bsz, nc, Q, G, N)
    hpg = H // G

    # intra-chunk: Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
    gb = torch.einsum("bcqgn,bckgn->bcgqk", C_c, B_c)
    gb = torch.repeat_interleave(gb, hpg, dim=2)     # (B, nc, H, Q, Q)
    ci = cum.permute(0, 1, 3, 2)                     # (B, nc, H, Q)
    dmat = ci[..., :, None] - ci[..., None, :]       # (B, nc, H, Q, K)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))
    dmat = torch.where(mask, dmat, -math.inf)        # mask, then exp
    M = gb * torch.exp(dmat)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, x_c)

    # chunk summaries: S_c = sum_j B_j ⊗ xdt_j * exp(cum_last - cum_j)
    wlast = torch.exp(cum[:, :, -1:, :] - cum)       # (B, nc, Q, H)
    Bh = torch.repeat_interleave(B_c, hpg, dim=3)    # (B, nc, Q, H, N)
    S_loc = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bh, x_c, wlast)

    # inter-chunk recurrence over the nc chunks (sequential, nc is small)
    chunk_decay = torch.exp(cum[:, :, -1, :])        # (B, nc, H)
    s = torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_loc[:, c]
    s_prev = torch.stack(s_prevs, dim=1)             # (B, nc, H, P, N)

    # inter-chunk contribution: Y[i] += C_i . S_prev * exp(cum_i)
    Ch = torch.repeat_interleave(C_c, hpg, dim=3)    # (B, nc, Q, H, N)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, s_prev,
                           torch.exp(cum))
    return reshape(y_intra + y_inter, Bsz, L, H, P), s


def ssd_step(h, xs, dts, A, Bm, Cm):
    """One token of the SSD recurrence, in f32. h: (B, H, P, N); xs:
    (B, H, P); dts: (B, H) post-softplus; A: (H,); Bm/Cm: (B, G, N).
    Returns (y (B, H, P) without the D skip, h')."""
    H = xs.shape[1]
    hpg = H // Bm.shape[1]
    a = torch.exp(-A * dts)                          # (B, H)
    Bh = torch.repeat_interleave(Bm, hpg, dim=1)     # (B, H, N)
    Ch = torch.repeat_interleave(Cm, hpg, dim=1)
    h = h * a[..., None, None] + \
        torch.einsum("bhn,bhp,bh->bhpn", Bh, xs, dts)
    return torch.einsum("bhpn,bhn->bhp", h, Ch), h


def ssd_recurrence(xh, dt, A, Bm, Cm):
    """:func:`ssd_chunked`'s plain per-token form: :func:`ssd_step`
    over the L positions from a zero state. Same arguments; returns
    (y (B, L, H, P), final state), f32."""
    f32 = torch.float32
    Bsz, L, H, P = xh.shape
    h = torch.zeros((Bsz, H, P, Bm.shape[3]), dtype=f32, device=xh.device)
    ys = []
    for t in range(L):
        y, h = ssd_step(h, xh[:, t].to(f32), dt[:, t].to(f32), A.to(f32),
                        Bm[:, t].to(f32), Cm[:, t].to(f32))
        ys.append(y)
    return torch.stack(ys, dim=1), h


def ssd_inputs(p: Dict, cfg, x: torch.Tensor):
    """The train/prefill path's projections up to the scan. x: (B, L,
    d) → (z, xr, br, cr, xs, dts, A, Bm, Cm): z and the conv inputs
    (xr, br, cr) in x's dtype, and :func:`ssd_chunked`'s arguments
    (xs (B, L, H, P), dts f32 (B, L, H), A f32 (H,), Bm/Cm (B, L, G,
    N))."""
    dt_ = x.dtype
    d_in, H, P, N, G = _dims(cfg)
    Bsz, L, _ = x.shape
    z, xr, br, cr, dtr = (torch.matmul(x, p[k].to(dt_)) for k in (
        "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"))
    xc = F.silu(causal_conv1d(xr, p["conv_x_w"].to(dt_),
                              p["conv_x_b"].to(dt_)))
    bc = F.silu(causal_conv1d(br, p["conv_b_w"].to(dt_),
                              p["conv_b_b"].to(dt_)))
    cc = F.silu(causal_conv1d(cr, p["conv_c_w"].to(dt_),
                              p["conv_c_b"].to(dt_)))
    dts = F.softplus(dtr.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = torch.exp(p["A_log"].to(torch.float32))
    xs = shard(reshape(xc, Bsz, L, H, P), "batch", None, "ff", None)
    return (z, xr, br, cr, xs, dts, A,
            reshape(bc, Bsz, L, G, N), reshape(cc, Bsz, L, G, N))


def _last_inputs(pre: torch.Tensor, W: int) -> torch.Tensor:
    """The conv state after a prefill: its last W-1 inputs, zero-padded
    on the left where the sequence is shorter (each rank its own rows
    under a mesh)."""
    rows = ("batch", None, None)
    return blockwise(lambda t: _last_inputs_of(t, W), [(pre, rows)],
                     out=rows)


def _last_inputs_of(pre: torch.Tensor, W: int) -> torch.Tensor:
    L = pre.shape[1]
    return F.pad(pre, [0, 0, W - 1, 0])[:, L:L + W - 1, :]


def mamba_apply(p: Dict, cfg, x: torch.Tensor, *, mode: str,
                cache: Optional[Dict] = None, chunk: int = 256
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, L, d) for train/prefill, (B, 1, d) for decode. Returns
    (out (B, L, d), the new cache: None in train mode)."""
    x = gather_seq(x)  # the sequence whole inside the block (SP)
    dt_ = x.dtype
    f32 = torch.float32
    d_in, H, P, N, G = _dims(cfg)
    Bsz, L, _ = x.shape
    W = cfg.conv_width

    if mode == "decode":
        if cache is None or L != 1:
            raise ValueError("mamba_apply: decode takes one token a lane "
                             "and a cache")
        z, xr, br, cr, dtr = (torch.matmul(x, p[k].to(dt_)) for k in (
            "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"))
        cx, xt = conv_update(cache["conv_x"], xr[:, 0],
                             p["conv_x_w"].to(dt_), p["conv_x_b"].to(dt_))
        cb, bt = conv_update(cache["conv_b"], br[:, 0],
                             p["conv_b_w"].to(dt_), p["conv_b_b"].to(dt_))
        cc, ct = conv_update(cache["conv_c"], cr[:, 0],
                             p["conv_c_w"].to(dt_), p["conv_c_b"].to(dt_))
        xs = reshape(F.silu(xt), Bsz, H, P).to(f32)
        Bm = reshape(F.silu(bt), Bsz, G, N).to(f32)
        Cm = reshape(F.silu(ct), Bsz, G, N).to(f32)
        dts = F.softplus(dtr[:, 0].to(f32) + p["dt_bias"].to(f32))
        A = torch.exp(p["A_log"].to(f32))
        # each rank its own lanes, every head (``blockwise``)
        r4, r3, r2 = ("batch", None, None, None), ("batch", None, None), \
            ("batch", None)
        y, h = blockwise(ssd_step, [(cache["ssm"], r4), (xs, r3),
                                    (dts, r2), (A, (None,)), (Bm, r3),
                                    (Cm, r3)], out=(r3, r4))
        y = y + xs * p["D"].to(f32)[None, :, None]
        y = reshape(y, Bsz, 1, d_in).to(dt_)
        new_cache = {"conv_x": cx.to(cache["conv_x"].dtype),
                     "conv_b": cb.to(cache["conv_b"].dtype),
                     "conv_c": cc.to(cache["conv_c"].dtype), "ssm": h}
    else:
        z, xr, br, cr, xs, dts, A, Bm, Cm = ssd_inputs(p, cfg, x)
        # each rank scans its own rows, every head (``blockwise``)
        rows4, rows3 = ("batch", None, None, None), ("batch", None, None)
        y, s_final = blockwise(
            lambda *a: ssd_chunked(*a[:2], a[4], *a[2:4], chunk),
            [(xs, rows4), (dts, rows3), (Bm, rows4), (Cm, rows4)], [A],
            out=(rows4, rows4))
        y = y + xs.to(f32) * p["D"].to(f32)[None, None, :, None]
        y = reshape(y, Bsz, L, d_in).to(dt_)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv_x": _last_inputs(xr, W),
                         "conv_b": _last_inputs(br, W),
                         "conv_c": _last_inputs(cr, W), "ssm": s_final}

    # gated RMSNorm (mamba2: norm(y * silu(z)))
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    y = shard(y, "batch", None, "ff")
    return torch.matmul(y, p["out_proj"].to(dt_)), new_cache


def init_mamba_cache(cfg, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    d_in, H, P, N, G = _dims(cfg)
    W = cfg.conv_width
    return {
        "conv_x": torch.zeros((batch, W - 1, d_in), dtype=dtype,
                              device=device),
        "conv_b": torch.zeros((batch, W - 1, G * N), dtype=dtype,
                              device=device),
        "conv_c": torch.zeros((batch, W - 1, G * N), dtype=dtype,
                              device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
    }


def mamba_cache_specs(cfg) -> Dict:
    return {"conv_x": ("batch", None, "ff"),
            "conv_b": ("batch", None, None),
            "conv_c": ("batch", None, None),
            "ssm": ("batch", "ssm_heads", None, None)}
