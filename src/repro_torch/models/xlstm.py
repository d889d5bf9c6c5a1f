"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel with log-space
stabilisation) and sLSTM (scalar memory, sequential scan with a
block-diagonal recurrence), after arXiv:2405.04517.

Port of ``repro.models.xlstm``: the same parameters, arithmetic,
dtypes and logical sharding annotations (``repro_torch.sharding``:
nothing without a mesh). The chunked mLSTM (:func:`mlstm_cell_chunked`)
is the parallel form: intra-chunk dense products and a short
inter-chunk loop; its plain per-token form is :func:`mlstm_cell_step`
run over the sequence (:func:`mlstm_recurrence`). The sLSTM is a
Python loop over the sequence, one :func:`_slstm_step` a token.

Two details the caches depend on, kept from the reference:
  * the mLSTM matrix state ``C`` is stored in bf16 in a cache, even
    under f32 compute (prefill writes it so and each decode step casts
    it back), so a decode continues from the state a prefill left;
  * the stabiliser ``m`` starts at ``NEG = -1e30``.
A decode returns the conv state in its cache's dtype, as ``ssm``'s
does (the one deliberate difference: see there).
The chunk geometry is :func:`ssm.chunk_geometry`'s (ROADMAP R13).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (act_fn, causal_conv1d, conv_update,
                                       dense_init, pdtype, rms_norm)
from repro_torch.models.ssm import _last_inputs, chunk_geometry
from repro_torch.sharding import (blockwise, elementwise, from_local_part,
                                  gather_seq, local_part, reshape, shard,
                                  unshard)

NEG = -1e30

# one generator per drawn leaf of a block, keyed by its index here
MLSTM_LEAVES = ("w_up_x", "w_up_z", "conv_w", "wq", "wk", "wv", "wi", "wf",
                "w_down")
SLSTM_LEAVES = ("Wg", "R", "w1", "w2")


def _mdims(cfg):
    dm = int(cfg.mlstm_proj_factor * cfg.d_model)
    Hl = cfg.num_lstm_heads
    return dm, Hl, dm // Hl


# ===================================================================== #
# mLSTM
# ===================================================================== #
def mlstm_init(generator: Callable[[int], torch.Generator], cfg, *,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """``generator(i)``: the ``torch.Generator`` of ``MLSTM_LEAVES[i]``."""
    d = cfg.d_model
    dm, Hl, dh = _mdims(cfg)
    dt = pdtype(cfg)
    leaf = {name: generator(i) for i, name in enumerate(MLSTM_LEAVES)}

    def dense(name, shape, fan_in=None):
        return dense_init(leaf[name], shape, dt, fan_in, device=device)

    full = lambda n, v: torch.full((n,), v, dtype=dt,  # noqa: E731
                                   device=device)
    return {
        "norm": full(d, 1.0),
        "w_up_x": dense("w_up_x", (d, dm)),
        "w_up_z": dense("w_up_z", (d, dm)),
        "conv_w": dense("conv_w", (cfg.conv_width, dm),
                        fan_in=cfg.conv_width),
        "conv_b": full(dm, 0.0),
        "wq": dense("wq", (dm, dm)),
        "wk": dense("wk", (dm, dm)),
        "wv": dense("wv", (dm, dm)),
        "wi": dense("wi", (dm, Hl)),
        "bi": full(Hl, -3.0),      # input gate starts fairly closed
        "wf": dense("wf", (dm, Hl)),
        "bf": full(Hl, 3.0),       # forget gate starts open
        "skip": full(dm, 1.0),
        "hnorm": full(dm, 1.0),
        "w_down": dense("w_down", (dm, d), fan_in=dm),
    }


def _headnorm(h: torch.Tensor, scale: torch.Tensor, eps: float
              ) -> torch.Tensor:
    """Per-head RMS norm over dh; h: (..., Hl, dh); scale: (Hl*dh,)."""
    shp, dt = h.shape, h.dtype
    hf = h.to(torch.float32)
    var = torch.mean(torch.square(hf), dim=-1, keepdim=True)
    hf = hf * torch.rsqrt(var + eps)
    hf = reshape(hf, *shp[:-2], shp[-2] * shp[-1]) * scale.to(torch.float32)
    return reshape(hf, *shp).to(dt)


def mlstm_cell_chunked(q, k, v, log_i, log_f, state, chunk: int):
    """q/k/v: (B, L, H, dh) (k pre-scaled by 1/sqrt(dh)); log_i/log_f:
    (B, L, H); state: (C (B,H,dh,dh), n (B,H,dh), m (B,H)) or None.
    Returns (h (B, L, H, dh), state'), f32."""
    Bsz, L, H, dh = q.shape
    f32 = torch.float32
    nc, Q = chunk_geometry(L, chunk)

    def rs(t, *tail):
        return reshape(t, Bsz, nc, Q, *tail)

    qc, kc, vc = (rs(t.to(f32), H, dh) for t in (q, k, v))
    li = rs(log_i.to(f32), H)
    b = torch.cumsum(rs(log_f.to(f32), H), dim=2)       # (B, nc, Q, H)
    bl = b[:, :, -1, :]                                 # (B, nc, H)

    # intra-chunk stabilised scores: s_ij = b_i - b_j + li_j  (i >= j)
    bi_ = b.permute(0, 1, 3, 2)                         # (B, nc, H, Q)
    s = bi_[..., :, None] - bi_[..., None, :] \
        + li.permute(0, 1, 3, 2)[..., None, :]          # (B, nc, H, Q, K)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=q.device))
    s = torch.where(mask, s, NEG)
    m_intra = torch.amax(s, dim=-1)                     # (B, nc, H, Q)
    qk = torch.einsum("bcqhd,bckhd->bchqk", qc, kc)
    qk = shard(qk, "batch", "cchunk", None, None, None)

    # chunk-local summaries for the state recurrence
    g = bl[:, :, None, :] - b + li                      # (B, nc, Q, H)
    m_loc = torch.amax(g, dim=2)                        # (B, nc, H)

    if state is None:
        C = torch.zeros((Bsz, H, dh, dh), dtype=f32, device=q.device)
        n = torch.zeros((Bsz, H, dh), dtype=f32, device=q.device)
        m = torch.full((Bsz, H), NEG, dtype=f32, device=q.device)
    else:
        C, n, m = (t.to(f32) for t in state)
    Cp, np_, mp = [], [], []
    for c in range(nc):
        Cp.append(C)
        np_.append(n)
        mp.append(m)
        m_new = torch.maximum(bl[:, c] + m, m_loc[:, c])           # (B, H)
        sc_old = torch.exp(bl[:, c] + m - m_new)
        w = torch.exp(g[:, c] - m_new[:, None, :])                # (B, Q, H)
        C = C * sc_old[..., None, None] + \
            torch.einsum("bqhd,bqhe,bqh->bhde", kc[:, c], vc[:, c], w)
        n = n * sc_old[..., None] + \
            torch.einsum("bqhd,bqh->bhd", kc[:, c], w)
        m = m_new
    Cp = torch.stack(Cp, dim=1)                         # (B, nc, H, dh, dh)
    np_ = torch.stack(np_, dim=1)                       # (B, nc, H, dh)
    mp = torch.stack(mp, dim=1)                         # (B, nc, H)

    # stabiliser per position: m_i = max(intra max, b_i + m_prev)
    d_inter = b + mp[:, :, None, :]                     # (B, nc, Q, H)
    m_i = torch.maximum(m_intra.permute(0, 1, 3, 2), d_inter)
    w_intra = torch.exp(s - m_i.permute(0, 1, 3, 2)[..., None])
    w_intra = torch.where(mask, w_intra, 0.0)           # (B, nc, H, Q, K)
    w_inter = torch.exp(d_inter - m_i)                  # (B, nc, Q, H)

    num = torch.einsum("bchqk,bckhe->bcqhe", w_intra * qk, vc)
    num = num + torch.einsum("bcqhd,bchde,bcqh->bcqhe", qc, Cp, w_inter)
    den = torch.einsum("bchqk->bchq", w_intra * qk).permute(0, 1, 3, 2)
    den = den + torch.einsum("bcqhd,bchd->bcqh", qc, np_) * w_inter
    den = torch.maximum(torch.abs(den), torch.exp(-m_i))  # (B, nc, Q, H)
    h = num / den[..., None]
    return reshape(h, Bsz, L, H, dh), (C, n, m)


def mlstm_cell_step(q, k, v, log_i, log_f, state):
    """Single decode step in f32. q/k/v: (B, H, dh); gates: (B, H);
    state (C, n, m). Returns (h (B, H, dh), state')."""
    f32 = torch.float32
    C, n, m = (t.to(f32) for t in state)
    q, k, v, log_i, log_f = (t.to(f32) for t in (q, k, v, log_i, log_f))
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(log_i - m_new)
    C = C * f_s[..., None, None] + i_s[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    n = n * f_s[..., None] + i_s[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def restabilise(state, m):
    """An mLSTM state's (C, n), stored scaled by exp(-state's m), scaled
    by exp(-m) instead: two states that differ only in their stabiliser
    then compare leaf for leaf."""
    C, n, m_old = state
    scale = torch.exp(m_old - m)
    return C * scale[..., None, None], n * scale[..., None]


def mlstm_recurrence(q, k, v, log_i, log_f):
    """:func:`mlstm_cell_chunked`'s plain per-token form:
    :func:`mlstm_cell_step` over the L positions from the initial state
    (C = 0, n = 0, m = NEG), all in f32. Returns (h (B, L, H, dh),
    state)."""
    Bsz, L, H, dh = q.shape
    f32 = torch.float32
    state = (torch.zeros((Bsz, H, dh, dh), dtype=f32, device=q.device),
             torch.zeros((Bsz, H, dh), dtype=f32, device=q.device),
             torch.full((Bsz, H), NEG, dtype=f32, device=q.device))
    hs = []
    for t in range(L):
        h, state = mlstm_cell_step(q[:, t], k[:, t], v[:, t], log_i[:, t],
                                   log_f[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_inputs(p: Dict, cfg, x: torch.Tensor, conv_state=None):
    """The mLSTM block's projections up to the cell. x: (B, L, d) →
    (z, xm, xc, q, k, v, log_i, log_f, the new conv state): with
    ``conv_state`` (decode, L = 1) the conv steps from it, else it runs
    causally over the sequence (the new conv state is then None)."""
    dt = x.dtype
    dm, Hl, dh = _mdims(cfg)
    Bsz, L, _ = x.shape
    h_in = rms_norm(x, p["norm"], cfg.norm_eps)
    xm = torch.matmul(h_in, p["w_up_x"].to(dt))
    z = torch.matmul(h_in, p["w_up_z"].to(dt))
    new_conv = None
    if conv_state is not None:
        new_conv, xc_t = conv_update(conv_state, xm[:, 0, :],
                                     p["conv_w"].to(dt), p["conv_b"].to(dt))
        xc = F.silu(xc_t)[:, None, :]
    else:
        xc = F.silu(causal_conv1d(xm, p["conv_w"].to(dt),
                                  p["conv_b"].to(dt)))
    q = reshape(torch.matmul(xc, p["wq"].to(dt)), Bsz, L, Hl, dh)
    k = reshape(torch.matmul(xc, p["wk"].to(dt)), Bsz, L, Hl, dh) \
        / math.sqrt(dh)
    v = reshape(torch.matmul(xm, p["wv"].to(dt)), Bsz, L, Hl, dh)
    log_i = torch.matmul(xc, p["wi"].to(dt)) + p["bi"].to(dt)
    log_f = elementwise(F.logsigmoid,
                        torch.matmul(xc, p["wf"].to(dt)) + p["bf"].to(dt))
    return z, xm, xc, q, k, v, log_i, log_f, new_conv


def mlstm_apply(p: Dict, cfg, x: torch.Tensor, *, mode: str,
                cache: Optional[Dict] = None, chunk: int = 256
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, L, d). Returns (the block's output, to be added to x; the
    new cache: None in train mode)."""
    x = gather_seq(x)  # the sequence whole inside the block (SP)
    dt = x.dtype
    dm, Hl, dh = _mdims(cfg)
    Bsz, L, _ = x.shape
    if mode == "decode":
        if cache is None or L != 1:
            raise ValueError("mlstm_apply: decode takes one token a lane "
                             "and a cache")
        z, xm, xc, q, k, v, log_i, log_f, conv = mlstm_inputs(
            p, cfg, x, cache["conv"])
        h, (C, n, m) = mlstm_cell_step(q[:, 0], k[:, 0], v[:, 0],
                                       log_i[:, 0], log_f[:, 0],
                                       (cache["C"], cache["n"], cache["m"]))
        h = h[:, None, :, :]
        new_cache = {"conv": conv.to(cache["conv"].dtype),
                     "C": C.to(cache["C"].dtype), "n": n, "m": m}
    else:
        z, xm, xc, q, k, v, log_i, log_f, _ = mlstm_inputs(p, cfg, x)
        # each rank its own rows, every head (``blockwise``)
        r4, r3, r2 = ("batch", None, None, None), ("batch", None, None), \
            ("batch", None)
        h, C, n, m = blockwise(
            lambda *a: _flat(mlstm_cell_chunked(*a, None, chunk)),
            [(q, r4), (k, r4), (v, r4), (log_i, r3), (log_f, r3)],
            out=(r4, r4, r3, r2))
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv": _last_inputs(xm, cfg.conv_width),
                         "C": C.to(torch.bfloat16), "n": n, "m": m}

    h = reshape(_headnorm(h.to(dt), p["hnorm"], cfg.norm_eps), Bsz, L, dm)
    h = h + p["skip"].to(dt) * xc
    return torch.matmul(h * F.silu(z), p["w_down"].to(dt)), new_cache


def _flat(out):
    """(h, (C, n, m)) → (h, C, n, m)."""
    h, (C, n, m) = out
    return h, C, n, m


def mlstm_specs(cfg) -> Dict:
    return {
        "norm": (None,), "w_up_x": ("embed", "ff"), "w_up_z": ("embed", "ff"),
        "conv_w": (None, "ff"), "conv_b": ("ff",),
        "wq": ("embed", "ff"), "wk": ("embed", "ff"), "wv": ("embed", "ff"),
        "wi": ("ff", None), "bi": (None,), "wf": ("ff", None), "bf": (None,),
        "skip": ("ff",), "hnorm": ("ff",), "w_down": ("ff", "embed"),
    }


def mlstm_cache_specs(cfg) -> Dict:
    return {"conv": ("batch", None, "ff"),
            "C": ("batch", None, None, "lstm_dh"),
            "n": ("batch", None, None), "m": ("batch", None)}


def slstm_specs(cfg) -> Dict:
    return {"norm": (None,), "Wg": ("embed", "ff"),
            "R": (None, None, None, None),
            "b": ("ff",), "gnorm": (None,), "ffn_norm": (None,),
            "w1": ("embed", "ff"), "w2": ("ff", "embed")}


def slstm_cache_specs(cfg) -> Dict:
    return {"h": ("batch", None), "c": ("batch", None),
            "n": ("batch", None), "m": ("batch", None)}


def init_mlstm_cache(cfg, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    dm, Hl, dh = _mdims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, dm), dtype=dtype,
                            device=device),
        "C": torch.zeros((batch, Hl, dh, dh), dtype=torch.bfloat16,
                         device=device),
        "n": torch.zeros((batch, Hl, dh), dtype=torch.float32,
                         device=device),
        "m": torch.full((batch, Hl), NEG, dtype=torch.float32,
                        device=device),
    }


# ===================================================================== #
# sLSTM
# ===================================================================== #
def slstm_ff_width(cfg) -> int:
    """The sLSTM block's FFN width, rounded up to a multiple of 64."""
    return ((int(cfg.slstm_ff_factor * cfg.d_model) + 63) // 64) * 64


def slstm_init(generator: Callable[[int], torch.Generator], cfg, *,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """``generator(i)``: the ``torch.Generator`` of ``SLSTM_LEAVES[i]``."""
    d = cfg.d_model
    Hl = cfg.num_lstm_heads
    dh = d // Hl
    f = slstm_ff_width(cfg)
    dt = pdtype(cfg)
    leaf = {name: generator(i) for i, name in enumerate(SLSTM_LEAVES)}
    ones = lambda: torch.ones((d,), dtype=dt, device=device)  # noqa: E731
    return {
        "norm": ones(),
        "Wg": dense_init(leaf["Wg"], (d, 4 * d), dt, device=device),
        "R": dense_init(leaf["R"], (4, Hl, dh, dh), dt, fan_in=dh,
                        device=device),
        "b": torch.cat([torch.full((d,), -3.0), torch.full((d,), 3.0),
                        torch.zeros((d,)), torch.zeros((d,))]).to(
                            device=device, dtype=dt),
        "gnorm": ones(),
        "ffn_norm": ones(),
        "w1": dense_init(leaf["w1"], (d, f), dt, device=device),
        "w2": dense_init(leaf["w2"], (f, d), dt, fan_in=f, device=device),
    }


def _slstm_step(p, cfg, carry, gx_t):
    """carry: (h, c, n, m) each (B, d) f32; gx_t: (B, 4d) f32, the gates
    before the recurrence."""
    h, c, n, m = carry
    d = h.shape[-1]
    Hl = cfg.num_lstm_heads
    hh = reshape(h, -1, Hl, d // Hl)
    rec = torch.einsum("bhd,ghde->gbhe", hh, p["R"].to(torch.float32))
    rec = reshape(rec, 4, -1, d)
    gi, gf, gz, go = (gx_t[..., i * d:(i + 1) * d] + rec[i]
                      for i in range(4))
    log_i = gi
    log_f = elementwise(F.logsigmoid, gf)
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(gz)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def slstm_scan(p, cfg, gx, carry):
    """:func:`_slstm_step` over the sequence. gx: (B, L, 4d) f32.
    Returns (hs (B, L, d), the last carry).

    Under a mesh the recurrence runs on each rank's own batch rows as
    plain tensors, with ``R`` whole (its spec replicates it): every
    step is a dozen small ops, which DTensor would dispatch one by one
    with their layouts, L times a block.

    On the ``meta`` device (a dry run: shapes without values) the L
    steps are taken as one step over B·L rows: the same products and
    elementwise ops at L times the rows, so the same FLOPs and saved
    activations, without L passes of the host's dispatch. The chain
    through time is in the values alone, and there are none."""
    gx = local_part(gx, "batch", None, None)
    carry = tuple(local_part(c, "batch", None) for c in carry)
    R = {"R": unshard(p["R"], rows=("batch",))}
    Bsz, L = gx.shape[:2]
    if gx.device.type == "meta":
        rows = tuple(c[:, None].expand(Bsz, L, c.shape[-1]).reshape(
            Bsz * L, -1) for c in carry)
        out = _slstm_step(R, cfg, rows, gx.reshape(Bsz * L, -1))
        out = tuple(c.reshape(Bsz, L, -1) for c in out)
        hs, carry = out[0], tuple(c[:, -1] for c in out)
    else:
        hs = []
        for t in range(L):
            carry = _slstm_step(R, cfg, carry, gx[:, t])
            hs.append(carry[0])
        hs = torch.stack(hs, dim=1)
    return (from_local_part(hs, "batch", None, None),
            tuple(from_local_part(c, "batch", None) for c in carry))


def slstm_apply(p: Dict, cfg, x: torch.Tensor, *, mode: str,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, L, d). Returns (x plus the block's output, the new cache:
    None in train mode)."""
    x = gather_seq(x)  # the sequence whole inside the block (SP)
    dt = x.dtype
    Bsz, L, d = x.shape
    h_in = rms_norm(x, p["norm"], cfg.norm_eps)
    gx = (torch.matmul(h_in, p["Wg"].to(dt)) + p["b"].to(dt)).to(
        torch.float32)
    if mode == "decode":
        if cache is None or L != 1:
            raise ValueError("slstm_apply: decode takes one token a lane "
                             "and a cache")
        carry = (cache["h"], cache["c"], cache["n"], cache["m"])
    else:
        z = torch.zeros((Bsz, d), dtype=torch.float32, device=x.device)
        carry = (z, z, z, torch.full((Bsz, d), NEG, dtype=torch.float32,
                                     device=x.device))
    hs, carry = slstm_scan(p, cfg, gx, carry)
    new_cache = None
    if mode != "train":
        new_cache = dict(zip(("h", "c", "n", "m"), carry))

    y = x + rms_norm(hs.to(dt), p["gnorm"], cfg.norm_eps)
    # gelu FFN (proj factor 4/3)
    hf = rms_norm(y, p["ffn_norm"], cfg.norm_eps)
    hf = act_fn("gelu")(torch.matmul(hf, p["w1"].to(dt)))
    hf = shard(hf, "batch", None, "ff")
    return y + torch.matmul(hf, p["w2"].to(dt)), new_cache


def init_slstm_cache(cfg, batch: int, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=torch.float32,  # noqa: E731
                            device=device)
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, d), NEG, dtype=torch.float32,
                            device=device)}
