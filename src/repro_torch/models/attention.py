"""GQA attention: chunked prefill, ring-buffer windowed KV caches,
gemma-style logit softcaps, RoPE, QKV bias.

Port of ``repro.models.attention``, with the reference's logical
sharding annotations (``repro_torch.sharding``: nothing without a
mesh; under one, each projection weight is redistributed whole but for
its TP dim before its product — FSDP's gather of the ``embed`` dim,
which DTensor would otherwise meet by splitting the activations' model
dim and summing bf16 partial products). The same arithmetic in the
same dtypes: scores and the weighted sum accumulate in f32 whatever the
compute dtype (the reference's ``preferred_element_type=f32``), and a
bf16 KV cache is read beside f32 queries by upcasting it, where JAX
promotes implicitly.

Layout: q is kept grouped as (B, S, KH_eff, G, dh) where KH_eff =
num_kv_heads * cfg.kv_repeat, so scores are computed grouped and the
KV cache is never materialized at full head count.

Functional contract: ``attn_apply`` returns a new cache and leaves the
one it was given as it was (callers reuse a prefill cache for several
decodes).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (apply_rope, apply_rope_pairs,
                                       dense_init, rms_norm, softcap)
from repro_torch.obs.core import NULL_RECORDER
from repro_torch.sharding import (axis_rules, blockwise, current_mesh,
                                  from_local_part, gather_seq, local_part,
                                  shard)

NEG_INF = -2.0e38


# --------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------- #
def attn_init(generators, cfg, dtype: torch.dtype, *,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """``generators``: four ``torch.Generator`` for wq, wk, wv, wo."""
    d, H, KH, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gq, gk, gv, go = generators
    p = {
        "wq": dense_init(gq, (d, H, dh), dtype, fan_in=d, device=device),
        "wk": dense_init(gk, (d, KH, dh), dtype, fan_in=d, device=device),
        "wv": dense_init(gv, (d, KH, dh), dtype, fan_in=d, device=device),
        "wo": dense_init(go, (H, dh, d), dtype, fan_in=H * dh,
                         device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KH, dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KH, dh), dtype=dtype, device=device)
    return p


def attn_specs(cfg) -> Dict:
    s = {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }
    if cfg.qkv_bias:
        s["bq"] = ("heads", None)
        s["bk"] = ("kv_heads", None)
        s["bv"] = ("kv_heads", None)
    return s


# --------------------------------------------------------------------- #
# core attend
# --------------------------------------------------------------------- #
def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    scores = torch.where(mask, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.clamp(m, min=-1e30)  # rows that are fully masked stay finite
    e = torch.exp(scores - m)
    e = torch.where(mask, e, 0.0)
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def _attend_block(q, k, v, q_pos, k_pos, *, window, cap, scale):
    """q: (B, Sq, KH, G, dh); k/v: (B, T, KH, dh); *_pos int (B, Sq) /
    (B, T). ``window``: None, or an int-like (0 = full attention)."""
    dt = q.dtype
    f32 = torch.float32
    scores = torch.einsum("bqkgd,btkd->bkgqt", q.to(f32),
                          k.to(f32)) * scale
    scores = softcap(scores, cap)
    scores = shard(scores, "batch", "act_kv", None, None, "act_kvseq")
    mask = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window is not None and int(window) > 0:
        mask = mask & (k_pos[:, None, :] > (q_pos[:, :, None] - int(window)))
    w = _masked_softmax(scores, mask[:, None, None, :, :])
    out = torch.einsum("bkgqt,btkd->bqkgd", w.to(dt).to(f32), v.to(f32))
    return out.to(dt)


def attend(q, k, v, q_pos, k_pos, *, window=None, cap=0.0, scale=1.0,
           q_chunk: int = 1024):
    """Chunked attention over the query axis (memory ~ Sq_chunk * T);
    each query row is independent, so the chunks compute the unchunked
    values (to the rounding of another batched product).

    Under a mesh (train and prefill, where only the batch and the KV
    heads are split) each rank attends its own block of sequences and
    heads as plain tensors: attention is independent across both, and
    DTensor would otherwise fold the two split dims of each batched
    product into one, which some of its versions refuse."""
    if current_mesh() is None:
        return _attend_chunks(q, k, v, q_pos, k_pos, window=window, cap=cap,
                              scale=scale, q_chunk=q_chunk)
    qn, kn = ("batch", None, "act_kv", None, None), \
        ("batch", None, "act_kv", None)
    parts = (local_part(q, *qn), local_part(k, *kn), local_part(v, *kn),
             local_part(q_pos, "batch", None),
             local_part(k_pos, "batch", None))
    with axis_rules(None, {}):      # plain tensors: no constraint inside
        out = _attend_chunks(*parts, window=window, cap=cap, scale=scale,
                             q_chunk=q_chunk)
    return from_local_part(out, *qn)


def _attend_chunks(q, k, v, q_pos, k_pos, *, window, cap, scale, q_chunk):
    Sq = q.shape[1]
    if Sq <= q_chunk or Sq % q_chunk != 0:
        return _attend_block(q, k, v, q_pos, k_pos,
                             window=window, cap=cap, scale=scale)
    return torch.cat([
        _attend_block(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk],
                      k_pos, window=window, cap=cap, scale=scale)
        for i in range(0, Sq, q_chunk)], dim=1)


# --------------------------------------------------------------------- #
# cache helpers (ring buffer when T < full sequence)
# --------------------------------------------------------------------- #
def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) symmetric int8 quantization of K/V rows --
    the paper's 8-bit ex-situ storage discipline applied to the decode
    cache. Returns (codes int8, scale f32 without dh)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def init_attn_cache(cfg, batch: int, cache_len: int, dtype: torch.dtype,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    KH_eff = cfg.num_kv_heads * cfg.kv_repeat
    shp = (batch, cache_len, KH_eff, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshp = shp[:-1]
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "ks": torch.zeros(sshp, dtype=torch.float32, device=device),
                "vs": torch.zeros(sshp, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def attn_cache_specs(cfg) -> Dict:
    s = {"k": ("batch", "act_kvseq", "act_kv", None),
         "v": ("batch", "act_kvseq", "act_kv", None)}
    if cfg.kv_cache_dtype == "int8":
        s["ks"] = ("batch", "act_kvseq", "act_kv")
        s["vs"] = ("batch", "act_kvseq", "act_kv")
    return s


def _ring_positions(pos: torch.Tensor, T: int) -> torch.Tensor:
    """Absolute position stored in each ring slot after writing ``pos``
    (a scalar → (T,), or (B,) → (B, T)); never-written slots come out
    negative."""
    j = torch.arange(T, dtype=torch.int32, device=pos.device)
    p = pos[..., None]
    return p - ((p % T - j) % T)


def _stored(cache_len: int, k: torch.Tensor) -> torch.Tensor:
    """:func:`_store_prefill`, each rank on its own rows and KV heads
    under a mesh (``blockwise``: the pad and roll run along the whole
    sequence)."""
    names = ("batch", None, "act_kv", None)[:k.dim()]
    return blockwise(lambda t: _store_prefill(cache_len, t),
                     [(k, names)], out=names)


def _write_slot(cache: torch.Tensor, idx: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """``cache`` (B, T, ...) with slot ``idx`` (a 1-element index) along
    T set to ``new`` (B, 1, ...). Under a mesh, where the ring's T may
    be split (decode's ``act_kvseq``), as a masked select: every rank
    keeps its own slots (``index_copy`` on a split dim is not laid out
    by every DTensor version)."""
    if current_mesh() is None:
        return cache.index_copy(1, idx, new)
    T = cache.shape[1]
    hit = torch.arange(T, device=idx.device) == idx
    return torch.where(hit.reshape((1, T) + (1,) * (cache.dim() - 2)),
                       new.to(cache.dtype), cache)


def _store_prefill(cache_len: int, k: torch.Tensor) -> torch.Tensor:
    """Store a prefilled sequence (B, S, ...) into a ring of length T:
    zero-padded when it fits, else its last T positions, each at its
    ring slot (position % T). Serves the (B, S, KH, dh) rows and their
    (B, S, KH) int8 scales alike."""
    S = k.shape[1]
    if S <= cache_len:
        pad = [0, 0] * (k.dim() - 2) + [0, cache_len - S]
        return torch.nn.functional.pad(k, pad)
    last = k[:, S - cache_len:]
    shift = (S - cache_len) % cache_len
    return torch.roll(last, shift, dims=1)


# --------------------------------------------------------------------- #
# full layer apply
# --------------------------------------------------------------------- #
def attn_apply(p: Dict, cfg, x: torch.Tensor, *, positions: torch.Tensor,
               mode: str, cache: Optional[Dict] = None,
               window=None, project=None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). positions: (B, S) absolute token positions.

    mode: "train" (no cache), "prefill" (build cache), "decode" (S == 1,
    read + update cache; ``cfg.decode_per_slot`` lets every batch lane
    hold its own position — the continuous-batching serving path).

    ``window``: None, or the layer's sliding window (0 = full). A Python
    int also sizes a prefill's ring (T = min(S, cfg.sliding_window));
    the stacks pass each layer's window as a 0-d tensor, as the
    reference's scan does, so their prefill keeps all S positions.

    project: optional ``(name, x (B, S, d_in)) -> (B, S, d_out)``
    override for the four linear projections ("wq"/"wk"/"wv"/"wo");
    ``repro_torch.lm`` routes them through crossbar-mapped tile grids
    while rope, softmax and cache surgery below stay plain tensor glue.
    QKV biases are still added here, so a projection backend must not
    fold them in.
    Returns (out (B, S, d), new_cache)."""
    x = gather_seq(x)  # the sequence whole inside the block (SP)
    dt = x.dtype
    B, S, _ = x.shape
    H, KH, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    KH_eff = KH * cfg.kv_repeat
    G = H // KH_eff
    scale = cfg.attn_scale if cfg.attn_scale else dh ** -0.5

    if project is None:
        # FSDP's gather: each weight whole but for its TP dim
        q = torch.einsum("bsd,dhk->bshk", x,
                         shard(p["wq"].to(dt), None, "heads", None))
        k = torch.einsum("bsd,dhk->bshk", x,
                         shard(p["wk"].to(dt), None, "kv_heads", None))
        v = torch.einsum("bsd,dhk->bshk", x,
                         shard(p["wv"].to(dt), None, "kv_heads", None))
    else:
        q = project("wq", x).reshape(B, S, H, dh)
        k = project("wk", x).reshape(B, S, KH, dh)
        v = project("wv", x).reshape(B, S, KH, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)

    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.kv_repeat > 1:
        k = torch.repeat_interleave(k, cfg.kv_repeat, dim=2)
        v = torch.repeat_interleave(v, cfg.kv_repeat, dim=2)
    q = q.reshape(B, S, KH_eff, G, dh)
    q = shard(q, "batch", None, "act_kv", None, None)
    k = shard(k, "batch", "act_kvseq", "act_kv", None)
    v = shard(v, "batch", "act_kvseq", "act_kv", None)

    new_cache = None
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("attn_apply: decode takes one token a lane "
                             "and a cache")
        T = cache["k"].shape[1]
        quant = cfg.kv_cache_dtype == "int8"
        if quant:
            kq, ks_new = _quant_kv(k)
            vq, vs_new = _quant_kv(v)
        else:
            # explicit downcast into the cache dtype (round to nearest
            # even, as the reference's astype)
            kq = k.to(cache["k"].dtype)
            vq = v.to(cache["v"].dtype)
        new_cache = {}
        if cfg.decode_per_slot:
            # continuous batching: every slot decodes at its own position
            pos_b = positions[:, 0]                      # (B,)
            at = (torch.arange(B, device=x.device), (pos_b % T).long())
            new_cache["k"] = cache["k"].index_put(at, kq[:, 0])
            new_cache["v"] = cache["v"].index_put(at, vq[:, 0])
            if quant:
                new_cache["ks"] = cache["ks"].index_put(at, ks_new[:, 0])
                new_cache["vs"] = cache["vs"].index_put(at, vs_new[:, 0])
            k_pos = _ring_positions(pos_b, T)
        else:
            pos = positions[0, 0]  # lockstep decode: one position
            idx = (pos % T).reshape(1).long()
            new_cache["k"] = _write_slot(cache["k"], idx, kq)
            new_cache["v"] = _write_slot(cache["v"], idx, vq)
            if quant:
                new_cache["ks"] = _write_slot(cache["ks"], idx, ks_new)
                new_cache["vs"] = _write_slot(cache["vs"], idx, vs_new)
            k_pos = _ring_positions(pos, T)[None, :].expand(B, T)
        for name in ("k", "v"):
            new_cache[name] = shard(new_cache[name], "batch", "act_kvseq",
                                    "act_kv", None)
        if quant:
            k_att = _dequant_kv(new_cache["k"], new_cache["ks"], dt)
            v_att = _dequant_kv(new_cache["v"], new_cache["vs"], dt)
        else:
            k_att, v_att = new_cache["k"], new_cache["v"]
        out = _attend_block(q, k_att, v_att, positions, k_pos,
                            window=window, cap=cfg.attn_softcap, scale=scale)
    else:
        out = attend(q, k, v, positions, positions,
                     window=window, cap=cfg.attn_softcap, scale=scale)
        if mode == "prefill":
            T = min(S, cfg.sliding_window) if isinstance(window, int) \
                and window > 0 else S
            if cfg.kv_cache_dtype == "int8":
                kq, ks_new = _quant_kv(k)
                vq, vs_new = _quant_kv(v)
                new_cache = {"k": _stored(T, kq), "v": _stored(T, vq),
                             "ks": _stored(T, ks_new),
                             "vs": _stored(T, vs_new)}
            else:
                new_cache = {"k": _stored(T, k), "v": _stored(T, v)}

    out = out.reshape(B, S, H, dh)
    if project is None:
        out = torch.einsum("bshk,hkd->bsd", out,
                           shard(p["wo"].to(dt), "heads", None, None))
    else:
        out = project("wo", out.reshape(B, S, H * dh))
    return out, new_cache


# --------------------------------------------------------------------- #
# MLA: DeepSeek's latent attention, absorbed
# --------------------------------------------------------------------- #
# What a position leaves in the cache is the normed latent c (r =
# kv_lora_rank values) and the rotated RoPE key (qk_rope_head_dim), side
# by side in one leaf ``ckv``: 576 values a position a layer at the
# published widths, where GQA with 16 KV heads of 128 would hold 4,096.
# K and V are never expanded. With W_kb (r → nope) and W_vb (r → v) the
# two halves of a head's kv_b_proj,
#
#   q_nope · (c W_kb) = (q_nope W_kbᵀ) · c     (the query taken to r)
#   Σ_t w_t (c_t W_vb) = (Σ_t w_t c_t) W_vb    (the sum taken in r)
#
# so scores and the weighted sum run over the latent cache itself, and
# each head's W_kbᵀ (nope → r) and W_vb (r → v) is applied once a query.
def mla_init(generators, cfg, dtype: torch.dtype, *,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """``generators``: four ``torch.Generator`` for wq, wkv_a, wkv_b,
    wo. Layouts: wq (d, H, nope + rope) (q_proj, q_lora_rank null);
    wkv_a (d, r + rope) (kv_a_proj_with_mqa: the latent, then the RoPE
    key); kv_norm (r,) (kv_a_layernorm); wkv_b (r, H, nope + v)
    (kv_b_proj: each head's k_nope, then its v); wo (H, v, d)."""
    d, H = cfg.d_model, cfg.num_heads
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    rope, dv = cfg.qk_rope_head_dim, cfg.v_head_dim
    gq, ga, gb, go = generators
    return {
        "wq": dense_init(gq, (d, H, nope + rope), dtype, fan_in=d,
                         device=device),
        "wkv_a": dense_init(ga, (d, r + rope), dtype, fan_in=d,
                            device=device),
        "kv_norm": torch.ones((r,), dtype=dtype, device=device),
        "wkv_b": dense_init(gb, (r, H, nope + dv), dtype, fan_in=r,
                            device=device),
        "wo": dense_init(go, (H, dv, d), dtype, fan_in=H * dv,
                         device=device),
    }


def mla_specs(cfg) -> Dict:
    return {"wq": ("embed", "heads", None), "wkv_a": ("embed", None),
            "kv_norm": (None,), "wkv_b": (None, "heads", None),
            "wo": ("heads", None, "embed")}


def mla_cache_width(cfg) -> int:
    """Values a position a layer holds in the latent cache ``ckv``."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("MLA keeps its latent cache in the "
                                  "caller's float dtype")
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def mla_cache_specs(cfg) -> Dict:
    return {"ckv": ("batch", "act_kvseq", None)}


def mla_projector(p: Dict, cfg):
    """The plain ``project(name, x)`` of an MLA layer: "wq_a" (q_proj
    and kv_a_proj side by side: they read the same input), "wkb" (each
    head's W_kbᵀ, nope → r), "wvb" (each head's W_vb, r → v), "wo".
    ``x`` is (B, S, d_in), heads flattened into the last dim."""
    H, r, nope = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    dv = cfg.v_head_dim

    def project(name: str, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if name == "wq_a":
            q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
            return torch.cat([q.flatten(2),
                              torch.matmul(x, p["wkv_a"].to(dt))], dim=-1)
        wb = p["wkv_b"].to(dt)
        if name == "wkb":
            return torch.einsum("bshn,rhn->bshr", x.unflatten(-1, (H, nope)),
                                wb[..., :nope]).flatten(2)
        if name == "wvb":
            return torch.einsum("bshr,rhv->bshv", x.unflatten(-1, (H, r)),
                                wb[..., nope:]).flatten(2)
        if name == "wo":
            return torch.einsum("bshv,hvd->bsd", x.unflatten(-1, (H, dv)),
                                p["wo"].to(dt))
        raise KeyError(name)
    return project


def _latent_attend(qc: torch.Tensor, keys: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, r: int,
                   scale: float, q_chunk: int = 512) -> torch.Tensor:
    """qc (B, S, H, r + rope): [q_nope W_kbᵀ, rotated q_pe]; keys
    (B, T, r + rope): [c, rotated k_pe]; positions (B, S) / (B, T)
    (negative: an empty slot). → the weighted sums of the latents
    (B, S, H, r), in f32, the queries in chunks of ``q_chunk``."""
    f32 = torch.float32
    B, S, H, C = qc.shape
    kf = keys.to(f32)
    kt = kf.transpose(1, 2)
    outs = []
    for i in range(0, S, q_chunk):
        qb = qc[:, i:i + q_chunk].to(f32)
        s = qb.shape[1]
        scores = torch.matmul(qb.reshape(B, s * H, C), kt) * scale
        qp = q_pos[:, i:i + q_chunk, None]
        mask = (k_pos[:, None, :] <= qp) & (k_pos[:, None, :] >= 0)
        mask = mask[:, :, None, :].expand(B, s, H, -1).reshape(B, s * H, -1)
        w = _masked_softmax(scores, mask)
        outs.append(torch.matmul(w, kf[..., :r]).reshape(B, s, H, r))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def mla_apply(p: Dict, cfg, x: torch.Tensor, *, positions: torch.Tensor,
              mode: str, cache: Optional[Dict] = None,
              kv_len: Optional[int] = None, project=None,
              rec=NULL_RECORDER) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d); positions (B, S). ``project(name, x)`` runs the
    layer's four static-weight products (:func:`mla_projector` when
    None; ``repro_torch.lm`` puts them on tile grids); the RoPE, the
    latent norm, the cache and the attention over it stay here.

    mode "train"/"prefill" attend within the sequence (prefill returns
    its ``ckv`` as the cache); "decode" (S == 1, every lane at its own
    position) writes each lane's ``ckv`` into ``cache`` IN PLACE and
    returns that same cache: the latent cache is the deployment's
    largest tensor, and a copy a step would double it. ``kv_len``, where
    the caller knows every lane's position is below it, bounds the
    slots read. ``rec`` brackets the attention over the latents
    (``lm.mla``). Returns (out (B, S, d), cache)."""
    B, S, _ = x.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if project is None:
        project = mla_projector(p, cfg)
    q, kv = project("wq_a", x).split([H * (nope + rope), r + rope], dim=-1)
    q_nope, q_pe = q.reshape(B, S, H, nope + rope).split([nope, rope], -1)
    c = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope_pairs(kv[..., None, r:], positions,
                            cfg.rope_theta)[..., 0, :]
    q_pe = apply_rope_pairs(q_pe, positions, cfg.rope_theta)
    q_lat = project("wkb", q_nope.reshape(B, S, H * nope))
    qc = torch.cat([q_lat.reshape(B, S, H, r), q_pe], dim=-1)
    ckv = torch.cat([c, k_pe], dim=-1)
    scale = (nope + rope) ** -0.5
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("mla_apply: decode takes one token a lane "
                             "and a cache")
        ring = cache["ckv"]
        T = ring.shape[1]
        pos_b = positions[:, 0]
        ring[torch.arange(B, device=x.device), (pos_b % T).long()] = \
            ckv[:, 0].to(ring.dtype)
        n = T if kv_len is None else max(1, min(T, int(kv_len)))
        keys = ring[:, :n]
        k_pos = _ring_positions(pos_b, T)[:, :n]
        new_cache = cache
    else:
        keys, k_pos = ckv, positions
        new_cache = {"ckv": ckv} if mode == "prefill" else None
    with rec.span("lm.mla"):
        o_lat = _latent_attend(qc, keys, positions, k_pos, r, scale)
    o = project("wvb", o_lat.to(x.dtype).reshape(B, S, H * r))
    return project("wo", o), new_cache
