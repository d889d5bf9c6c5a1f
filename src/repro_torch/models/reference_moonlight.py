"""Plain reference of Moonlight-16B-A3B (``deepseek_v3``) over one
expert-parallel rank's share.

Plain ``torch`` only: it imports no JAX, no kernel and nothing of the
package it checks, and computes in float32 with TF32 off (``arith=
"tf32"``, the control, rounds both operands of every product to TF32's
10 mantissa bits, as a TF32 tensor core reads them, and sums in f32).
No cache and no batching: one sequence at a time, its whole forward.

The layer equations, as the published modeling code (DeepSeek-V3's)
writes them, in the EXPANDED form: each position's K and V are made
from its latent,

    q = x W_q            → per head q_nope (128), q_pe (64)
    [c', k_pe] = x W_kva ; c = RMSNorm(c')   (512 + 64)
    [k_nope, v] = c W_kvb                   per head (128 + 128)
    q_pe, k_pe rotated (interleaved pairs, θ = rope_theta)
    k = [k_nope, k_pe] (k_pe shared by the heads)
    o = softmax(q·k / √192, causal) v ;  out = o W_o

then the dense GLU FFN (layers < first_k_dense_replace) or the MoE:
scores σ(x W_gate) over all the router's experts; the top
``num_experts_per_tok`` of score + e_score_correction_bias (one group;
on a tie the lower expert index, as a stable sort gives it); weights
the chosen scores over their sum + 1e-20, times routed_scaling_factor;
out = shared experts(x) + Σ over the chosen experts HELD HERE of
weight · expert(x). Pre-norm residual blocks with RMS norms, a final
norm and an untied head.

Departures from the published model, each deliberate:

* the share: of ``router_experts`` (64) routed experts only the
  ``n_routed_experts`` of rank ``expert_rank`` are held and computed;
  what the others would add is left out, as an expert-parallel rank
  leaves it to its peers (the router keeps its full width and top-k);
* the vocabulary is a slice (``vocab_size`` rows of the embedding and
  of the head) and the depth ``num_hidden_layers``: the configuration's
  cut;
* float32 throughout (the published weights are bf16) and seeded
  weights (:func:`make_params`);
* RoPE follows the modeling code's layout: q_pe and k_pe are
  de-interleaved (evens, then odds) and rotated as halves, which dots
  as the interleaved rotation;
* only the logits asked for are computed (the head is a product per
  row).

Besides the logits, each token's router gap in each MoE layer: the
K-th choice value (score + bias) less the (K+1)-th. Where it is within
rounding of zero, a correct implementation may route the token either
way. A row's gap (:func:`outputs`) is the smallest that could move its
logits: its own token's in every MoE layer, and each earlier token's
in the MoE layers some later layer reads (the model's last layer feeds
only its own token's logits).

The benchmark's harness calls :func:`make_params` and :func:`outputs`.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# rows of a query block in the attention (bounds the scores' memory)
Q_BLOCK = 512


# --------------------------------------------------------------------- #
# the float weights both sides get
# --------------------------------------------------------------------- #
def _dims(config: dict) -> dict:
    c = config
    return {"d": int(c["hidden_size"]), "H": int(c["num_attention_heads"]),
            "nope": int(c["qk_nope_head_dim"]),
            "rope": int(c["qk_rope_head_dim"]), "dv": int(c["v_head_dim"]),
            "r": int(c["kv_lora_rank"]), "F": int(c["intermediate_size"]),
            "f": int(c["moe_intermediate_size"]),
            "held": int(c["n_routed_experts"]),
            "E": int(c.get("router_experts", c["n_routed_experts"])),
            "lo": int(c.get("expert_rank", 0)) * int(c["n_routed_experts"]),
            "shared": int(c["n_shared_experts"]),
            "K": int(c["num_experts_per_tok"]),
            "V": int(c["vocab_size"]), "L": int(c["num_hidden_layers"]),
            "nd": int(c["first_k_dense_replace"])}


def make_params(config: dict, gen: torch.Generator, device) -> dict:
    """Seeded float32 weights on ``device``, drawn from ``gen`` in a
    fixed order: linear weights N(0, 1/fan_in) as (in, out) matrices,
    the embedding N(0, embed_std²), norm scales 1, the router's
    correction bias N(0, gate_bias_std²) (``config["weights"]``)."""
    k = _dims(config)
    wts = config["weights"]
    d, H, r = k["d"], k["H"], k["r"]

    def lin(n_in, n_out, lead=()):
        return torch.randn(tuple(lead) + (n_in, n_out), generator=gen,
                           device=device) / math.sqrt(n_in)

    def ones(n):
        return torch.ones((n,), device=device)

    embed = torch.randn((k["V"], d), generator=gen, device=device) * \
        float(wts["embed_std"])
    layers = []
    for i in range(k["L"]):
        lay = {"input_norm": ones(d), "post_norm": ones(d),
               "q_proj": lin(d, H * (k["nope"] + k["rope"])),
               "kv_a_proj": lin(d, r + k["rope"]), "kv_norm": ones(r),
               "kv_b_proj": lin(r, H * (k["nope"] + k["dv"])),
               "o_proj": lin(H * k["dv"], d)}
        if i < k["nd"]:
            lay["mlp"] = {"w1": lin(d, k["F"]), "w3": lin(d, k["F"]),
                          "w2": lin(k["F"], d)}
        else:
            fs = k["f"] * k["shared"]
            lay["moe"] = {
                "gate": lin(d, k["E"]),
                "gate_bias": torch.randn((k["E"],), generator=gen,
                                         device=device) *
                float(wts["gate_bias_std"]),
                "w1": lin(d, k["f"], (k["held"],)),
                "w3": lin(d, k["f"], (k["held"],)),
                "w2": lin(k["f"], d, (k["held"],)),
                "shared": {"w1": lin(d, fs), "w3": lin(d, fs),
                           "w2": lin(fs, d)}}
        layers.append(lay)
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": lin(d, k["V"])}


# --------------------------------------------------------------------- #
# arithmetic
# --------------------------------------------------------------------- #
def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the card's f32 products, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mm(a: torch.Tensor, b: torch.Tensor, arith: str) -> torch.Tensor:
    if arith == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    elif arith != "exact":
        raise ValueError(f"unknown arith {arith!r}")
    return torch.matmul(a, b)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, n, dr): de-interleave, rotate as halves (the modeling
    code's ``apply_rotary_pos_emb``)."""
    dr = x.shape[-1]
    half = dr // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = pos.to(torch.float32)[:, None] * inv            # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _glu(x, w1, w3, w2, arith):
    h = _mm(x, w1, arith)
    return _mm(torch.nn.functional.silu(h) * _mm(x, w3, arith), w2, arith)


# --------------------------------------------------------------------- #
# the forward
# --------------------------------------------------------------------- #
def _attention(lay: dict, x: torch.Tensor, k: dict, theta: float,
               eps: float, arith: str) -> torch.Tensor:
    S = x.shape[0]
    H, nope, rope, dv, r = k["H"], k["nope"], k["rope"], k["dv"], k["r"]
    pos = torch.arange(S, device=x.device)
    q = _mm(x, lay["q_proj"], arith).view(S, H, nope + rope)
    kv = _mm(x, lay["kv_a_proj"], arith)
    c = _rms(kv[:, :r], lay["kv_norm"], eps)
    kvb = _mm(c, lay["kv_b_proj"], arith).view(S, H, nope + dv)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    q_pe = _rope(q[..., nope:], pos, theta)
    k_pe = _rope(kv[:, None, r:], pos, theta).expand(S, H, rope)
    qh = torch.cat([q[..., :nope], q_pe], -1).transpose(0, 1)   # (H, S, dq)
    kh = torch.cat([k_nope, k_pe], -1).transpose(0, 1)
    vh = v.transpose(0, 1)                                       # (H, S, dv)
    scale = (nope + rope) ** -0.5
    out = []
    for i in range(0, S, Q_BLOCK):
        s = _mm(qh[:, i:i + Q_BLOCK], kh.transpose(1, 2), arith) * scale
        n = s.shape[1]
        causal = pos[None, :] <= pos[i:i + n, None]
        w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out.append(_mm(w, vh, arith))                            # (H, n, dv)
    o = torch.cat(out, dim=1).transpose(0, 1).reshape(S, H * dv)
    return _mm(o, lay["o_proj"], arith)


def _moe(m: dict, x: torch.Tensor, k: dict, scaling: float, arith: str
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out (S, d), router gap (S,), chosen expert ids (S, K))."""
    K = k["K"]
    scores = torch.sigmoid(_mm(x, m["gate"], arith))
    vals, order = torch.sort(scores + m["gate_bias"], dim=-1,
                             descending=True, stable=True)
    ids = order[:, :K]
    w = torch.gather(scores, 1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scaling
    gap = vals[:, K - 1] - vals[:, K]
    sh = m["shared"]
    y = _glu(x, sh["w1"], sh["w3"], sh["w2"], arith)
    for e in range(k["held"]):
        sel = ids == k["lo"] + e                                  # (S, K)
        tok = torch.nonzero(sel.any(1))[:, 0]
        if tok.numel() == 0:
            continue
        we = (w * sel)[tok].sum(1)
        ye = _glu(x[tok], m["w1"][e], m["w3"][e], m["w2"][e], arith)
        y = y.index_add(0, tok, we[:, None] * ye)
    return y, gap, ids


def forward(config: dict, params: dict, tokens: torch.Tensor,
            rows: Optional[Sequence[int]] = None, *, arith: str = "exact"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sequence ``tokens`` (S,) → (logits (len(rows), V) at
    positions ``rows`` (all when None), router gaps (S, MoE layers),
    the chosen experts (S, MoE layers, K), each token's in ascending
    order)."""
    k = _dims(config)
    eps, theta = float(config["rms_norm_eps"]), float(config["rope_theta"])
    scaling = float(config["routed_scaling_factor"])
    with exact_f32():
        h = params["embed"][tokens]
        gaps: List[torch.Tensor] = []
        chosen: List[torch.Tensor] = []
        for lay in params["layers"]:
            h = h + _attention(lay, _rms(h, lay["input_norm"], eps), k,
                               theta, eps, arith)
            x = _rms(h, lay["post_norm"], eps)
            if "moe" in lay:
                y, gap, ids = _moe(lay["moe"], x, k, scaling, arith)
                gaps.append(gap)
                chosen.append(torch.sort(ids, dim=-1).values)
            else:
                m = lay["mlp"]
                y = _glu(x, m["w1"], m["w3"], m["w2"], arith)
            h = h + y
        if rows is not None:
            h = h[torch.as_tensor(list(rows), device=h.device)]
        logits = _mm(_rms(h, params["final_norm"], eps), params["lm_head"],
                     arith)
    S = tokens.shape[0]
    gap = torch.stack(gaps, 1) if gaps else \
        torch.full((S, 0), math.inf, device=h.device)
    ids = torch.stack(chosen, 1) if chosen else \
        torch.zeros((S, 0, k["K"]), dtype=torch.int64, device=h.device)
    return logits, gap, ids


def outputs(config: dict, params: dict, inputs: Dict, *, block: int = 0,
            arith: str = "exact") -> Dict:
    """``inputs``: request → (its tokens (n,), the positions whose
    logits are asked for). → (request, position) → {"y": the logits
    (V,), "gap": the row's router gap: the smallest of its own token's
    over the MoE layers and of each earlier token's over the MoE layers
    a later layer reads; "gaps" (position + 1, MoE layers) and "ids"
    (position + 1, MoE layers, K) int16: each of its tokens' gaps and
    chosen experts (ascending); "read": how many leading MoE layers a
    later layer reads}. ``block`` is the harness's row block; a
    sequence runs whole, its attention in blocks of ``Q_BLOCK``
    queries."""
    # the last layer's MoE output reaches no later layer
    read = int(config["num_hidden_layers"]) - int(
        config["first_k_dense_replace"]) - 1
    out = {}
    for req, (tokens, rows) in inputs.items():
        rows = sorted(int(p) for p in rows)
        logits, gap, ids = forward(config, params, tokens[:rows[-1] + 1],
                                   rows, arith=arith)
        ids = ids.to(torch.int16)
        inf = gap.new_full((gap.shape[0], 1), math.inf)
        own = torch.cat([gap, inf], 1).amin(1)
        seen = torch.cummin(torch.cat([gap[:, :read], inf], 1).amin(1),
                            0).values
        earlier = torch.cat([inf[:1, 0], seen[:-1]])
        row_gap = torch.minimum(own, earlier).tolist()
        for i, p in enumerate(rows):
            out[(req, p)] = {"y": logits[i], "gap": row_gap[p],
                             "gaps": gap[:p + 1], "ids": ids[:p + 1],
                             "read": read}
    return out
