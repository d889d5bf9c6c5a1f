"""Top-k token-choice MoE with sort-based capacity dispatch.

Port of ``repro.models.moe``. The usual one-hot dispatch einsum
(GShard) materializes a (tokens × experts × capacity) tensor; instead
the (token, choice) assignments are sorted by expert id and each
expert's first C tokens are gathered into a dense (E, C, d) block, so
compute scales with the active FLOPs (tokens · top_k · d · f). Overflow
assignments are dropped in token order (capacity-factor semantics) and
counted in the aux metrics.

The reference's semantics, kept exactly:
  * the router's softmax over all experts in f32 (the logits
    accumulate in f32 whatever the compute dtype);
  * top-k, then the k gates renormalised to sum to one;
  * the Switch load-balance loss on the top-1 choice,
    E · Σ_e mean_prob_e · frac_tokens_e;
  * a STABLE argsort of the flattened (token, choice) expert ids, so
    an expert's slots fill in token order;
  * capacity ``max(8, round_up(int(round(T·k/E·cf)), 8))`` with
    Python's ``round`` (half to even);
  * the segment-sum combine (an ``index_add`` into T + 1 rows, the
    last taking the dropped slots);
  * the shared experts added outside the routing;
  * the grouped path (GShard's G axis) taken only when
    ``moe_groups > 1`` and the token count divides by it.

Top-k is a stable descending sort cut to k: on tied probabilities it
keeps the lower expert index first, as ``jax.lax.top_k`` does
(``torch.topk`` does not promise an order on ties).

The reference's ``shard(...)`` constraints stand at its places
(``repro_torch.sharding``: nothing without a mesh) and ``moe_specs``
gives the parameters' logical axes. Under a mesh the experts' blocks
are DTensors, ``exp`` on ``model`` (expert parallelism), but DTensor
has no sharding rule for the sort dispatch (``searchsorted``, the
index gathers, ``index_add``), so that part runs on plain tensors:

  * the token path routes all T tokens on every rank (its capacity and
    its drops are global): the tokens are gathered whole
    (``sharding.unshard``), routed and dispatched alike on every rank,
    the (E, C, d) block is split to ``("exp", "cap", None)`` for the
    experts, and gathered whole again for the combine;
  * the grouped path routes each rank's own groups, which follow
    ``batch`` (``sharding.local_part``): nothing crosses ranks but the
    experts' blocks and the aux scalars' means.

The aux scalars come back as DTensors under a mesh, so that their
gradient reaches the router through the DTensor graph.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.layers import act_fn, dense_init, embed_init
from repro_torch.obs.core import NULL_RECORDER
from repro_torch.obs.core import current as _obs_current
from repro_torch.sharding import (current_mesh, from_local_part, gather_seq,
                                  local_part, reshape, shard, unshard)

# the generator order of ``moe_init``'s leaves
MOE_LEAVES = ("router", "w1", "w3", "w2", "shared_w1", "shared_w3",
              "shared_w2", "router_bias")
# std of the seeded sigmoid router's correction bias (a trained model's
# is learnt; its values move the choice, not the arithmetic)
ROUTER_BIAS_STD = 0.05


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_init(generators: Sequence[torch.Generator], cfg,
             dtype: torch.dtype, *, device: torch.device) -> Dict:
    """``generators``: one ``torch.Generator`` a leaf, in the order of
    ``MOE_LEAVES`` (the shared ones are used when the config has shared
    experts). Layouts as the reference's: router (d, E), w1/w3
    (E, d, f), w2 (E, f, d), shared w1/w3 (d, f·n_shared), w2
    (f·n_shared, d)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    El = cfg.local_experts
    g = dict(zip(MOE_LEAVES, generators))
    p = {
        "router": dense_init(g["router"], (d, E), dtype, fan_in=d,
                             device=device),
        "w1": dense_init(g["w1"], (El, d, f), dtype, fan_in=d,
                         device=device),
        "w3": dense_init(g["w3"], (El, d, f), dtype, fan_in=d,
                         device=device),
        "w2": dense_init(g["w2"], (El, f, d), dtype, fan_in=f,
                         device=device),
    }
    if cfg.router == "sigmoid_bias":
        p["router_bias"] = embed_init(g["router_bias"], (E,), dtype,
                                      device=device) * ROUTER_BIAS_STD
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w1": dense_init(g["shared_w1"], (d, fs), dtype, device=device),
            "w3": dense_init(g["shared_w3"], (d, fs), dtype, device=device),
            "w2": dense_init(g["shared_w2"], (fs, d), dtype, fan_in=fs,
                             device=device),
        }
    return p


def moe_specs(cfg) -> Dict:
    s = {
        "router": ("embed", None),
        "w1": ("exp", "embed", None),
        "w3": ("exp", "embed", None),
        "w2": ("exp", None, "embed"),
    }
    if cfg.num_shared_experts:
        s["shared"] = {"w1": ("embed", "ff"), "w3": ("embed", "ff"),
                       "w2": ("ff", "embed")}
    if cfg.router == "sigmoid_bias":
        s["router_bias"] = (None,)
    return s


def capacity(tokens: int, cfg) -> int:
    c = int(round(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor))
    return max(8, _round_up(c, 8))


# --------------------------------------------------------------------- #
# routing and dispatch (the steps the token and grouped paths share)
# --------------------------------------------------------------------- #
def route(p: Dict, cfg, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., T, d) → (probs (..., T, E) f32, renormalised gates
    (..., T, K) f32, expert ids (..., T, K) int64, best first)."""
    f32 = torch.float32
    logits = torch.matmul(x.to(f32), p["router"].to(x.dtype).to(f32))
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[..., :cfg.top_k], ids[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def dispatch(expert_ids: torch.Tensor, E: int, C: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., T, K) expert ids → (flat slot ids (..., E, C) into the
    flattened T·K assignments, valid (..., E, C)): each expert's first
    C assignments in token order. Invalid slots point at assignment 0."""
    lead = expert_ids.shape[:-2]
    flat_e = expert_ids.reshape(*lead, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order).contiguous()
    ar = torch.arange(E, dtype=sorted_e.dtype, device=sorted_e.device)
    ar = ar.expand(*lead, E).contiguous()
    starts = torch.searchsorted(sorted_e, ar, side="left")
    counts = torch.searchsorted(sorted_e, ar, side="right") - starts
    cs = torch.arange(C, dtype=starts.dtype, device=starts.device)
    valid = cs < counts[..., None]                            # (..., E, C)
    slot = torch.where(valid, starts[..., None] + cs, 0)
    flat_slot = torch.gather(order, -1, slot.reshape(*lead, E * C))
    return flat_slot.reshape(*lead, E, C), valid


def _experts(p: Dict, cfg, x_e: torch.Tensor, names) -> torch.Tensor:
    """(..., E, C, d) gathered tokens through each expert's GLU MLP;
    ``names``: the logical axes of the (..., E, C, ·) blocks."""
    dt = x_e.dtype
    x_e = shard(x_e, *names)
    h = torch.matmul(x_e, p["w1"].to(dt))
    g = torch.matmul(x_e, p["w3"].to(dt))
    h = shard(act_fn(cfg.act)(h) * g, *names)
    return torch.matmul(h, p["w2"].to(dt))


def moe_apply(p: Dict, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux). Aux carries the load-balance loss
    (``aux_loss``) and the share of dropped assignments
    (``drop_frac``), f32 scalars.

    With ``cfg.moe_groups = G > 1`` (and B·S divisible by G) the
    tokens are split into G local-dispatch groups: routing, capacity
    and combine stay inside a group."""
    x = gather_seq(x)  # the sequence whole inside the block (SP)
    dt = x.dtype
    B, S, d = x.shape
    G = max(cfg.moe_groups, 1)
    T = B * S
    if G > 1 and T % G == 0:
        y, aux = _moe_grouped(p, cfg, reshape(x, G, T // G, d))
    else:
        y, aux = _moe_tokens(p, cfg, reshape(x, T, d))
    y = shard(reshape(y, B, S, d), "batch", "seq", None)

    if cfg.num_shared_experts:
        sh = p["shared"]
        hs = act_fn(cfg.act)(torch.matmul(x, sh["w1"].to(dt)))
        hs = hs * torch.matmul(x, sh["w3"].to(dt))
        hs = shard(hs, "batch", None, "ff")
        # onto the sequence shards before the sum, as ``y``: the
        # gradient then comes back whole into the product
        y = y + shard(torch.matmul(hs, sh["w2"].to(dt)), "batch", "seq",
                      None)
    return y, aux


def _moe_tokens(p: Dict, cfg, xt: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Route one token group. xt: (T, d) -> (y (T, d), aux)."""
    dt = xt.dtype
    T, d = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(T, cfg)
    # under a mesh: every rank routes every token (a no-op without one)
    xt = unshard(xt)
    router = unshard(p["router"])

    probs, gate_vals, expert_ids = route({"router": router}, cfg, xt)
    # load-balance aux (Switch): E * mean(frac_tokens_e * mean_prob_e)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(expert_ids[:, 0], E).to(
        torch.float32).mean(dim=0)
    aux_loss = E * torch.sum(me * ce)

    flat_slot, valid = dispatch(expert_ids, E, C)             # (E, C)
    token_ids = flat_slot // K
    choice = flat_slot % K
    gates_ec = gate_vals[token_ids.reshape(-1), choice.reshape(-1)]
    gates_ec = (gates_ec.reshape(E, C) * valid).to(torch.float32)

    x_e = xt[token_ids.reshape(-1)].reshape(E, C, d)
    names = ("exp", "cap", None)
    y_e = _experts(p, cfg, x_e, names) * shard(gates_ec[..., None].to(dt),
                                                *names)
    y_e = unshard(shard(y_e, *names))

    # combine: invalid slots land in row T, which is dropped
    seg = torch.where(valid, token_ids, T).reshape(-1)
    y = torch.zeros((T + 1, d), dtype=torch.float32, device=xt.device)
    y = y.index_add(0, seg, y_e.reshape(E * C, d).to(torch.float32))
    y = y[:T].to(dt)

    dropped = 1.0 - valid.sum() / max(T * K, 1)
    return y, {"aux_loss": shard(aux_loss),
               "drop_frac": shard(dropped.to(torch.float32))}


def _moe_grouped(p: Dict, cfg, xg: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Local-dispatch MoE with an explicit group axis. xg: (G, Tg, d).
    Routing, capacity gather and combine are per group; the combine
    sums in the compute dtype, as the reference's does."""
    dt = xg.dtype
    Tg, d = xg.shape[1:]
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(Tg, cfg)
    # this rank's groups, as plain tensors (all of them without a mesh)
    xg = local_part(xg, "batch", None, None)
    G = xg.shape[0]

    router = unshard(p["router"], rows=("batch",))
    probs, gate_vals, expert_ids = route({"router": router}, cfg,
                                         xg)                  # (G, Tg, ·)
    me = probs.mean(dim=1)                                    # (G, E)
    ce = torch.nn.functional.one_hot(expert_ids[:, :, 0], E).to(
        torch.float32).mean(dim=1)
    aux_loss = E * from_local_part(torch.sum(me * ce, dim=-1),
                                   "batch").mean()

    flat_slot, valid = dispatch(expert_ids, E, C)             # (G, E, C)
    token_ids = flat_slot // K
    choice = flat_slot % K
    g_idx = torch.arange(G, device=xg.device)[:, None]
    gates_ec = gate_vals[g_idx, token_ids.reshape(G, -1),
                         choice.reshape(G, -1)].reshape(G, E, C) * valid

    x_e = xg[g_idx, token_ids.reshape(G, -1)].reshape(G, E, C, d)
    blocks = ("batch", None, None, None)
    names = ("batch", "exp", None, None)
    y_e = _experts(p, cfg, from_local_part(x_e, *blocks), names) * \
        shard(from_local_part(gates_ec[..., None].to(dt), *blocks), *names)
    y_e = local_part(shard(y_e, *names), *blocks)

    seg = torch.where(valid, token_ids, Tg) + \
        (Tg + 1) * torch.arange(G, device=xg.device)[:, None, None]
    y = torch.zeros((G * (Tg + 1), d), dtype=dt, device=xg.device)
    y = y.index_add(0, seg.reshape(-1), y_e.reshape(G * E * C, d))
    y = from_local_part(y.reshape(G, Tg + 1, d)[:, :Tg], "batch", None, None)

    n_valid = from_local_part(valid.reshape(G, -1).sum(-1), "batch").sum()
    G_all = G if current_mesh() is None else y.shape[0]
    dropped = 1.0 - n_valid / max(G_all * Tg * K, 1)
    return y, {"aux_loss": aux_loss, "drop_frac": dropped.to(torch.float32)}


# --------------------------------------------------------------------- #
# sigmoid-plus-bias routing over a held share of the experts
# --------------------------------------------------------------------- #
def route_sigmoid(logits: torch.Tensor, bias: torch.Tensor, cfg
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's noaux_tc selection (one group) from the router's
    logits (..., E) f32: scores σ(logit); the top ``cfg.top_k`` of
    score + ``bias`` (a stable descending sort: on ties the lower
    expert index first); the weights are the chosen *scores*, without
    the bias, over their sum + 1e-20, times ``cfg.routed_scaling``.
    Returns (weights (..., K) f32, expert ids (..., K) int64, best
    first, and the router gap (...): the K-th choice value less the
    (K+1)-th, where a rounding can swap the last expert in)."""
    f32 = torch.float32
    K = cfg.top_k
    scores = torch.sigmoid(logits.to(f32))
    vals, order = torch.sort(scores + bias.to(f32), dim=-1,
                             descending=True, stable=True)
    ids = order[..., :K]
    w = torch.gather(scores, -1, ids)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling
    gap = vals[..., K - 1] - vals[..., K] if vals.shape[-1] > K else \
        torch.full(vals.shape[:-1], float("inf"), device=vals.device)
    return w, ids, gap


def held_projector(p: Dict, cfg):
    """The plain ``project(name, x)`` of a held-expert MoE layer:
    "router" (d → E, f32), "shared_w13" / "shared_w2" (the shared
    experts' GLU: w1 and w3 side by side, then w2), "w13.e" / "w2.e"
    (held expert e, 0-based among the held)."""
    def project(name: str, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if name == "router":
            return torch.matmul(x.to(torch.float32),
                                p["router"].to(torch.float32))
        if name.startswith("shared_"):
            sh = p["shared"]
            w = torch.cat([sh["w1"], sh["w3"]], dim=1) \
                if name == "shared_w13" else sh["w2"]
        else:
            kind, e = name.split(".")
            e = int(e)
            w = torch.cat([p["w1"][e], p["w3"][e]], dim=1) \
                if kind == "w13" else p["w2"][e]
        return torch.matmul(x, w.to(dt))
    return project


def glu(project, cfg, name: str, x: torch.Tensor, w2: str) -> torch.Tensor:
    """A GLU through ``project``: ``name`` gives w1's and w3's outputs
    side by side, ``w2`` the down product of act(h1) · h3."""
    h1, h3 = project(name, x).chunk(2, dim=-1)
    return project(w2, act_fn(cfg.act)(h1) * h3)


def held_moe_apply(p: Dict, cfg, x: torch.Tensor, *, project=None,
                   rec=NULL_RECORDER, routes=None) -> torch.Tensor:
    """One expert-parallel rank's MoE layer (drop-free): every token is
    routed over all ``cfg.num_experts`` (:func:`route_sigmoid`); this
    rank holds experts lo … lo + held − 1 (``cfg.expert_rank``,
    ``cfg.local_experts``) and adds, for the tokens routed to them,
    their weighted outputs to the shared experts' (which every rank
    computes alike). What the other ranks' experts would add is theirs.

    The step's (token, choice) pairs are grouped by held expert (a
    stable sort), each expert runs once on its own rows, and the
    weighted results are scatter-added. The group sizes come to the
    host (one synchronise a layer): each expert's products take their
    rows as a shape. ``project(name, x)``: :func:`held_projector` when
    None; ``repro_torch.lm`` puts every product on tile grids. ``rec``
    brackets ``lm.route`` (router, selection, grouping), ``lm.shared``
    and ``lm.experts`` (the held experts' products, weighting and
    scatter); the counter ``lm.expert_assignments`` adds the pairs the
    held experts computed, on the card. ``routes``, a list, gets the
    step's chosen expert ids (B·S, K) int16 appended. x (B, S, d) →
    (B, S, d)."""
    B, S, d = x.shape
    T, K = B * S, cfg.top_k
    El = cfg.local_experts
    lo = cfg.expert_rank * El
    if project is None:
        project = held_projector(p, cfg)
    xt = x.reshape(T, d)
    with rec.span("lm.route"):
        w, ids, _ = route_sigmoid(project("router", xt), p["router_bias"],
                                  cfg)
        if routes is not None:
            routes.append(ids.to(torch.int16))
        local = ids - lo
        local = torch.where((local >= 0) & (local < El), local,
                            El).reshape(-1)
        order = torch.argsort(local, stable=True)
        counts = torch.bincount(local, minlength=El + 1)[:El]
        rows = order // K
        weights = w.reshape(-1)[order]
        sizes = counts.tolist()
    tel = _obs_current()
    if tel.active:
        tel.metrics.counter("lm.expert_assignments").inc(counts.sum())
    if cfg.num_shared_experts:
        with rec.span("lm.shared"):
            y = glu(project, cfg, "shared_w13", xt, "shared_w2")
    else:
        y = torch.zeros_like(xt)
    with rec.span("lm.experts"):
        start = 0
        for e, n in enumerate(sizes):
            if not n:
                continue
            tok = rows[start:start + n]
            ye = glu(project, cfg, f"w13.{e}", xt.index_select(0, tok),
                      f"w2.{e}")
            y.index_add_(0, tok, ye * weights[start:start + n, None]
                         .to(ye.dtype))
            start += n
    return y.reshape(B, S, d)
