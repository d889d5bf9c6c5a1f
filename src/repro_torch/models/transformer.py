"""The per-family block stacks: dense (also vlm and audio), MoE, the
zamba-style hybrid and xLSTM.

Port of ``repro.models.transformer``. Parameters are stacked along
leading axes, as the reference's scans stack them: (layers, ...) for
the dense and MoE stacks; (groups, per-group, ...) for the hybrid's
Mamba2 blocks, with its one shared attention block unstacked; (groups,
...) and (groups, mLSTMs a group, ...) for xLSTM. Python loops over the
layers and groups replace the scans. In train mode each block (each
group, in the hybrid and xLSTM stacks) is rematerialised as
``cfg.remat`` says, as the reference wraps its scan body in
``jax.checkpoint``:

  "full" — ``torch.utils.checkpoint.checkpoint`` (non-reentrant) around
           each block: only the block's input is kept, the rest is
           recomputed in the backward pass;
  "dots" — the same with a selective policy that keeps the outputs of
           the plain matrix products (``aten.mm``/``addmm``: the
           reference's ``dots_with_no_batch_dims_saveable``; batched
           products such as attention scores are recomputed);
  "none" — no checkpointing.

Stack API, as the reference's:

  init(generator, cfg, device)                   -> stacked params
  specs(cfg)          -> logical axis names per param (no stack axis)
  apply(p, cfg, h, positions, mode, cache)       -> (h, new_cache, aux)
  init_cache(cfg, batch, cache_len, dtype, device) -> cache
  cache_specs(cfg)    -> logical axis names per cache leaf
  cache_axes(cfg)     -> each cache leaf's (lane axis, ring axis or None)

The residual stream is annotated ``shard(h, "batch", "seq", None)`` at
the reference's block boundaries (``repro_torch.sharding``: nothing
without a mesh).

``cache_axes`` is what the serving engine's lane surgery
(``serving.kvcache``) reads: the attention rings' lane is axis 1 and
their positions axis 2; the Mamba2 and mLSTM states, stacked (groups,
per-group, B, ...), have their lane at axis 2 and no ring; the sLSTM
state's lane is axis 1.

``aux`` accumulates by summation over the layers, in every mode (the
reference's ``scan_stack``): the MoE stack starts it at zero
``aux_loss`` and ``drop_frac``, so ``drop_frac`` is a sum over layers,
not a share (reports divide it by the layer count); the dense stack's
is empty.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (mlp_apply, mlp_init, mlp_specs,
                                       pdtype, rms_norm)
from repro_torch.obs.core import NULL_RECORDER
from repro_torch.sharding import carry_rules, shard

# one generator per parameter leaf of a block, keyed by these codes; an
# MoE block's MLP leaves take the codes after them (``moe.MOE_LEAVES``)
_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")

# (lane axis, ring axis) of a stacked cache's leaves: an attention ring
# (layers or groups, B, T, ...); a state stacked (groups, per-group, B,
# ...) or (groups, B, ...), copied whole
RING_AXES = (1, 2)
STATE_AXES_2 = (2, None)
STATE_AXES_1 = (1, None)


def lead_specs(specs, n: int = 1):
    """Specs with ``n`` leading (stack) axes of None."""
    if isinstance(specs, dict):
        return {k: lead_specs(v, n) for k, v in specs.items()}
    return (None,) * n + specs


def layer_slice(tree, layer: int):
    """Layer ``layer`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, layer) for k, v in tree.items()}
    return tree[layer]


def _block_init(generator: Callable[[int], torch.Generator], cfg,
                device: torch.device, use_moe: bool = False) -> Dict:
    """``generator(i)``: the ``torch.Generator`` of leaf ``_LEAVES[i]``
    (of ``moe.MOE_LEAVES[i - len(_LEAVES)]`` for an MoE block's MLP)."""
    d = cfg.d_model
    dt = pdtype(cfg)
    p = {
        "attn": attn.attn_init([generator(i) for i in range(4)], cfg, dt,
                               device=device),
        "attn_norm": torch.ones((d,), dtype=dt, device=device),
        "mlp_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if use_moe:
        p["mlp"] = moe_mod.moe_init(
            [generator(len(_LEAVES) + j)
             for j in range(len(moe_mod.MOE_LEAVES))], cfg, dt,
            device=device)
    else:
        p["mlp"] = mlp_init([generator(i) for i in (4, 5, 6)], d, cfg.d_ff,
                            dt, device=device)
    if cfg.post_block_norm:
        p["attn_post"] = torch.ones((d,), dtype=dt, device=device)
        p["mlp_post"] = torch.ones((d,), dtype=dt, device=device)
    return p


def _block_specs(cfg, use_moe: bool):
    s = {
        "attn": attn.attn_specs(cfg),
        "attn_norm": (None,),
        "mlp_norm": (None,),
        "mlp": moe_mod.moe_specs(cfg) if use_moe else mlp_specs(),
    }
    if cfg.post_block_norm:
        s["attn_post"] = (None,)
        s["mlp_post"] = (None,)
    return s


def _block_apply(p, cfg, h, *, positions, mode, cache, window,
                 use_moe=False, project=None, mlp_fn=None):
    """project/mlp_fn: optional linear-projection overrides (see
    ``attention.attn_apply``); ``repro_torch.lm`` substitutes
    crossbar-mapped tile grids for the block's seven matmuls while
    norms, residuals, rope, softmax and cache surgery stay here."""
    a_in = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    a_out, new_cache = attn.attn_apply(p["attn"], cfg, a_in,
                                       positions=positions, mode=mode,
                                       cache=cache, window=window,
                                       project=project)
    if cfg.post_block_norm:
        a_out = rms_norm(a_out, p["attn_post"], cfg.norm_eps)
    h = shard(h + _seq_sharded(a_out), "batch", "seq", None)

    m_in = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    aux = {}
    if use_moe:
        m_out, aux = moe_mod.moe_apply(p["mlp"], cfg, m_in)
    elif mlp_fn is not None:
        m_out = mlp_fn(p["mlp"], m_in)
    else:
        m_out = mlp_apply(p["mlp"], m_in, cfg.act, m_in.dtype)
    if cfg.post_block_norm:
        m_out = rms_norm(m_out, p["mlp_post"], cfg.norm_eps)
    return (shard(h + _seq_sharded(m_out), "batch", "seq", None),
            new_cache, aux)


def _seq_sharded(out):
    """A sublayer's output on the residual stream's layout, before the
    residual sum: under sequence parallelism its partial sums are
    reduce-scattered onto the sequence shards here, as an explicit
    constraint, so that its gradient comes back gathered whole into
    the sublayer's products (a sum's implicit redistribution would hand
    them a sequence-split gradient, which DTensor lays out only as a
    strided shard). No-op without a mesh."""
    return shard(out, "batch", "seq", None)


def _save_plain_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep plain (unbatched) matmul outputs."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg, mode: str) -> Callable:
    """``fn(h) -> out`` rematerialised per ``cfg.remat`` in train mode.
    The recomputation sees the rule table of the forward
    (``sharding.carry_rules``): on the card it runs on the autograd
    engine's thread."""
    if mode != "train" or cfg.remat == "none":
        return fn
    fn = carry_rules(fn)
    if cfg.remat == "dots":
        contexts = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _save_plain_matmuls)
        return lambda h: ckpt.checkpoint(fn, h, use_reentrant=False,
                                         context_fn=contexts)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return lambda h: ckpt.checkpoint(fn, h, use_reentrant=False)


def _layer_windows(cfg) -> torch.Tensor:
    """Per-layer sliding window (0 = full), an int32 tensor on the CPU
    (its 0-d entries are what the blocks get: see ``attn_apply``).
    gemma2: even layers local."""
    if cfg.local_global:
        w = [cfg.sliding_window if i % 2 == 0 else 0
             for i in range(cfg.num_layers)]
    elif cfg.sliding_window and cfg.family not in ("hybrid",):
        w = [cfg.sliding_window] * cfg.num_layers
    else:
        w = [0] * cfg.num_layers
    return torch.tensor(w, dtype=torch.int32)


def stack_caches(caches):
    """Per-layer cache dicts → one cache stacked on a leading layer axis
    (None when the mode builds no cache)."""
    if not caches or caches[0] is None:
        return None
    return _stack_trees(caches)


class DenseStack:
    use_moe = False

    @classmethod
    def init(cls, generator: Callable[..., torch.Generator], cfg,
             device: torch.device) -> Dict:
        """``generator(layer, leaf)`` → that leaf's ``torch.Generator``."""
        layers = [_block_init(lambda i, _l=layer: generator(_l, i), cfg,
                              device, cls.use_moe)
                  for layer in range(cfg.num_layers)]
        return _stack_trees(layers)

    @classmethod
    def specs(cls, cfg):
        return _block_specs(cfg, cls.use_moe)

    @classmethod
    def apply(cls, p, cfg, h, *, positions, mode,
              cache: Optional[Dict] = None):
        windows = _layer_windows(cfg)
        aux = {"aux_loss": torch.zeros((), device=h.device),
               "drop_frac": torch.zeros((), device=h.device)} \
            if cls.use_moe else {}
        caches = []
        for layer in range(cfg.num_layers):
            def block(h, p_l=layer_slice(p, layer), w=windows[layer],
                      c_l=None if cache is None else
                      layer_slice(cache, layer)):
                return _block_apply(p_l, cfg, h, positions=positions,
                                    mode=mode, cache=c_l, window=w,
                                    use_moe=cls.use_moe)
            if mode == "train":
                h, a = _remat(lambda h, f=block: _drop_cache(f(h)), cfg,
                              mode)(h)
            else:
                h, c_new, a = block(h)
                caches.append(c_new)
            aux = {k: v + a[k] for k, v in aux.items()}
        return h, stack_caches(caches), aux

    @classmethod
    def init_cache(cls, cfg, batch: int, cache_len: int,
                   dtype: torch.dtype, device: torch.device) -> Dict:
        one = attn.init_attn_cache(cfg, batch, cache_len, dtype, device)
        return _zeros_stacked(one, cfg.num_layers)

    @classmethod
    def cache_specs(cls, cfg):
        return lead_specs(attn.attn_cache_specs(cfg))

    @classmethod
    def cache_axes(cls, cfg):
        return RING_AXES


class MoEStack(DenseStack):
    use_moe = True


# ===================================================================== #
# DeepSeek-V3 style: leading dense layers, then MoE; MLA throughout
# ===================================================================== #
def ffn_projector(p: Dict):
    """The plain ``project(name, x)`` of a dense GLU FFN: "w13" (w1 and
    w3 side by side), "w2"."""
    def project(name: str, x: torch.Tensor) -> torch.Tensor:
        w = torch.cat([p["w1"], p["w3"]], dim=1) if name == "w13" \
            else p["w2"]
        return torch.matmul(x, w.to(x.dtype))
    return project


class LatentMoEStack:
    """``cfg.first_k_dense`` dense layers (FFN ``cfg.dense_d_ff``), then
    MoE layers of sigmoid-routed held experts
    (``moe.held_moe_apply``); every layer's attention is MLA
    (``attention.mla_apply``). Params ``{"dense": (first_k_dense, ...),
    "moe": (num_layers − first_k_dense, ...)}`` (a kind with no layer
    has no key); cache ``{"ckv": (layers, B, T, r + rope)}``.

    ``apply``'s ``hooks(layer) -> (project, ffn)`` hands a layer's
    attention products and its FFN or MoE products to another backend
    (``repro_torch.lm`` maps them onto tile grids); None: plain
    products. A decode writes the latent cache in place and returns
    it. ``routes``, a list, gets each MoE layer's chosen expert ids
    (B·S, K) appended, in layer order."""

    @staticmethod
    def check(cfg) -> None:
        if cfg.attention != "mla" or cfg.router != "sigmoid_bias":
            raise NotImplementedError(
                "the latent MoE stack runs MLA with sigmoid-routed experts")
        if not 0 <= cfg.first_k_dense <= cfg.num_layers:
            raise ValueError(f"first_k_dense {cfg.first_k_dense} of "
                             f"{cfg.num_layers} layers")

    @staticmethod
    def layer(p: Dict, cfg, layer: int):
        """(layer ``layer``'s params, whether it is an MoE layer)."""
        nd = cfg.first_k_dense
        if layer < nd:
            return layer_slice(p["dense"], layer), False
        return layer_slice(p["moe"], layer - nd), True

    @classmethod
    def init(cls, generator: Callable[..., torch.Generator], cfg,
             device: torch.device) -> Dict:
        """``generator(layer, leaf)``, leaves as ``_block_init``'s."""
        cls.check(cfg)
        d, dt = cfg.d_model, pdtype(cfg)

        def block(layer: int, moe: bool) -> Dict:
            def gen(i):
                return generator(layer, i)
            p = {"attn": attn.mla_init([gen(i) for i in range(4)], cfg, dt,
                                       device=device),
                 "attn_norm": torch.ones((d,), dtype=dt, device=device),
                 "mlp_norm": torch.ones((d,), dtype=dt, device=device)}
            if moe:
                p["mlp"] = moe_mod.moe_init(
                    [gen(len(_LEAVES) + j)
                     for j in range(len(moe_mod.MOE_LEAVES))], cfg, dt,
                    device=device)
            else:
                p["mlp"] = mlp_init([gen(i) for i in (4, 5, 6)], d,
                                    cfg.dense_d_ff, dt, device=device)
            return p

        nd, L = cfg.first_k_dense, cfg.num_layers
        out = {}
        if nd:
            out["dense"] = _stack_trees([block(i, False) for i in range(nd)])
        if L > nd:
            out["moe"] = _stack_trees([block(i, True) for i in range(nd, L)])
        return out

    @classmethod
    def specs(cls, cfg):
        def block(moe):
            return {"attn": attn.mla_specs(cfg), "attn_norm": (None,),
                    "mlp_norm": (None,),
                    "mlp": moe_mod.moe_specs(cfg) if moe else mlp_specs()}
        out = {}
        if cfg.first_k_dense:
            out["dense"] = block(False)
        if cfg.num_layers > cfg.first_k_dense:
            out["moe"] = block(True)
        return out

    @classmethod
    def apply(cls, p, cfg, h, *, positions, mode,
              cache: Optional[Dict] = None, hooks=None,
              kv_len: Optional[int] = None, rec=NULL_RECORDER,
              routes=None):
        if mode == "train":
            raise NotImplementedError("the latent MoE stack serves; it "
                                      "does not train")
        caches = []
        for layer in range(cfg.num_layers):
            p_l, moe = cls.layer(p, cfg, layer)
            project, ffn = hooks(layer) if hooks is not None else \
                (None, None)
            a_in = rms_norm(h, p_l["attn_norm"], cfg.norm_eps)
            a_out, c_new = attn.mla_apply(
                p_l["attn"], cfg, a_in, positions=positions, mode=mode,
                cache=None if cache is None else layer_slice(cache, layer),
                kv_len=kv_len, project=project, rec=rec)
            h = h + a_out
            m_in = rms_norm(h, p_l["mlp_norm"], cfg.norm_eps)
            if moe:
                m_out = moe_mod.held_moe_apply(p_l["mlp"], cfg, m_in,
                                               project=ffn, rec=rec,
                                               routes=routes)
            else:
                m_out = moe_mod.glu(ffn or ffn_projector(p_l["mlp"]), cfg,
                                    "w13", m_in, "w2")
            h = h + m_out
            caches.append(c_new)
        if mode == "decode":
            return h, cache, {}
        return h, stack_caches(caches), {}

    @classmethod
    def init_cache(cls, cfg, batch: int, cache_len: int,
                   dtype: torch.dtype, device: torch.device) -> Dict:
        return {"ckv": torch.zeros(
            (cfg.num_layers, batch, cache_len, attn.mla_cache_width(cfg)),
            dtype=dtype, device=device)}

    @classmethod
    def cache_specs(cls, cfg):
        return lead_specs(attn.mla_cache_specs(cfg))

    @classmethod
    def cache_axes(cls, cfg):
        return RING_AXES


# ===================================================================== #
# zamba-style hybrid: groups of Mamba2 blocks + one shared attention block
# ===================================================================== #
class HybridStack:
    """cfg.num_layers Mamba2 blocks; after every ``shared_attn_every`` of
    them one application of a single *shared* transformer block, whose
    attention sees ``cfg.sliding_window`` positions (its cache holds
    ``min(cache_len, window)``)."""

    @staticmethod
    def _group_geometry(cfg):
        per = cfg.shared_attn_every
        if per <= 0 or cfg.num_layers % per:
            raise ValueError(f"hybrid: {cfg.num_layers} layers do not tile "
                             f"into groups of {per}")
        return cfg.num_layers // per, per

    @classmethod
    def init(cls, generator: Callable[..., torch.Generator], cfg,
             device: torch.device) -> Dict:
        """``generator(layer, leaf)``: Mamba2 block ``layer`` (0 ..
        num_layers - 1) draws ``ssm.MAMBA_LEAVES``; the shared block is
        layer ``num_layers``."""
        G, per = cls._group_geometry(cfg)
        d = cfg.d_model
        groups = [{
            "mamba": _stack_trees([
                ssm_mod.mamba_init(lambda i, _l=g * per + j: generator(_l, i),
                                   cfg, device=device)
                for j in range(per)]),
            "mamba_norm": torch.ones((per, d), dtype=pdtype(cfg),
                                     device=device)} for g in range(G)]
        return {"groups": _stack_trees(groups),
                "shared": _block_init(lambda i: generator(cfg.num_layers, i),
                                      cfg, device)}

    @classmethod
    def specs(cls, cfg):
        return {"groups": {"mamba": lead_specs(ssm_mod.mamba_specs(cfg)),
                           "mamba_norm": (None, None)},
                "shared": _block_specs(cfg, use_moe=False)}

    @classmethod
    def apply(cls, p, cfg, h, *, positions, mode,
              cache: Optional[Dict] = None):
        G, per = cls._group_geometry(cfg)
        window = cfg.sliding_window if cfg.sliding_window else None

        def group(h, p_g, c_g):
            mamba = []
            for i in range(per):
                m_in = rms_norm(h, p_g["mamba_norm"][i], cfg.norm_eps)
                out, c_m = ssm_mod.mamba_apply(
                    layer_slice(p_g["mamba"], i), cfg, m_in, mode=mode,
                    cache=None if c_g is None else
                    layer_slice(c_g["mamba"], i))
                h = h + _seq_sharded(out)
                mamba.append(c_m)
            h = shard(h, "batch", "seq", None)
            h, c_a, _ = _block_apply(
                p["shared"], cfg, h, positions=positions, mode=mode,
                cache=None if c_g is None else c_g["attn"], window=window)
            return h, {"mamba": stack_caches(mamba), "attn": c_a}

        return _apply_groups(group, cfg, mode, h, p["groups"], cache, G)

    @classmethod
    def init_cache(cls, cfg, batch: int, cache_len: int,
                   dtype: torch.dtype, device: torch.device) -> Dict:
        G, per = cls._group_geometry(cfg)
        attn_len = min(cache_len, cfg.sliding_window) \
            if cfg.sliding_window else cache_len
        mamba = ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
        one = attn.init_attn_cache(cfg, batch, attn_len, dtype, device)
        return {"mamba": _zeros_stacked(mamba, G, per),
                "attn": _zeros_stacked(one, G)}

    @classmethod
    def cache_specs(cls, cfg):
        return {"mamba": lead_specs(ssm_mod.mamba_cache_specs(cfg), 2),
                "attn": lead_specs(attn.attn_cache_specs(cfg))}

    @classmethod
    def cache_axes(cls, cfg):
        return {"mamba": STATE_AXES_2, "attn": RING_AXES}


# ===================================================================== #
# xLSTM: groups of (slstm_period - 1) mLSTM blocks + 1 sLSTM block
# ===================================================================== #
class XLSTMStack:
    @staticmethod
    def _group_geometry(cfg):
        per = cfg.slstm_period
        if per <= 0 or cfg.num_layers % per:
            raise ValueError(f"xlstm: {cfg.num_layers} layers do not tile "
                             f"into groups of {per}")
        return cfg.num_layers // per, per - 1

    @classmethod
    def init(cls, generator: Callable[..., torch.Generator], cfg,
             device: torch.device) -> Dict:
        """``generator(layer, leaf)``: group g's mLSTM j is layer
        g·period + j (``xlstm.MLSTM_LEAVES``), its sLSTM layer g·period
        + period - 1 (``xlstm.SLSTM_LEAVES``)."""
        G, n_m = cls._group_geometry(cfg)
        per = n_m + 1
        groups = [{
            "mlstm": _stack_trees([
                xlstm_mod.mlstm_init(
                    lambda i, _l=g * per + j: generator(_l, i), cfg,
                    device=device) for j in range(n_m)]),
            "slstm": xlstm_mod.slstm_init(
                lambda i, _l=g * per + n_m: generator(_l, i), cfg,
                device=device)} for g in range(G)]
        return {"groups": _stack_trees(groups)}

    @classmethod
    def specs(cls, cfg):
        return {"groups": {"mlstm": lead_specs(xlstm_mod.mlstm_specs(cfg)),
                           "slstm": xlstm_mod.slstm_specs(cfg)}}

    @classmethod
    def apply(cls, p, cfg, h, *, positions, mode,
              cache: Optional[Dict] = None):
        G, n_m = cls._group_geometry(cfg)

        def group(h, p_g, c_g):
            mlstm = []
            for i in range(n_m):
                out, c_m = xlstm_mod.mlstm_apply(
                    layer_slice(p_g["mlstm"], i), cfg, h, mode=mode,
                    cache=None if c_g is None else
                    layer_slice(c_g["mlstm"], i))
                h = h + _seq_sharded(out)
                mlstm.append(c_m)
            h, c_s = xlstm_mod.slstm_apply(
                p_g["slstm"], cfg, h, mode=mode,
                cache=None if c_g is None else c_g["slstm"])
            h = shard(h, "batch", "seq", None)
            return h, {"mlstm": stack_caches(mlstm), "slstm": c_s}

        return _apply_groups(group, cfg, mode, h, p["groups"], cache, G)

    @classmethod
    def init_cache(cls, cfg, batch: int, cache_len: int,
                   dtype: torch.dtype, device: torch.device) -> Dict:
        G, n_m = cls._group_geometry(cfg)
        mlstm = xlstm_mod.init_mlstm_cache(cfg, batch, dtype, device)
        slstm = xlstm_mod.init_slstm_cache(cfg, batch, device)
        return {"mlstm": _zeros_stacked(mlstm, G, n_m),
                "slstm": _zeros_stacked(slstm, G)}

    @classmethod
    def cache_specs(cls, cfg):
        return {"mlstm": lead_specs(xlstm_mod.mlstm_cache_specs(cfg), 2),
                "slstm": lead_specs(xlstm_mod.slstm_cache_specs(cfg))}

    @classmethod
    def cache_axes(cls, cfg):
        return {"mlstm": STATE_AXES_2, "slstm": STATE_AXES_1}


def _apply_groups(group, cfg, mode, h, groups, cache, G):
    """The hybrid and xLSTM stacks' loop over their G groups (the
    reference's ``scan_stack``): ``group(h, p_g, c_g) -> (h, cache_g)``,
    rematerialised as a whole in train mode, where it keeps no cache.
    Returns (h, the stacked caches or None, no aux)."""
    caches = []
    for g in range(G):
        p_g = layer_slice(groups, g)
        if mode == "train":
            h = _remat(lambda h, p_g=p_g: group(h, p_g, None)[0], cfg,
                       mode)(h)
        else:
            h, c_g = group(h, p_g, None if cache is None else
                           layer_slice(cache, g))
            caches.append(c_g)
    return h, stack_caches(caches), {}


def _zeros_stacked(one: Dict, *lead: int) -> Dict:
    """Zeros of each leaf's dtype, with ``lead`` axes in front (as the
    reference's ``init_cache`` stacks: zeros, whatever the leaf's own
    initial value)."""
    return {k: torch.zeros(tuple(lead) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in one.items()}


def _drop_cache(out):
    """A train-mode block's (h, cache, aux) without the (absent) cache."""
    h, _, aux = out
    return h, aux


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def get_stack(cfg):
    if cfg.family in ("dense", "vlm", "audio"):
        return DenseStack
    if cfg.family == "moe":
        return LatentMoEStack if cfg.attention == "mla" else MoEStack
    if cfg.family == "hybrid":
        return HybridStack
    if cfg.family == "ssm":
        return XLSTMStack
    raise ValueError(f"unknown family {cfg.family!r}")
