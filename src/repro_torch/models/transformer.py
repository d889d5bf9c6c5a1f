"""The dense and MoE transformer block stacks.

Port of the dense/vlm/audio and moe stacks of
``repro.models.transformer``. Parameters are
stacked along a leading layer axis, as the reference's scan stacks
them; a Python loop over the layers replaces the scan. In train mode
each block is rematerialised as ``cfg.remat`` says, as the reference
wraps its scan body in ``jax.checkpoint``:

  "full" — ``torch.utils.checkpoint.checkpoint`` (non-reentrant) around
           each block: only the block's input is kept, the rest is
           recomputed in the backward pass;
  "dots" — the same with a selective policy that keeps the outputs of
           the plain matrix products (``aten.mm``/``addmm``: the
           reference's ``dots_with_no_batch_dims_saveable``; batched
           products such as attention scores are recomputed);
  "none" — no checkpointing.

Stack API, as the reference's:

  init(seed, cfg, device)                        -> stacked params
  apply(p, cfg, h, positions, mode, cache)       -> (h, new_cache, aux)
  init_cache(cfg, batch, cache_len, dtype, device) -> cache

``aux`` accumulates by summation over the layers, in every mode (the
reference's ``scan_stack``): the MoE stack starts it at zero
``aux_loss`` and ``drop_frac``, so ``drop_frac`` is a sum over layers,
not a share (reports divide it by the layer count); the dense stack's
is empty.

The hybrid (zamba2) and ssm (xlstm) stacks are ROADMAP Queue 1 item 9:
``get_stack`` raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import mlp_apply, mlp_init, pdtype, rms_norm

# one generator per parameter leaf of a block, keyed by these codes; an
# MoE block's MLP leaves take the codes after them (``moe.MOE_LEAVES``)
_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


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
    h = h + a_out

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
    return h + m_out, new_cache, aux


def _save_plain_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep plain (unbatched) matmul outputs."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg, mode: str) -> Callable:
    """``fn(h) -> out`` rematerialised per ``cfg.remat`` in train mode."""
    if mode != "train" or cfg.remat == "none":
        return fn
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
        return {k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                               dtype=v.dtype, device=device)
                for k, v in one.items()}


class MoEStack(DenseStack):
    use_moe = True


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
        return MoEStack
    if cfg.family in ("hybrid", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the hybrid (mamba2) and ssm (xlstm) "
            f"stacks are not ported yet (ROADMAP Queue 1 item 9)")
    raise ValueError(f"unknown family {cfg.family!r}")
