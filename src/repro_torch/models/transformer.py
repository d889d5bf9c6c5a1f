"""The dense transformer block stack.

Port of the dense half of ``repro.models.transformer``. Parameters are
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

The moe, ssm, hybrid and xlstm stacks are ROADMAP Queue 1 item 9:
``get_stack`` raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, mlp_init, pdtype, rms_norm

# one generator per parameter leaf of a block, keyed by these codes
_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def layer_slice(tree, layer: int):
    """Layer ``layer`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, layer) for k, v in tree.items()}
    return tree[layer]


def _block_init(generator: Callable[[int], torch.Generator], cfg,
                device: torch.device) -> Dict:
    """``generator(i)``: the ``torch.Generator`` of leaf ``_LEAVES[i]``."""
    d = cfg.d_model
    dt = pdtype(cfg)
    gens = [generator(i) for i in range(len(_LEAVES))]
    p = {
        "attn": attn.attn_init(gens[:4], cfg, dt, device=device),
        "attn_norm": torch.ones((d,), dtype=dt, device=device),
        "mlp_norm": torch.ones((d,), dtype=dt, device=device),
        "mlp": mlp_init((gens[4], gens[5], gens[6]), d, cfg.d_ff, dt,
                        device=device),
    }
    if cfg.post_block_norm:
        p["attn_post"] = torch.ones((d,), dtype=dt, device=device)
        p["mlp_post"] = torch.ones((d,), dtype=dt, device=device)
    return p


def _block_apply(p, cfg, h, *, positions, mode, cache, window,
                 project=None, mlp_fn=None):
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
    if mlp_fn is not None:
        m_out = mlp_fn(p["mlp"], m_in)
    else:
        m_out = mlp_apply(p["mlp"], m_in, cfg.act, m_in.dtype)
    if cfg.post_block_norm:
        m_out = rms_norm(m_out, p["mlp_post"], cfg.norm_eps)
    return h + m_out, new_cache, {}


def _save_plain_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep plain (unbatched) matmul outputs."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg, mode: str) -> Callable:
    """``fn(h) -> h`` rematerialised per ``cfg.remat`` in train mode."""
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
    @classmethod
    def init(cls, generator: Callable[..., torch.Generator], cfg,
             device: torch.device) -> Dict:
        """``generator(layer, leaf)`` → that leaf's ``torch.Generator``."""
        layers = [_block_init(lambda i, _l=layer: generator(_l, i), cfg,
                              device)
                  for layer in range(cfg.num_layers)]
        return _stack_trees(layers)

    @classmethod
    def apply(cls, p, cfg, h, *, positions, mode,
              cache: Optional[Dict] = None):
        windows = _layer_windows(cfg)
        if mode == "train":
            for layer in range(cfg.num_layers):
                def block(h, p_l=layer_slice(p, layer), w=windows[layer]):
                    return _block_apply(p_l, cfg, h, positions=positions,
                                        mode=mode, cache=None, window=w)[0]
                h = _remat(block, cfg, mode)(h)
            return h, None, {}
        caches = []
        for layer in range(cfg.num_layers):
            h, c_new, _ = _block_apply(
                layer_slice(p, layer), cfg, h, positions=positions,
                mode=mode,
                cache=None if cache is None else layer_slice(cache, layer),
                window=windows[layer])
            caches.append(c_new)
        return h, stack_caches(caches), {}

    @classmethod
    def init_cache(cls, cfg, batch: int, cache_len: int,
                   dtype: torch.dtype, device: torch.device) -> Dict:
        one = attn.init_attn_cache(cfg, batch, cache_len, dtype, device)
        return {k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                               dtype=v.dtype, device=device)
                for k, v in one.items()}


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def get_stack(cfg):
    if cfg.family in ("dense", "vlm", "audio"):
        return DenseStack
    if cfg.family in ("moe", "hybrid", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the moe/ssm/hybrid/xlstm stacks are "
            f"not ported yet (ROADMAP Queue 1 item 9)")
    raise ValueError(f"unknown family {cfg.family!r}")
