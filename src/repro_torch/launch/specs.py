"""Shape stand-ins and DTensor placements for parameters, optimizer
state, batches and caches.

Port of ``repro.launch.specs``. Nothing here allocates: parameter,
optimizer and cache shapes come from the real initialisers on the
``meta`` device (the analogue of ``jax.eval_shape``), and batch inputs
are ``meta`` tensors made directly. Placements are
``repro_torch.sharding``'s: one DTensor placement a mesh axis, from the
rule table installed with ``axis_rules``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import placements, spec_for, tree_shardings

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def param_shapes(cfg):
    return model_lib.init_params(cfg, 0, device=META)


def param_shardings(cfg, mesh):
    return tree_shardings(model_lib.param_specs(cfg), mesh)


def opt_shapes(cfg, optimizer, pshapes):
    return optimizer.init(pshapes)


def opt_shardings(pshardings, mesh) -> AdamWState:
    """AdamWState(step, m, v): m/v mirror params; step replicated."""
    return AdamWState(step=placements(mesh, ()), m=pshardings, v=pshardings)


def batch_specs(cfg, shape_cfg, mesh, *, with_labels: bool
                ) -> Tuple[Dict, Dict]:
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    bspec = spec_for(["batch"])
    shapes: Dict[str, Any] = {}
    shards: Dict[str, Any] = {}
    if cfg.frontend != "none":
        shapes["embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16)
        shards["embeds"] = placements(mesh, bspec + (None, None))
    else:
        shapes["tokens"] = _sds((B, S), torch.int32)
        shards["tokens"] = placements(mesh, bspec + (None,))
    if with_labels:
        shapes["labels"] = _sds((B, S), torch.int32)
        shards["labels"] = placements(mesh, bspec + (None,))
    return shapes, shards


def cache_shapes(cfg, batch: int, cache_len: int):
    return model_lib.init_cache(cfg, batch, cache_len, device=META)


def cache_shardings(cfg, mesh):
    return tree_shardings(model_lib.cache_specs(cfg), mesh)


def decode_specs(cfg, shape_cfg, mesh):
    """(shapes, shardings) for (cache, tokens, pos)."""
    B = shape_cfg.global_batch
    cache_len = shape_cfg.seq_len
    cshape = cache_shapes(cfg, B, cache_len)
    cshard = cache_shardings(cfg, mesh)
    tshape = _sds((B, 1), torch.int32)
    tshard = placements(mesh, spec_for(["batch"]) + (None,))
    pshape = _sds((), torch.int32)
    pshard = placements(mesh, ())
    return (cshape, tshape, pshape), (cshard, tshard, pshard)
