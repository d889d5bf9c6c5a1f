"""Step functions: train (with microbatch gradient accumulation), eval,
prefill and decode.

Port of ``repro.train.steps``, eager. A train step moves the host batch
to the parameters' device, runs one forward and backward a microbatch
(the model's blocks rematerialised as ``cfg.remat`` says), sums the
gradients in f32, divides by the microbatch count and takes one
optimizer step.

Under a mesh (``repro_torch.sharding.axis_rules``) the parameters and
the optimizer state are DTensors placed by the rule table, and the step
is the reference's: every rank holds the same global batch (the
pipeline is a function of (seed, step)), the microbatches are resplit
with ``shard(x, None, "batch", ...)`` so each rank keeps its rows, the
model's plain functions run on DTensors — DTensor's sharding
propagation issues the collectives, and a plain tensor made inside the
model (positions, masks, constants) counts as replicated
(``implicit_replication``) — and the gradients are pinned to the
parameter specs (``tree_shard_like``), which turns their pending sums
into reduce-scatters onto the FSDP shards. The metrics come back as
plain replicated tensors, gathered on every rank. Without a mesh none
of this runs.

:func:`make_dp_train_step` is data parallelism with replicated
parameters over a process group, without DTensors: each rank runs its
share of every microbatch, and the f32 gradient sums are all-reduced
(``all_reduce`` on the parameters' own device): plain c10d collectives,
no DTensor, which any group serves (phase 15 drives it on the card).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.pytree import leaves, tree_map, unflatten_like
from repro_torch.sharding import current_mesh, shard, tree_shard_like


def effective_accum(cfg, global_batch: int, dp: int) -> int:
    """Clamp cfg.grad_accum so each microbatch still tiles the DP axis."""
    accum = max(cfg.grad_accum, 1)
    while accum > 1 and (global_batch % accum != 0 or
                         (global_batch // accum) % dp != 0 or
                         (global_batch // accum) < dp):
        accum -= 1
    return max(accum, 1)


def _device_of(params) -> torch.device:
    return leaves(params)[0].device


def _replicated(metrics: Dict) -> Dict:
    """DTensor metrics → plain tensors (collective: every rank calls)."""
    from torch.distributed.tensor import DTensor

    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in metrics.items()}


def value_and_grad(cfg, params, batch) -> Tuple[Dict, object]:
    """(metrics, grads): the loss's metrics (detached) and the gradient
    of the loss with respect to every parameter leaf, in the
    parameters' structure. A leaf the loss does not reach (the token
    table under a batch of frontend ``embeds``) gets a zero gradient,
    as ``jax.grad`` gives it."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model_lib.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves(live), grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, grads))


def _accumulate(cfg, params, mbs: Dict, accum: int):
    """Σ over the ``accum`` microbatches ``mbs[k][i]`` of the gradients,
    in f32, and the mean of their metrics."""
    gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
    history = []
    for i in range(accum):
        metrics, g = value_and_grad(cfg, params,
                                    {k: v[i] for k, v in mbs.items()})
        for a, b in zip(leaves(gsum), leaves(g)):
            a.add_(b.to(torch.float32))
        history.append(metrics)
        del g
    return gsum, {k: torch.stack([m[k] for m in history]).mean()
                  for k in history[0]}


def make_train_step(cfg, optimizer, *, global_batch: int, dp: int = 1
                    ) -> Tuple[Callable, int]:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` and the microbatch count it accumulates over."""
    accum = effective_accum(cfg, global_batch, dp)

    def step(params, opt_state, batch):
        dev = _device_of(params)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in batch.items()}
        if accum > 1:
            def resplit(x):
                x = x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
                return shard(x, None, "batch", *([None] * (x.ndim - 2)))

            gsum, metrics = _accumulate(
                cfg, params, {k: resplit(v) for k, v in batch.items()},
                accum)
            grads = tree_map(lambda g: g / accum, gsum)
        else:
            batch = {k: shard(v, "batch", *([None] * (v.ndim - 1)))
                     for k, v in batch.items()}
            metrics, grads = value_and_grad(cfg, params, batch)
        # pin the gradients to the parameter specs: their pending sums
        # become reduce-scatters onto the FSDP shards (no-op w/o mesh)
        grads = tree_shard_like(grads, model_lib.param_specs(cfg))
        new_params, new_opt, om = optimizer.update(grads, opt_state,
                                                   params)
        return new_params, new_opt, {**metrics, **om}

    def train_step(params, opt_state, batch):
        with _mesh_context():
            new_params, new_opt, metrics = step(params, opt_state, batch)
            return new_params, new_opt, _replicated(metrics)

    return train_step, accum


def _mesh_context():
    """Under a mesh, DTensor's ``implicit_replication`` (a plain tensor
    made inside the model counts as replicated); else nothing."""
    import contextlib

    if current_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_dp_train_step(cfg, optimizer, *, global_batch: int,
                       group=None) -> Tuple[Callable, int]:
    """Data parallelism with replicated parameters over ``group`` (the
    default group when None): ``train_step(params, opt_state, batch)``
    where every rank holds the same parameters and the same global
    batch. Each rank takes its contiguous 1/W of every microbatch's
    rows, its f32 gradient sums are all-reduced and divided by W and by
    the microbatch count, and every rank takes the same AdamW step; the
    metrics are the ranks' mean. Collective: every rank calls it."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    accum = effective_accum(cfg, global_batch, world)
    rows = global_batch // accum // world

    def train_step(params, opt_state, batch):
        dev = _device_of(params)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in batch.items()}
        gsum, metrics = _accumulate(
            cfg, params, {k: v.reshape(accum, world, rows, *v.shape[1:])
                          [:, rank] for k, v in batch.items()}, accum)
        for g in leaves(gsum):
            dist.all_reduce(g, group=group)
        grads = tree_map(lambda g: g / (accum * world), gsum)
        names = sorted(metrics)
        means = torch.stack([metrics[k] for k in names]).to(torch.float32)
        dist.all_reduce(means, group=group)
        metrics = dict(zip(names, means / world))
        new_params, new_opt, om = optimizer.update(grads, opt_state,
                                                   params)
        return new_params, new_opt, {**metrics, **om}

    return train_step, accum


def make_eval_step(cfg) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model_lib.loss_fn(cfg, params, batch)
        return metrics
    return eval_step


def make_prefill_step(cfg) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        with _mesh_context():
            return model_lib.prefill(cfg, params, batch)
    return prefill_step


def make_decode_step(cfg) -> Callable:
    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        with _mesh_context():
            return model_lib.decode_step(cfg, params, cache, tokens, pos)
    return decode_step
