"""Step functions: train (with microbatch gradient accumulation), eval,
prefill and decode.

Port of ``repro.train.steps``, eager on one device. The reference pins
gradient and microbatch shardings to the parameter specs
(``tree_shard_like``, ``shard``) so XLA lowers the data-parallel
reduction as a reduce-scatter; on one card there is nothing to shard,
and that belongs to the sharding slice (ROADMAP Queue 1 item 9). A
train step moves the host batch to the parameters' device, runs one
forward and backward a microbatch (the model's blocks rematerialised
as ``cfg.remat`` says), sums the gradients in f32, divides by the
microbatch count and takes one optimizer step.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.pytree import leaves, tree_map, unflatten_like


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


def make_train_step(cfg, optimizer, *, global_batch: int, dp: int = 1
                    ) -> Tuple[Callable, int]:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` and the microbatch count it accumulates over."""
    accum = effective_accum(cfg, global_batch, dp)

    def train_step(params, opt_state, batch):
        dev = _device_of(params)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in batch.items()}
        if accum > 1:
            mbs = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                   for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=dev), params)
            history = []
            for i in range(accum):
                metrics, g = value_and_grad(
                    cfg, params, {k: v[i] for k, v in mbs.items()})
                for a, b in zip(leaves(gsum), leaves(g)):
                    a.add_(b.to(torch.float32))
                history.append(metrics)
                del g
            grads = tree_map(lambda g: g / accum, gsum)
            metrics = {k: torch.stack([m[k] for m in history]).mean()
                       for k in history[0]}
        else:
            metrics, grads = value_and_grad(cfg, params, batch)
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
        return model_lib.prefill(cfg, params, batch)
    return prefill_step


def make_decode_step(cfg) -> Callable:
    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return model_lib.decode_step(cfg, params, cache, tokens, pos)
    return decode_step
