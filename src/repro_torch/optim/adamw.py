"""AdamW + global-norm clipping + LR schedules.

Port of ``repro.optim.adamw``. The optimizer state mirrors the
parameter tree (``m``, ``v`` the same structure, f32), so a checkpoint
of ``(params, opt_state)`` names its leaves as the reference's does.
There is no weight decay on leaves with fewer than two dimensions
(norms, biases). Updates run under ``torch.no_grad`` on the device the
parameters live on; the step counter is a 0-d int32 tensor there, and
a schedule maps it to a 0-d f32 tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.pytree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # like params (f32)
    v: Any                   # like params (f32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]   # schedule: step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        device = leaves(params)[0].device

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict]:
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0) \
            if self.clip_norm else torch.ones((), device=gnorm.device)
        step = state.step + 1
        lr = self.lr(step)
        stepf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, device=stepf.device),
                             stepf)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, device=stepf.device),
                             stepf)

        def upd(g, m, v, p):
            g = g * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * torch.square(g)
            mh = m / c1
            vh = v / c2
            u = mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay and p.dim() >= 2:  # no decay on norms/bias
                u = u + self.weight_decay * p.to(torch.float32)
            return p + (-lr * u).to(p.dtype), m, v

        # each leaf of ``out`` is a (param, m, v) triple; the traversal
        # follows the parameters' structure, so the triples stay whole
        out = tree_map(upd, grads, state.m, state.v, params)
        new_params, m, v = (tree_map(lambda _, t, i=i: t[i], params, out)
                            for i in range(3))
        return new_params, AdamWState(step, m, v), \
            {"grad_norm": gnorm, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in leaves(tree):
        s = torch.sum(torch.square(leaf.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_value: float):
    def lr(step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(lr_value, dtype=torch.float32,
                            device=step.device)
    return lr
