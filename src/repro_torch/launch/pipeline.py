"""Pipeline parallelism: the GPipe schedule over the ``pod`` axis.

Port of ``repro.launch.pipeline``. When a model's parameters do not
fit one pod even FSDP-sharded, the pod axis becomes a pipeline axis:
each stage owns a contiguous block of layers, microbatches stream
through, and only (B_micro, ..., d_model) activations cross stages.

Here a stage is one rank along a ``DeviceMesh``'s ``axis`` (default
``pod``), and each rank holds only its own stage's parameters (the
reference's ``stage_params`` carry a leading ``n_stages`` dim sharded
over the axis; here that dim is the ranks). The schedule is the
reference's S + M − 1 ticks for S stages and M microbatches: at tick
t stage s runs microbatch t − s when 0 ≤ t − s < M (stage 0 takes it
from the batch, every other stage from its left neighbour) and idles
otherwise — the idle ticks are the bubble, (S−1)/(S+M−1). Each
activation goes rightwards point to point, one hop a microbatch and a
boundary (the reference's ``ppermute``), and the last stage's
collected outputs are broadcast to every stage (the reference's
one-hot ``psum``), so every rank returns the same (B, ...) array.

Forward and backward. With grad mode off, or when neither ``x`` nor a
stage parameter requires a gradient (serving, evaluation), the
schedule runs under ``no_grad`` and keeps nothing. Otherwise it is
differentiable, as the reference composes with ``jax.grad``. The
forward stashes each microbatch's graph on its stage: the received
input, as a leaf that requires a gradient, and the stage's output
(GPipe's activation stash; a stage that wants less memory remats
inside ``stage_fn``). The backward runs the schedule in reverse,
microbatches last to first: the last stage starts from the cotangent
of its own collected outputs, every other stage receives d h_out from
its right neighbour, and each sends d h_in to its left one — one hop a
microbatch and a boundary, leftwards. A stage's parameter gradients
are summed over the microbatches onto its own leaves. The output is
replicated, so every rank calls ``backward`` on the same loss of it
(the reference's one global loss outside ``shard_map``); only the last
stage's cotangent is used, never the ranks' sum. ``x`` is replicated
too: when it requires a gradient, stage 0 assembles d x over the
microbatches and broadcasts it, so every rank holds the whole d x.

Transport. Where NCCL serves the group's CUDA tensors, and for CPU
tensors, the activation is sent as it is. Where gloo or the staged
backend serves them (``launch.mesh.cuda_backend``; neither sends a
CUDA tensor point to point), a CUDA activation crosses through a
pinned host buffer: it is copied to the host, sent over the group's
gloo, received into a host buffer and copied to the receiver's device
(the same for the broadcasts and the backward's sends). The route
follows the backend serving CUDA tensors and the tensor's device
alone, and ``stats["staged_bytes"]`` counts the bytes copied between
device and host. (The card's run decided it: see ROADMAP, "Pipeline
transport".)
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.pytree import leaves, unflatten_like


def stage_index(axis: str = "pod", *, mesh=None) -> int:
    """This rank's stage: its coordinate on ``mesh``'s ``axis`` (the
    installed mesh, :func:`repro_torch.sharding.current_mesh`, when
    ``mesh`` is None)."""
    if mesh is None:
        from repro_torch.sharding import current_mesh
        mesh = current_mesh()
    return mesh.get_local_rank(axis)




class _Link:
    """Point-to-point and broadcast on one group, through pinned host
    buffers where the group's CUDA tensors are not NCCL's."""

    def __init__(self, group, stats: Dict):
        import torch.distributed as dist

        from repro_torch.launch.mesh import cuda_backend

        self.dist = dist
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.via_host = cuda_backend(group) != "nccl"
        self.stats = stats

    def _staged(self, t: torch.Tensor) -> bool:
        return self.via_host and t.device.type == "cuda"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.stats["staged_bytes"] += t.numel() * t.element_size()
        return host

    def _to_device(self, host: torch.Tensor, dev) -> torch.Tensor:
        self.stats["staged_bytes"] += host.numel() * host.element_size()
        return host.to(dev, non_blocking=False)

    def send(self, t: torch.Tensor, to_stage: int) -> None:
        buf = self._to_host(t) if self._staged(t) else t.contiguous()
        self.dist.send(buf, dst=self.ranks[to_stage], group=self.group)

    def recv(self, like: torch.Tensor, from_stage: int) -> torch.Tensor:
        if self._staged(like):
            host = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self.dist.recv(host, src=self.ranks[from_stage], group=self.group)
            return self._to_device(host, like.device)
        buf = torch.empty_like(like)
        self.dist.recv(buf, src=self.ranks[from_stage], group=self.group)
        return buf

    def broadcast(self, t: torch.Tensor, from_stage: int) -> torch.Tensor:
        src = self.ranks[from_stage]
        if self._staged(t):
            mine = self.dist.get_rank() == src
            host = self._to_host(t) if mine else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
            self.dist.broadcast(host, src=src, group=self.group)
            return t if mine else self._to_device(host, t.device)
        t = t.contiguous()
        self.dist.broadcast(t, src=src, group=self.group)
        return t




def _microbatches(x: torch.Tensor, microbatches: int) -> torch.Tensor:
    """(B, ...) → (M, B/M, ...)."""
    B = x.shape[0]
    if microbatches < 1 or B % microbatches != 0:
        raise ValueError(f"pipeline_apply: batch {B} does not split into "
                         f"{microbatches} microbatches")
    return x.reshape(microbatches, B // microbatches, *x.shape[1:])


class _Schedule:
    """One call's schedule on this rank: its stage among ``n_stages``
    and the link to its neighbours (None for one stage)."""

    def __init__(self, mesh, axis: str, microbatches: int, stats: Dict):
        self.n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
        self.sidx = stage_index(axis, mesh=mesh)
        self.microbatches = microbatches
        self.last = self.sidx == self.n_stages - 1
        self.link = _Link(mesh.get_group(axis), stats) \
            if self.n_stages > 1 else None

    def ticks(self):
        """The microbatches this stage runs, in tick order: at tick t
        microbatch t − s, the bubble skipped."""
        for t in range(self.n_stages + self.microbatches - 1):
            m = t - self.sidx
            if 0 <= m < self.microbatches:
                yield m

    def forward(self, run: Callable, mbs: torch.Tensor) -> torch.Tensor:
        """``run(m, h)`` over the ticks; the last stage's outputs, (M,
        B/M, ...), broadcast to every stage."""
        outs = torch.zeros_like(mbs)
        for m in self.ticks():
            h = mbs[m] if self.sidx == 0 else \
                self.link.recv(mbs[m], self.sidx - 1)
            h = run(m, h)
            if not self.last:
                self.link.send(h, self.sidx + 1)
            else:
                outs[m] = h
        if self.link is not None:
            outs = self.link.broadcast(outs, self.n_stages - 1)
        return outs


class _Pipeline(torch.autograd.Function):
    """The whole schedule as one autograd node. Its inputs are ``x`` and
    this stage's parameter leaves; the forward keeps each microbatch's
    (input leaf, output) graph, the backward runs the reverse schedule
    over it."""

    @staticmethod
    def forward(ctx, sched, stage_fn, stage_params, x, *params):
        live = [p.detach().requires_grad_(p.requires_grad) for p in params]
        tree = unflatten_like(stage_params, live)
        d_in = sched.sidx > 0 or x.requires_grad
        stash = {}

        def run(m, h):
            h = h.detach().requires_grad_(d_in)
            with torch.enable_grad():
                out = stage_fn(tree, h)
            stash[m] = (h, out)
            return out.detach()

        outs = sched.forward(run, _microbatches(x, sched.microbatches))
        ctx.sched, ctx.stash, ctx.live = sched, stash, live
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, d_out):
        sched, stash, live = ctx.sched, ctx.stash, ctx.live
        ctx.stash = ctx.live = None
        d_outs = _microbatches(d_out, sched.microbatches)
        wrt = [p for p in live if p.requires_grad]
        sums = [None] * len(wrt)
        want_x = ctx.needs_input_grad[3]
        dxs = torch.zeros_like(d_outs) if want_x else None
        for m in reversed(list(sched.ticks())):
            h_in, h_out = stash.pop(m)
            dh = d_outs[m] if sched.last else \
                sched.link.recv(h_out, sched.sidx + 1)
            ins = ([h_in] if h_in.requires_grad else []) + wrt
            grads = torch.autograd.grad(h_out, ins, dh, allow_unused=True)
            if h_in.requires_grad:
                d_h, grads = grads[0], grads[1:]
                if sched.sidx > 0:
                    sched.link.send(d_h, sched.sidx - 1)
                else:
                    dxs[m] = d_h
            sums = [s if g is None else g if s is None else s + g
                    for s, g in zip(sums, grads)]
            del h_in, h_out, dh, grads
        if want_x and sched.link is not None:
            dxs = sched.link.broadcast(dxs, 0)
        it = iter(sums)
        d_params = [next(it) if p.requires_grad else None for p in live]
        dx = dxs.reshape(d_out.shape) if want_x else None
        return (None, None, None, dx, *d_params)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pod", microbatches: int,
                   stats: Optional[Dict] = None) -> torch.Tensor:
    """Run ``stage_fn`` as an S-deep GPipe pipeline, S = the size of
    ``mesh``'s ``axis``. Collective: every rank of the axis calls it,
    and where its output is differentiated, every rank calls
    ``backward`` on the same loss of it.

    stage_fn: (params_for_stage, h) -> h, shape-preserving (one layer
        block).
    stage_params: this rank's stage's parameters (a pytree of tensors);
        their gradients, summed over the microbatches, land on them.
    x: (B, ...) the whole batch, the same on every rank;
        B % microbatches == 0. Its gradient is the whole d x, the same
        on every rank.
    stats: a dict that gains ``staged_bytes`` (device↔host copies of
        the gloo route, the backward's included; 0 on every other
        route).
    Returns ``stage_fn`` applied S times over the stages in order, the
    same (B, ...) tensor on every rank.
    """
    mbs = _microbatches(x, microbatches)
    stats = {} if stats is None else stats
    stats.setdefault("staged_bytes", 0)
    sched = _Schedule(mesh, axis, microbatches, stats)
    params = leaves(stage_params)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params)):
        return _Pipeline.apply(sched, stage_fn, stage_params, x, *params)
    with torch.no_grad():
        outs = sched.forward(lambda m, h: stage_fn(stage_params, h), mbs)
    return outs.reshape(x.shape)


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    """GPipe bubble overhead — the schedule's idle fraction."""
    return (n_stages - 1) / (n_stages + microbatches - 1)
