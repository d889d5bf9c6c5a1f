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

Transport. On an NCCL group, and for CPU tensors, the activation is
sent as it is. On a gloo group a CUDA activation crosses through a
pinned host buffer: it is copied to the host, sent, received into a
host buffer and copied to the receiver's device (the same for the
broadcast). The route follows the group's backend and the tensor's
device alone, and ``stats["staged_bytes"]`` counts the bytes copied
between device and host. (The card's run decided it: see ROADMAP,
"Pipeline transport".)

``pipeline_apply`` is forward only (serving, evaluation), as the
reference documents and tests it; a stage parameter that requires a
gradient raises: the backward is ROADMAP Queue 1 item 9i.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.pytree import leaves


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
    buffers where a gloo group meets a CUDA tensor."""

    def __init__(self, group, stats: Dict):
        import torch.distributed as dist

        self.dist = dist
        self.group = group
        self.ranks = dist.get_process_group_ranks(group)
        self.gloo = dist.get_backend(group) == "gloo"
        self.stats = stats

    def _staged(self, t: torch.Tensor) -> bool:
        return self.gloo and t.device.type == "cuda"

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


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pod", microbatches: int,
                   stats: Optional[Dict] = None) -> torch.Tensor:
    """Run ``stage_fn`` as an S-deep GPipe pipeline, S = the size of
    ``mesh``'s ``axis``. Collective: every rank of the axis calls it.

    stage_fn: (params_for_stage, h) -> h, shape-preserving (one layer
        block).
    stage_params: this rank's stage's parameters (a pytree).
    x: (B, ...) the whole batch, the same on every rank;
        B % microbatches == 0.
    stats: a dict that gains ``staged_bytes`` (device↔host copies of
        the gloo route; 0 on every other route).
    Returns ``stage_fn`` applied S times over the stages in order, the
    same (B, ...) tensor on every rank.
    """
    if any(isinstance(p, torch.Tensor) and p.requires_grad
           for p in leaves(stage_params)):
        raise NotImplementedError(
            "pipeline_apply is forward only: a stage parameter requires "
            "a gradient (the pipeline's backward is ROADMAP Queue 1 item "
            "9i)")
    B = x.shape[0]
    if microbatches < 1 or B % microbatches != 0:
        raise ValueError(f"pipeline_apply: batch {B} does not split into "
                         f"{microbatches} microbatches")
    stats = {} if stats is None else stats
    stats.setdefault("staged_bytes", 0)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    sidx = stage_index(axis, mesh=mesh)
    mbs = x.reshape(microbatches, B // microbatches, *x.shape[1:])
    link = _Link(mesh.get_group(axis), stats) if n_stages > 1 else None
    outs = torch.zeros_like(mbs)
    for t in range(n_stages + microbatches - 1):
        m = t - sidx
        if not 0 <= m < microbatches:
            continue                     # the bubble: this stage idles
        h = mbs[m] if sidx == 0 else link.recv(mbs[m], sidx - 1)
        h = stage_fn(stage_params, h)
        if sidx < n_stages - 1:
            link.send(h, sidx + 1)
        else:
            outs[m] = h
    if link is not None:
        outs = link.broadcast(outs, n_stages - 1)
    return outs.reshape(B, *x.shape[1:])


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    """GPipe bubble overhead — the schedule's idle fraction."""
    return (n_stages - 1) / (n_stages + microbatches - 1)
