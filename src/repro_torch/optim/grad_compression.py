"""Gradient compression with error feedback, for the data-parallel
gradient reduction.

Port of ``repro.optim.grad_compression``. Compressing the gradient to
int8 codes cuts the bytes on the wire at the cost of quantization error,
which error feedback re-injects next step so the *sum over time* is
unbiased:

    q_t   = Q(g_t + e_t)
    e_t+1 = (g_t + e_t) − D(q_t)
    update uses  allreduce(D(q_t))

``quantize_leaf``, ``dequantize_leaf``, ``init_error`` and
``compress_decompress`` are the reference's arithmetic (``torch.round``
rounds half to even, as ``jnp.round``: the codes are equal).

``compressed_psum`` reduces over the process groups of a
``DeviceMesh``'s data-parallel axes, each rank holding its own full
gradient. Two deliberate differences from the reference:

* **R15, one shared scale.** The reference quantises each rank's
  ``t = g + e`` with that rank's own scale, sums the codes and
  dequantises the sum with the largest scale: biased whenever the
  ranks' gradients differ (two ranks holding ``[1, .5, -.3]`` and
  ``[.01, .004, -.002]`` get a "mean" of ``[1.0, .453, -.248]`` for
  ``[.505, .252, -.151]``). Here one small f32 all-reduce (MAX) of the
  ranks' per-leaf scales comes first, every rank quantises with that
  shared scale, and the summed codes are dequantised with it; the new
  error is ``t − codes·scale_shared``. The mean then lies within
  ``scale_shared / 2`` of the plain mean, and equals the reference's
  whenever the ranks' gradients are equal (every scale is then the
  shared one).
* **R16, the wire.** The reference sums int8 codes on an int16 wire,
  which holds the sum of at most 258 ranks (127 × 258 = 32,766) and
  which gloo refuses (``Invalid scalar type``); an int8 all-reduce
  would wrap (100 + 100 → −56). Here the int8 codes travel by
  ``all_gather_into_tensor`` and each rank sums the W gathered rows in
  int32: per rank and element, 1 byte sent and W − 1 received, against
  the 2(W − 1)/W × 4 bytes each way of a ring all-reduce of f32 — a 4×
  cut at W = 2, and fewer bytes for every W < 8. Over a second
  data-parallel axis (``("pod", "data")``) the int32 partial sums are
  all-reduced (4 bytes an element on that axis's ring).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.pytree import leaves, tree_map, unflatten_like


def _qmax(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def quantize_leaf(g: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = _qmax(bits)
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / qmax
    return _codes(g, scale, qmax), scale


def _codes(t: torch.Tensor, scale: torch.Tensor, qmax: float
           ) -> torch.Tensor:
    return torch.clamp(torch.round(t / scale), -qmax, qmax).to(torch.int8)


def dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_decompress(grads, error, bits: int = 8):
    """Local quantize→dequantize with error feedback (the lossy part;
    the reduction itself is whatever the caller wraps around it)."""
    deq, new_e = [], []
    for g, e in zip(leaves(grads), leaves(error)):
        t = g.to(torch.float32) + e
        codes, scale = quantize_leaf(t, bits)
        d = dequantize_leaf(codes, scale)
        deq.append(d)
        new_e.append(t - d)
    return unflatten_like(grads, deq), unflatten_like(error, new_e)


def _sum_codes(codes: torch.Tensor, groups) -> torch.Tensor:
    """Σ over the ranks of ``groups`` of the int8 ``codes``, in int32."""
    import torch.distributed as dist

    total = None
    for group in groups:
        if total is None:
            world = dist.get_world_size(group)
            rows = torch.empty((world * codes.numel(),), dtype=torch.int8,
                               device=codes.device)
            dist.all_gather_into_tensor(rows, codes.reshape(-1),
                                        group=group)
            total = rows.view(world, *codes.shape).sum(dim=0,
                                                       dtype=torch.int32)
        else:
            dist.all_reduce(total, group=group)
    return total


def compressed_psum(mesh, dp_axes: Sequence[str], grads, error,
                    bits: int = 8):
    """The mean over the ranks of ``mesh``'s ``dp_axes`` of each rank's
    gradient tree, reduced as int8 codes with one shared scale a leaf,
    and the new error state. Collective: every rank of those axes
    calls it with trees of one structure and shapes."""
    import torch.distributed as dist

    groups = [mesh.get_group(ax) for ax in dp_axes]
    n = 1
    for group in groups:
        n *= dist.get_world_size(group)
    qmax = _qmax(bits)
    ts = [g.to(torch.float32) + e for g, e in zip(leaves(grads),
                                                   leaves(error))]
    scales = torch.stack([torch.clamp(torch.max(torch.abs(t)), min=1e-12)
                          / qmax for t in ts])
    for group in groups:
        dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
    mean, new_e = [], []
    for t, scale in zip(ts, scales):
        codes = _codes(t, scale, qmax)
        total = _sum_codes(codes, groups)
        mean.append(total.to(torch.float32) * scale / n)
        new_e.append(t - dequantize_leaf(codes, scale))
    return unflatten_like(grads, mean), unflatten_like(error, new_e)
