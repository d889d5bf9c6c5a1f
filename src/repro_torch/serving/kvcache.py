"""Slot-level cache surgery for continuous batching.

Port of ``repro.serving.kvcache``. The batched cache is a nested dict of
tensors; each leaf has a lane (batch) axis and, if it is an attention
ring, a ring (position) axis. ``axes`` says which: ``(lane, ring)``
for every leaf, or a nested dict of such pairs (a pair stands for every
leaf under its key), as ``transformer.<Stack>.cache_axes(cfg)`` gives
them. The default, ``(1, 2)``, is the dense stacks' (layers, B, T, ...)
rings. A leaf with ring ``None`` is a recurrent state (the Mamba2 and
mLSTM states, stacked (groups, per-group, B, ...), have their lane at
axis 2; the sLSTM state's is axis 1) and is copied whole.

Admitting a request = writing its prefilled cache into lane ``slot``;
retiring = zeroing the lane. The reference's jitted functions donate
the cache; these write into it in place and return it.

The reference takes axis 1 as every leaf's lane, so its engine writes
the hybrid and xLSTM states of every admitted request into lane 0
(ROADMAP R12). Here each leaf's lane is its own: the port's engine
departs from the reference there on purpose, and serves each request
the tokens of its own greedy decode.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.models.transformer import RING_AXES


def _leaves(cache: Dict, axes, other: Optional[Dict] = None
            ) -> Iterator[Tuple[str, torch.Tensor, Tuple, Optional[object]]]:
    """(path, leaf, (lane, ring), the same leaf of ``other``) over a
    nested cache."""
    for name, leaf in cache.items():
        ax = axes[name] if isinstance(axes, dict) else axes
        o = None if other is None else other[name]
        if isinstance(leaf, dict):
            for path, lf, a, ol in _leaves(leaf, ax, o):
                yield f"{name}.{path}", lf, a, ol
        else:
            yield name, leaf, ax, o


def clear_slot(cache: Dict, slot: int, axes=RING_AXES) -> Dict:
    """Zero lane ``slot`` of every leaf (in place); returns the cache."""
    for _, leaf, (lane, _), _ in _leaves(cache, axes):
        leaf.select(lane, int(slot)).zero_()
    return cache


def write_slot(cache: Dict, one_cache: Dict, slot: int,
               axes=RING_AXES) -> Dict:
    """Copy a single-lane cache (a B = 1 prefill's) into lane ``slot``,
    in place, cast into the cache's dtype (bf16 rounds to nearest even,
    as the reference's ``astype``). A ring leaf's S positions go to the
    lane's first S ring slots; its other slots keep what they held
    (decode masks them by position). A state leaf is copied whole.
    Returns the cache."""
    for name, dst, (lane, ring), src in _leaves(cache, axes, one_cache):
        want = list(dst.shape)
        want[lane] = 1
        got = list(src.shape)
        if ring is not None and got[ring] <= want[ring]:
            want[ring] = got[ring]
        if got != want:
            what = f"at most {dst.shape[ring]} positions" if ring is not \
                None else f"shape {tuple(want)}"
            raise ValueError(f"write_slot: {name} {tuple(src.shape)} is not "
                             f"one lane of {what}")
        lane_dst = dst.select(lane, int(slot))
        if ring is not None:
            lane_dst = lane_dst.narrow(ring - (ring > lane), 0, got[ring])
        lane_dst.copy_(src.select(lane, 0))
    return cache
