"""Slot-level KV-cache surgery for continuous batching.

Port of ``repro.serving.kvcache``. The batched cache is one dict of
tensors whose axis 1 (after the layer axis) is the slot/batch lane.
Admitting a request = writing its prefilled prefix into lane ``slot``;
retiring = zeroing the lane. The reference's jitted functions donate
the cache; these write into it in place and return it.
"""
from __future__ import annotations

from typing import Dict

import torch

_LANE = 1           # cache leaves are stacked (layers, B, ...)


def clear_slot(cache: Dict[str, torch.Tensor], slot: int
               ) -> Dict[str, torch.Tensor]:
    """Zero lane ``slot`` of every leaf (in place); returns the cache."""
    for leaf in cache.values():
        leaf.select(_LANE, int(slot)).zero_()
    return cache


def write_slot(cache: Dict[str, torch.Tensor],
               one_cache: Dict[str, torch.Tensor], slot: int
               ) -> Dict[str, torch.Tensor]:
    """Copy a single-lane cache (a B = 1 prefill's) into lane ``slot``,
    in place: its S positions go to the lane's first S ring slots,
    cast into the cache's dtype (bf16 rounds to nearest even, as the
    reference's ``astype``); the lane's other slots keep what they
    held (decode masks them by position). Returns the cache."""
    for name, dst in cache.items():
        src = one_cache[name]
        if src.shape[_LANE] != 1 or src.shape[2] > dst.shape[2]:
            raise ValueError(
                f"write_slot: {name} {tuple(src.shape)} is not one lane "
                f"of at most {dst.shape[2]} positions")
        dst.select(_LANE, int(slot))[:, :src.shape[2]].copy_(
            src.select(_LANE, 0))
    return cache
