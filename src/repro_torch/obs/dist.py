"""Cross-rank aggregation of registry snapshots.

Port of ``repro.obs.dist``. The same wire discipline as the router's
stat gathers (:mod:`repro_torch.fleet.router`): small collectives on
the gloo control plane, every rank calls together, every rank gets the
merged result. A snapshot is variable-size JSON, so it rides as a
two-phase gather — lengths first, then zero-padded uint8 payloads —
both bounded because histogram reservoirs are bounded.
"""
from __future__ import annotations

import json
from typing import List

import torch

from repro_torch.launch.mesh import allgather, process_count


def allgather_snapshots(snapshot: dict) -> List[dict]:
    """Allgather one registry snapshot per rank → every rank's
    snapshot, in rank order (collective: every rank must call
    together). Without a group, or in a group of one: the identity."""
    if process_count() == 1:
        return [snapshot]
    data = torch.tensor(list(json.dumps(snapshot, sort_keys=True).encode()),
                        dtype=torch.uint8)
    sizes = allgather(torch.tensor([data.numel()], dtype=torch.int64))
    sizes = sizes.ravel().tolist()
    buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
    buf[:data.numel()] = data
    gathered = allgather(buf)
    return [json.loads(bytes(gathered[i, :n].tolist()).decode())
            for i, n in enumerate(sizes)]
