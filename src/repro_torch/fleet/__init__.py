"""repro_torch.fleet — one compiled chip served as a fleet of logical
chips, in one process or over ranks, with continuous batching and high
availability (port of ``repro.fleet``):

  fleet = shard_chip(chip, n_chips)        # n logical chips, one image
  y = fleet.stream(x)                      # == chip.stream(x)
  router = FleetRouter(fleet, lanes_per_chip=8)
  router.serve(StreamSource(SensorPipeline()))   # sensor-fed loop
  print(fleet.report(router))              # hardware + served roll-up

  # one rank of a fleet of ranks (a gloo process group):
  fleet = shard_chip(chip, mesh=make_distributed_fleet_mesh(2))
  router = fleet.serve()                   # DistributedFleetRouter
  router.serve(StreamSource.for_host(SensorPipeline()))
  router.stats_global()                    # exact, on every rank

Self-checks:  PYTHONPATH=src python -m repro_torch.fleet --selftest
              (--distributed-selftest, --chaos-selftest)

Submodule imports are lazy (PEP 562), as in the reference.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ShardedChip": "repro_torch.fleet.shard",
    "shard_chip": "repro_torch.fleet.shard",
    "FleetRouter": "repro_torch.fleet.router",
    "DistributedFleetRouter": "repro_torch.fleet.router",
    "FleetRequest": "repro_torch.fleet.router",
    "RouterStats": "repro_torch.fleet.router",
    "merge_stats": "repro_torch.fleet.router",
    "stats_from_states": "repro_torch.fleet.router",
    "BoundedQueue": "repro_torch.fleet.source",
    "StreamSource": "repro_torch.fleet.source",
    "FleetReport": "repro_torch.fleet.report",
    "fleet_report": "repro_torch.fleet.report",
    "HAConfig": "repro_torch.fleet.ha",
    "HAFleetServer": "repro_torch.fleet.ha",
    "HeartbeatBoard": "repro_torch.fleet.ha",
    "FailureDetector": "repro_torch.fleet.ha",
    "MembershipChange": "repro_torch.fleet.ha",
    "StepGuard": "repro_torch.fleet.ha",
    "degrade_to_local": "repro_torch.fleet.ha",
    "local_fleet_mesh": "repro_torch.fleet.ha",
    "source_snapshot": "repro_torch.fleet.ha",
    "replay_requests": "repro_torch.fleet.ha",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
