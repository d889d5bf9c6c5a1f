"""repro_torch.tune — SLO/budget-driven fabric autotuning (port of
``repro.tune``).

The paper fixes one system and hand-picks the core geometry from the
Figs. 13–14 sweeps; this package runs that sweep as a SEARCH. Declare
what must be served (a :class:`repro_torch.deploy.DeploymentSpec`
whose apps carry ``items_per_second`` SLOs) and what the fleet may
spend (a :class:`TuneBudget` of area/power/chips), and ``tune`` walks
system × geometry × chip count per app through the Tables I–VI cost
oracle and the routed TDM throughput gate, returning the cheapest
concrete fabric as a :class:`TunedFabric`:

  from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
  from repro_torch.tune import TuneBudget, tune

  tuned = tune(DeploymentSpec(apps=(
      AppSpec("deep", "deep", items_per_second=1e5),
      AppSpec("ocr", "ocr", items_per_second=1e5, weight_bits=12),
  )), TuneBudget(power_mw=120.0))
  print(tuned.report())       # Figs. 13–14-style frontier + why losers lost
  d = deploy(tuned.spec)      # heterogeneous chip_systems fleet, live

The search is analytic and needs no device; the deployment it emits
runs on the spec's device (the card by default).

Self-check:  PYTHONPATH=src python -m repro_torch.tune --selftest
(``--device cpu``).

Submodule imports are lazy (PEP 562), as in the reference.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "TuneBudget": "repro_torch.tune.search",
    "CandidatePoint": "repro_torch.tune.search",
    "ComboPoint": "repro_torch.tune.search",
    "TunedFabric": "repro_torch.tune.search",
    "candidate_point": "repro_torch.tune.search",
    "tune": "repro_torch.tune.search",
    "DEFAULT_GEOMETRIES": "repro_torch.tune.search",
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
