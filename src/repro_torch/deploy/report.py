"""Multi-app deployment accounting: Tables II–VI, composed per tenant.

Port of ``repro.deploy.report``. Co-residency composes linearly on the
hardware side: each app's programmed cores occupy their own slice of
every fleet chip, so the deployment's area/power/core inventory is the
per-app chip reports summed (× the app's chips), exactly the way
Tables II–VI sum independent benchmarks over one core design. The
served side is whatever the multi-app router measured — carried per
app AND as the fleet roll-up, never re-derived from the analytic
envelope.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Mapping, Optional

from repro_torch.fleet.report import FleetReport, fleet_report


@dataclasses.dataclass(frozen=True)
class DeploymentReport:
    """Per-app fleet reports plus the co-resident roll-up.

    ``n_chips`` is the whole fleet's chip count; on a heterogeneous
    fleet each app's row carries ITS submesh size (``rep.n_chips``),
    and the roll-up stays the per-app sum — chips of different systems
    never double-count because each app's cores live only on its own
    system's chips."""
    n_chips: int
    apps: Dict[str, FleetReport]
    # linear co-residency roll-up (Σ over apps of the per-app fleet)
    cores: int
    area_mm2: float
    power_mw: float
    capacity_items_per_second: float
    # measured serving roll-up (None for analytic-only reports)
    served: Optional[object] = None     # DeploymentStats
    served_fraction_of_capacity: Optional[float] = None

    def __str__(self) -> str:
        head = (f"DeploymentReport[{len(self.apps)} app(s) on "
                f"{self.n_chips} chip(s): {self.cores} cores, "
                f"{self.area_mm2:.3f} mm2, {self.power_mw:.3f} mW, "
                f"capacity {self.capacity_items_per_second:.3g} "
                f"items/s]")
        lines = [f"  {name:>12s}: {rep.n_chips}x {rep.chip.system} "
                 f"{rep.chip.cores} cores, {rep.area_mm2:.3f} mm2, "
                 f"{rep.power_mw:.3f} mW"
                 for name, rep in self.apps.items()]
        if self.served is not None:
            lines.append(f"  served: {self.served.fleet}"
                         + (f" ({self.served_fraction_of_capacity:.2%}"
                            f" of analytic capacity)"
                            if self.served_fraction_of_capacity
                            is not None else ""))
        return "\n".join([head] + lines)


def deployment_report(chips: Mapping[str, object], n_chips,
                      served=None, *,
                      total_chips: Optional[int] = None
                      ) -> DeploymentReport:
    """Compose the multi-app report from ``{app: CompiledChip}``.

    Pure in the chips (no device is touched); ``served`` is a live
    router's :class:`repro_torch.deploy.DeploymentStats`, folded in
    when given.

    ``n_chips`` is an int (every app spans the whole fleet — the
    homogeneous case) or a ``{app: n}`` mapping for heterogeneous
    fleets, where each app's cores occupy only its own system's
    submesh. Apps of one system SHARE that system's chips, so the
    fleet-wide count cannot be inferred from the per-app mapping —
    pass ``total_chips`` (the mesh size) alongside; without it the
    report uses the mapping's max, which is right only when every app
    lives on one submesh.
    """
    if isinstance(n_chips, Mapping):
        missing = sorted(set(chips) - set(n_chips))
        if missing:
            raise ValueError(f"deployment_report: no n_chips entry "
                             f"for app(s) {missing}")
        per_app = {name: int(n_chips[name]) for name in chips}
        fleet_chips = int(total_chips) if total_chips is not None \
            else max(per_app.values())
    else:
        per_app = {name: int(n_chips) for name in chips}
        fleet_chips = int(n_chips) if total_chips is None \
            else int(total_chips)
    apps = {}
    for name, chip in chips.items():
        member = types.SimpleNamespace(chip=chip,
                                       n_chips=per_app[name])
        apps[name] = fleet_report(member)
    cap = sum(r.capacity_items_per_second for r in apps.values())
    served_fleet = served.fleet if served is not None else None
    return DeploymentReport(
        n_chips=fleet_chips,
        apps=apps,
        cores=sum(r.cores for r in apps.values()),
        area_mm2=sum(r.area_mm2 for r in apps.values()),
        power_mw=sum(r.power_mw for r in apps.values()),
        capacity_items_per_second=cap,
        served=served,
        served_fraction_of_capacity=(
            served_fleet.items_per_second / cap
            if served_fleet is not None and cap else None),
    )
