"""Fleet-level accounting: per-chip Tables II–VI roll-up + served rates.

Port of ``repro.fleet.report``. A fleet is ``n_chips`` identical
compiled chips, so the hardware side composes linearly from one
:class:`repro_torch.chip.ChipReport` (areas and powers add, per-item
energy is unchanged, capacity multiplies). The *served* side does not —
it is whatever the continuous-batching router actually achieved against
real traffic — so the report carries both: the analytic envelope and,
when a router is given, the measured :class:`RouterStats` with the
achieved fraction of capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.chip.report import ChipReport


@dataclasses.dataclass(frozen=True)
class FleetReport:
    n_chips: int
    chip: ChipReport                    # one member's full accounting
    # linear hardware roll-up
    cores: int
    area_mm2: float
    power_mw: float
    capacity_items_per_second: float    # Σ chips, compute-limited
    routing_limited_items_per_second: float
    energy_per_item_nj: float
    # measured serving roll-up (None for analytic-only reports)
    served: Optional[object] = None     # RouterStats
    served_fraction_of_capacity: Optional[float] = None

    def __str__(self) -> str:
        s = (f"FleetReport[{self.n_chips}x {self.chip.system} chip, "
             f"{self.cores} cores, {self.area_mm2:.3f} mm2, "
             f"{self.power_mw:.3f} mW, capacity "
             f"{self.capacity_items_per_second:.3g} items/s, "
             f"{self.energy_per_item_nj:.3g} nJ/item]")
        if self.served is not None:
            s += f"\n  served: {self.served}"
            s += (f" ({self.served_fraction_of_capacity:.2%} of "
                  f"analytic capacity)")
        return s


def fleet_report(fleet, router=None) -> FleetReport:
    """Assemble the roll-up for a :class:`repro_torch.fleet.ShardedChip`,
    optionally folding in a router's measured serving stats.

    The hardware envelope always spans the WHOLE fleet, so on a
    distributed fleet the served side must too: a
    :class:`DistributedFleetRouter` contributes its exact cross-rank
    ``stats_global()`` (a collective — every rank must assemble the
    report together, the same lockstep rule as every other verb),
    never its process-local counters, which would understate served
    throughput by ~n_processes× against the fleet-wide capacity.
    """
    chip_rep: ChipReport = fleet.chip.report()
    n = fleet.n_chips
    cap = chip_rep.capacity_items_per_second * \
        chip_rep.replication * n
    if router is None:
        served = None
    elif getattr(fleet, "is_distributed", False) and \
            hasattr(router, "stats_global"):
        served = router.stats_global()
    else:
        served = router.stats()
    return FleetReport(
        n_chips=n,
        chip=chip_rep,
        cores=chip_rep.cores * n,
        area_mm2=chip_rep.area_mm2 * n,
        power_mw=chip_rep.power_mw * n,
        capacity_items_per_second=cap,
        # the chip report's routing limit is per REPLICA (each replica
        # owns its own mesh copy), so the fleet total scales by
        # replication × chips, exactly like compute capacity
        routing_limited_items_per_second=(
            chip_rep.routing_limited_items_per_second *
            chip_rep.replication * n),
        energy_per_item_nj=chip_rep.energy_per_item_nj,
        served=served,
        served_fraction_of_capacity=(
            served.items_per_second / cap if served is not None and cap
            else None),
    )
