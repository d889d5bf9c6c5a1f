"""chip.report(): the unified full-system accounting for one compile.

Port copy of ``repro.chip.report`` (plain Python).

Everything the Tables II–VI benchmarks previously assembled by hand
from three modules (``mapping`` core inventory, ``routing`` mesh/TSV
energy + TDM schedule, ``costmodel`` area/power) in one record, against
the same calibrated Table-I core models.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.costmodel import SystemCost, fabric_cost


@dataclasses.dataclass(frozen=True)
class ChipReport:
    """Area / power / throughput of a compiled chip (one system)."""
    system: str
    cores: int
    cores_per_replica: int
    dac_cores: int
    replication: int
    utilization: float                  # programmed synapses / capacity
    area_mm2: float
    power_mw: float
    leak_mw: float
    compute_mw: float
    routing_mw: float
    tsv_mw: float
    items_per_second: float             # accounted rate
    capacity_items_per_second: float    # one replica, compute-limited
    routing_limited_items_per_second: float
    energy_per_item_nj: float
    grid: Tuple[int, int]               # mesh of one replica
    schedule_cycles: int                # TDM frame on the busiest link

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"ChipReport[{self.system}] {self.cores} cores "
                f"({self.replication}x replica of "
                f"{self.cores_per_replica} on {self.grid[0]}x"
                f"{self.grid[1]} mesh), {self.area_mm2:.3f} mm2, "
                f"{self.power_mw:.3f} mW "
                f"(leak {self.leak_mw:.3f} + compute "
                f"{self.compute_mw:.3f} + mesh {self.routing_mw:.3f} + "
                f"tsv {self.tsv_mw:.3f}), "
                f"{self.items_per_second:.3g} items/s, "
                f"{self.energy_per_item_nj:.3g} nJ/item")


def chip_report(chip) -> ChipReport:
    """Assemble the report for a :class:`repro_torch.chip.CompiledChip`.

    The accounted rate is the compile-time target when one was given
    (replication was sized to it, §V.C); otherwise the chip is assumed
    to stream at one replica's compute-limited capacity.
    """
    mapping, route = chip.mapping, chip.route
    rate = chip.items_per_second or mapping.items_per_second_capacity
    cost: SystemCost = fabric_cost(
        mapping, route, items_per_second=rate,
        tsv_bits_per_item=chip.tsv_bits_per_item, geom=chip.geom)
    return ChipReport(
        system=chip.system,
        cores=mapping.total_cores,
        cores_per_replica=mapping.cores_per_replica,
        dac_cores=mapping.n_dac_cores,
        replication=mapping.replication,
        utilization=mapping.utilization,
        area_mm2=cost.area_mm2,
        power_mw=cost.power_mw,
        leak_mw=cost.leak_mw,
        compute_mw=cost.compute_mw,
        routing_mw=cost.routing_mw,
        tsv_mw=cost.tsv_mw,
        items_per_second=cost.items_per_second,
        capacity_items_per_second=mapping.items_per_second_capacity,
        routing_limited_items_per_second=route.max_items_per_second,
        energy_per_item_nj=cost.energy_per_item_nj,
        grid=route.grid,
        schedule_cycles=route.schedule_cycles,
    )
