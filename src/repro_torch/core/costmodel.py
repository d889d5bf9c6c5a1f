"""Full-system area/power/energy accounting (paper §IV.D, §V, Tables I–VI).

Port copy of ``repro.core.costmodel``: the same plain Python, on the
port's own mapping, routing and core models. The operation order is the
reference's, so the tables agree to the last bit, not merely closely.

For each application × system the model assembles:

  area   = Σ core area (core area includes its router slice — the
           paper's published tables are exactly cores × Table-I area)
  power  = leakage (all placed cores)                      [static]
         + core dynamic power × duty cycle                 [compute]
         + mesh energy/item × item rate                    [routing]
         + TSV energy/item × item rate                     [3-D IO]

Duty cycles come from the mapping's per-core busy time and the
replica's item rate; routing energy comes from the static router's
hop-weighted bit counts. RISC rows use the analytic cycles-per-MAC
calibration for the NN apps and SimpleScalar-calibrated cycles/item
for the two algorithmic apps (edge, motion) — see configs.paper_apps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.paper_apps import APPS, AppConfig
from repro_torch.core import routing as routing_lib
from repro_torch.core.mapping import (Mapping, map_networks, nn_macs,
                                      risc_cores_needed)
from repro_torch.core.neural_core import (CYCLE_S, TSV_PJ_PER_BIT,
                                          CoreGeometry, DigitalCore,
                                          MemristorCore, RiscCore,
                                          analog_precision_feasible)
from repro_torch.core.systems import normalize_system


@dataclasses.dataclass
class SystemCost:
    system: str
    cores: int
    area_mm2: float
    power_mw: float
    leak_mw: float
    compute_mw: float
    routing_mw: float
    tsv_mw: float
    items_per_second: float
    mapping: Optional[Mapping] = None
    route: Optional[routing_lib.RouteReport] = None

    @property
    def energy_per_item_nj(self) -> float:
        return self.power_mw * 1e-3 / self.items_per_second * 1e9


def risc_cost(app: AppConfig) -> SystemCost:
    risc = RiscCore()
    if app.risc_algorithmic:
        n = risc_cores_needed(app.risc_cycles_per_item,
                              app.items_per_second, cycles_per_op=1.0)
    else:
        n = risc_cores_needed(nn_macs(app.memristor_nets),
                              app.items_per_second)
    # the paper reports RISC cores at full power (they are saturated by
    # construction — replication is sized to the load)
    power = n * risc.power_mw
    return SystemCost("risc", n, n * risc.area_mm2, power,
                      n * risc.leak_mw, power - n * risc.leak_mw,
                      0.0, 0.0, app.items_per_second)


def fabric_cost(mapping: Mapping, route: routing_lib.RouteReport, *,
                items_per_second: float,
                tsv_bits_per_item: Optional[float] = None,
                geom: Optional[CoreGeometry] = None) -> SystemCost:
    """Assemble the unified area/power/throughput numbers for an
    already-mapped, already-routed fabric (the shared backend of
    ``specialized_cost`` and ``repro_torch.chip.CompiledChip.report``).

    ``tsv_bits_per_item`` overrides the mapping-derived sensor traffic
    (sliding-window apps reuse pixels, so unique TSV bits < mapped
    bits); ``None`` uses the router's per-item TSV count.
    """
    system = mapping.system
    rate = items_per_second
    rate_per_replica = rate / mapping.replication

    if system == "memristor":
        plain = MemristorCore(geom=geom) if geom else MemristorCore()
        dac = MemristorCore(geom=plain.geom, has_dac=True)
        n_dac = mapping.n_dac_cores
        n_plain = mapping.total_cores - n_dac
        area = n_dac * dac.area_mm2() + n_plain * plain.area_mm2()
        leak = n_dac * dac.leak_mw() + n_plain * plain.leak_mw()
        # duty-cycled dynamic power, replica busy time × per-replica rate
        dyn = 0.0
        for c in mapping.cores:
            core = dac if c.kind == "dac" else plain
            duty = min(1.0, c.busy_cycles(system) *
                       CYCLE_S * rate_per_replica)
            dyn += (core.power_mw() - core.leak_mw()) * duty
        dyn *= mapping.replication
    else:
        core = DigitalCore(geom=geom) if geom else DigitalCore()
        area = mapping.total_cores * core.area_mm2()
        leak = mapping.total_cores * core.leak_mw()
        dyn = 0.0
        for c in mapping.cores:
            duty = min(1.0, c.busy_cycles(system) *
                       CYCLE_S * rate_per_replica)
            dyn += (core.power_mw() - core.leak_mw()) * duty
        dyn *= mapping.replication

    # routing + TSV energy: per-item energy × total item rate (replica
    # flows each carry their share of the rate)
    routing_mw = route.mesh_energy_pj * 1e-12 * rate * 1e3
    tsv_bits = route.tsv_bits if tsv_bits_per_item is None \
        else tsv_bits_per_item
    tsv_mw = tsv_bits * TSV_PJ_PER_BIT * 1e-12 * rate * 1e3
    power = leak + dyn + routing_mw + tsv_mw
    return SystemCost(system, mapping.total_cores, area, power, leak, dyn,
                      routing_mw, tsv_mw, rate, mapping, route)


def specialized_cost(app: AppConfig, system: str,
                     geom: Optional[CoreGeometry] = None) -> SystemCost:
    # "1t1m" used to fall through to the SRAM branch here; normalizing
    # at the entry point is the fix the alias helper exists for
    system = normalize_system(system, context="specialized_cost")
    nets = app.memristor_nets if system == "memristor" else app.sram_nets
    mapping = map_networks(nets, system=system, geom=geom,
                           items_per_second=app.items_per_second,
                           sensor_flags=app.sensor_flags(system),
                           deps=app.net_deps(system))
    route = routing_lib.route(mapping)
    # unique sensor bits per item (see AppConfig.tsv_bits_per_item)
    return fabric_cost(mapping, route,
                       items_per_second=app.items_per_second,
                       tsv_bits_per_item=app.tsv_bits_per_item, geom=geom)


def app_costs(app: AppConfig) -> Dict[str, SystemCost]:
    return {
        "risc": risc_cost(app),
        "digital": specialized_cost(app, "digital"),
        "1t1m": specialized_cost(app, "memristor"),
    }


def efficiency_over_risc(costs: Dict[str, SystemCost]) -> Dict[str, float]:
    base = costs["risc"].power_mw
    return {k: base / v.power_mw for k, v in costs.items()}


def all_tables() -> Dict[str, Dict[str, SystemCost]]:
    """Tables II–VI: every app × system."""
    return {app_id: app_costs(app) for app_id, app in APPS.items()}


# --------------------------------------------------------------------- #
# design-space exploration (Figs. 13–14)
# --------------------------------------------------------------------- #
def design_space(system: str, geometries=None, *,
                 bits: int = 8) -> Dict[str, Dict]:
    """Sweep core geometry; per app report area & power normalized to the
    best geometry for that app (the paper's Figs. 13/14 procedure).

    ``bits`` sets the synaptic precision the analog feasibility bound is
    evaluated at (paper default 8 — the Fig. 13 starred entries)."""
    system = normalize_system(system, context="design_space")
    if geometries is None:
        geometries = [CoreGeometry(r, r // 2)
                      for r in (32, 64, 128, 256, 512)] \
            if system == "memristor" else \
            [CoreGeometry(r, r // 2) for r in (64, 128, 256, 512, 1024)]
    out: Dict[str, Dict] = {}
    for app_id, app in APPS.items():
        rows = {}
        for geom in geometries:
            c = specialized_cost(app, system, geom=geom)
            rows[f"{geom.rows}x{geom.cols}"] = {
                "area_mm2": c.area_mm2, "power_mw": c.power_mw,
                "cores": c.cores,
                # analog crossbars above the wire-IR precision bound
                # cannot hold `bits`-bit synapses (§IV.A / Fig. 13)
                "feasible": analog_precision_feasible(geom, bits=bits)
                if system == "memristor" else True}
        a0 = min(r["area_mm2"] for r in rows.values())
        p0 = min(r["power_mw"] for r in rows.values())
        for r in rows.values():
            r["norm_area"] = r["area_mm2"] / a0
            r["norm_power"] = r["power_mw"] / p0
        out[app_id] = rows
    return out


def _geom_key(g: str):
    rows, cols = g.split("x")
    return (int(rows), int(cols))


def best_geometry(system: str, geometries=None, *,
                  bits: int = 8, apps=None) -> str:
    """Geometry minimizing total normalized area+power over the apps
    among *feasible* geometries — the paper's selection rule (§V.B):
    128×64 (1T1M, wire-IR-bounded), 256×128 (digital).

    ``apps`` names the benchmarks that vote (default: the deep-NN
    classifier apps — ``risc_algorithmic=False`` — the workloads the
    §V.B fabric is sized FOR; the single-layer sensor-plane kernels
    fit any geometry's slice and ride along, and letting them vote
    drags the digital pick a bin below the paper's).

    A geometry is feasible only if EVERY voting app can realize it
    (the AND across apps, not the last app swept); infeasible
    geometries are excluded from selection, not merely starred. Cost
    ties break deterministically toward the smallest geometry (fewest
    idle cells). Raises when no swept geometry is feasible — e.g. a
    ``bits`` precision no analog crossbar size can hold.
    """
    ds = design_space(system, geometries, bits=bits)
    if apps is None:
        apps = [a for a, cfg in APPS.items()
                if not cfg.risc_algorithmic]
    unknown = sorted(set(apps) - set(ds))
    if unknown:
        raise ValueError(f"best_geometry: unknown app(s) {unknown} "
                         f"(known: {sorted(ds)})")
    sums: Dict[str, float] = {}
    feasible: Dict[str, bool] = {}
    for app_id in apps:
        rows = ds[app_id]
        for g, r in rows.items():
            sums[g] = sums.get(g, 0.0) + r["norm_area"] + r["norm_power"]
            feasible[g] = feasible.get(g, True) and bool(r["feasible"])
    ok = {g: s for g, s in sums.items() if feasible[g]}
    if not ok:
        raise ValueError(
            f"best_geometry: no feasible geometry for system "
            f"{system!r} at {bits}-bit precision among "
            f"{sorted(sums, key=_geom_key)} — every candidate exceeds "
            "the wire-IR-drop precision bound "
            "(neural_core.analog_precision_feasible)")
    return min(ok, key=lambda g: (ok[g],) + _geom_key(g))
