"""The fabric autotuner: spec → cheapest feasible fabric.

Port of ``repro.tune.search``: the same search, gates, cost order and
report, over the port's copies of the cost oracle
(:func:`repro_torch.core.costmodel.fabric_cost`), the mapping pass and
the router. It is analytic — plain Python, no tensor, no device — so
it runs anywhere; the emitted spec keeps the input spec's ``device``
and ``use_kernel`` for the deployment that follows.

The paper picks its core geometry by hand-sweeping normalized
area/power per app (Figs. 13–14) and fixes ONE system per fabric; this
module inverts the whole configuration surface. Given a
:class:`repro_torch.deploy.DeploymentSpec` whose apps carry
``items_per_second`` SLOs, and a fleet-wide :class:`TuneBudget`, it
searches system (memristor vs digital) × tile geometry × chip count
per app with the Tables I–VI cost oracle and the routed TDM
link-capacity check as the throughput feasibility gate, and returns a
:class:`TunedFabric` — a ready-to-``deploy()`` spec (heterogeneous
``chip_systems`` mesh when the cheapest fabric mixes systems) plus a
Figs. 13–14-style frontier report saying why every losing point lost.

Feasibility, per candidate point (app × system × geometry):

  * analog precision — a memristor crossbar above the wire-IR-drop
    bound cannot hold the app's ``weight_bits`` synapses
    (:func:`repro_torch.core.neural_core.analog_precision_feasible`);
    this is what drives heterogeneity: a high-precision tenant must go
    digital even when 1T1M wins on raw cost;
  * routed throughput — one chip carries
    ``replication × route.max_items_per_second`` items/s (the §V.C
    compute fan-out times the TDM link cap); an SLO above that is
    split across ``ceil(SLO / per-chip)`` chips;
  * the budget — fleet-wide area/power/chip-count ceilings, applied
    to the assembled combination.

Cost ordering is lexicographic (power, area, chips, smallest
geometry) — the paper's figure of merit is power/energy efficiency,
and the deterministic tail keeps ties stable. Fleet cost composes
exactly the way :func:`repro_torch.deploy.deployment_report` composes
it (per-app chip report × the app's submesh size, summed), so the
tuner's predicted cost IS the deployed report's cost.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import routing as routing_lib
from repro_torch.core.costmodel import fabric_cost
from repro_torch.core.mapping import map_networks
from repro_torch.core.neural_core import (CoreGeometry,
                                    analog_precision_feasible)
from repro_torch.core.systems import normalize_system
from repro_torch.deploy.spec import AppSpec, DeploymentSpec

# the Figs. 13–14 sweep ranges (cols = rows/2, the paper's aspect)
DEFAULT_GEOMETRIES: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "memristor": tuple((r, r // 2) for r in (32, 64, 128, 256, 512)),
    "digital": tuple((r, r // 2) for r in (64, 128, 256, 512, 1024)),
}


@dataclasses.dataclass(frozen=True)
class TuneBudget:
    """Fleet-wide ceilings (None = unconstrained)."""
    area_mm2: Optional[float] = None
    power_mw: Optional[float] = None
    max_chips: Optional[int] = None

    def __post_init__(self):
        for field in ("area_mm2", "power_mw", "max_chips"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"TuneBudget: {field} must be "
                                 f"positive or None (got {v!r})")


@dataclasses.dataclass(frozen=True)
class CandidatePoint:
    """One (app × system × geometry) design point, fully costed.

    ``n_chips`` is the chips THIS app needs to meet its SLO (the TDM
    gate); ``area_mm2``/``power_mw`` are per chip at the app's full
    rate — the unit :func:`repro_torch.deploy.deployment_report` multiplies.
    ``feasible=False`` points carry the reason they lost.
    """
    app: str
    system: str
    geometry: str                       # "128x64"
    n_chips: int
    area_mm2: float                     # per chip
    power_mw: float                     # per chip
    capacity_items_per_second: float    # per chip
    items_per_second: float             # the app's SLO
    feasible: bool
    reason: str = ""

    @property
    def geom(self) -> Tuple[int, int]:
        rows, cols = self.geometry.split("x")
        return (int(rows), int(cols))


@dataclasses.dataclass(frozen=True)
class ComboPoint:
    """One full fleet assignment (every app placed), costed and gated
    against the budget — a row of the tuner's frontier."""
    assignment: Tuple[Tuple[str, str, str], ...]   # (app, system, geom)
    chip_systems: Tuple[str, ...]
    n_chips: int
    area_mm2: float
    power_mw: float
    feasible: bool
    reason: str = ""
    selected: bool = False

    @property
    def homogeneous(self) -> bool:
        return len(set(s for _, s, _ in self.assignment)) == 1

    def cost_key(self):
        return (self.power_mw, self.area_mm2, self.n_chips,
                tuple(sorted(g for _, _, g in self.assignment)))


def _app_networks(app: AppSpec, system: str):
    """→ (net tuples, compile kwargs) for costing ``app`` on
    ``system`` — the analytic slice of
    :func:`repro_torch.deploy.deployment._resolve_network` (no weights, no
    programming; the cost oracle only needs shapes and rates)."""
    net = app.network
    if isinstance(net, str):
        from repro_torch.configs.paper_apps import APPS

        cfg = APPS.get(net)
        if cfg is None:
            raise ValueError(f"tune: app {app.name!r}: unknown paper "
                             f"app {net!r} (known: {sorted(APPS)})")
        return cfg.nets(system), dict(
            items_per_second=app.items_per_second
            or cfg.items_per_second,
            sensor_flags=cfg.sensor_flags(system),
            deps=cfg.net_deps(system),
            tsv_bits_per_item=cfg.tsv_bits_per_item)
    if hasattr(net, "dims"):                      # MLPSpec
        dims = tuple(net.dims)
    elif hasattr(net, "layers"):                  # ProgrammedMLP
        dims = (net.layers[0].d_in,) + tuple(lp.d_out
                                             for lp in net.layers)
    else:                                         # bare net tuple(s)
        seq = list(net)
        if seq and isinstance(seq[0], int):
            seq = [tuple(net)]
        nets = tuple((int(i), tuple(d)) for i, d in seq)
        return nets, dict(items_per_second=app.items_per_second,
                          sensor_flags=None, deps=None,
                          tsv_bits_per_item=None)
    return ((1, dims),), dict(items_per_second=app.items_per_second,
                              sensor_flags=None, deps=None,
                              tsv_bits_per_item=None)


def candidate_point(app: AppSpec, system: str,
                    geom: Tuple[int, int], *,
                    max_chips: Optional[int] = None) -> CandidatePoint:
    """Cost one (app × system × geometry) point through the same
    oracle the deployed report uses: ``map_networks`` sizes the §V.C
    replica fan-out, ``route`` prices the TDM schedule (the per-chip
    throughput cap), ``fabric_cost`` assembles Tables I–VI."""
    system = normalize_system(system, context="tune")
    g = CoreGeometry(*geom)
    gname = f"{g.rows}x{g.cols}"
    nets, kw = _app_networks(app, system)
    rate = kw["items_per_second"]
    if system == "memristor" and not analog_precision_feasible(
            g, bits=app.weight_bits):
        return CandidatePoint(
            app.name, system, gname, 0, 0.0, 0.0, 0.0, rate, False,
            reason=(f"IR-drop: {g.rows}+{g.cols} wire segments exceed "
                    f"the {app.weight_bits}-bit analog precision "
                    "bound"))
    mapping = map_networks(nets, system=system, geom=g,
                           items_per_second=rate,
                           sensor_flags=kw["sensor_flags"],
                           deps=kw["deps"])
    route = routing_lib.route(mapping)
    cap = mapping.replication * route.max_items_per_second
    if rate and cap > 0 and math.isfinite(cap):
        n_chips = max(1, math.ceil(rate / cap - 1e-9))
    else:
        n_chips = 1
    cost = fabric_cost(mapping, route, items_per_second=rate,
                       tsv_bits_per_item=kw["tsv_bits_per_item"],
                       geom=g)
    if max_chips is not None and n_chips > max_chips:
        return CandidatePoint(
            app.name, system, gname, n_chips, cost.area_mm2,
            cost.power_mw, cap, rate, False,
            reason=(f"throughput: needs {n_chips} chips for "
                    f"{rate:g} items/s ({cap:g}/chip) but the budget "
                    f"caps the fleet at {max_chips}"))
    return CandidatePoint(app.name, system, gname, n_chips,
                          cost.area_mm2, cost.power_mw, cap, rate,
                          True)


def _pareto(points: Sequence[CandidatePoint]) -> List[CandidatePoint]:
    """Drop points dominated on (power, area, chips) — they can never
    appear in a cheapest combination, so pruning them keeps the
    cross-product exhaustive-in-effect without being exhaustive in
    size. Dominated points stay in the frontier report with the
    dominator named."""
    keep = []
    for p in points:
        dominated_by = None
        for q in points:
            if q is p:
                continue
            no_worse = (q.power_mw <= p.power_mw and
                        q.area_mm2 <= p.area_mm2 and
                        q.n_chips <= p.n_chips)
            better = (q.power_mw < p.power_mw or
                      q.area_mm2 < p.area_mm2 or
                      q.n_chips < p.n_chips)
            if no_worse and better:
                dominated_by = q
                break
        if dominated_by is None:
            keep.append(p)
    return keep


@dataclasses.dataclass(frozen=True)
class TunedFabric:
    """The search result: a deployable spec plus the explained search.

    ``spec`` is ready for :func:`repro_torch.deploy.deploy` — apps rewritten
    onto their cost-optimal system/geometry, the fleet topology fixed
    by ``chip_systems`` (heterogeneous when the winner mixes systems).
    ``frontier`` holds every full assignment the search costed, gated
    and ranked; ``candidates`` every per-app design point including
    the infeasible ones and why they lost.
    """
    spec: DeploymentSpec
    assignment: Mapping[str, CandidatePoint]
    chip_systems: Tuple[str, ...]
    n_chips: int
    area_mm2: float
    power_mw: float
    budget: TuneBudget
    frontier: Tuple[ComboPoint, ...]
    candidates: Tuple[CandidatePoint, ...]

    def report(self) -> str:
        """Figs. 13–14-style rendering: the per-app sweep (with
        infeasibility reasons), then the assembled frontier and the
        winner."""
        lines = [f"TunedFabric[{self.n_chips} chip(s) "
                 f"{list(self.chip_systems)}: {self.area_mm2:.3f} mm2, "
                 f"{self.power_mw:.3f} mW]"]
        lines.append("  candidate sweep (per chip at the app's SLO):")
        for c in self.candidates:
            if c.feasible:
                lines.append(
                    f"    {c.app:>10s} {c.system:>9s} {c.geometry:>9s}"
                    f"  {c.area_mm2:8.3f} mm2  {c.power_mw:9.3f} mW "
                    f" x{c.n_chips} chip(s)")
            else:
                lines.append(
                    f"    {c.app:>10s} {c.system:>9s} {c.geometry:>9s}"
                    f"  infeasible: {c.reason}")
        lines.append("  frontier (full assignments, cheapest first):")
        ranked = sorted(self.frontier,
                        key=lambda f: (not f.feasible, f.cost_key()))
        for f in ranked:
            tag = "SELECTED" if f.selected else \
                ("ok" if f.feasible else f"lost: {f.reason}")
            named = ", ".join(f"{a}->{s} {g}"
                              for a, s, g in f.assignment)
            lines.append(f"    [{tag}] {named}: {f.n_chips} chip(s), "
                         f"{f.area_mm2:.3f} mm2, {f.power_mw:.3f} mW")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.report()


def tune(spec: DeploymentSpec,
         budget: Optional[TuneBudget] = None, *,
         systems: Sequence[str] = ("memristor", "digital"),
         geometries: Optional[Mapping[str, Sequence[Tuple[int, int]]]]
         = None) -> TunedFabric:
    """Search the design space for the cheapest fabric meeting every
    app's SLO inside ``budget`` (see the module docstring for the
    gates and the cost order). The input spec's per-app ``system`` /
    ``geom`` are treated as defaults to OVERRIDE — the search owns
    them; everything else (params, seeds, lanes, queue limits, noise)
    rides through to the emitted spec untouched.

    Raises ``ValueError`` when no assignment is feasible — with the
    frontier's reasons in the message, so the caller knows which gate
    to relax.
    """
    budget = budget or TuneBudget()
    systems = tuple(normalize_system(s, context="tune")
                    for s in systems)
    geoms = dict(DEFAULT_GEOMETRIES)
    if geometries is not None:
        for sys_name, gs in geometries.items():
            geoms[normalize_system(sys_name, context="tune")] = \
                tuple(tuple(g) for g in gs)

    # 1. cost every per-app point, keep the per-(app, system) Pareto
    #    sets for the cross product
    all_points: List[CandidatePoint] = []
    per_app: Dict[str, List[CandidatePoint]] = {}
    for app in spec.apps:
        options: List[CandidatePoint] = []
        for system in systems:
            pts = [candidate_point(app, system, g,
                                   max_chips=budget.max_chips)
                   for g in geoms[system]]
            all_points.extend(pts)
            options.extend(_pareto([p for p in pts if p.feasible]))
        if not options:
            reasons = "; ".join(
                f"{p.system} {p.geometry}: {p.reason}"
                for p in all_points
                if p.app == app.name and not p.feasible)
            raise ValueError(
                f"tune: no feasible (system, geometry) point for app "
                f"{app.name!r} — {reasons}")
        per_app[app.name] = options

    # 2. assemble every combination, gate against the budget
    names = [a.name for a in spec.apps]
    frontier: List[ComboPoint] = []
    best: Optional[ComboPoint] = None
    best_choice: Optional[Tuple[CandidatePoint, ...]] = None
    for choice in itertools.product(*(per_app[n] for n in names)):
        # apps of one system co-reside on that system's chips: the
        # submesh must carry the largest per-app demand
        chips_per_system: Dict[str, int] = {}
        for p in choice:
            chips_per_system[p.system] = max(
                chips_per_system.get(p.system, 0), p.n_chips)
        n_total = sum(chips_per_system.values())
        area = sum(p.area_mm2 * chips_per_system[p.system]
                   for p in choice)
        power = sum(p.power_mw * chips_per_system[p.system]
                    for p in choice)
        feasible, reason = True, ""
        if budget.max_chips is not None and n_total > budget.max_chips:
            feasible, reason = False, (
                f"over chip budget: {n_total} > {budget.max_chips}")
        elif budget.area_mm2 is not None and area > budget.area_mm2:
            feasible, reason = False, (
                f"over area budget: {area:.3f} > "
                f"{budget.area_mm2:.3f} mm2")
        elif budget.power_mw is not None and power > budget.power_mw:
            feasible, reason = False, (
                f"over power budget: {power:.3f} > "
                f"{budget.power_mw:.3f} mW")
        chip_systems = tuple(
            s for s in sorted(chips_per_system)
            for _ in range(chips_per_system[s]))
        combo = ComboPoint(
            assignment=tuple((p.app, p.system, p.geometry)
                             for p in choice),
            chip_systems=chip_systems, n_chips=n_total,
            area_mm2=area, power_mw=power,
            feasible=feasible, reason=reason)
        frontier.append(combo)
        if feasible and (best is None or
                         combo.cost_key() < best.cost_key()):
            best, best_choice = combo, choice

    if best is None:
        losses = "; ".join(
            f"{'+'.join(s for _, s, _ in f.assignment)}: {f.reason}"
            for f in frontier[:8])
        raise ValueError(
            f"tune: no assignment of {len(names)} app(s) fits the "
            f"budget {budget} — e.g. {losses}")

    frontier = [dataclasses.replace(f, selected=(f is best))
                for f in frontier]
    assignment = {p.app: p for p in best_choice}
    tuned_apps = tuple(
        dataclasses.replace(app, system=assignment[app.name].system,
                            geom=assignment[app.name].geom)
        for app in spec.apps)
    tuned_spec = DeploymentSpec(
        apps=tuned_apps, chip_systems=best.chip_systems,
        queue_limit=spec.queue_limit, use_kernel=spec.use_kernel,
        strict_rate=spec.strict_rate, device=spec.device)
    return TunedFabric(
        spec=tuned_spec, assignment=assignment,
        chip_systems=best.chip_systems, n_chips=best.n_chips,
        area_mm2=best.area_mm2, power_mw=best.power_mw,
        budget=budget, frontier=tuple(frontier),
        candidates=tuple(all_points))
