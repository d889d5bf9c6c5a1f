"""Static 2-D mesh routing for the multicore fabric (paper §II.B, Fig. 4).

Port copy of ``repro.core.routing``: the same plain Python (it imports
no JAX, but ``repro``'s package does, so ``repro_torch`` keeps its
own copy).

Feed-forward neural traffic is deterministic, so the network is a
*statically time-multiplexed* SRAM-programmed switch fabric: every flow
(producer core → consumer core, so-many bits, every iteration) is known
at compile time and the TDM slot table is computed here — the software
analogue of programming the Fig. 4 switch SRAM.

Pipeline stages map to flows: each consumer group's input vector must
arrive from the cores hosting the producer stage. We place the cores of
one pipeline replica on a near-square grid in stage order (producers and
consumers end up adjacent — the same locality argument the paper makes
for distributing DAC/plain cores uniformly), route XY, and accumulate
per-link loads.

Outputs:
  * per-link bits/item → the TDM schedule length per link and the
    routing-limited throughput (a static network forwards LINK_BITS
    per cycle per link);
  * hop-weighted bits → mesh energy (Orion-style pJ/bit/hop constant);
  * TSV bits → 3-D stack input energy [30];
  * a conflict-free slot assignment proving the schedule is realizable.

This model is what `costmodel.py` uses for the routing terms of Tables
II–VI, and `tests/test_routing.py` property-checks its invariants
(conservation, schedule feasibility, deadlock-freedom by construction —
XY routing on a mesh with static slots cannot deadlock).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.mapping import Mapping, MappedCore
from repro_torch.core.neural_core import (CLOCK_HZ, LINK_BITS,
                                          LINK_PJ_PER_BIT, TSV_PJ_PER_BIT)

Coord = Tuple[int, int]
Link = Tuple[Coord, Coord]


@dataclasses.dataclass(frozen=True)
class Flow:
    src: Coord
    dst: Coord
    bits: int          # per item (one inference/iteration)
    stage: int         # consumer stage (TDM phase)


@dataclasses.dataclass
class RouteReport:
    grid: Tuple[int, int]
    flows: List[Flow]
    link_bits: Dict[Link, int]          # per item
    max_link_bits: int
    total_hop_bits: int                 # Σ bits × hops
    tsv_bits: float
    eject_bits: float                   # final outputs to processor buffer
    schedule: Dict[Link, List[Tuple[int, int, int]]]  # (stage, start, nslots)

    @property
    def mesh_energy_pj(self) -> float:
        # +1: ejection into the consumer core's input buffer
        return self.total_hop_bits * LINK_PJ_PER_BIT

    @property
    def tsv_energy_pj(self) -> float:
        return self.tsv_bits * TSV_PJ_PER_BIT

    @property
    def schedule_cycles(self) -> int:
        """TDM frame length: slots needed on the busiest link."""
        return math.ceil(self.max_link_bits / LINK_BITS)

    @property
    def max_items_per_second(self) -> float:
        """Routing-limited rate (links forward LINK_BITS/cycle)."""
        if self.max_link_bits == 0:
            return float("inf")
        return CLOCK_HZ / self.schedule_cycles


def grid_shape(n: int) -> Tuple[int, int]:
    w = max(1, math.ceil(math.sqrt(n)))
    h = math.ceil(n / w)
    return (h, w)


def place(cores: Sequence[MappedCore]) -> List[Coord]:
    """Row-major snake placement in creation (≈ stage) order: successive
    pipeline stages land on adjacent tiles."""
    h, w = grid_shape(len(cores))
    coords: List[Coord] = []
    for i in range(len(cores)):
        r, c = divmod(i, w)
        coords.append((r, c if r % 2 == 0 else w - 1 - c))
    return coords


def xy_route(src: Coord, dst: Coord) -> List[Link]:
    """Dimension-ordered (X then Y) routing — deadlock-free on a mesh."""
    links: List[Link] = []
    r, c = src
    while c != dst[1]:
        nc = c + (1 if dst[1] > c else -1)
        links.append(((r, c), (r, nc)))
        c = nc
    while r != dst[0]:
        nr = r + (1 if dst[0] > r else -1)
        links.append(((r, c), (nr, c)))
        r = nr
    return links


def build_flows(mapping: Mapping) -> Tuple[List[Flow], List[Coord],
                                           float, float]:
    """Derive the flow set of one pipeline replica.

    Each consumer group of stage s pulls its input vector from the cores
    hosting stage s−1 groups, split proportionally to producer columns
    (outputs). Stage-0 input arrives via TSV; the final stage ejects to
    the processor-facing buffer at grid corner (0, 0) (§II.C).
    """
    coords = place(mapping.cores)
    # producers by stage: (core index, neuron outputs in that stage)
    by_stage: Dict[int, List[Tuple[int, int]]] = {}
    out_bits = 1 if mapping.system == "memristor" else 8
    for ci, core in enumerate(mapping.cores):
        for g in core.groups:
            by_stage.setdefault(g.stage, []).append((ci, g.cols))
    flows: List[Flow] = []
    tsv_bits = 0.0
    last_stage = max(by_stage) if by_stage else 0
    for ci, core in enumerate(mapping.cores):
        for g in core.groups:
            if g.first_layer:
                tsv_bits += g.rows * 8
                continue
            producers = by_stage.get(g.stage - 1, [])
            total_cols = sum(p[1] for p in producers) or 1
            need = g.rows * g.in_bits
            for pi, pcols in producers:
                bits = math.ceil(need * pcols / total_cols)
                if pi == ci or bits == 0:
                    continue  # self-loopback through the local switch
                flows.append(Flow(coords[pi], coords[ci], bits, g.stage))
    # ejection of final outputs to the processor buffer
    eject_bits = sum(cols for _, cols in by_stage.get(last_stage, ())) \
        * out_bits
    for pi, pcols in by_stage.get(last_stage, ()):
        flows.append(Flow(coords[pi], (0, 0),
                          pcols * out_bits, last_stage + 1))
    return flows, coords, tsv_bits, float(eject_bits)


def route(mapping: Mapping) -> RouteReport:
    flows, coords, tsv_bits, eject_bits = build_flows(mapping)
    link_bits: Dict[Link, int] = {}
    total_hop_bits = 0
    for f in flows:
        links = xy_route(f.src, f.dst)
        total_hop_bits += f.bits * (len(links) + 1)  # +1 local ejection
        for l in links:
            link_bits[l] = link_bits.get(l, 0) + f.bits
    # static TDM slot assignment: per link, stage-ordered, first free slot
    schedule: Dict[Link, List[Tuple[int, int, int]]] = {}
    cursor: Dict[Link, int] = {}
    for f in sorted(flows, key=lambda f: (f.stage, f.src, f.dst)):
        slots = math.ceil(f.bits / LINK_BITS)
        for l in xy_route(f.src, f.dst):
            start = cursor.get(l, 0)
            schedule.setdefault(l, []).append((f.stage, start, slots))
            cursor[l] = start + slots
    return RouteReport(
        grid=grid_shape(len(mapping.cores)),
        flows=flows,
        link_bits=link_bits,
        max_link_bits=max(link_bits.values(), default=0),
        total_hop_bits=total_hop_bits,
        tsv_bits=tsv_bits,
        eject_bits=eject_bits,
        schedule=schedule,
    )
