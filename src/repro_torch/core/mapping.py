"""NN → neural-core mapping compiler (paper §IV.C, Fig. 11).

Port copy of ``repro.core.mapping``: the same plain Python (it imports
no JAX, but ``repro``'s package does, so ``repro_torch`` keeps its
own copy).

The neural hardware cannot time-multiplex neurons (weights live in the
cores), so network structure is *compiled* onto fixed-geometry cores:

  * a layer with more outputs than core columns splits by outputs
    (trivial — fragments share the input rows);
  * a layer with more inputs than core rows splits each neuron into
    sub-neurons plus a combining neuron (Fig. 11) — the combiner is a
    real neuron with its *own* per-neuron fan-in, so the topology
    changes and ex-situ training happens *after* mapping;
  * small units pack together: same-stage units sit block-diagonally
    (rows add) and evaluate in one crossbar step when their rows fit;
    otherwise the core time-multiplexes groups through the routing
    switch's self-loopback (Fig. 4), executing serially per item;
  * first-layer units receive 8-bit sensor data through the TSV stack
    and live in DAC-equipped cores (Fig. 8); DAC and plain cores are
    disjoint populations distributed uniformly over the chip (§III.C);
  * the mapped pipeline is replicated until it meets the application's
    real-time rate (§V.C).

Units are emitted at natural granularity — one per network instance,
per input chunk, per combiner neuron — so the packer only ever reasons
about blocks whose neurons share one input vector. This pass produces
(a) the core inventory for the cost model, (b) per-core busy time for
duty-cycle power, (c) the traffic matrix for the static router, and
(d) the tile table that ``crossbar_layer`` executes functionally.

Validation against the paper's published core counts (Tables II–VI):
deep 1T1M 31✓, edge 1T1M 16✓ (throughput replication ×8), motion 1T1M
2✓, deep digital 9✓, motion digital 2✓ — see benchmarks/tables.py for
the full comparison including the two cells where our packer needs
*fewer* cores than published (ocr, object; discussed in EXPERIMENTS.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.neural_core import (CYCLE_S, CROSSBAR_EVAL_CYCLES,
                                          CoreGeometry, DigitalCore,
                                          LINK_BITS, MemristorCore)

Net = Tuple[int, Tuple[int, ...]]  # (instances, layer dims)


# --------------------------------------------------------------------- #
# units: post-splitting mappable blocks
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Unit:
    """A block of neurons that share one input vector (rows ≤ core rows)."""
    name: str
    stage: int            # pipeline depth (0 = sensor-facing)
    rows: int             # shared inputs of the block
    cols: int             # neurons in the block
    in_bits: int          # input precision arriving over the mesh
    first_layer: bool     # sensor inputs via TSV (DAC core, memristor)
    kind: str = "layer"   # layer | sub | combiner

    @property
    def synapses(self) -> int:
        return self.rows * self.cols


def split_network(dims: Sequence[int], geom: CoreGeometry, *,
                  system: str, instances: int = 1,
                  name: str = "net", sensor: bool = True,
                  stage_offset: int = 0) -> List[Unit]:
    """Expand one MLP topology into mappable units with Fig.11 splitting.

    ``system`` is 'memristor' (1-bit threshold hidden traffic) or
    'digital' (8-bit LUT traffic). Splitting recurses: a combiner whose
    fan-in still exceeds the core rows is split again. Instanced nets
    (the paper's ``64(2→1)`` notation) emit one unit per instance so the
    packer can lay them out block-diagonally. ``sensor=False`` marks a
    cascaded network whose first layer reads other networks' outputs
    over the mesh rather than the TSV sensor interface.
    """
    hidden_bits = 1 if system == "memristor" else 8
    units: List[Unit] = []
    for inst in range(instances):
        iname = f"{name}.i{inst}" if instances > 1 else name
        stage = stage_offset
        for li in range(len(dims) - 1):
            n_in, n_out = dims[li], dims[li + 1]
            first = li == 0 and sensor
            in_bits = 8 if first else hidden_bits
            fan_in, depth = n_in, 0
            while fan_in > geom.rows:
                chunks = math.ceil(fan_in / geom.rows)
                rows = math.ceil(fan_in / chunks)
                # one unit per input chunk: each chunk's sub-neurons
                # share that chunk's input slice (Fig. 11 lower level)
                for c in range(chunks):
                    r = min(rows, fan_in - c * rows)
                    units.append(Unit(f"{iname}.L{li}.s{depth}.k{c}",
                                      stage, r, n_out, in_bits,
                                      first and depth == 0, "sub"))
                stage += 1
                # the combiner level: every output neuron privately owns
                # its `chunks` partials → one 1-column unit per neuron
                fan_in, in_bits, depth = chunks, hidden_bits, depth + 1
                if fan_in <= geom.rows:
                    for j in range(n_out):
                        units.append(Unit(f"{iname}.L{li}.c{depth}.n{j}",
                                          stage, fan_in, 1, in_bits,
                                          False, "combiner"))
                    stage += 1
                    fan_in = -1  # handled; skip the dense emit below
            if fan_in >= 0:
                units.append(Unit(f"{iname}.L{li}", stage, fan_in, n_out,
                                  in_bits, first, "layer"))
                stage += 1
    return units


def network_depth(dims: Sequence[int], geom: CoreGeometry) -> int:
    """Pipeline stages a topology occupies after Fig.11 splitting."""
    depth = 0
    for li in range(len(dims) - 1):
        fan_in = dims[li]
        while fan_in > geom.rows:
            depth += 1                       # sub-neuron level
            fan_in = math.ceil(fan_in / geom.rows)
        depth += 1                           # dense / combiner level
    return depth


def split_networks(nets: Sequence[Net], geom: CoreGeometry, *,
                   system: str,
                   sensor_flags: Optional[Sequence[bool]] = None,
                   deps: Optional[Sequence[Sequence[int]]] = None
                   ) -> List[Unit]:
    """Split a set of (possibly cascaded) networks.

    ``deps[i]`` lists the nets whose outputs net ``i`` consumes; a
    cascaded net starts at the stage where its deepest producer ends, so
    the packer's same-stage joins respect the pipeline dataflow.
    Default: sensor nets have no deps; each cascaded net depends on every
    preceding net (matches the paper's app descriptions).
    """
    if sensor_flags is None:
        sensor_flags = [True] * len(nets)
    if deps is None:
        deps = [() if sensor_flags[i] else tuple(range(i))
                for i in range(len(nets))]
    depths = [network_depth(dims, geom) for _, dims in nets]
    offsets: List[int] = []
    for i in range(len(nets)):
        offsets.append(0 if sensor_flags[i] else
                       max((offsets[d] + depths[d] for d in deps[i]),
                           default=0))
    units: List[Unit] = []
    for i, (instances, dims) in enumerate(nets):
        units += split_network(dims, geom, system=system,
                               instances=instances, name=f"n{i}",
                               sensor=sensor_flags[i],
                               stage_offset=offsets[i])
    return units


# --------------------------------------------------------------------- #
# packing
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Group:
    """Units evaluated in one crossbar step (block-diagonal, same stage,
    rows add; all members' neurons fire in the same analog evaluation).
    ``syn`` is the *programmed* synapse count — block-diagonal packing
    leaves the off-diagonal devices at G_OFF, so syn < rows·cols once a
    group has more than one member."""
    stage: int
    rows: int
    cols: int
    in_bits: int
    first_layer: bool
    members: List[str]
    syn: int = 0


@dataclasses.dataclass
class MappedCore:
    kind: str                     # "dac" | "plain"
    geom: CoreGeometry
    groups: List[Group]

    @property
    def used_cols(self) -> int:
        return sum(g.cols for g in self.groups)

    @property
    def used_synapses(self) -> int:
        return sum(g.syn for g in self.groups)

    def busy_cycles(self, system: str) -> int:
        """Serial time-multiplexed evaluation of all groups per item."""
        total = 0
        for g in self.groups:
            if system == "memristor":
                # stage-0 inputs arrive via TSV (not the 8-bit mesh link)
                stream = 0 if g.first_layer else \
                    math.ceil(g.rows * g.in_bits / LINK_BITS)
                total += stream + CROSSBAR_EVAL_CYCLES
            else:
                # digital: one input component per cycle from the input
                # buffer; serial 8-bit output streaming overlaps the next
                # pattern (§II.A) → stage is max of the two streams.
                total += max(g.rows, g.cols)
        return total


def pack(units: Sequence[Unit], geom: CoreGeometry, *,
         system: str) -> List[MappedCore]:
    """First-fit packing of (column-fragmentable) units into cores."""
    cores: List[MappedCore] = []
    # open-core index per kind to keep first-fit from rescanning
    open_cores: Dict[str, List[MappedCore]] = {"dac": [], "plain": []}
    order = sorted(units, key=lambda u: (u.stage, -u.rows, u.name))
    for u in order:
        kind = "dac" if (system == "memristor" and u.first_layer) \
            else "plain"
        remaining = u.cols
        for c in open_cores[kind]:
            if remaining == 0:
                break
            free = geom.cols - c.used_cols
            if free <= 0:
                continue
            joined = False
            for g in c.groups:
                # block-diagonal join: same pipeline stage, rows fit
                if g.stage == u.stage and g.in_bits == u.in_bits and \
                        g.first_layer == u.first_layer and \
                        g.rows + u.rows <= geom.rows:
                    take = min(free, remaining)
                    g.rows += u.rows
                    g.cols += take
                    g.syn += u.rows * take
                    g.members.append(u.name)
                    remaining -= take
                    joined = True
                    break
            if not joined:
                take = min(free, remaining)
                c.groups.append(Group(u.stage, u.rows, take, u.in_bits,
                                      u.first_layer, [u.name],
                                      syn=u.rows * take))
                remaining -= take
        while remaining > 0:
            take = min(geom.cols, remaining)
            core = MappedCore(kind, geom,
                              [Group(u.stage, u.rows, take, u.in_bits,
                                     u.first_layer, [u.name],
                                     syn=u.rows * take)])
            cores.append(core)
            open_cores[kind].append(core)
            remaining -= take
        # retire full cores
        open_cores[kind] = [c for c in open_cores[kind]
                            if c.used_cols < geom.cols]
    return cores


# --------------------------------------------------------------------- #
# full mapping result
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Mapping:
    system: str                    # memristor | digital
    geom: CoreGeometry
    units: List[Unit]
    cores: List[MappedCore]        # one pipeline replica
    replication: int
    pipeline_cycles: int           # bottleneck core cycles per item
    items_per_second_capacity: float  # of one replica

    @property
    def cores_per_replica(self) -> int:
        return len(self.cores)

    @property
    def total_cores(self) -> int:
        return len(self.cores) * self.replication

    @property
    def n_dac_cores(self) -> int:
        return sum(1 for c in self.cores if c.kind == "dac") \
            * self.replication

    @property
    def utilization(self) -> float:
        used = sum(c.used_synapses for c in self.cores)
        return used / max(len(self.cores) * self.geom.synapses, 1)

    def busy_seconds_per_item(self) -> float:
        """Σ over cores of serial busy time — drives duty-cycle power."""
        return sum(c.busy_cycles(self.system) for c in self.cores) * CYCLE_S

    def mesh_bits_per_item(self) -> float:
        """Bits entering cores over the mesh per item (pre-hop-count);
        the static router turns this into per-link schedules."""
        bits = 0.0
        for c in self.cores:
            for g in c.groups:
                if not g.first_layer:
                    bits += g.rows * g.in_bits
        return bits

    def tsv_bits_per_item(self) -> float:
        bits = 0.0
        for c in self.cores:
            for g in c.groups:
                if g.first_layer:
                    bits += g.rows * 8  # 8-bit sensor samples
        return bits


def map_networks(nets: Sequence[Net], *, system: str,
                 geom: Optional[CoreGeometry] = None,
                 items_per_second: float = 0.0,
                 sensor_flags: Optional[Sequence[bool]] = None,
                 deps: Optional[Sequence[Sequence[int]]] = None) -> Mapping:
    """The end-to-end §IV.C pass: split → pack → replicate."""
    if geom is None:
        geom = MemristorCore().geom if system == "memristor" \
            else DigitalCore().geom
    units = split_networks(nets, geom, system=system,
                           sensor_flags=sensor_flags, deps=deps)
    cores = pack(units, geom, system=system)
    bottleneck = max((c.busy_cycles(system) for c in cores), default=1)
    rate = 1.0 / (bottleneck * CYCLE_S)
    replication = max(1, math.ceil(items_per_second / rate)) \
        if items_per_second else 1
    return Mapping(system, geom, units, cores, replication, bottleneck,
                   rate)


def risc_cores_needed(macs_per_item: float, items_per_second: float,
                      *, cycles_per_op: Optional[float] = None) -> int:
    """RISC replica count for the same real-time load (§V.C)."""
    from repro_torch.core.neural_core import RiscCore
    risc = RiscCore()
    cpo = cycles_per_op if cycles_per_op is not None else risc.cycles_per_mac
    cycles_per_item = macs_per_item * cpo
    rate_per_core = risc.clock_hz / cycles_per_item
    return max(1, math.ceil(items_per_second / rate_per_core))


def nn_macs(nets: Sequence[Net]) -> int:
    """MAC count of the float networks (the RISC implementation)."""
    total = 0
    for instances, dims in nets:
        total += instances * sum(dims[i] * dims[i + 1]
                                 for i in range(len(dims) - 1))
    return total
