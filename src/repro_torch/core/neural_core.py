"""Neural core models: geometry, timing, area, power (paper §II, §III, Table I).

Port copy of ``repro.core.neural_core``: the same plain Python (it imports
no JAX, but ``repro``'s package does, so ``repro_torch`` keeps its
own copy).

Three core types, each an analytic model calibrated so that the paper's
published geometry reproduces Table I exactly:

  RISC     0.524 mm², 87 mW (54 leak), 1 GHz; 3.97e-5 s for one
           784-synapse neuron  →  50.6 cycles per MAC.
  Digital  SRAM 256×128 synapses: 0.208 mm², 24.2 mW (6.94 leak),
           200 MHz; 1.28e-6 s per input vector — exactly 256 cycles:
           one input component per cycle, all neurons MAC in parallel,
           output routing overlapped (§II.A).
  1T1M     memristor 128×64: 0.0082 mm², 0.0888 mW (0.0118 leak);
           9e-8 s — exactly 18 cycles at 200 MHz: 16 cycles to stream
           128 one-bit threshold inputs over the 8-bit link + 2 cycles
           (10 ns) of crossbar evaluation (§IV.D).

Geometry scaling (for the Fig. 13/14 design-space exploration) splits
each anchor into a fixed part (control FSM, buffers, LUT/activation)
and a part proportional to the synapse array / peripheral count, with
the proportions taken from the paper's own observations (LUT = 1% area,
0.3% power of a 256×128 digital core; leakage dominated by the SRAM
array; crossbar area dominated by 1T1M cells).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

CLOCK_HZ = 200e6            # specialized cores' routing/exec clock (§IV.D)
CYCLE_S = 1.0 / CLOCK_HZ
LINK_BITS = 8               # on-chip network bus width (Fig. 4)
RISC_CLOCK_HZ = 1e9
CROSSBAR_EVAL_S = 10e-9     # analog evaluation time (SPICE, §IV.D)
CROSSBAR_EVAL_CYCLES = 2    # = 10 ns at 200 MHz
TSV_PJ_PER_BIT = 0.05       # 3-D stack IO energy [30]
# Orion-derived mesh link+switch energy at 45 nm (per bit per hop) for
# the short static-switched segments of Fig. 4; the routing fabric runs
# at the same 200 MHz clock. 0.05 pJ/bit/hop is the low-swing static-
# switch figure consistent with the paper's system powers (§V.C).
LINK_PJ_PER_BIT = 0.05


@dataclasses.dataclass(frozen=True)
class CoreGeometry:
    rows: int   # inputs (synapses per neuron)
    cols: int   # neurons

    @property
    def synapses(self) -> int:
        return self.rows * self.cols


DIGITAL_GEOM = CoreGeometry(256, 128)   # paper's optimum (§V.B)
MEMRISTOR_GEOM = CoreGeometry(128, 64)  # paper's optimum (§V.B)


# --------------------------------------------------------------------- #
# RISC baseline (Table I; McPAT + SimpleScalar constants)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RiscCore:
    area_mm2: float = 0.524
    power_mw: float = 87.0
    leak_mw: float = 54.0
    clock_hz: float = RISC_CLOCK_HZ
    # 3.97e-5 s × 1 GHz / 784 synapses  →  cycles per MAC including
    # load/activation overhead (Table I row 1).
    cycles_per_mac: float = 3.97e-5 * RISC_CLOCK_HZ / 784.0

    def nn_time_s(self, macs: int) -> float:
        return macs * self.cycles_per_mac / self.clock_hz

    def time_s(self, ops: int, cycles_per_op: float) -> float:
        """Algorithmic (non-NN) implementations — edge/motion (§V.C)."""
        return ops * cycles_per_op / self.clock_hz


# --------------------------------------------------------------------- #
# SRAM digital neural core (§II.A)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DigitalCore:
    geom: CoreGeometry = DIGITAL_GEOM
    weight_bits: int = 8
    io_bits: int = 8

    # Table I anchors at 256×128
    _A0: float = 0.208      # mm²
    _P0: float = 24.2       # mW total (while active)
    _L0: float = 6.94       # mW leakage

    # fixed-vs-array split: LUT+control+buffers+MAC datapath ≈ 12% of
    # area / 20% of active power at the anchor geometry; the rest scales
    # with the synapse array (CACTI-style linear-in-bits model).
    _FIX_AREA: float = 0.12
    _FIX_POWER: float = 0.20
    _FIX_LEAK: float = 0.08

    def area_mm2(self) -> float:
        s = self.geom.synapses / DIGITAL_GEOM.synapses
        return self._A0 * (self._FIX_AREA + (1 - self._FIX_AREA) * s)

    def power_mw(self) -> float:
        s = self.geom.synapses / DIGITAL_GEOM.synapses
        return self._P0 * (self._FIX_POWER + (1 - self._FIX_POWER) * s)

    def leak_mw(self) -> float:
        s = self.geom.synapses / DIGITAL_GEOM.synapses
        return self._L0 * (self._FIX_LEAK + (1 - self._FIX_LEAK) * s)

    def layer_cycles(self, n_inputs: int, n_outputs: int) -> int:
        """One layer evaluation: inputs stream one component/cycle;
        serial 8-bit output routing of the *previous* pattern overlaps
        (§II.A), so the stage is bounded by max(read, write) streams."""
        in_c = n_inputs * self.io_bits // self.io_bits       # = n_inputs
        out_c = n_outputs * self.io_bits // LINK_BITS        # serial out
        return max(in_c, out_c)

    def layer_time_s(self, n_inputs: int, n_outputs: int) -> float:
        return self.layer_cycles(n_inputs, n_outputs) * CYCLE_S

    def vector_time_s(self) -> float:
        """Full-array evaluation (Table I row 2): rows cycles."""
        return self.geom.rows * CYCLE_S


# --------------------------------------------------------------------- #
# 1T1M memristor neural core (§III)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MemristorCore:
    geom: CoreGeometry = MEMRISTOR_GEOM
    has_dac: bool = False    # first-layer cores carry DACs (Fig. 8)
    out_bits: int = 1        # threshold activation → 1-bit outputs

    # Table I anchors at 128×64
    _A0: float = 0.0082     # mm²
    _P0: float = 0.0888     # mW (during evaluation)
    _L0: float = 0.0118     # mW

    # crossbar cells + drivers dominate; control/buffers are the fixed
    # slice. DACs add ~35% area and ~50% active power to a first-layer
    # core (8-bit DAC per row vs. a simple ±V driver).
    _FIX_AREA: float = 0.18
    _FIX_POWER: float = 0.25
    _FIX_LEAK: float = 0.30
    _DAC_AREA: float = 0.35
    _DAC_POWER: float = 0.50

    def area_mm2(self) -> float:
        s = self.geom.synapses / MEMRISTOR_GEOM.synapses
        a = self._A0 * (self._FIX_AREA + (1 - self._FIX_AREA) * s)
        if self.has_dac:
            a *= 1.0 + self._DAC_AREA * self.geom.rows / MEMRISTOR_GEOM.rows
        return a

    def power_mw(self) -> float:
        s = self.geom.synapses / MEMRISTOR_GEOM.synapses
        p = self._P0 * (self._FIX_POWER + (1 - self._FIX_POWER) * s)
        if self.has_dac:
            p *= 1.0 + self._DAC_POWER * self.geom.rows / MEMRISTOR_GEOM.rows
        return p

    def leak_mw(self) -> float:
        """Non-volatile crossbar → near-zero static draw when idle; this
        is the *active-state* leakage (Table I row 3)."""
        s = self.geom.synapses / MEMRISTOR_GEOM.synapses
        return self._L0 * (self._FIX_LEAK + (1 - self._FIX_LEAK) * s)

    def layer_cycles(self, n_inputs: int, in_bits: int = 1) -> int:
        """Input streaming over the 8-bit link + 2-cycle crossbar eval.
        Table I row 3: 128 one-bit inputs → 16 + 2 = 18 cycles = 90 ns."""
        in_c = math.ceil(n_inputs * in_bits / LINK_BITS)
        return in_c + CROSSBAR_EVAL_CYCLES

    def layer_time_s(self, n_inputs: int, in_bits: int = 1) -> float:
        return self.layer_cycles(n_inputs, in_bits) * CYCLE_S


def analog_precision_feasible(geom: CoreGeometry, *, bits: int = 8,
                              r_seg: float = 2.5,
                              g_on: float = 8e-6) -> bool:
    """Wire-IR-drop precision bound on analog crossbar size.

    The worst-placed device sees ≈ r_seg·(rows+cols) of series wire; the
    induced relative weight distortion g_on·R_path must stay within half
    an LSB of the target precision, or the crossbar cannot realize 8-bit
    synapses no matter how carefully it is programmed (this is the
    SPICE-observed effect behind the paper's Fig. 13 optimum):

        g_on · r_seg · (rows+cols)  ≤  0.5 / (2^(bits-1) − 1)

    With the published device (8 µS) and 2.5 Ω/segment wire this admits
    rows+cols ≤ 196 — exactly the paper's 128×64 pick, and excludes
    256×128 and larger.
    """
    half_lsb = 0.5 / (2 ** (bits - 1) - 1)
    return g_on * r_seg * (geom.rows + geom.cols) <= half_lsb


# --------------------------------------------------------------------- #
# Table I reproduction (anchors → the published table)
# --------------------------------------------------------------------- #
def table1() -> Dict[str, Dict[str, float]]:
    risc = RiscCore()
    dig = DigitalCore()
    mem = MemristorCore()
    return {
        "risc": {"area_mm2": risc.area_mm2, "power_mw": risc.power_mw,
                 "leak_mw": risc.leak_mw,
                 "time_s": risc.nn_time_s(784)},
        "digital": {"area_mm2": dig.area_mm2(), "power_mw": dig.power_mw(),
                    "leak_mw": dig.leak_mw(),
                    "time_s": dig.vector_time_s()},
        "1t1m": {"area_mm2": mem.area_mm2(), "power_mw": mem.power_mw(),
                 "leak_mw": mem.leak_mw(),
                 "time_s": mem.layer_time_s(128, in_bits=1)},
    }
