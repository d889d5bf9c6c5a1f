"""The paper's own five streaming applications (section IV.B).

Port copy of ``repro.configs.paper_apps``: the same plain Python (it
imports no JAX, but ``repro.configs`` pulls in the LM configs, so
``repro_torch`` keeps its own copy).

Each application is a set of MLP topologies per system type (the paper
uses different network decompositions for the memristor vs SRAM systems
because the memristor cores emit 1-bit threshold outputs and therefore
need parallel networks to form multi-bit outputs), plus the real-time
throughput requirement from section V.C.

``networks`` entries are (replication, layer_dims) — e.g. the motion
application's ``64(2→1)`` stage is ``(64, (2, 1))``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.systems import normalize_system

Net = Tuple[int, Tuple[int, ...]]  # (instances, layer dims)


@dataclass(frozen=True)
class AppConfig:
    name: str
    # networks per system type
    memristor_nets: Tuple[Net, ...]
    sram_nets: Tuple[Net, ...]
    # RISC implementation: ops per input item (calibrated, see costmodel)
    risc_algorithmic: bool  # True → RISC runs the classic algorithm, not a NN
    # real-time workload
    items_per_second: float        # required classifications / pixels / frames
    inputs_per_item: int           # input vector component count per item
    description: str = ""
    # which networks read the sensor directly (True) vs. cascade from the
    # outputs of earlier networks (False). Defaults to all-sensor.
    memristor_sensor: Tuple[bool, ...] = ()
    sram_sensor: Tuple[bool, ...] = ()
    # per-net producer indices for cascaded nets (None → each cascaded
    # net depends on every preceding net)
    memristor_deps: Optional[Tuple[Tuple[int, ...], ...]] = None
    sram_deps: Optional[Tuple[Tuple[int, ...], ...]] = None
    # RISC cycles per item for algorithmic implementations — SimpleScalar
    # measurements are not reproducible offline, so these are calibrated
    # from the paper's published core counts (Tables III-IV):
    # cores × 1 GHz / items_per_second.
    risc_cycles_per_item: Optional[float] = None
    # unique sensor bits crossing the TSV per item. Defaults to
    # inputs_per_item × 8; sliding-window apps override it because each
    # pixel crosses the 3-D stack once even though overlapping windows
    # reuse it many times (edge: 1 new pixel per output pixel).
    sensor_bits_per_item: Optional[float] = None

    @property
    def tsv_bits_per_item(self) -> float:
        return self.sensor_bits_per_item if self.sensor_bits_per_item \
            is not None else self.inputs_per_item * 8.0

    def nets(self, system: str) -> Tuple[Net, ...]:
        """The app's network decomposition for a system (any alias)."""
        return self.memristor_nets \
            if normalize_system(system) == "memristor" else self.sram_nets

    def sensor_flags(self, system: str) -> Tuple[bool, ...]:
        system = normalize_system(system)
        nets = self.memristor_nets if system == "memristor" else self.sram_nets
        flags = self.memristor_sensor if system == "memristor" \
            else self.sram_sensor
        return flags if flags else (True,) * len(nets)

    def net_deps(self, system: str):
        return self.memristor_deps \
            if normalize_system(system) == "memristor" else self.sram_deps


# -- real-time requirements (section V.C) ------------------------------- #
_CHARS_PER_S = 100_000.0
_FRAME_W, _FRAME_H, _FPS = 1280, 1080, 60.0
_PIXELS_PER_S = _FRAME_W * _FRAME_H * _FPS


APPS: Dict[str, AppConfig] = {
    "edge": AppConfig(
        name="edge",
        memristor_nets=(
            (1, (9, 20, 15)),
            (1, (24, 20, 15)),
            (1, (15, 10, 4)),
            (1, (15, 10, 4)),
        ),
        sram_nets=((1, (9, 20, 1)),),
        risc_algorithmic=True,
        items_per_second=_PIXELS_PER_S,  # one output pixel per input pixel
        inputs_per_item=9,               # 3x3 Sobel window
        description="Sobel edge detection, 1280x1080@60fps",
        # the two (15,...) nets combine the first two nets' outputs into
        # the multi-bit result — they are cascaded, not sensor-facing
        memristor_sensor=(True, True, False, False),
        # the two combiner nets run in parallel, each on one sensor net
        memristor_deps=((), (), (0, 1), (0, 1)),
        risc_cycles_per_item=240e9 / _PIXELS_PER_S,   # Sobel, measured
        sensor_bits_per_item=8.0,   # one new pixel per 3x3 window step
    ),
    "motion": AppConfig(
        name="motion",
        memristor_nets=(
            (64, (2, 1)),
            (1, (64, 10)),
            (1, (20, 10)),
        ),
        sram_nets=(
            (64, (2, 1)),
            (1, (64, 1)),
            (1, (2, 1)),
        ),
        risc_algorithmic=True,
        # one motion estimate per 8x8 grid cell, two frames compared
        items_per_second=_PIXELS_PER_S / 64.0,
        inputs_per_item=128,  # 8x8 from each of two frames
        description="Motion estimation in 5% increments, 1280x1080@60fps",
        # stage-2/3 nets aggregate the per-pixel-pair nets' outputs
        memristor_sensor=(True, False, False),
        sram_sensor=(True, False, False),
        risc_cycles_per_item=7e9 / (_PIXELS_PER_S / 64.0),  # measured
        sensor_bits_per_item=64 * 8.0,  # one new frame's 8x8 grid/item
    ),
    "deep": AppConfig(
        name="deep",
        memristor_nets=((1, (784, 200, 100, 10)),),
        sram_nets=((1, (784, 200, 100, 10)),),
        risc_algorithmic=False,
        items_per_second=_CHARS_PER_S,
        inputs_per_item=784,
        description="MNIST deep network, 100k characters/s",
    ),
    "object": AppConfig(
        name="object",
        memristor_nets=((1, (3072, 100, 10)),),
        sram_nets=((1, (3072, 100, 10)),),
        risc_algorithmic=False,
        items_per_second=_CHARS_PER_S,
        inputs_per_item=3072,
        description="CIFAR-10 object recognition, 100k items/s",
    ),
    "ocr": AppConfig(
        name="ocr",
        memristor_nets=((1, (2500, 60, 26)),),
        sram_nets=((1, (2500, 60, 26)),),
        risc_algorithmic=False,
        items_per_second=_CHARS_PER_S,
        inputs_per_item=2500,
        description="Chars74K OCR (50x50 subsampled), 100k characters/s",
    ),
}

# Paper's published results (Tables II-VI) for validation.
# (cores, area_mm2, power_mW) per system.
PAPER_TABLES: Dict[str, Dict[str, Tuple[int, float, float]]] = {
    "deep":   {"risc": (902, 472.65, 78_474.0), "digital": (9, 1.88, 82.40),
               "1t1m": (31, 0.25, 0.42)},
    "edge":   {"risc": (240, 125.76, 20_880.0), "digital": (18, 3.75, 433.16),
               "1t1m": (16, 0.13, 1.41)},
    "motion": {"risc": (7, 3.67, 609.0), "digital": (2, 0.42, 42.57),
               "1t1m": (2, 0.02, 0.11)},
    "object": {"risc": (1358, 711.59, 118_146.0),
               "digital": (17, 3.54, 148.55), "1t1m": (68, 0.56, 0.94)},
    "ocr":    {"risc": (825, 432.30, 71_775.0), "digital": (13, 2.71, 119.08),
               "1t1m": (31, 0.25, 0.49)},
}

# Paper Table I core-level constants (the calibration anchors).
PAPER_TABLE_I = {
    "risc":    {"area_mm2": 0.524, "power_mw": 87.0, "leak_mw": 54.0,
                "time_s": 3.97e-5, "note": "1 neuron, 784 synapse"},
    "digital": {"area_mm2": 0.208, "power_mw": 24.2, "leak_mw": 6.94,
                "time_s": 1.28e-6, "note": "128 neuron, 256 synapse/neuron"},
    "1t1m":    {"area_mm2": 0.0082, "power_mw": 0.0888, "leak_mw": 0.0118,
                "time_s": 9e-8, "note": "64 neuron, 128 synapse/neuron"},
}
