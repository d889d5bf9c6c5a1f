"""Run one cell of ``BENCHMARK.json`` and print its result line.

A run: the configuration's reference (``references/``) draws the float
weights from the seed on the card; the program (``programs/``) is built
from them; the mix's generator (``generators/``) makes its inputs from
the seed and warms up every shape it uses; the window runs for
``--seconds``, under the profiler with ``--trace 1``; the peak memory is
read and the program freed; the reference works out its answers from
the same weights and inputs, and the configuration's judge
(``judges/``) holds the outputs the window kept to them; the readers in
``metrics/`` make the cell's end-to-end (``--trace 0``) or per-layer
(``--trace 1``) metrics. Whatever belongs to one configuration, mix or
metric lives in those files, so a new one needs no edit here. The last line of standard output is the result
object; the last lines of standard error give each number compared
beside its limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

from portbench import devtrace, sensor

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level modules a run must not have loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# purpose separator of the weight draw in the stream mix
_FOLD_WEIGHTS = 0x3E16
# rows of a reference block
REF_BLOCK = 16384


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in file ``path``, found by name, loaded once."""
    name = "portbench_{}_{}".format(
        path.parent.name, path.stem.replace("-", "_").replace(".", "_"))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of the benchmark and everything it names."""
    bench: dict
    workload: dict
    config: dict
    mix: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> List[dict]:
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]


def load_cell(workload: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(bench, w, load_json(ROOT / conf["file"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"))


def reference(config: dict):
    return load_module(HERE / "references" / f"{config['reference']}.py")


def make_params(config: dict, seed: int, device) -> list:
    """The weights both sides get, drawn on ``device`` from the seed by
    the configuration's reference."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(
        sensor.stream_seed(seed, _FOLD_WEIGHTS))
    return reference(config).make_params(config, gen, dev)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    config: dict
    batch: int
    window: object
    setup_s: float
    trace: Optional[devtrace.TraceSummary]
    enqueue: Optional[List[float]]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_outputs(cell: Cell, params, inputs: dict, **control
                      ) -> dict:
    """The reference's answers for every input (``control``: the
    configuration's lower precision), in blocks of ``REF_BLOCK`` rows,
    with TF32 off for the card's f32 products."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return reference(cell.config).outputs(
            cell.config, params, inputs, block=REF_BLOCK, **control)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _power_limit() -> object:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return "not measured"


def judge(config: dict):
    return load_module(HERE / "judges" / f"{config['check']['judge']}.py")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t0: Optional[float] = None,
             batch: Optional[int] = None,
             wrap: Optional[Callable] = None) -> dict:
    """Run ``cell`` once and return its result object. ``batch``
    overrides the mix's batch size and ``wrap`` replaces the program's
    call by ``wrap(call)``: both for the CPU tests only."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cfg = cell.config
    program = load_module(HERE / "programs" / f"{cfg['program']}.py")
    gen = load_module(HERE / "generators" / f"{cell.mix['generator']}.py")
    params = make_params(cfg, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    call = program.build(cfg, params, dev)
    if wrap is not None:
        call = wrap(call)
    traffic = gen.Traffic(cell.mix, seed, dev, cfg, batch=batch)
    traffic.warm(call)
    enqueue = traffic.enqueue_bursts(call) if trace else None
    _sync(dev)
    setup_s = time.perf_counter() - t0
    summary = None
    if trace:
        win, summary = devtrace.capture(
            lambda: traffic.window(call, seconds))
    else:
        win = traffic.window(call, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    del call
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    refs = reference_outputs(cell, params, traffic.reference_inputs())
    verdict = judge(cfg).verdict(win.kept, refs, cfg["check"])
    correct = verdict["correct"] and win.calls > 0

    run = Run(cfg, traffic.batch, win, setup_s, summary, enqueue)
    metrics = {}
    for m in cell.metrics(trace):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": int(cell.workload["chips"]),
            "memory_peak_bytes": int(peak)}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    if dev.type == "cuda":
        info["power_limit_w"] = _power_limit()
    result = {"correct": bool(correct), "attempted": int(win.items),
              "failed": int(verdict["failed"]),
              "metrics": metrics, "device": info}
    if summary is not None:
        top = sorted(summary.ops.items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {
            "device_ops": [[name[:120], s] for name, (_, s) in top],
            "idle_gaps": [[name[:120], s] for name, s in summary.gaps]}
    result["info"] = {"calls": win.calls, **verdict["info"],
                      "seconds": win.seconds}
    result["check"] = verdict["check"]
    return result


def control_verdict(cell: Cell, seed: int, *, device="cuda",
                    batch: Optional[int] = None) -> dict:
    """The control: the reference put in the program's place, in the
    configuration's lower precision (its ``control``), at the cell's own
    inputs, judged as a run judges the program."""
    dev = torch.device(device)
    cfg = cell.config
    gen = load_module(HERE / "generators" / f"{cell.mix['generator']}.py")
    params = make_params(cfg, seed, dev)
    traffic = gen.Traffic(cell.mix, seed, dev, cfg, batch=batch)
    inputs = traffic.reference_inputs()
    refs = reference_outputs(cell, params, inputs)
    ctrl = reference_outputs(cell, params, inputs, **cfg["control"])
    return judge(cfg).verdict([(k, v["y"]) for k, v in ctrl.items()], refs,
                              cfg["check"])


def check_lines(result: dict) -> List[str]:
    lines = ["info " + " ".join(f"{k} {v!r}"
                                for k, v in result["info"].items())]
    for name, c in result["check"].items():
        v, lim = c["value"], c["limit"]
        ok = v != "inf" and v <= lim
        lines.append(f"check {name} {v!r} limit {lim!r} "
                     f"{'ok' if ok else 'FAIL'}")
    return lines


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
