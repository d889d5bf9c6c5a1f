"""The harness finds every cell's files by name, ``BENCHMARK.json``
keeps to the benchmark's contract, and a run refuses to run where it
must not."""
import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_has_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_lines_use_the_allowed_characters():
    seen = set()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
        for w in m.get("workloads", CELLS):
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", CELLS), (m["name"], w)
    assert "stream_mfu" in {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(workload):
    cell = harness.load_cell(workload)
    e2e = {m["name"] for m in cell.metrics(False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics(True)


@pytest.mark.parametrize("workload", CELLS)
def test_every_name_finds_its_files(workload):
    cell = harness.load_cell(workload)
    conf = {c["name"]: c for c in BENCH["configs"]}[cell.workload["config"]]
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    assert cell.config["name"] == cell.workload["config"]
    for path in (HERE / "programs" / f"{cell.config['program']}.py",
                 HERE / "references" / f"{cell.config['reference']}.py",
                 HERE / "judges" / f"{cell.config['check']['judge']}.py",
                 HERE / "generators" / f"{cell.mix['generator']}.py"):
        assert path.is_file(), path
    ref = harness.reference(cell.config)
    assert callable(ref.make_params) and callable(ref.outputs)
    assert callable(harness.judge(cell.config).verdict)
    for m in cell.metrics(False) + cell.metrics(True):
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= \
        max(1, len(BENCH["workloads"]) // 4)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch", "repro_torch.chip", "jax.numpy", "repro",
             "repro.core", "jaxlib", "flax.linen", "jaxtyping", "reprox"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)
    for path in (HERE / "references").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("repro_torch", "portbench"), \
                (path, mod)


def _run(cwd: Path, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "2147483659", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_a_run_without_the_program_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_setup_and_window_metrics_read_the_run(workload):
    cell = harness.load_cell(workload)

    class W:
        items, seconds, calls = 4000, 2.0, 40
        latencies = [i / 1000.0 for i in range(1, 101)]

    run = harness.Run(cell.config, 100, W(), 7.5, None, None)
    read = {m["name"]: harness.load_module(
        HERE / "metrics" / f"{m['name']}.py").read(run)
        for m in cell.metrics(False)}
    assert read["setup_s"] == 7.5
    if "items_per_s" in read:
        assert read["items_per_s"] == 2000.0
    if "batch_p95_ms" in read:
        assert math.isclose(read["batch_p95_ms"], 95.0)
