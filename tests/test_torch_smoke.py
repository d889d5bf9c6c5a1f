"""The card scripts' bookkeeping, on the CPU: what ``chip_smoke.py``
reports under each key of a kernel row, its phases 5 to 10 run on the
kernels' plain versions with the launch counters bumped as launches
would (phase 9, which kills ranks, under the opt-in ``chaos`` marker), how it refuses to run without a card, and how
``scripts/kernel_ab.py`` refuses to run without trees or a card.
Nothing here times anything."""
import importlib.util
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke with its two timers replaced: the host-paced one
    returns 2.0 ms, the card's own 1.0 ms."""
    module = _load("chip_smoke", ROOT / "chip_smoke.py")
    monkeypatch.setattr(module, "_time_ms", lambda torch, fn: 2.0)
    monkeypatch.setattr(module, "_device_ms", lambda torch, fn: 1.0)
    return module


def test_smoke_ms_keys_are_host_paced_and_device_keys_the_cards(smoke):
    """``ms``, ``plain_ms`` and ``library_ms`` keep the first slice's
    meaning (CUDA events at the host's launch pace); the card's own
    times go under ``device_*`` keys."""
    t = smoke._times(None, None, None, None)
    assert {k: t[k] for k in ("ms", "plain_ms", "library_ms")} == \
        {"ms": 2.0, "plain_ms": 2.0, "library_ms": 2.0}
    assert {k: t[k] for k in ("device_ms", "plain_device_ms",
                              "library_device_ms")} == \
        {"device_ms": 1.0, "plain_device_ms": 1.0, "library_device_ms": 1.0}


def test_smoke_kernel_row_sums_layers_and_bounds_each(smoke):
    layers = [{"max_abs_err": 1e-6, "bytes_ms": 0.05, "ops_ms": 0.04,
               "ops_ms_f32_cuda_cores": 0.1,
               **smoke._times(None, None, None, None)},
              {"max_abs_err": 3e-6, "bytes_ms": 0.01, "ops_ms": 0.02,
               "ops_ms_f32_cuda_cores": 0.03,
               **smoke._times(None, None, None, None)}]
    row = smoke._kernel_row("k", "src", "ref:1", 39, layers)
    assert row["launches"] == 39 and row["max_abs_err"] == 3e-6
    assert row["ms"] == 4.0 and row["device_ms"] == 2.0
    assert row["library_ms"] == 4.0 and row["plain_device_ms"] == 2.0
    # each layer's bound is the larger of its bytes and operations
    assert row["bound_ms"] == pytest.approx(0.05 + 0.02)
    assert row["bound_ms_f32_cuda_cores"] == pytest.approx(0.1 + 0.03)
    assert row["bound_by"] == "bytes"
    assert row["share_of_bound"] == pytest.approx(0.07 / 4.0)
    assert row["device_share_of_bound"] == pytest.approx(0.07 / 2.0)


@pytest.mark.parametrize("args", [[], ["."], ["--rounds", "1", "."]])
def test_kernel_ab_refuses_without_trees_or_a_card(args):
    """No tree: usage and exit 2. Without a card: exit 2 before anything
    is built (where a card is visible the script would run)."""
    if args and torch.cuda.is_available():
        pytest.skip("a card is visible: the script would run")
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "kernel_ab.py"), *args],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""


# ------------------ phases 5 and 6, rehearsed on the CPU ------------------ #
@pytest.fixture
def cpu_smoke(monkeypatch):
    """chip_smoke's phases on the CPU: the kernels' plain versions run,
    each wrapper call bumps its launch counter as a launch would,
    ``synchronize`` is a no-op, and the batch is 256 items (the drift
    rate scaled so a batch ages the chip as 16,384 items do on the
    card)."""
    from repro_torch.kernels import crossbar_mvm as cb_mod
    from repro_torch.kernels import int8_matmul as i8_mod
    from repro_torch.kernels import ops
    module = _load("chip_smoke", ROOT / "chip_smoke.py")
    o_cb, o_i8 = ops.crossbar_mvm, ops.int8_matmul

    def counted_cb(*a, **k):
        cb_mod.launches.add()
        return o_cb(*a, **k)

    def counted_i8(x, w, scale=None, offset=None, **k):
        (i8_mod.fused_launches if scale is not None
         else i8_mod.raw_launches).add()
        return o_i8(x, w, scale, offset, **k)

    monkeypatch.setattr(ops, "crossbar_mvm", counted_cb)
    monkeypatch.setattr(ops, "int8_matmul", counted_i8)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rate = module.DRIFT_RATE * module.STREAM_B / 256
    monkeypatch.setattr(module, "STREAM_B", 256)
    monkeypatch.setattr(module, "DRIFT_RATE", rate)
    monkeypatch.setattr(module, "NOISE_KW",
                        dict(module.NOISE_KW, drift_rate=rate))
    return module, ops


def _phase_lines(out):
    import json
    return {d["phase"]: d for d in map(json.loads, out.splitlines())
            if "phase" in d}


def test_smoke_variability_phase_on_the_cpu(cpu_smoke, capsys):
    import repro_torch.chip as chip_mod
    import repro_torch.variability as var
    from repro_torch.chip import compile as tcompile
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.core import quantization as tq
    smoke, ops = cpu_smoke
    chip, x, launches = smoke.phase_variability(
        torch, ops, tcompile, tq, tcl, chip_mod, var, torch.device("cpu"),
        "cpu")
    line = _phase_lines(capsys.readouterr().out)["variability"]
    assert line["launches_per_stream_call"] == [3] * smoke.DRIFT_CALLS
    # 8 calls + a probe + 2 ideal-model streams, the drift-only chip's 6,
    # the canary's 3 + 4 × (stream, probe, probe after the recal)
    assert launches == {"crossbar_mvm": 93, "int8_matmul_fused": 6,
                        "int8_matmul_raw": 0}
    assert [c["age"] for c in line["checks"]] == [0, 256, 7 * 256]
    assert line["output_moved_rel_oldest_vs_age0"] > 1e-3
    assert line["canary"]["accuracy_after"] == [1.0] * 4
    assert min(line["canary"]["series"]["accuracy"]) < 0.99
    assert chip.items_streamed == smoke.DRIFT_CALLS * 256


def test_smoke_paper_apps_phase_on_the_cpu(cpu_smoke, capsys):
    import repro_torch.chip as chip_mod
    from repro_torch.chip import compile as tcompile
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.core import quantization as tq
    smoke, ops = cpu_smoke
    launches = smoke.phase_paper_apps(torch, ops, tcompile, tq, tcl,
                                      chip_mod, torch.device("cpu"), "cpu")
    line = _phase_lines(capsys.readouterr().out)["paper_apps"]
    assert line["reports_equal_golden"] == 15
    assert len(line["nets"]) == 15
    assert launches == {"crossbar_mvm": 16, "int8_matmul_fused": 11,
                        "int8_matmul_raw": 0}
    assert {(r["app"], tuple(r["tiles"][0])) for r in line["nets"]
            if r["system"] == "memristor" and r["app"] in
            ("object", "ocr")} == {("object", (24, 2)), ("ocr", (20, 1))}


def test_smoke_wide_digital_phase_on_the_cpu(cpu_smoke, capsys):
    """Phase 7: four raw launches a layer (2 × 2 byte planes at 12
    bits), no fused launch, the stream equal to the einsum path."""
    import repro_torch.chip as chip_mod
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.kernels import ref
    smoke, ops = cpu_smoke
    chip, x, launches = smoke.phase_wide_digital(
        torch, ops, ref, tcl, chip_mod, torch.device("cpu"), "cpu")
    line = _phase_lines(capsys.readouterr().out)["wide_digital"]
    assert line["launches_per_stream_call"] == {
        "crossbar_mvm": 0, "int8_matmul_fused": 0, "int8_matmul_raw": 12}
    # the stream's 12 and 12 an engine step of the serve drain
    assert launches == {"crossbar_mvm": 0, "int8_matmul_fused": 0,
                        "int8_matmul_raw": 12 * (1 + line["engine_steps"])}
    assert line["planes"] == [[2, 784, 200], [2, 200, 100], [2, 100, 10]]
    assert line["raw_plane_checks_exact"] == 12
    assert x.shape == (256, 784) and chip.plan[0].tiles.bits == 12


def test_smoke_fleet_phase_on_the_cpu(cpu_smoke, capsys, monkeypatch):
    """Phase 8: three launches a fleet batch, no compile, every stream
    equal to the chip's, the drifting fleet's clock, and the router."""
    import repro_torch.chip as chip_mod
    from repro_torch.chip import compile as tcompile
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.variability import NoiseModel
    smoke, ops = cpu_smoke
    monkeypatch.setattr(smoke, "FLEET_RAGGED_B", 65)
    spec = tcl.MLPSpec(smoke.DEEP)
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    drifting = chip_mod.compile_chip(spec, params=params,
                                     noise=NoiseModel(**smoke.NOISE_KW),
                                     device="cpu")
    chips, x, launches = smoke.phase_fleet(torch, ops, tcompile, tcl,
                                           chip_mod, drifting,
                                           torch.device("cpu"), "cpu")
    line = _phase_lines(capsys.readouterr().out)["fleet"]
    assert line["compile_delta"] == 0
    assert line["launches_per_fleet_batch"]["memristor"]["crossbar_mvm"] == 3
    assert line["launches_per_fleet_batch"]["digital"][
        "int8_matmul_fused"] == 3
    for system in ("memristor", "digital"):
        res = line["systems"][system]
        assert all(res[k]["equal"] for k in ("batch", "ragged", "resize_2",
                                             "resize_4", "reprogram"))
        assert res["router"]["requests"] == 32 and \
            res["router"]["items"] == 288
    assert list(line["drifting"]) == ["0", "256", "512"]
    assert drifting.items_streamed == 3 * 256
    # 5 streams + 19 router steps a system, and the drifting fleet's 3
    assert launches == {"crossbar_mvm": 3 * (5 + 19 + 3),
                        "int8_matmul_fused": 3 * (5 + 19),
                        "int8_matmul_raw": 0}
    assert set(chips) == {"memristor", "digital"} and x.shape[0] == 256


def test_smoke_deploy_phase_on_the_cpu(cpu_smoke, capsys, monkeypatch,
                                      tmp_path):
    """Phase 10 on the CPU: single-app deploys with the chip's three
    launches a batch, the two-tenant served drain under telemetry (its
    trace written under ``build/`` and reloaded), the tuned
    heterogeneous fabric (ocr through eight raw launches a batch: two
    layers of 2 × 2 byte planes), the deployed canary loop, and the
    times' bookkeeping. 8 lanes of the drifting tenant age it as
    512 items a step do on the card (the fixture scales the rate)."""
    import repro_torch.chip as chip_mod
    import repro_torch.variability as var
    from repro_torch.chip import compile as tcompile
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.core import quantization as tq
    from repro_torch.kernels import ref
    smoke, ops = cpu_smoke
    monkeypatch.setattr(smoke, "ROOT", str(tmp_path))
    monkeypatch.setattr(smoke, "DEPLOY_REQUESTS", 6)
    monkeypatch.setattr(smoke, "VAR_LANES", 4)
    monkeypatch.setattr(smoke, "SERVE_DRAINS", 1)
    monkeypatch.setattr(smoke, "STREAM_ROUNDS", 1)
    monkeypatch.setattr(smoke, "_time_ms", lambda torch, fn, iters: 2.0)
    monkeypatch.setattr(smoke, "_device_busy",
                        lambda torch, chip, x, uk, ms: {})
    two, het, xs, launches = smoke.phase_deploy(
        torch, ops, ref, tcompile, tq, tcl, chip_mod, var,
        torch.device("cpu"), "cpu")
    smoke.phase_deploy_times(torch, chip_mod, two, het, xs, "cpu")
    out = capsys.readouterr().out
    line = _phase_lines(out)["deploy"]
    for system, key in (("memristor", "crossbar_mvm"),
                        ("digital", "int8_matmul_fused")):
        assert line["single_app"][system]["launches_per_batch"][key] == 3
    steps = line["two_tenants"]["steps"]
    assert line["two_tenants"]["roll_up"] == {
        "requests": 12, "items": 12 * 16, "rejected": 0, "lanes": 16}
    assert set(line["two_tenants"]["step_phase_share"]) == {
        "admit", "dispatch", "device_step", "gather", "finish"}
    assert (tmp_path / "build" / "phase10_trace.json").exists()
    tuned = line["tuned"]
    assert tuned["assignment"] == {"deep": ["memristor", "128x64"],
                                   "ocr": ["digital", "128x64"]}
    assert tuned["chip_systems"] == ["digital", "memristor"]
    assert tuned["launches_per_batch"]["ocr"]["int8_matmul_raw"] == 8
    assert tuned["ocr_planes"] == [[2, 2500, 60], [2, 60, 26]]
    assert tuned["raw_plane_checks_exact"] == 2 * 4 * 2
    loop = line["canary_loop"]
    assert loop["recals"] and loop["compile_delta"] == 0
    assert all(r["after"] >= 0.99 for r in loop["recals"])
    assert loop["journaled"] == len(loop["recals"])
    # the path's launches: (a) 3 + 3; (b) 3 K1 and 3 K2 a step; (c) the
    # two tenants' batches and the mixed drain; (d) 3 K1 a step
    assert launches["int8_matmul_fused"] == 3 + 3 * steps
    assert launches["int8_matmul_raw"] % 8 == 0 and \
        launches["int8_matmul_raw"] > 8
    assert launches["crossbar_mvm"] > 3 + 3 * steps + 3 + 3 * loop["steps"]
    assert out.count('"metric": "deploy_router_steps_per_s"') == 2
    assert out.count('"metric": "deploy_tuned_tenant_stream"') == 2


@pytest.mark.chaos
def test_smoke_ranks_phase_on_the_cpu(cpu_smoke, capsys, monkeypatch):
    """Phase 9 with CPU ranks: spawned processes, one gloo group, the
    lockstep fleet on both systems, then a rank killed mid-serve in a
    lockstep and in a federated fleet (the ranks run the plain
    versions: no launches). Chaos-marked, as every kill scenario."""
    import repro_torch.chip as chip_mod
    smoke, _ = cpu_smoke
    monkeypatch.setattr(smoke, "RANK_REQUESTS", 4)
    monkeypatch.setattr(smoke, "RANK_DRAINS", 2)
    launches = smoke.phase_ranks(torch, chip_mod, "cpu", "cpu")
    out = capsys.readouterr().out
    line = _phase_lines(out)["ranks"]
    for system in ("memristor", "digital"):
        res = line["systems"][system]
        assert res["equal_to_chip"] == [True, True]
        assert len(set(res["steps_per_rank"])) == 1
        assert res["stats_global"]["requests"] == 8
        assert len(res["lockstep_drains"]) == 2
    assert line["lockstep_degrade"]["survivor"] == 0
    assert line["federated_chaos"]["survivor"] == 1
    for name in ("lockstep_degrade", "federated_chaos"):
        assert line[name]["uids_completed_once"] == 16
        assert line[name]["compile_delta"] == 0
    assert set(launches.values()) == {0}
    assert out.count('"metric": "ranks_router_rate"') == 2


def test_smoke_refuses_without_a_card_or_the_repository(tmp_path):
    """Without a card it exits non-zero and prints no result, also from
    a directory that holds chip_smoke.py and nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script would run")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              cwd=script.parent)
        assert proc.returncode != 0
        assert proc.stdout == ""
