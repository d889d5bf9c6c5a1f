"""The card scripts' bookkeeping, on the CPU: what ``chip_smoke.py``
reports under each key of a kernel row, its phases 5 to 12 run on the
kernels' plain versions with the launch counters bumped as launches
would (phase 9, which kills ranks, under the opt-in ``chaos`` marker;
phases 11 and 12 at a reduced width), how it refuses to run without a
card, and how ``scripts/kernel_ab.py`` refuses to run without trees or
a card. Nothing here times anything."""
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
    """The JSON lines of a phase's output, by phase (the training
    launcher prints plain lines between them)."""
    import json
    return {d["phase"]: d for d in
            map(json.loads, (line for line in out.splitlines()
                             if line.startswith("{")))
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


def test_smoke_lm_phase_on_the_cpu(cpu_smoke, capsys, monkeypatch):
    """Phase 11 on the CPU at a small width (2 layers of the reduced
    qwen): 7 × 2 crossbar launches a forward, the served tokens equal
    the dense Engine's, the reduced deploy duo, and the times'
    bookkeeping (one line per serving engine, forward and LM shape)."""
    from repro_torch.configs import qwen1p5_0p5b
    from repro_torch.kernels import ref
    from repro_torch.core import crossbar_layer as tcl
    smoke, ops = cpu_smoke
    monkeypatch.setattr(smoke, "SERVE_DRAINS", 1)
    monkeypatch.setattr(smoke, "_time_ms",
                        lambda torch, fn, iters=20, warmup=3: 2.0)
    monkeypatch.setattr(smoke, "_device_ms",
                        lambda torch, fn, iters=20, warmup=3: 1.0)
    monkeypatch.setattr(smoke, "_busy", lambda torch, fn, ms, n=5: {})
    cfg = qwen1p5_0p5b.reduced().replace(num_layers=2)
    launches = smoke.phase_lm(torch, ops, ref, tcl, torch.device("cpu"),
                              "cpu", cfg=cfg)
    out = capsys.readouterr().out
    line = _phase_lines(out)["lm"]
    for system in ("memristor", "digital"):
        res = line["systems"][system]
        assert res["launches_per_forward"]["crossbar_mvm"] == 14
        assert all(r <= 1e-6 for r in res["rel"].values())
        assert len(res["residual_rel"]) == 2
        serving = res["serving"]
        assert serving["tokens_equal_engine"] and \
            serving["first_divergence"] is None
        assert serving["items"] == serving["lm_tokens_counter"] == 96
    assert line["systems"]["digital"]["geometry"] == "256x128"
    duo = line["deploy_duo"]
    assert duo["tokens_equal_engine"] and set(duo["report_rows"]) == \
        {"sensor", "lm"}
    assert duo["roll_up"]["items"] == 5 * 6 + 3 + 4 + 5
    # the path: 2 × (prefill + decode + the served drain), then the duo
    assert launches["crossbar_mvm"] == sum(
        2 * 14 + line["systems"][s]["serving"]["launches"]["crossbar_mvm"]
        for s in ("memristor", "digital")) + \
        duo["launches"]["crossbar_mvm"]
    assert out.count('"metric": "lm_serving"') == 2      # memristor only
    assert out.count('"metric": "lm_forward"') == 8
    assert out.count('"lm_shape"') == 2 * 3 * 2


def test_smoke_train_phase_on_the_cpu(cpu_smoke, capsys, monkeypatch):
    """Phase 12 on the CPU, cut to size: the QAT deep app (512 training
    images, 60 steps) deployed on both systems with the kernels' launch
    counts, the 12-bit net through the raw kernel's 12 plane launches,
    Fig. 12's table and the variation-aware pair; the reduced qwen
    trained 6 steps through the launcher, interrupted after step 3 and
    resumed to the bit, its checkpoint saves and restores accounted;
    the restored step-6 weights served through the crossbar launches
    with tokens equal to the dense Engine's."""
    import repro_torch.chip as chip_mod
    import repro_torch.variability as var
    from repro_torch.chip import compile as tcompile
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.core import quantization as tq
    from repro_torch.kernels import ref
    smoke, ops = cpu_smoke
    monkeypatch.setattr(smoke, "QAT_TRAIN_N", 512)
    monkeypatch.setattr(smoke, "QAT_TEST_N", 256)
    monkeypatch.setattr(smoke, "QAT_STEPS", 60)
    monkeypatch.setattr(smoke, "FIG12_STEPS", 5)
    monkeypatch.setattr(smoke, "_busy", lambda torch, fn, ms, n=5: {})
    args = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
            "--steps", "6", "--global-batch", "4", "--seq-len", "16",
            "--ckpt-every", "3"]
    launches = smoke.phase_train(torch, ops, ref, tcompile, tq, tcl,
                                 chip_mod, var, torch.device("cpu"), "cpu",
                                 train_args=args)
    lines = _phase_lines(capsys.readouterr().out)
    qat = lines["train_qat"]
    for system, key in (("memristor", "crossbar_mvm"),
                        ("digital", "int8_matmul_fused")):
        dep = qat["deployed"][system]
        assert dep["launches_per_batch"][key] == 3
        assert abs(dep["qat_minus_kernel"]) <= 0.03
    assert qat["deployed"]["digital"]["geometry"] == "256x128"
    assert qat["wide_12_bit"]["launches_per_batch"]["int8_matmul_raw"] == 12
    assert set(qat["fig12"]["error"]) == {"sigmoid", "threshold"}
    assert set(qat["fig12"]["error"]["sigmoid"]) == {"32", "8", "6", "4"}
    assert set(qat["variation_aware_pair"]) == {"clean", "variation_aware"}
    lm = lines["train_lm"]
    assert [r["step"] for r in lm["steps"]] == list(range(6))
    assert lm["steps"][-1]["loss"] < lm["steps"][0]["loss"]
    assert lm["resumed_leg_steps"] == [0, 1, 2, 3, 4, 5]
    assert lm["resume_bit_equal"] and lm["resume_rel"] == 0.0
    assert not lm["deterministic_algorithms_needed"]
    assert [(r["op"], r["step"]) for r in lm["checkpoint_io"]] == [
        ("save", 3), ("save", 6), ("save", 3), ("restore", 3),
        ("save", 6), ("restore", 6)]
    assert all(r["bytes"] > 0 for r in lm["checkpoint_io"])
    assert len(lm["profiled_steps"]) == 2 and lm["restored_step"] == 6
    served = lines["train_served"]
    assert served["launches_per_forward"]["crossbar_mvm"] == 7 * 3
    assert served["serving"]["tokens_equal_engine"]
    assert all(r <= 1e-6 for r in served["rel"].values())
    # the path: the deployed streams, accuracy(chip=), the 12-bit
    # stream, the noisy pair, then the served LM
    assert launches["int8_matmul_raw"] == 12
    assert launches["int8_matmul_fused"] == 3 + 3
    assert launches["crossbar_mvm"] == 3 + 3 + 2 * 3 + 2 * 21 + \
        served["serving"]["launches"]["crossbar_mvm"]


def test_smoke_families_phase_on_the_cpu(cpu_smoke, capsys, monkeypatch):
    """Phase 13 on the CPU, cut to size: Eq. 3 against K1's plain version
    on both tile geometries (64 inputs), the seven reduced archs, a
    2-layer reduced gemma2 (a 24-token prompt past its 16-token window,
    3 decode steps) through compile_lm on both systems with 7 × 2
    launches a forward and tokens equal to the dense Engine's, and the
    reduced moonshot at capacity factor 1.25 (drops), its dispatch
    against the per-token loop and the Engine's drains."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.kernels import ref
    smoke, ops = cpu_smoke
    monkeypatch.setattr(smoke, "EQ3_B", 64)
    monkeypatch.setattr(smoke, "SERVE_DRAINS", 1)
    monkeypatch.setattr(smoke, "_time_ms",
                        lambda torch, fn, iters=20, warmup=3: 2.0)
    monkeypatch.setattr(smoke, "_device_ms",
                        lambda torch, fn, iters=20, warmup=3: 1.0)
    monkeypatch.setattr(smoke, "_busy", lambda torch, fn, ms, n=5: {})
    gemma = get_reduced("gemma2-9b").replace(num_layers=2)
    moe = get_reduced("moonshot-v1-16b-a3b").replace(capacity_factor=1.25)
    launches = smoke.phase_families(
        torch, ops, ref, tcl, torch.device("cpu"), "cpu",
        gemma=dict(cfg=gemma, prompt=24, new=3, shape_rows=(1, 24)),
        moe=dict(cfg=moe, batch=(4, 32), loop_tokens=16,
                 prompts=(3, 5, 8), new=4))
    out = capsys.readouterr().out
    lines = _phase_lines(out)
    eq3 = lines["families_eq3"]["tiles"]
    assert [(t["tile"], t["r_seg"]) for t in eq3] == [
        ([128, 64], 0.0), ([128, 64], 2.5), ([256, 128], 0.0),
        ([256, 128], 2.5)]
    assert all(t["k1_vs_eq3_rel"] <= 1e-5 and
               t["threshold_flips_outside_band"] == 0 for t in eq3)
    assert set(lines["families_reduced"]["archs"]) == \
        set(smoke.FAMILY_ARCHS)
    g = lines["families_gemma2"]
    assert g["dense_tokens"] == g["engine_tokens"] and \
        g["full_attention_twin_rel"] > 1e-4
    for system, geometry in (("memristor", "128x64"),
                             ("digital", "256x128")):
        res = g["systems"][system]
        assert res["geometry"] == geometry
        assert res["launches_per_forward"] == [14]
        assert len(res["rel"]) == 4 and max(res["rel"]) <= 1e-6
        assert res["tokens_equal_dense"] and \
            res["served_tokens_equal_engine"]
    m = lines["families_moe"]
    assert m["prefill"]["drop_frac_per_layer"] > 0
    assert m["dispatch_vs_loop"]["drop_frac"] == 0.0 and \
        m["dispatch_vs_loop"]["rel"] <= 1e-5
    assert m["decode_vs_prefill"]["rel"] < 0.02
    assert m["serving"]["requests"] == 3
    # the path: Eq. 3's two K1 launches a tile and wire setting, then
    # each system's 1 + 3 forwards and its served drain
    assert launches["crossbar_mvm"] == 2 * 4 + sum(
        14 * 4 + g["systems"][s]["serving_launches"]
        for s in ("memristor", "digital"))
    assert launches["int8_matmul_fused"] == launches["int8_matmul_raw"] == 0
    assert out.count('"lm_shape"') == 2 * 5 * 2


def test_smoke_state_space_phase_on_the_cpu(cpu_smoke, capsys, monkeypatch):
    """Phase 14 on the CPU, cut to size: the two reduced archs against
    the CPU (the same tensors twice), the reduced zamba2 (a 40-token
    prompt past its 32-token window) and xlstm through the scan check,
    prefill/decode consistency and an Engine drain of 3 prompts on 4
    lanes, then both trained at the reduced width, xlstm stopped after
    its step-2 checkpoint and resumed to the bit. No kernel launches."""
    from repro_torch.configs import get_reduced
    smoke, ops = cpu_smoke
    monkeypatch.setattr(smoke, "SERVE_DRAINS", 1)
    monkeypatch.setattr(smoke, "_time_ms",
                        lambda torch, fn, iters=20, warmup=3: 2.0)
    monkeypatch.setattr(smoke, "_busy", lambda torch, fn, ms, n=5: {})
    small = dict(new=3, prompts=(3, 5, 8), serve_new=4)
    train = ["--reduced", "--global-batch", "2", "--seq-len", "16",
             "--device", "cpu"]
    launches = smoke.phase_state_space(
        torch, ops, torch.device("cpu"), "cpu",
        hybrid=dict(cfg=get_reduced("zamba2-1.2b"), scan_len=64,
                    batch=(1, 40), **small),
        ssm=dict(cfg=get_reduced("xlstm-350m"), scan_len=64, batch=(2, 32),
                 **small),
        train=dict(hybrid_args=smoke.HYBRID_TRAIN_ARGS + train,
                   ssm_args=smoke.SSM_TRAIN_ARGS + train))
    lines = _phase_lines(capsys.readouterr().out)
    assert set(lines["state_space_reduced"]["archs"]) == \
        set(smoke.STATE_ARCHS)
    for name, op in (("hybrid", "ssd_chunked"),
                     ("ssm", "mlstm_cell_chunked")):
        res = lines[f"state_space_{name}"]
        assert res["scan"]["op"] == op and res["scan"]["y_rel"] <= 1e-5
        c = res["consistency"]
        assert len(c["rel"]) == 4 and max(c["rel"]) < 0.02
        assert c["tokens_differ_outside_ties"] == 0 and \
            c["tokens_differ_outside_band"] == 0
        assert res["serving"]["requests"] == 3 and \
            res["serving"]["tokens_equal_own_greedy"]
    hybrid = lines["state_space_train_hybrid"]
    assert [s["step"] for s in hybrid["steps"]] == [0, 1]
    ssm = lines["state_space_train_ssm"]
    assert ssm["resume_bit_equal"] and ssm["resumed_leg_steps"] == [0, 1,
                                                                    2, 3]
    assert {r["op"] for r in ssm["checkpoint_io"]} == {"save", "restore"}
    assert set(launches.values()) == {0}


def test_smoke_parallel_phase_on_the_cpu(cpu_smoke, capsys):
    """Phase 15 on the CPU, cut to size: the reduced qwen's 3 steps (8 ×
    16 tokens) in one process and on 2 gloo CPU ranks as data
    parallelism with replicated parameters (f32 within rel 1e-5, bf16
    losses within 1e-3), and ``compressed_psum`` at the reduced gradient
    tree over 5 steps of error feedback. No kernel launches."""
    smoke, ops = cpu_smoke
    spec = {"reduced": True, "seq_len": 16}
    launches = smoke.phase_parallel(torch, ops, torch.device("cpu"), "cpu",
                                    spec=spec)
    lines = _phase_lines(capsys.readouterr().out)
    dp = lines["parallel_dp"]
    assert dp["ranks"] == smoke.PAR_RANKS and dp["reduced"]
    assert len(dp["one_process"]["f32"]["losses"]) == 3
    for w in dp["workers"]:
        assert max(w["f32_loss_rel"]) <= smoke.PAR_TOL
        assert w["f32"]["params_rel"] <= smoke.PAR_TOL
        assert max(w["own_dtype_loss_rel"]) <= smoke.PAR_BF16_TOL
        assert w["f32"]["accum"] == 1       # the reduced config's
        # the gradient all-reduce moved the f32 tree each step
        assert all(s["collective_calls"] > 0 and s["collective_bytes"] > 0
                   for s in w["f32"]["steps"])
    psum = lines["parallel_psum"]["workers"]
    assert len(psum) == smoke.PAR_RANKS
    for w in psum:
        assert len(w["steps"]) == 5
        assert w["sum_drift"] <= w["one_step_bound"] * (1 + 1e-5) + 1e-5
        assert w["wire_bytes_compressed"] * 4 == w["wire_bytes_plain"]
    assert set(launches.values()) == {0}


def test_smoke_launch_tools_phase_on_the_cpu(cpu_smoke, capsys):
    """Phase 16 on the CPU, cut to size: the dry run's prediction of the
    reduced qwen's train and decode steps beside the steps run here
    (the card's peak and busy gates need the card); the sweep cut to
    the two committed reduced cells (qwen and moonshot ``train_4k`` on
    16×16), their ``model_flops`` and ``cost.bytes_per_device``
    reproduced; the pipeline of a 4-layer reduced qwen as 4 stages on 4
    gloo CPU ranks within rel 1e-5 of the sequential forward, then its
    pipelined train step (loss, gradients, one AdamW step) within rel
    1e-5 of one process's, M sends each way at each boundary. No kernel
    launches."""
    smoke, ops = cpu_smoke
    spec = {"reduced": True, "seq_len": 16,
            "sweep_archs": ["qwen1.5-0.5b", "moonshot-v1-16b-a3b"],
            "sweep_shapes": "train_4k", "sweep_meshes": ("single",),
            "pipe_layers": 4}
    launches = smoke.phase_launch_tools(torch, ops, torch.device("cpu"),
                                        "cpu", spec=spec)
    lines = _phase_lines(capsys.readouterr().out)
    steps = lines["launch_dryrun_vs_card"]
    for k in ("train", "decode"):
        pred = steps[k]["predicted"]
        assert pred["peak_bytes"] >= pred["state_bytes"] > 0
        assert 0.0 < pred["useful_flops_frac"] <= 1.0
        assert pred["bound_s"] > 0.0 and steps[k]["measured"]["wall_ms"] > 0
    cells = lines["launch_dryrun_sweep"]["cells"]
    assert sorted((c["arch"], c["status"], c["mesh"]) for c in cells) == \
        [("moonshot-smoke", "ok", "16x16"), ("qwen-smoke", "ok", "16x16")]
    pipe = lines["launch_pipeline"]
    assert pipe["stages"] == 4 and pipe["bubble_fraction"] == 3 / 7
    assert len(pipe["workers"]) == 4
    for w in pipe["workers"]:
        assert w["rel"] <= smoke.PIPE_TOL and not w["graph"]
        assert w["staged_bytes"] == 0           # CPU tensors go as they are
        t = w["train"]
        assert max(t["loss_rel"], t["block_grads"]["rel"],
                   t["replicated_grads"]["rel"], t["params"]["tree_rel"]) \
            <= smoke.PIPE_TOL
        assert t["staged_bytes"] == 0 and t["counts"]["broadcast"] == 2
        assert t["counts"]["collective-permute"] == \
            4 * ((w["stage"] < 3) + (w["stage"] > 0))
        assert 0.0 <= t["link_s"] <= t["wall_s"]
    assert pipe["boundary_bytes_per_microbatch"] == 2 * 16 * 64 * 4
    assert set(launches.values()) == {0}
