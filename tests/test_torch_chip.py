"""The slice as a whole: the port's deep-app chip (compile → program →
stream → serve) against the reference's, on the CPU.

The reference's ``mlp_init(PRNGKey(0))`` weights are carried across as
numpy. The port streams through its kernel path (on CPU tensors, the
kernels' plain versions); the reference through its einsum path (its
Pallas kernels cannot build on this JAX). The two round differently —
the kernel scales each row chunk's partial, the einsum folds the scale
into the weights first — so every layer's pre-activation is compared
at rel ≤ 1e-5 on shared inputs, and a threshold unit may differ only
where the reference's own pre-activation is within 1e-5·max|pre| of
zero (such units are counted and printed). Final outputs: rel ≤ 1e-5.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.chip as jchip
from repro.chip import compile as jcompile
from repro.configs.paper_apps import APPS
from repro.core import crossbar_layer as jcl
from repro.core import quantization as jq
from repro.core.neural_core import CoreGeometry as JGeom

from repro_torch import obs as tobs
from repro_torch.chip import compile as tcompile
from repro_torch.chip import __main__ as tmain
from repro_torch.chip import ChipRequest, compile_chip
from repro_torch.core import crossbar_layer as tcl
from repro_torch.core import quantization as tq
from repro_torch.core.neural_core import CoreGeometry as TGeom
from repro_torch.kernels import ops
from repro_torch.variability import NoiseModel as TNoise

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEEP = (784, 200, 100, 10)
BAND = 1e-5          # near-zero band for threshold units, × max|pre|


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _np_params(jparams):
    return [{k: np.asarray(v) for k, v in p.items()} for p in jparams]


def _deep_pair(system, jkey=0):
    """The reference's and the port's deep-app chips on the same
    (reference-drawn) weights."""
    jspec = jcl.MLPSpec(DEEP, activation="threshold",
                        out_activation="linear")
    jparams = jcl.mlp_init(jax.random.PRNGKey(jkey), jspec)
    jc = jchip.compile_chip(jspec, params=jparams, system=system)
    tspec = tcl.MLPSpec(DEEP, activation="threshold",
                        out_activation="linear")
    tparams = tcl.params_from_numpy(_np_params(jparams), device="cpu")
    tc = compile_chip(tspec, params=tparams, system=system, device="cpu")
    return jspec, jparams, jc, tspec, tparams, tc


def _layerwise(jc, tc, x):
    """Each layer on the reference's own input: pre-activations within
    rel ≤ 1e-5; returns (threshold flips, reference pre-activations)."""
    h = np.asarray(x, np.float32)
    flips, pres = 0, []
    for jl, tl in zip(jc.plan, tc.plan):
        pre_ref = np.asarray(jcompile._apply_stream_layer(
            dataclasses.replace(jl, activation="linear"), jnp.asarray(h),
            False))
        pre_out = tcompile._apply_stream_layer(
            dataclasses.replace(tl, activation="linear"),
            torch.tensor(h), True).numpy()
        assert _rel(pre_out, pre_ref) <= 1e-5
        post_ref = np.asarray(jq.make_activation(jl.activation)(
            jnp.asarray(pre_ref)))
        post_out = tq.make_activation(tl.activation)(
            torch.from_numpy(pre_out)).numpy()
        if jl.activation == "threshold":
            differ = np.sign(post_out) != np.sign(post_ref)
            near = np.abs(pre_ref) <= BAND * np.max(np.abs(pre_ref))
            assert not np.any(differ & ~near)
            flips += int(differ.sum())
        pres.append(pre_ref)
        h = post_ref
    return flips, pres


# ------------------------- the deep app, both systems ----------------- #
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_deep_app_stream_matches_reference(system):
    jspec, jparams, jc, tspec, tparams, tc = _deep_pair(system)
    x = np.random.default_rng(1).uniform(0, 1, (256, 784)).astype(
        np.float32)
    flips, pres = _layerwise(jc, tc, x)
    print(f"{system}: {flips} threshold unit(s) flipped inside the "
          f"near-zero band")
    ops.reset_launch_counts()
    out = tc.stream(torch.from_numpy(x)).numpy()
    assert ops.launch_counts() == {"crossbar_mvm": 0,
                                   "int8_matmul_fused": 0,
                                   "int8_matmul_raw": 0}   # CPU: plain
    ref_stream = np.asarray(jc.stream(jnp.asarray(x)))
    mode = "crossbar" if system == "memristor" else "digital"
    ref_dense = np.asarray(jcl.programmed_mlp_apply(
        jcl.program_mlp(jparams, jspec, mode=mode), jnp.asarray(x)))
    assert out.shape == (256, 10)
    # the reference's layer-by-layer (eager) chain ends in the final
    # layer's linear output; with no flip the port follows it exactly
    eager_out = pres[-1]
    near_rows = np.zeros(x.shape[0], bool)
    for pre in pres[:-1]:
        near_rows |= np.any(np.abs(pre) <= BAND * np.max(np.abs(pre)),
                            axis=1)
    print(f"{system}: {int(near_rows.sum())} row(s) hold a hidden unit in "
          f"the near-zero band")
    assert near_rows.sum() <= 0.1 * near_rows.size
    rows = ~near_rows if flips else np.ones_like(near_rows)
    assert _rel(out[rows], eager_out[rows]) <= 1e-5
    # the reference's jitted stream and dense path round their own way
    # (XLA fuses the epilogue), so a unit in the band may take the other
    # rail there: those rows are left out against them
    rows = ~near_rows
    assert _rel(out[rows], ref_stream[rows]) <= 1e-5
    assert _rel(out[rows], ref_dense[rows]) <= 1e-5
    # the port's own einsum path is the reference's arithmetic
    plain = tc.stream(torch.from_numpy(x), use_kernel=False).numpy()
    assert _rel(plain[rows], ref_stream[rows]) <= 1e-5


@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_deep_app_plan_matches_reference(system):
    _, _, jc, _, _, tc = _deep_pair(system)
    assert len(tc.plan) == len(jc.plan) == 3
    for jl, tl in zip(jc.plan, tc.plan):
        assert tl.levels == jl.levels
        assert tl.activation == jl.activation
        for jw, tw in zip(jl.combine, tl.combine):
            assert _rel(tw, jw) <= 1e-6
    if system == "memristor":
        assert [tl.tiles.gp.shape for tl in tc.plan] == \
            [(7, 4, 128, 64), (2, 2, 128, 64), (1, 1, 128, 64)]
        assert [tl.levels for tl in tc.plan] == [((1, 7),), ((1, 2),), ()]
    else:
        assert [tuple(tl.tiles.wq.shape) for tl in tc.plan] == \
            [(784, 200), (200, 100), (100, 10)]
        assert all(tl.tiles.wq.dtype == torch.int8 for tl in tc.plan)


def _asdict(report):
    return dataclasses.asdict(report)


@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_deep_app_mapping_and_route_equal_reference(system):
    _, _, jc, _, _, tc = _deep_pair(system)
    assert _asdict(tc.mapping) == _asdict(jc.mapping)
    assert _asdict(tc.route) == _asdict(jc.route)
    assert (tc.replication, tc.total_cores) == \
        (jc.replication, jc.total_cores)


@pytest.mark.parametrize("app_id", sorted(APPS))
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_paper_app_mapping_and_route_equal_reference(app_id, system):
    """Analytic compiles of every paper app (the reference's net
    tuples, at the app's real-time rate): placement, core inventory and
    the TDM schedule are the same."""
    app = APPS[app_id]
    jc = jchip.compile_app(app, system)
    nets = app.memristor_nets if system == "memristor" else app.sram_nets
    tc = compile_chip(nets, system=system,
                      items_per_second=app.items_per_second,
                      sensor_flags=app.sensor_flags(system),
                      deps=app.net_deps(system), device="cpu")
    assert tc.plan is None
    assert _asdict(tc.mapping) == _asdict(jc.mapping)
    assert _asdict(tc.route) == _asdict(jc.route)


# ------------------------------- serving ------------------------------ #
def _serve_trace(eng, make_items):
    """5 requests of 2–6 items (one more is refused by queue_limit=5),
    drained through ``slots=3``."""
    accepted = [eng.submit(ChipRequest(uid=i, items=make_items(i)))
                for i in range(5)]
    accepted.append(eng.submit(ChipRequest(uid=5, items=make_items(5))))
    done = eng.run_until_drained()
    return accepted, {st.request.uid: st for st in done}


def test_serving_accounting_equals_reference():
    _, _, jc, _, _, tc = _deep_pair("memristor")
    rng = np.random.default_rng(2)
    trace = [rng.uniform(0, 1, (2 + i % 5, 784)).astype(np.float32)
             for i in range(6)]
    # the reference's engine class itself: jc.serve() would also set
    # its process-wide warn-once deprecation state
    jeng = jchip.ChipEngine(jc, slots=3, queue_limit=5)
    teng = tc.serve(slots=3, queue_limit=5)
    jacc, jdone = _serve_trace(jeng, lambda i: trace[i].copy())
    tacc, tdone = _serve_trace(teng, lambda i: trace[i].copy())
    assert tacc == jacc == [True] * 5 + [False]
    assert (teng.steps, teng.items_emitted, teng.rejected) == \
        (jeng.steps, jeng.items_emitted, jeng.rejected)
    assert teng.rejected == 1
    assert sorted(tdone) == sorted(jdone) == list(range(5))
    for uid, jst in jdone.items():
        tst = tdone[uid]
        assert (tst.admit_step, tst.done_step, tst.slot, tst.pos) == \
            (jst.admit_step, jst.done_step, jst.slot, jst.pos)
        assert _rel(tst.result, jst.result) <= 1e-5
        want = tc.stream(torch.from_numpy(trace[uid])).numpy()
        np.testing.assert_allclose(tst.result, want, atol=1e-5)


def test_serve_records_telemetry_when_configured():
    _, _, _, _, _, tc = _deep_pair("digital")
    tel = tobs.configure()
    try:
        eng = tc.serve(slots=2)
        for i in range(3):
            eng.submit(ChipRequest(uid=i, items=np.full((2, 784), 0.5)))
        eng.run_until_drained()
        snap = tel.metrics.snapshot()
    finally:
        tobs.disable()
    assert snap["counters"]["engine.items"] == eng.items_emitted == 6
    assert snap["counters"]["chip.items_streamed"] == 2 * eng.steps
    assert snap["histograms"]["engine.step_s"]["count"] == eng.steps


# --------------------------- other chip paths ------------------------- #
def test_multi_level_combiner_matches_reference():
    """75 row chunks on an 8-row core: an intermediate sub-neuron level
    before the final combining neuron (Fig. 11 recursion)."""
    dims = (600, 5, 3)
    jspec = jcl.MLPSpec(dims, activation="sigmoid", out_activation="linear")
    jparams = jcl.mlp_init(jax.random.PRNGKey(3), jspec)
    jc = jchip.compile_chip(jspec, params=jparams, geom=JGeom(8, 8))
    tc = compile_chip(tcl.MLPSpec(dims, activation="sigmoid"),
                      params=tcl.params_from_numpy(_np_params(jparams),
                                                   device="cpu"),
                      geom=TGeom(8, 8), device="cpu")
    assert tc.plan[0].levels == jc.plan[0].levels
    assert len(tc.plan[0].levels) >= 2
    x = np.random.default_rng(4).uniform(0, 1, (9, 600)).astype(np.float32)
    assert _rel(tc.stream(torch.from_numpy(x)),
                jc.stream(jnp.asarray(x))) <= 1e-5


def test_replica_fanout_matches_single_replica_and_reference():
    dims = (64, 24, 4)
    jspec = jcl.MLPSpec(dims, activation="sigmoid", out_activation="linear")
    jparams = jcl.mlp_init(jax.random.PRNGKey(7), jspec)
    tspec = tcl.MLPSpec(dims, activation="sigmoid")
    tparams = tcl.params_from_numpy(_np_params(jparams), device="cpu")
    probe = compile_chip(tspec, params=tparams, device="cpu")
    rate = 3.5 * probe.mapping.items_per_second_capacity
    tc = compile_chip(tspec, params=tparams, items_per_second=rate,
                      device="cpu")
    jc = jchip.compile_chip(jspec, params=jparams, items_per_second=rate)
    assert tc.replication == jc.replication > 1
    x = np.random.default_rng(8).uniform(
        0, 1, (3 * tc.replication + 1, 64)).astype(np.float32)
    fanned = tc.stream(torch.from_numpy(x))
    # the plain versions' CPU matmuls may block a padded batch
    # differently: the reference's own fan-out bound
    np.testing.assert_allclose(
        fanned.numpy(), tc.stream(torch.from_numpy(x),
                                  fan_out=False).numpy(),
        rtol=1e-6, atol=1e-6)
    assert _rel(fanned, jc.stream(jnp.asarray(x))) <= 1e-5


def test_programmed_mlp_compiles_without_re_encoding():
    _, jparams, _, tspec, tparams, tc = _deep_pair("memristor")
    prog = tcl.program_mlp(tparams, tspec)
    chip = compile_chip(prog, system="memristor")
    assert chip.device == torch.device("cpu")
    assert chip.plan[0].tiles is prog.layers[0]
    with pytest.raises(ValueError, match="does not match system"):
        compile_chip(prog, system="digital")
    x = torch.rand((4, 784), generator=torch.Generator().manual_seed(0))
    compiles = tcompile.compile_count()
    assert torch.equal(chip.stream(x), tc.stream(x))
    assert tcompile.compile_count() == compiles    # streams never compile


def test_dense_kernel_path_matches_mapped_stream():
    """programmed_mlp_apply through the crossbar kernel's reduce mode
    (plain version here) agrees with the mapped stream."""
    _, _, _, tspec, tparams, tc = _deep_pair("memristor")
    x = torch.rand((64, 784), generator=torch.Generator().manual_seed(5))
    prog = tcl.program_mlp(tparams, tspec)
    dense = tcl.programmed_mlp_apply(prog, x, use_kernel=True)
    assert _rel(dense, tc.stream(x)) <= 1e-5


def test_analytic_chip_and_unported_verbs_raise():
    """An analytic-only chip still refuses stream() and serve(); its
    report() (the cost-model slice) equals the reference's, and a chip
    compiles with an ideal NoiseModel (the variability slice) to the
    same stream as with none."""
    chip = compile_chip((1, (8, 4)), device="cpu")
    assert chip.plan is None
    with pytest.raises(ValueError, match="analytic-only"):
        chip.stream(torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="analytic-only"):
        chip.serve()
    jrep = jchip.compile_chip((1, (8, 4))).report().to_dict()
    assert chip.report().to_dict() == jrep
    spec = tcl.MLPSpec((8, 4))
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    ideal = compile_chip(spec, params=params, device="cpu")
    noisy = compile_chip(spec, params=params, noise=TNoise(), device="cpu")
    assert noisy.noise == TNoise() and not noisy.has_drift
    x = torch.rand((3, 8), generator=torch.Generator().manual_seed(1))
    assert torch.equal(noisy.stream(x), ideal.stream(x))


def test_infeasible_rate_warns_like_the_reference():
    """A rate the routed TDM schedule cannot carry per replica warns
    with the same capacity figure the reference reports."""
    nets = ((1, (784, 200, 100, 10)),)
    probe = compile_chip(nets, device="cpu")
    rate = 10 * probe.replication * probe.route.max_items_per_second
    # the replica fan-out follows compute capacity; the link does not
    with pytest.warns(tcompile.ChipRateWarning, match="infeasible"):
        tc = compile_chip(nets, items_per_second=rate, device="cpu")
    with pytest.warns(jchip.ChipRateWarning, match="infeasible"):
        jc = jchip.compile_chip(nets, items_per_second=rate)
    assert tc.replication == jc.replication
    assert tc.route.max_items_per_second == jc.route.max_items_per_second


def test_compile_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_chip((1, (8, 4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.selftest(verbose=False)


def test_selftest_passes_on_cpu(capsys):
    assert tmain.main(["--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # the report checks the reference's selftest makes
    assert "[ok] report reproduces the Tables II-VI deep-app " \
        "accounting" in out
    assert "[ok] report power decomposes" in out
    assert "FAIL" not in out


# ------------------------------ no JAX in the port -------------------- #
def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "kernel_ab.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_roots(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
