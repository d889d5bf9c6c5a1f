"""The port's LM tenants (``repro_torch.lm``) against the reference's
``repro.lm``, on the CPU, at ``reduced_serving()`` width.

Weights are handed across as numpy (``params_from_numpy``); tokens come
from ``np.random.default_rng``. Bounds:

  * the mapped forward (every block linear through the programmed tile
    plans and the Fig. 11 combiner; on the CPU the crossbar kernel's
    plain version) against the port's dense forward and against the
    reference's mapped forward (its dense forward on the (4, 32)
    geometry, whose eager route takes the reference 30 s): prefill
    logits, prefill cache and a per-slot decode within rel ≤ 1e-6
    (about 3e-7 measured), on both systems and on the (4, 32) geometry
    with its ≥ 2-level combiner;
  * greedy token streams, through ``deploy()``: equal to the reference
    ``Engine``'s and to the port's, request by request;
  * the analytic chip's report, and the LM row of a deployment report,
    against the reference's at rel 1e-9 (both are plain Python floats
    over the same mapping).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen1p5_0p5b as jqwen
from repro import deploy as jdeploy
from repro import lm as jlm
from repro.models import model as jmodel
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest

from repro_torch.chip import compile_chip, compile_count
from repro_torch.configs import qwen1p5_0p5b as tqwen
from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
from repro_torch.lm import (CompiledLM, LM_LINEARS, LMMember,
                            TransformerParams, compile_lm, lm_request,
                            tokens_from_state)
from repro_torch.lm import __main__ as lm_main
from repro_torch.models import model as tmodel
from repro_torch.serving import Engine, Request

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jqwen.reduced_serving()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tqwen.reduced_serving()
    tp = tmodel.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _t(x):
    return x.float().numpy()


def _reference_engine(jcfg, jp, prompts, n_new, cache_len=64):
    eng = JEngine(jcfg, jp, slots=max(2, len(prompts)), cache_len=cache_len)
    for i, p in enumerate(prompts):
        eng.submit(JRequest(uid=i, prompt=list(p), max_new_tokens=n_new))
    eng.run_until_drained()
    return [st.generated for st in
            sorted(eng.finished, key=lambda st: st.request.uid)]


def _port_engine(tcfg, tp, prompts, n_new, cache_len=64):
    eng = Engine(tcfg, tp, slots=max(2, len(prompts)), cache_len=cache_len)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=n_new))
    eng.run_until_drained()
    return [st.generated for st in
            sorted(eng.finished, key=lambda st: st.request.uid)]


def _report_close(got, want):
    assert got.to_dict() == pytest.approx(want.to_dict(), rel=1e-9)


# ------------------------------------------------------------------- #
# mapped forward == dense forward == the reference's mapped forward
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("system,geometry", [
    ("memristor", None),
    ("digital", None),
    # 4-row tiles on d_model=64 → 16 sub-neuron partials per linear →
    # a ≥2-level Fig. 11 combiner tree on the mapped path
    ("memristor", (4, 32)),
])
def test_mapped_matches_dense(setup, system, geometry):
    jcfg, jp, tcfg, tp = setup
    clm = compile_lm(TransformerParams(tcfg, tp), system=system,
                     geometry=geometry, device="cpu")
    dcfg = tcfg.replace(decode_per_slot=True)
    if geometry is None:
        jclm = jlm.compile_lm(jlm.TransformerParams(jcfg, jp),
                              system=system, geometry=geometry)
        j_prefill, j_decode = jclm.prefill, jclm.decode
    else:
        # the reference's compile_lm routes its analytic chip eagerly,
        # 30 s at 16 row chunks a linear (R8): hold the (4, 32) plans
        # against its dense forward instead
        assert any(len(plans[n].levels) >= 2
                   for plans in clm.plans for n in LM_LINEARS)
        jd = jcfg.replace(decode_per_slot=True)
        j_prefill = lambda t: jmodel.prefill(  # noqa: E731
            jd, jp, {"tokens": t})
        j_decode = lambda c, t, p: jmodel.decode_step(  # noqa: E731
            jd, jp, c, t, p)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 7))
    d_logits, d_cache = tmodel.prefill(dcfg, tp, {"tokens": toks})
    m_logits, m_cache = clm.prefill(toks)
    j_logits, j_cache = j_prefill(toks)
    assert _rel(_t(m_logits), _t(d_logits)) <= 1e-6
    assert _rel(_t(m_logits), np.asarray(j_logits)) <= 1e-6
    for k in d_cache:
        assert _rel(_t(m_cache[k]), _t(d_cache[k])) <= 1e-6
        assert _rel(_t(m_cache[k]), np.asarray(j_cache[k])) <= 1e-6

    # per-slot decode: each lane at its own position
    step = np.asarray([[3], [9]], np.int32)
    pos = np.asarray([7, 5], np.int32)
    d_step, _ = tmodel.decode_step(dcfg, tp, d_cache, step, pos)
    m_step, m_next = clm.decode(m_cache, step, pos)
    j_step, _ = j_decode(j_cache, step, pos)
    assert _rel(_t(m_step), _t(d_step)) <= 1e-6
    assert _rel(_t(m_step), np.asarray(j_step)) <= 1e-6
    assert set(m_next) == {"k", "v"} and m_next["k"].shape == \
        m_cache["k"].shape


def test_compiled_lm_structure_and_lazy_chip(setup):
    jcfg, jp, tcfg, _ = setup
    c0 = compile_count()
    clm = compile_lm(tcfg, seed=3, tokens_per_second=10.0, device="cpu")
    assert isinstance(clm, CompiledLM)
    assert len(clm.plans) == tcfg.num_layers
    assert all(set(p) == set(LM_LINEARS) for p in clm.plans)
    assert clm.cfg.compute_dtype == "float32" and clm.cfg.decode_per_slot
    # the analytic chip is built on first access, once
    assert compile_count() == c0 and "chip" not in clm.__dict__
    chip = clm.chip
    assert compile_count() == c0 + 1 and clm.chip is chip
    assert len(chip.mapping.units) == 7 * tcfg.num_layers
    assert chip.plan is None            # analytic: no programmed MLP
    rep = clm.report()
    assert rep.area_mm2 > 0 and rep.power_mw > 0
    # seeded compile == the dense init with the same seed
    ref = tmodel.init_params(clm.cfg, 3, device="cpu")
    flat = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in
               zip(flat(clm.params), flat(ref)))


@pytest.mark.parametrize("system,geometry", [("memristor", None),
                                             ("digital", None),
                                             ("digital", (128, 64))])
def test_chip_report_equals_the_reference(setup, system, geometry):
    jcfg, _, tcfg, _ = setup
    clm = compile_lm(tcfg, system=system, geometry=geometry,
                     tokens_per_second=50.0, device="cpu")
    jclm = jlm.compile_lm(jcfg, system=system, geometry=geometry,
                          tokens_per_second=50.0)
    assert (clm.chip.geom.rows, clm.chip.geom.cols) == \
        (jclm.chip.geom.rows, jclm.chip.geom.cols)
    assert clm.chip.total_cores == jclm.chip.total_cores
    assert clm.chip.replication == jclm.chip.replication
    assert clm.chip.route.schedule_cycles == jclm.chip.route.schedule_cycles
    _report_close(clm.report(), jclm.report())


def test_compile_lm_rejects_wrong_inputs(setup):
    _, _, tcfg, _ = setup
    with pytest.raises(TypeError, match="ModelConfig or TransformerParams"):
        compile_lm(MLPSpec((4, 2)), device="cpu")
    with pytest.raises(NotImplementedError, match="dense transformer"):
        compile_lm(tcfg.replace(family="ssm"), device="cpu")


def test_compile_chip_points_model_configs_at_compile_lm(setup):
    """The sensor compiler names the right entry point when handed a
    transformer config, as the reference's does."""
    _, _, tcfg, _ = setup
    with pytest.raises(NotImplementedError,
                       match=r"repro_torch\.lm\.compile_lm"):
        compile_chip(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="model configs"):
        compile_chip(tqwen.CONFIG, device="cpu")


# ------------------------------------------------------------------- #
# decode-as-streaming through deploy()
# ------------------------------------------------------------------- #
def test_lm_tenant_tokens_match_dense_engine(setup):
    jcfg, jp, tcfg, tp = setup
    dep = deploy(AppSpec("lm", tcfg, params=tp, cache_len=64,
                         lanes_per_chip=2), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(0, tcfg.vocab_size, size=n))
               for n in (4, 6, 3, 5)]
    for p in prompts:
        assert dep.submit_tokens("lm", p, max_new_tokens=5)
    dep.run_until_drained()
    got = dep.generated_tokens("lm")
    assert len(got) == len(prompts)
    assert all(len(t) == 5 for t in got.values())
    mapped = [got[uid] for uid in sorted(got)]
    assert mapped == _reference_engine(jcfg, jp, prompts, 5)
    assert mapped == _port_engine(tcfg, tp, prompts, 5)
    stats = dep.stats()
    assert stats.apps["lm"].items == stats.fleet.items == 20
    dep.close()


def test_lm_tenant_sensor_verbs_are_guarded(setup):
    _, _, tcfg, tp = setup
    dep = deploy(AppSpec("lm", tcfg, params=tp, cache_len=32), device="cpu")
    with pytest.raises(TypeError, match="submit_tokens"):
        dep.submit("lm", np.zeros((3, 1), np.float32))
    with pytest.raises(TypeError, match="submit_tokens"):
        dep.stream("lm", np.zeros((3, 1), np.float32))
    with pytest.raises(NotImplementedError, match="compile_lm"):
        dep.reprogram("lm", tp)
    with pytest.raises(NotImplementedError, match="LM tenant"):
        dep.attach_monitor("lm", np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError, match="cache_len"):
        dep.submit_tokens("lm", [1, 2, 3], max_new_tokens=40)
    dep.close()

    # and the reverse direction: submit_tokens on a sensor tenant
    spec = MLPSpec((8, 4), activation="threshold", out_activation="linear")
    dep = deploy(AppSpec("s", spec, params=mlp_init(
        spec, generator=torch.Generator().manual_seed(0), device="cpu")),
        device="cpu")
    with pytest.raises(TypeError, match="sensor tenant"):
        dep.submit_tokens("s", [1, 2])
    with pytest.raises(TypeError, match="sensor tenant"):
        dep.generated_tokens("s")
    dep.close()


def test_lm_appspec_validation(setup):
    _, _, tcfg, _ = setup
    with pytest.raises(ValueError, match="cache_len"):
        AppSpec("lm", tcfg, cache_len=1)
    with pytest.raises(ValueError, match="analytic"):
        deploy(DeploymentSpec(apps=(AppSpec("lm", tcfg, analytic=True),),
                              device="cpu"))
    with pytest.raises(ValueError, match="noise"):
        deploy(DeploymentSpec(apps=(AppSpec("lm", tcfg, noise=object()),),
                              device="cpu"))
    with pytest.raises(ValueError, match="lanes"):
        LMMember(compile_lm(tcfg, device="cpu"), lanes=0)


def test_lm_resize_preserves_continuations(setup):
    """Elastic resize mid-decode: evicted LM lanes re-admit by
    re-prefilling prompt + emitted prefix into the rebuilt cache —
    greedy determinism makes the final streams identical to an
    uninterrupted run; growing the fleet grows the lanes."""
    jcfg, jp, tcfg, tp = setup
    dep = deploy(AppSpec("lm", tcfg, params=tp, cache_len=64,
                         lanes_per_chip=2), n_chips=1, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [list(rng.integers(0, tcfg.vocab_size, size=n))
               for n in (5, 4, 6)]
    for p in prompts:
        assert dep.submit_tokens("lm", p, max_new_tokens=6)
    dep.step()
    dep.step()
    dep.resize(1)                       # same size: still evict+requeue
    dep.step()
    dep.resize(2)
    member = dep.router.members["lm"]
    assert member.lanes == 4 and member.cache["k"].shape[1] == 4
    assert member.n_chips == 2
    dep.run_until_drained()
    got = dep.generated_tokens("lm")
    assert [got[uid] for uid in sorted(got)] == \
        _reference_engine(jcfg, jp, prompts, 6)
    assert dep.stats().apps["lm"].items == 18
    dep.close()


def test_lm_deployment_report_row_equals_the_reference(setup):
    """The LM tenant's priced row (and the sensor row beside it) of a
    served duo, against the reference's deployment of the same duo."""
    jcfg, jp, tcfg, tp = setup
    apps = lambda AS, cfg, params: (  # noqa: E731
        AS("sensor", "deep", items_per_second=100.0, lanes_per_chip=2,
           analytic=True),
        AS("lm", cfg, params=params, items_per_second=50.0,
           lanes_per_chip=2, cache_len=64))
    got = deploy(DeploymentSpec(apps=apps(AppSpec, tcfg, tp),
                                device="cpu")).report()
    want = jdeploy.deploy(jdeploy.DeploymentSpec(
        apps=apps(jdeploy.AppSpec, jcfg, jp))).report()
    assert set(got.apps) == set(want.apps) == {"sensor", "lm"}
    for name, w in want.apps.items():
        g = got.apps[name]
        assert g.n_chips == w.n_chips and g.cores == w.cores
        _report_close(g.chip, w.chip)
        for f in ("area_mm2", "power_mw", "capacity_items_per_second",
                  "routing_limited_items_per_second", "energy_per_item_nj"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-9)
    assert got.area_mm2 == pytest.approx(want.area_mm2, rel=1e-9)


def test_lm_request_and_state_helpers():
    req = lm_request((1, 2, 3), max_new_tokens=4)
    assert req.prompt == (1, 2, 3)
    assert req.items.shape == (4, 1)
    with pytest.raises(ValueError, match="empty prompt"):
        lm_request(())
    with pytest.raises(ValueError, match="max_new_tokens"):
        lm_request((1,), max_new_tokens=0)
    jreq = jlm.lm_request((1, 2, 3), max_new_tokens=4)
    assert dataclasses.asdict(req).keys() == dataclasses.asdict(jreq).keys()

    class _St:
        outputs = [np.asarray([3.0]), np.asarray([7.0])]
    assert tokens_from_state(_St()) == [3, 7] == jlm.tokens_from_state(_St())


def test_lm_selftest_passes_on_cpu():
    """The sensor + LM duo on 2 logical chips (the reference's duo):
    tokens equal the dense Engine's, exact roll-up and token telemetry."""
    assert lm_main.selftest(verbose=False, device="cpu", n_chips=2)
