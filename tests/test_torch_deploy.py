"""The port's declarative deployment (``repro_torch.deploy``) against the
reference's ``repro.deploy``, on the CPU.

Weights are handed across as numpy (``params_from_numpy``), inputs come
from ``np.random.default_rng``. Bounds:

  * spec validation raises the reference's ``ValueError`` with the
    reference's text, case by case;
  * a single-app deployment streams through the port's own
    ``shard_chip`` path, so the two are equal to the bit
    (``torch.equal``); against the reference's chip on the einsum path
    the bound is rel ≤ 1e-5 on the rows where no hidden threshold unit
    lies within 1e-5·max|pre| of zero (R2, R6);
  * router accounting is compared where it is deterministic: per-app
    requests, items, rejected, lanes and steps, and the finish order;
  * ``deployment_report`` equals the reference's at 1e-9 on chips
    compiled from the same weights (both are pure in the chips).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.chip as jchip
import repro.deploy as jdeploy
from repro.chip import compile as jcompile
from repro.core import crossbar_layer as jcl
from repro.deploy import spec as jspec_mod

from repro_torch.chip import ChipRateWarning, compile_chip, compile_count
from repro_torch.chip import compile as tcompile
from repro_torch.core import crossbar_layer as tcl
from repro_torch.deploy import (AppSpec, DeploymentSpec, MultiAppRouter,
                                deploy, deployment_report, single_app)
from repro_torch.deploy import __main__ as dmain
from repro_torch.deploy import spec as tspec_mod
from repro_torch.fleet import FleetRouter, shard_chip
from repro_torch.serving.engine import ItemRequest

torch.set_num_threads(1)

DIMS = (64, 32, 10)
DIMS_B = (32, 16, 4)
BAND = 1e-5
SYSTEMS = [("memristor", 8), ("digital", 8), ("digital", 12)]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _np_params(jparams):
    return [{k: np.asarray(v) for k, v in p.items()} for p in jparams]


@pytest.fixture(scope="module")
def weights():
    """The reference's weights for two nets, and the same weights as
    port tensors on the CPU."""
    out = {}
    for name, dims, seed in (("a", DIMS, 0), ("b", DIMS_B, 7)):
        jspec = jcl.MLPSpec(dims, activation="threshold",
                            out_activation="linear")
        jparams = jcl.mlp_init(jax.random.PRNGKey(seed), jspec)
        tspec = tcl.MLPSpec(dims, activation="threshold",
                            out_activation="linear")
        out[name] = (jspec, jparams, tspec,
                     tcl.params_from_numpy(_np_params(jparams),
                                           device="cpu"))
    return out


def _x(seed, b, d=DIMS[0]):
    return np.random.default_rng(seed).uniform(0, 1, (b, d)).astype(
        np.float32)


# -------------------- spec validation --------------------------------- #
class _Mesh:
    """A stand-in mesh: the spec only checks that one was given."""


def _app_cases(m):
    net = (1, (8, 4))
    return [
        lambda: m.AppSpec("", net),
        lambda: m.AppSpec("a", net, lanes_per_chip=0),
        lambda: m.AppSpec("a", net, queue_limit=0),
        lambda: m.AppSpec("a", net, queue_limit=True),
        lambda: m.AppSpec("a", net, queue_limit=2.5),
        lambda: m.AppSpec("a", net, geom=(128,)),
        lambda: m.AppSpec("a", net, geom=(128, 0)),
        lambda: m.AppSpec("a", net, analytic=True, params=[{}]),
        lambda: m.AppSpec("a", net, cache_len=1),
        lambda: m.AppSpec("a", net, cache_len=True),
        lambda: m.AppSpec("a", net, system="tpu"),
        lambda: m.DeploymentSpec(apps=()),
        lambda: m.DeploymentSpec(apps=(m.AppSpec("a", net),
                                       m.AppSpec("a", net))),
        lambda: m.DeploymentSpec(apps=(m.AppSpec("a", net),), n_chips=2,
                                 mesh=_Mesh()),
        lambda: m.DeploymentSpec(apps=(m.AppSpec("a", net),),
                                 queue_limit=0),
        lambda: m.DeploymentSpec(apps=(m.AppSpec("a", net),), n_chips=2,
                                 chip_systems=("memristor",)),
        lambda: m.DeploymentSpec(apps=(m.AppSpec("a", net),),
                                 chip_systems=()),
        lambda: m.DeploymentSpec(apps=(m.AppSpec("a", net),),
                                 chip_systems=("digital",)),
        lambda: m.DeploymentSpec(apps=(m.AppSpec("a", net),),
                                 chip_systems=("sram", "gpu")),
    ]


@pytest.mark.parametrize("case", range(len(_app_cases(tspec_mod))))
def test_spec_validation_raises_as_the_reference(case):
    """Each malformed spec raises ``ValueError`` with the reference's
    own text."""
    with pytest.raises(ValueError) as want:
        _app_cases(jspec_mod)[case]()
    with pytest.raises(ValueError) as got:
        _app_cases(tspec_mod)[case]()
    assert str(got.value) == str(want.value)


def test_spec_fields_and_defaults_as_the_reference():
    """Aliases normalise alike, ``single_app`` routes the same keywords,
    and the port's two documented differences hold: ``use_kernel``
    defaults to True and the spec carries a ``device``."""
    net = (1, (8, 4))
    j = jspec_mod.single_app(net, system="1t1m", n_chips=2,
                             lanes_per_chip=3, queue_limit=5, seed=4,
                             geom=[64, 32], strict_rate=True,
                             chip_systems=None)
    t = single_app(net, system="1t1m", n_chips=2, lanes_per_chip=3,
                   queue_limit=5, seed=4, geom=[64, 32], strict_rate=True,
                   chip_systems=None)
    assert dataclasses.asdict(t.apps[0]) == dataclasses.asdict(j.apps[0])
    assert t.apps[0].system == "memristor" and t.apps[0].geom == (64, 32)
    assert (t.n_chips, t.queue_limit, t.strict_rate) == \
        (j.n_chips, j.queue_limit, j.strict_rate)
    assert not j.use_kernel and t.use_kernel and t.device is None
    hetero = DeploymentSpec(apps=(AppSpec("a", net, system="sram"),),
                            chip_systems=["sram", "1t1m"])
    assert hetero.chip_systems == jspec_mod.DeploymentSpec(
        apps=(jspec_mod.AppSpec("a", net, system="sram"),),
        chip_systems=["sram", "1t1m"]).chip_systems


# -------------------- single-app streams ------------------------------ #
@pytest.mark.parametrize("system,bits", SYSTEMS)
@pytest.mark.parametrize("n_chips", [1, 3])
def test_single_app_deploy_equals_shard_chip_and_the_reference(
        weights, system, bits, n_chips):
    jspec, jparams, tspec, tparams = weights["a"]
    d = deploy(AppSpec("a", tspec, params=tparams, system=system,
                       weight_bits=bits), n_chips=n_chips, device="cpu")
    legacy = shard_chip(compile_chip(tspec, params=tparams, system=system,
                                     weight_bits=bits, device="cpu"),
                        n_chips)
    x = _x(3, 37)
    y = d.stream("a", torch.from_numpy(x))
    assert d.n_chips == n_chips and d.device == torch.device("cpu")
    assert torch.equal(y, legacy.stream(torch.from_numpy(x)))
    assert torch.equal(d.stream("a", x, use_kernel=False),
                       legacy.stream(x, use_kernel=False))

    jc = jchip.compile_chip(jspec, params=jparams, system=system,
                            weight_bits=bits)
    ref = np.asarray(jc.stream(jnp.asarray(x), use_kernel=False))
    clear = np.ones(x.shape[0], bool)
    h = jnp.asarray(x)
    for layer in jc.plan[:-1]:
        pre = np.asarray(jcompile._apply_stream_layer(
            dataclasses.replace(layer, activation="linear"), h, False))
        clear &= ~np.any(np.abs(pre) <= BAND * np.abs(pre).max(), axis=1)
        h = jcompile._apply_stream_layer(layer, h, False)
    assert clear.sum() >= 30
    assert _rel(y.numpy()[clear], ref[clear]) <= 1e-5


def test_paper_app_by_name_gets_seeded_weights():
    """A single-net paper app streams out of the box with ``mlp_init``
    weights from ``AppSpec.seed``; a multi-net one is analytic-only."""
    d = deploy([AppSpec("deep", "deep", seed=3),
                AppSpec("edge", "edge")], n_chips=1, device="cpu")
    spec = tcl.MLPSpec((784, 200, 100, 10))
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    x = torch.from_numpy(_x(1, 5, 784))
    assert torch.equal(d.stream("deep", x),
                       compile_chip(spec, params=params,
                                    device="cpu").stream(x))
    assert d.params("deep") is not None and d.params("edge") is None
    with pytest.raises(ValueError, match="analytic-only"):
        d.stream("edge", x)
    rep = d.report()
    assert set(rep.apps) == {"deep", "edge"}
    assert list(d.router.members) == ["deep"]
    with pytest.raises(ValueError, match="unknown paper app"):
        deploy(AppSpec("x", "nope"), device="cpu")
    with pytest.raises(ValueError, match="params only apply"):
        deploy(AppSpec("e", "edge", params=params), device="cpu")


# -------------------- the multi-app router ---------------------------- #
def _trace():
    rng = np.random.default_rng(11)
    return [("alpha" if i % 3 else "beta",
             rng.integers(1, 6), i % 4 == 3) for i in range(14)]


def _drive(d, submit, step):
    """Replay one submit trace: submit, with engine steps interleaved;
    then drain. Returns the finished (key, uid order) list."""
    for app, n, then_step in _trace():
        d_in = DIMS[0] if app == "alpha" else DIMS_B[0]
        submit(app, np.full((int(n), d_in), 0.5, np.float32))
        if then_step:
            step()
    return d.run_until_drained()


def test_two_tenant_drain_accounts_as_the_reference(weights):
    """The same submit trace through both packages' multi-app routers
    (one chip): per-app requests, items, rejected, lanes and steps, and
    the finish order, are the reference's."""
    ja, jb = weights["a"], weights["b"]
    jd = jdeploy.deploy(jdeploy.DeploymentSpec(apps=(
        jdeploy.AppSpec("alpha", ja[0], params=ja[1], lanes_per_chip=2),
        jdeploy.AppSpec("beta", jb[0], params=jb[1], system="digital",
                        lanes_per_chip=1),
    ), n_chips=1, queue_limit=3))
    td = deploy(DeploymentSpec(apps=(
        AppSpec("alpha", ja[2], params=ja[3], lanes_per_chip=2),
        AppSpec("beta", jb[2], params=jb[3], system="digital",
                lanes_per_chip=1),
    ), n_chips=1, queue_limit=3, device="cpu"))
    assert isinstance(td.router, MultiAppRouter)
    jdone = _drive(jd, jd.submit, jd.step)
    tdone = _drive(td, td.submit, td.step)
    assert [(s.request.key, s.request.uid) for s in tdone] == \
        [(s.request.key, s.request.uid) for s in jdone]
    js, ts = jd.stats(), td.stats()
    fields = ("requests", "items", "rejected", "lanes", "steps")
    for name in ("alpha", "beta"):
        assert {f: getattr(ts.apps[name], f) for f in fields} == \
            {f: getattr(js.apps[name], f) for f in fields}
    assert {f: getattr(ts.fleet, f) for f in fields} == \
        {f: getattr(js.fleet, f) for f in fields}
    assert ts.fleet.rejected > 0
    # every routed output is the tenant's own direct stream
    for st in tdone:
        want = td.chip(st.request.key).stream(
            torch.from_numpy(st.request.items)).numpy()
        np.testing.assert_allclose(st.result, want, atol=1e-5)
    jd.close()


def test_resize_and_degrade_keep_the_accounting(weights):
    """``resize`` re-serves every member on the new mesh with no compile,
    requeues in-flight lanes at the front and rebuilds the per-app lane
    budgets."""
    _, _, tspec, tparams = weights["a"]
    _, _, tspec_b, tparams_b = weights["b"]
    d = deploy([AppSpec("alpha", tspec, params=tparams, lanes_per_chip=2),
                AppSpec("beta", tspec_b, params=tparams_b,
                        lanes_per_chip=1)], n_chips=2, device="cpu")
    for i in range(4):
        d.submit("alpha", _x(i, 3 + i))
        d.submit("beta", _x(10 + i, 2, DIMS_B[0]))
    d.step()
    c0 = compile_count()
    d.resize(3)
    assert compile_count() == c0 and d.n_chips == 3
    assert d.router.slots == 3 * 2 + 3 * 1
    assert d.router.members["alpha"].n_chips == 3
    done = d.run_until_drained()
    assert len(done) == 8 and d.stats().fleet.items == \
        sum(3 + i for i in range(4)) + 8


def test_reprogram_runs_no_compile_and_equals_a_fresh_compile(weights):
    _, _, tspec, tparams = weights["a"]
    _, _, tspec_b, tparams_b = weights["b"]
    d = deploy([AppSpec("alpha", tspec, params=tparams),
                AppSpec("beta", tspec_b, params=tparams_b,
                        system="digital")], n_chips=2, device="cpu")
    x, xb = torch.from_numpy(_x(0, 9)), torch.from_numpy(_x(1, 9, 32))
    before_b = d.stream("beta", xb)
    new = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(5),
                       device="cpu")
    c0 = compile_count()
    d.reprogram("alpha", new)
    assert compile_count() == c0 and d.params("alpha") is new
    fresh = compile_chip(tspec, params=new, device="cpu")
    assert torch.equal(d.stream("alpha", x), fresh.stream(x))
    assert torch.equal(d.stream("beta", xb), before_b)


# -------------------- accounting -------------------------------------- #
def _report_close(got, want):
    assert got.n_chips == want.n_chips and set(got.apps) == set(want.apps)
    for name, rep in want.apps.items():
        g = got.apps[name]
        assert g.n_chips == rep.n_chips and g.cores == rep.cores
        assert g.chip.to_dict() == pytest.approx(rep.chip.to_dict(),
                                                 rel=1e-9)
        for f in ("area_mm2", "power_mw", "capacity_items_per_second",
                  "routing_limited_items_per_second",
                  "energy_per_item_nj"):
            assert getattr(g, f) == pytest.approx(getattr(rep, f), rel=1e-9)
    assert got.cores == want.cores
    for f in ("area_mm2", "power_mw", "capacity_items_per_second"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-9)


@pytest.mark.parametrize("hetero", [False, True])
def test_deployment_report_equals_the_reference(weights, hetero):
    """Chips compiled from the same weights: the report is pure in the
    chips, so it equals the reference's at 1e-9, homogeneous (every
    app on 3 chips) or heterogeneous (per-app submesh sizes)."""
    ja, jb = weights["a"], weights["b"]
    jchips = {"a": jchip.compile_chip(ja[0], params=ja[1],
                                      items_per_second=2e5),
              "b": jchip.compile_chip(jb[0], params=jb[1],
                                      system="digital"),
              "edge": jchip.compile_chip(((1, (9, 20, 15)),))}
    tchips = {"a": compile_chip(ja[2], params=ja[3], items_per_second=2e5,
                                device="cpu"),
              "b": compile_chip(jb[2], params=jb[3], system="digital",
                                device="cpu"),
              "edge": compile_chip(((1, (9, 20, 15)),), device="cpu")}
    if hetero:
        n = {"a": 1, "b": 2, "edge": 1}
        want = jdeploy.deployment_report(jchips, n, total_chips=3)
        got = deployment_report(tchips, n, total_chips=3)
    else:
        want = jdeploy.deployment_report(jchips, 3)
        got = deployment_report(tchips, 3)
    _report_close(got, want)
    assert str(got).splitlines()[0] == str(want).splitlines()[0]
    with pytest.raises(ValueError, match="no n_chips entry"):
        deployment_report(tchips, {"a": 1})


def test_heterogeneous_deployment_on_one_device(weights):
    """``chip_systems`` builds one logical chip per entry on the one
    device; each app serves on its own system's submesh."""
    _, _, tspec, tparams = weights["a"]
    _, _, tspec_b, tparams_b = weights["b"]
    d = deploy(DeploymentSpec(apps=(
        AppSpec("a", tspec, params=tparams, lanes_per_chip=3),
        AppSpec("b", tspec_b, params=tparams_b, system="sram",
                lanes_per_chip=2),
    ), chip_systems=("memristor", "digital", "digital"), device="cpu"))
    assert d.n_chips == 3 and d.chip_systems == ("memristor", "digital",
                                                 "digital")
    assert (d.app_chips("a"), d.app_chips("b")) == (1, 2)
    assert d.router.slots == 3 * 1 + 2 * 2
    for app, spec_, params, system in (("a", tspec, tparams, "memristor"),
                                       ("b", tspec_b, tparams_b,
                                        "digital")):
        x = torch.from_numpy(_x(4, 7, spec_.dims[0]))
        want = compile_chip(spec_, params=params, system=system,
                            device="cpu").stream(x)
        assert torch.equal(d.stream(app, x), want)
    rep = d.report()
    assert rep.n_chips == 3 and rep.apps["b"].n_chips == 2
    assert rep.power_mw == pytest.approx(
        d.chip("a").report().power_mw + 2 * d.chip("b").report().power_mw,
        rel=1e-12)
    with pytest.raises(ValueError, match="heterogeneous"):
        d.resize(4)


# -------------------- admission, rates, refusals ---------------------- #
def test_queue_limit_semantics(weights):
    """The app's bound wins over the deployment-wide default; ``None``
    everywhere is unbounded."""
    _, _, tspec, tparams = weights["a"]
    _, _, tspec_b, tparams_b = weights["b"]
    d = deploy(DeploymentSpec(apps=(
        AppSpec("a", tspec, params=tparams, queue_limit=1),
        AppSpec("b", tspec_b, params=tparams_b)), queue_limit=2,
        device="cpu"))
    assert [d.submit("a", _x(i, 2)) for i in range(3)] == \
        [True, False, False]
    assert [d.submit("b", _x(i, 2, DIMS_B[0])) for i in range(3)] == \
        [True, True, False]
    assert d.stats().apps["a"].rejected == 2
    d.run_until_drained()
    free = deploy(AppSpec("a", tspec, params=tparams), device="cpu")
    assert all(free.submit("a", _x(i, 1)) for i in range(50))


def test_rate_warnings_fire_exactly_once():
    """An infeasible SLO warns once at deploy time (the compile defers
    to the fleet-scope check), as the reference does, for a streaming
    and for an analytic-only tenant; ``strict_rate`` raises."""
    deep = (784, 200, 100, 10)
    jspec = jcl.MLPSpec(deep)
    jparams = jcl.mlp_init(jax.random.PRNGKey(0), jspec)
    tspec = tcl.MLPSpec(deep)
    tparams = tcl.params_from_numpy(_np_params(jparams), device="cpu")
    chip = compile_chip(tspec, params=tparams, device="cpu")
    bad = 1e3 * chip.route.max_items_per_second

    def count(fn, category):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
        return [w for w in caught if issubclass(w.category, category)]

    for tnet, jnet, kw in ((tspec, jspec, {}), ((1, deep), (1, deep), {})):
        ours = count(lambda: deploy(AppSpec(
            "a", tnet, params=tparams if tnet is tspec else None,
            items_per_second=bad), device="cpu"), ChipRateWarning)
        theirs = count(lambda: jdeploy.deploy(jdeploy.AppSpec(
            "a", jnet, params=jparams if jnet is jspec else None,
            items_per_second=bad), n_chips=1), jchip.ChipRateWarning)
        assert len(ours) == len(theirs) == 1
        assert "fleet-wide" in str(ours[0].message)
    with pytest.raises(ValueError, match="infeasible"):
        deploy(AppSpec("a", tspec, params=tparams, items_per_second=bad),
               strict_rate=True, device="cpu")
    assert not count(lambda: deploy(AppSpec(
        "a", tspec, params=tparams, items_per_second=1e4), device="cpu"),
        ChipRateWarning)


def test_lm_tenants_and_closed_deployments_refuse(weights):
    """An LM tenant of a family ``compile_lm`` cannot map raises
    ``NotImplementedError`` at deploy (LM tenants themselves are tested
    in ``test_torch_lm.py``); the LM verbs refuse a sensor tenant; a
    closed deployment refuses every verb."""
    _, _, tspec, tparams = weights["a"]

    class LMConfig:
        family = "qwen"
        num_layers = 2

    with pytest.raises(NotImplementedError, match="dense transformer"):
        deploy(AppSpec("lm", LMConfig()), device="cpu")
    d = deploy(AppSpec("a", tspec, params=tparams), device="cpu")
    with pytest.raises(TypeError, match="sensor tenant"):
        d.submit_tokens("a", (1, 2, 3))
    with pytest.raises(TypeError, match="sensor tenant"):
        d.generated_tokens("a")
    with pytest.raises(ValueError, match="unknown app"):
        d.submit("nope", _x(0, 1))
    with d:
        assert "a:memristor" in repr(d)
    assert repr(d) == "Deployment[closed]"
    x = _x(0, 2)
    for verb in (lambda: d.stream("a", x), lambda: d.submit("a", x),
                 d.step, d.run_until_drained, d.report, d.metrics,
                 lambda: d.trace("t.json"), lambda: d.resize(2),
                 lambda: d.reprogram("a", tparams), d.stats,
                 lambda: d.chip("a")):
        with pytest.raises(RuntimeError, match="closed"):
            verb()
    d.close()                                      # idempotent


def test_deploy_entry_forms_and_refusals(weights):
    _, _, tspec, tparams = weights["a"]
    spec = DeploymentSpec(apps=(AppSpec("a", tspec, params=tparams),),
                          device="cpu")
    with pytest.raises(ValueError, match="inside the DeploymentSpec"):
        deploy(spec, n_chips=2)
    with pytest.raises(ValueError, match="FleetMesh"):
        deploy(AppSpec("a", tspec, params=tparams), mesh=object(),
               device="cpu")
    with pytest.raises(ValueError, match="no monitor attached"):
        deploy(spec).attach_recalibration("a")
    # the default device is the card, never a fallback to the CPU
    if torch.cuda.is_available():
        assert deploy(AppSpec("a", tspec, params=tparams)).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deploy(AppSpec("a", tspec, params=tparams))


def test_shard_serve_warns_once_and_deploy_gives_the_same_router(
        weights, monkeypatch):
    """``ShardedChip.serve`` is deprecated in favour of ``deploy``: it
    warns once a process, naming ``repro_torch.deploy.deploy``, and the
    deployment's router serves the same trace to the same results,
    steps and lanes."""
    _, _, tspec, tparams = weights["a"]
    chip = compile_chip(tspec, params=tparams, device="cpu")
    monkeypatch.setattr(tcompile, "_DEPRECATION_WARNED", set())
    fleet = shard_chip(chip, 2)
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.deploy\.deploy"):
        old = fleet.serve(lanes_per_chip=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        again = fleet.serve(lanes_per_chip=2)
    assert type(old) is type(again) is FleetRouter
    d = deploy(AppSpec("app", tspec, params=tparams, lanes_per_chip=2),
               n_chips=2, device="cpu")
    reqs = [_x(i, 2 + i % 3) for i in range(7)]
    for uid, items in enumerate(reqs):
        old.submit(ItemRequest(uid=uid, items=items))
        d.submit("app", items)
    a, b = old.run_until_drained(), d.run_until_drained()
    assert d.router.slots == old.slots == 4
    assert d.router.steps == old.steps
    assert [s.request.uid for s in a] == [s.request.uid for s in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.result, y.result)


# -------------------- the selftests ----------------------------------- #
def test_deploy_selftest_passes_on_the_cpu():
    assert dmain.selftest(verbose=False, device="cpu")


def test_variability_selftest_passes_on_the_cpu():
    from repro_torch.variability import __main__ as vmain
    assert vmain.selftest(verbose=False, device="cpu")


def test_obs_selftest_passes_on_the_cpu():
    from repro_torch.obs import __main__ as omain
    assert omain.selftest(verbose=False, device="cpu")
