"""The port's fabric autotuner (``repro_torch.tune``) against the
reference's ``repro.tune``, on the CPU.

The search is analytic plain Python over the port's copy of the cost
oracle, so every candidate (feasible, reason, n_chips), every frontier
row and the winning assignment must be the reference's, with area,
power and capacity at rel 1e-9, and ``TunedFabric.report()`` must print
the same lines. The scenarios are the reference selftest's
(``src/repro/tune/__main__.py``: deep and 12-bit ocr at 1e5 items/s,
free and under a binding power budget) and ``tests/test_tune.py``'s
chip-budget and throughput-split cases. The tuned spec then deploys on
the CPU with the reference's weights handed across, each tenant equal
to its single-system chip to the bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.deploy as jdeploy
import repro.tune as jtune
from repro.core import crossbar_layer as jcl

import repro_torch.tune as ttune
from repro_torch.chip import compile_chip
from repro_torch.configs.paper_apps import APPS
from repro_torch.core import crossbar_layer as tcl
from repro_torch.core.neural_core import CoreGeometry
from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
from repro_torch.tune import (DEFAULT_GEOMETRIES, TuneBudget,
                              candidate_point, tune)
from repro_torch.tune import __main__ as tmain

torch.set_num_threads(1)

SLO = 1e5
FLOATS = ("area_mm2", "power_mw", "capacity_items_per_second",
          "items_per_second")


def _specs(**kw):
    apps = (("deep", "deep", {}), ("ocr", "ocr", {"weight_bits": 12}))
    return (jdeploy.DeploymentSpec(apps=tuple(
        jdeploy.AppSpec(n, net, items_per_second=SLO, **a)
        for n, net, a in apps), **kw),
        DeploymentSpec(apps=tuple(
            AppSpec(n, net, items_per_second=SLO, **a)
            for n, net, a in apps), device="cpu", **kw))


def _same_point(got, want):
    assert (got.app, got.system, got.geometry, got.n_chips, got.feasible,
            got.reason) == (want.app, want.system, want.geometry,
                            want.n_chips, want.feasible, want.reason)
    for f in FLOATS:
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-9)


def _same_fabric(got, want):
    assert len(got.candidates) == len(want.candidates)
    for g, w in zip(got.candidates, want.candidates):
        _same_point(g, w)
    assert len(got.frontier) == len(want.frontier)
    for g, w in zip(got.frontier, want.frontier):
        assert (g.assignment, g.chip_systems, g.n_chips, g.feasible,
                g.reason, g.selected) == (w.assignment, w.chip_systems,
                                          w.n_chips, w.feasible, w.reason,
                                          w.selected)
        assert (g.area_mm2, g.power_mw) == pytest.approx(
            (w.area_mm2, w.power_mw), rel=1e-9)
    assert set(got.assignment) == set(want.assignment)
    for name in want.assignment:
        _same_point(got.assignment[name], want.assignment[name])
    assert got.chip_systems == want.chip_systems
    assert got.n_chips == want.n_chips
    assert got.area_mm2 == pytest.approx(want.area_mm2, rel=1e-9)
    assert got.power_mw == pytest.approx(want.power_mw, rel=1e-9)
    assert got.report().splitlines() == want.report().splitlines()
    assert [dataclasses.asdict(a) for a in got.spec.apps] == \
        [dataclasses.asdict(a) for a in want.spec.apps]
    assert got.spec.chip_systems == want.spec.chip_systems


@pytest.fixture(scope="module")
def free():
    jspec, tspec = _specs()
    return jtune.tune(jspec), tune(tspec), jspec, tspec


def test_free_search_equals_the_reference(free):
    want, got, _, tspec = free
    _same_fabric(got, want)
    assert {a: (p.system, p.geometry, p.n_chips)
            for a, p in got.assignment.items()} == \
        {"deep": ("memristor", "128x64", 1), "ocr": ("digital", "128x64", 1)}
    assert got.chip_systems == ("digital", "memristor")
    assert got.spec.device == "cpu" and got.spec.use_kernel


def test_budgeted_search_equals_the_reference(free):
    want_free, got_free, jspec, tspec = free
    homog = min(f.power_mw for f in got_free.frontier
                if f.feasible and f.homogeneous)
    power = (got_free.power_mw + homog) / 2
    want = jtune.tune(jspec, jtune.TuneBudget(power_mw=power))
    got = tune(tspec, TuneBudget(power_mw=power))
    _same_fabric(got, want)
    assert all(not f.feasible and "over power budget" in f.reason
               for f in got.frontier if f.homogeneous)


def test_chip_budget_case_equals_the_reference():
    """``max_chips=1``: both apps co-reside on one digital chip."""
    jspec, tspec = _specs()
    want = jtune.tune(jspec, jtune.TuneBudget(max_chips=1))
    got = tune(tspec, TuneBudget(max_chips=1))
    _same_fabric(got, want)
    assert got.n_chips == 1 and got.chip_systems == ("digital",)


def test_throughput_split_case_equals_the_reference():
    """An SLO 40× one chip's routed capacity splits the app across
    chips; a chip cap below that is a named infeasibility."""
    japp = jdeploy.AppSpec("deep", "deep", items_per_second=SLO)
    tapp = AppSpec("deep", "deep", items_per_second=SLO)
    base = candidate_point(tapp, "memristor", (128, 64))
    _same_point(base, jtune.candidate_point(japp, "memristor", (128, 64)))
    rate = base.capacity_items_per_second * 40
    big_t = dataclasses.replace(tapp, items_per_second=rate)
    big_j = dataclasses.replace(japp, items_per_second=rate)
    pt = candidate_point(big_t, "memristor", (128, 64))
    _same_point(pt, jtune.candidate_point(big_j, "memristor", (128, 64)))
    assert pt.feasible and pt.n_chips >= 2
    capped = candidate_point(big_t, "memristor", (128, 64),
                             max_chips=pt.n_chips - 1)
    _same_point(capped, jtune.candidate_point(
        big_j, "memristor", (128, 64), max_chips=pt.n_chips - 1))
    assert not capped.feasible and "throughput" in capped.reason


@pytest.mark.parametrize("case,match", [("memristor_only", "IR-drop"),
                                        ("absurd_budget",
                                         "over power budget")])
def test_infeasible_searches_raise_as_the_reference(case, match):
    jspec, tspec = _specs()
    if case == "memristor_only":
        def run(mod, spec):
            return mod.tune(spec, systems=("memristor",))
    else:
        def run(mod, spec):
            return mod.tune(spec, mod.TuneBudget(power_mw=1.0))
    with pytest.raises(ValueError, match=match) as want:
        run(jtune, jspec)
    with pytest.raises(ValueError, match=match) as got:
        run(ttune, tspec)
    assert str(got.value) == str(want.value)


def test_budget_checks_and_geometries_as_the_reference():
    for field in ("area_mm2", "power_mw", "max_chips"):
        with pytest.raises(ValueError, match=field):
            TuneBudget(**{field: -1})
    assert DEFAULT_GEOMETRIES == jtune.DEFAULT_GEOMETRIES


def test_tuned_spec_deploys_with_handed_across_weights(free):
    """The tuned spec deployed on the CPU, its tenants' weights the
    reference's: each tenant streams as its single-system chip to the
    bit, and the deployment's report reproduces the tuner's cost at
    1e-9."""
    _, got, _, _ = free
    apps, chips, xs = [], {}, {}
    for i, app in enumerate(got.spec.apps):
        pt = got.assignment[app.name]
        dims = APPS[app.name].nets(pt.system)[0][1]
        jparams = jcl.mlp_init(jax.random.PRNGKey(10 + i), jcl.MLPSpec(dims))
        params = tcl.params_from_numpy(
            [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
            device="cpu")
        apps.append(dataclasses.replace(app, params=params))
        chips[app.name] = compile_chip(
            tcl.MLPSpec(dims), params=params, system=pt.system,
            geom=CoreGeometry(*pt.geom), weight_bits=app.weight_bits,
            device="cpu")
        xs[app.name] = torch.from_numpy(np.random.default_rng(i).uniform(
            0, 1, (9, dims[0])).astype(np.float32))
    d = deploy(dataclasses.replace(got.spec, apps=tuple(apps)))
    assert d.chip_systems == got.chip_systems and d.n_chips == 2
    for name, chip in chips.items():
        assert torch.equal(d.stream(name, xs[name]), chip.stream(xs[name]))
    assert d.chip("ocr").plan[0].tiles.bits == 12
    rep = d.report()
    assert rep.area_mm2 == pytest.approx(got.area_mm2, rel=1e-9)
    assert rep.power_mw == pytest.approx(got.power_mw, rel=1e-9)


def test_tune_selftest_passes_on_the_cpu():
    assert tmain.selftest(verbose=False, device="cpu")
