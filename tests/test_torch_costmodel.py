"""The port's cost model, paper-app configs and chip reports against the
reference, on the CPU.

The cost model is plain Python in both packages, with the reference's
operation order kept, so the numbers are compared at rel 1e-9 against
the committed golden files (``tests/golden/dse_tables.json``,
``tests/golden/fleet_tables.json``, the reference's own pins of Tables
II–VI and Figs. 13–14) and for equality against the live reference.
"""
import dataclasses
import json
import pathlib

import pytest
import torch

from repro.chip import compile_app as jcompile_app
from repro.configs import paper_apps as japps
from repro.core import costmodel as jcost

from repro_torch.chip import compile_app, compile_chip
from repro_torch.chip import compile as tcompile
from repro_torch.chip.report import ChipReport, chip_report
from repro_torch.configs import paper_apps as tapps
from repro_torch.core import costmodel as tcost
from repro_torch.core.neural_core import CoreGeometry as TGeom

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
RTOL = 1e-9
SYSTEMS = {"1t1m": "memristor", "digital": "digital"}


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), path
    else:
        assert got == want, path


def _cost_dict(c):
    d = dataclasses.asdict(c)
    d.pop("mapping")
    d.pop("route")
    return d


@pytest.fixture(scope="module")
def fleet_golden():
    return json.loads((GOLDEN / "fleet_tables.json").read_text())["apps"]


@pytest.fixture(scope="module")
def dse_golden():
    return json.loads((GOLDEN / "dse_tables.json").read_text())


# ------------------------------ DSE (Figs. 13–14) --------------------- #
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_design_space_equals_golden_and_reference(system, dse_golden):
    got = tcost.design_space(system)
    _close(got, dse_golden["design_space"][system])
    assert got == jcost.design_space(system)


@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_best_geometry_equals_golden(system, dse_golden):
    # the golden file is the reference's own pin of its selection
    assert tcost.best_geometry(system) == \
        dse_golden["best_geometry"][system]


def test_best_geometry_refusals_and_options_match_reference():
    pairs = [(TGeom(r, r // 2), jcost.CoreGeometry(r, r // 2))
             for r in (64, 128, 256)]
    tg, jg = [t for t, _ in pairs], [j for _, j in pairs]
    for kw in (dict(bits=16), dict(apps=["nope"])):
        with pytest.raises(ValueError) as jerr:
            jcost.best_geometry("memristor", jg, **kw)
        with pytest.raises(ValueError) as terr:
            tcost.best_geometry("memristor", tg, **kw)
        assert str(terr.value) == str(jerr.value)
    # every app voting, and a sweep of the caller's geometries
    for kw in (dict(apps=list(tapps.APPS)), dict()):
        assert tcost.best_geometry("memristor", tg, **kw) == \
            jcost.best_geometry("memristor", jg, **kw)


# ------------------------------ Tables II–VI -------------------------- #
@pytest.mark.parametrize("app_id", sorted(tapps.APPS))
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_compile_app_report_equals_golden_and_reference(app_id, system,
                                                        fleet_golden):
    chip = compile_app(tapps.APPS[app_id], system, device="cpu")
    assert chip.plan is None and chip.rate_validated
    rep = chip.report()
    assert isinstance(rep, ChipReport)
    got = rep.to_dict()
    _close(got, fleet_golden[app_id][system])
    jrep = jcompile_app(japps.APPS[app_id], system).report()
    assert got == jrep.to_dict()
    assert str(rep) == str(jrep)
    assert rep.power_mw == pytest.approx(
        rep.leak_mw + rep.compute_mw + rep.routing_mw + rep.tsv_mw,
        rel=1e-12)


@pytest.mark.parametrize("app_id", sorted(tapps.APPS))
def test_risc_cost_equals_golden_and_reference(app_id, fleet_golden):
    got = tcost.risc_cost(tapps.APPS[app_id])
    _close(_cost_dict(got), fleet_golden[app_id]["risc"])
    assert _cost_dict(got) == _cost_dict(jcost.risc_cost(
        japps.APPS[app_id]))
    assert got.energy_per_item_nj == \
        jcost.risc_cost(japps.APPS[app_id]).energy_per_item_nj


def test_all_tables_and_efficiency_equal_reference():
    t, j = tcost.all_tables(), jcost.all_tables()
    assert set(t) == set(j) == set(tapps.APPS)
    for app_id in t:
        assert {k: _cost_dict(v) for k, v in t[app_id].items()} == \
            {k: _cost_dict(v) for k, v in j[app_id].items()}
        assert tcost.efficiency_over_risc(t[app_id]) == \
            jcost.efficiency_over_risc(j[app_id])


def test_specialized_cost_normalizes_system_aliases():
    app = tapps.APPS["deep"]
    assert _cost_dict(tcost.specialized_cost(app, "1t1m")) == \
        _cost_dict(tcost.specialized_cost(app, "memristor"))
    assert _cost_dict(tcost.specialized_cost(app, "sram")) == \
        _cost_dict(jcost.specialized_cost(japps.APPS["deep"], "digital"))
    with pytest.raises(ValueError):
        tcost.specialized_cost(app, "analog")


# ------------------------------ paper-app configs --------------------- #
def test_paper_app_configs_equal_reference():
    assert set(tapps.APPS) == set(japps.APPS)
    for app_id, t in tapps.APPS.items():
        j = japps.APPS[app_id]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.tsv_bits_per_item == j.tsv_bits_per_item
        for system in ("memristor", "1t1m", "digital", "sram"):
            assert t.nets(system) == j.nets(system)
            assert t.sensor_flags(system) == j.sensor_flags(system)
            assert t.net_deps(system) == j.net_deps(system)
    assert tapps.PAPER_TABLES == japps.PAPER_TABLES
    assert tapps.PAPER_TABLE_I == japps.PAPER_TABLE_I


# ------------------------------ reports of streamable chips ----------- #
def test_report_of_a_weighted_chip_equals_the_analytic_one():
    """Programmed state does not enter the accounting: a chip compiled
    with weights reports what its analytic compile reports, and an
    unset rate is accounted at one replica's capacity."""
    from repro_torch.core import crossbar_layer as tcl
    spec = tcl.MLPSpec((784, 200, 100, 10))
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    chip = compile_chip(spec, params=params, items_per_second=1e5,
                        tsv_bits_per_item=784 * 8.0, device="cpu")
    analytic = compile_app(tapps.APPS["deep"], "memristor", device="cpu")
    assert chip.report().to_dict() == analytic.report().to_dict()
    free = compile_chip(((1, (784, 200, 100, 10)),), device="cpu")
    rep = chip_report(free)
    assert rep.items_per_second == rep.capacity_items_per_second == \
        free.mapping.items_per_second_capacity


def test_strict_rate_raises_and_validate_rate_is_recorded():
    nets = ((1, (784, 200, 100, 10)),)
    probe = compile_chip(nets, device="cpu")
    rate = 10 * probe.replication * probe.route.max_items_per_second
    with pytest.raises(ValueError, match="infeasible"):
        compile_chip(nets, items_per_second=rate, strict_rate=True,
                     device="cpu")
    quiet = compile_chip(nets, items_per_second=rate, validate_rate=False,
                         device="cpu")
    assert not quiet.rate_validated
    with pytest.warns(tcompile.ChipRateWarning, match="infeasible"):
        loud = compile_chip(nets, items_per_second=rate, device="cpu")
    assert loud.rate_validated
    assert quiet.report().to_dict() == loud.report().to_dict()
