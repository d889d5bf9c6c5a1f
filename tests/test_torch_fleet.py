"""The port's one-process fleet (``repro_torch.fleet``) against the
reference's ``repro.fleet``, on the CPU.

The fleet folds its logical chips into the batch, so its stream must
equal the single chip's to the bit (``torch.equal``: batch rows are
independent, as the reference's rel 0.0 pin says). Against the
reference's stream on carried weights the bound is rel ≤ 1e-5, held on
the rows where no hidden threshold unit lies within 1e-5·max|pre| of
zero (R6). Router accounting is compared where it is deterministic:
admissions, rejections, steps, items, finish order and lanes; the
stats formulas on the same stamps to 1e-12.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.chip as jchip
import repro.fleet as jfleet
from repro.chip import compile as jcompile
from repro.core import crossbar_layer as jcl
from repro.serving.engine import ItemRequest as JRequest
from repro.serving.engine import ItemRequestState as JState

from repro_torch import obs as tobs
from repro_torch.chip import compile as tcompile
from repro_torch.chip import ChipRateWarning, compile_chip, reprogram_chip
from repro_torch.core import crossbar_layer as tcl
from repro_torch.data import SensorPipeline
from repro_torch.fleet import (BoundedQueue, FleetRouter, RouterStats,
                               StreamSource, merge_stats, shard_chip)
from repro_torch.fleet import __main__ as fmain
from repro_torch.fleet import router as trouter
from repro_torch.kernels import ops
from repro_torch.serving.engine import ItemRequest, ItemRequestState
from repro_torch.variability import NoiseModel

torch.set_num_threads(1)

DIMS = (64, 32, 10)
BAND = 1e-5
SYSTEMS = [("memristor", 8), ("digital", 8), ("digital", 12)]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _np_params(jparams):
    return [{k: np.asarray(v) for k, v in p.items()} for p in jparams]


@pytest.fixture(scope="module")
def pairs():
    """The reference's and the port's chips on the same weights, per
    (system, bits)."""
    jspec = jcl.MLPSpec(DIMS, activation="threshold",
                        out_activation="linear")
    jparams = jcl.mlp_init(jax.random.PRNGKey(0), jspec)
    tspec = tcl.MLPSpec(DIMS, activation="threshold",
                        out_activation="linear")
    tparams = tcl.params_from_numpy(_np_params(jparams), device="cpu")
    out = {}
    for system, bits in SYSTEMS:
        jc = jchip.compile_chip(jspec, params=jparams, system=system,
                                weight_bits=bits)
        tc = compile_chip(tspec, params=tparams, system=system,
                          weight_bits=bits, device="cpu")
        out[system, bits] = (jc, tc)
    return out, tspec, tparams


@pytest.fixture
def chip(pairs):
    return pairs[0]["memristor", 8][1]


def _x(seed, b, d=DIMS[0]):
    return torch.rand((b, d), generator=torch.Generator().manual_seed(seed))


# -------------------- sharded stream ---------------------------------- #
@pytest.mark.parametrize("system,bits", SYSTEMS)
@pytest.mark.parametrize("n_chips", [1, 2, 3, 4])
def test_fleet_stream_equals_chip_stream(pairs, system, bits, n_chips):
    """Ragged batches included (any B, whatever the fleet size): the
    rows equal the chip's to the bit."""
    tc = pairs[0][system, bits][1]
    fleet = shard_chip(tc, n_chips)
    assert fleet.n_chips == n_chips and not fleet.is_distributed
    for b in (1, 2, 7, 13):
        x = _x(b, b)
        y = fleet.stream(x)
        assert y.shape == (b, DIMS[-1]) and y.device == tc.device
        assert torch.equal(y, tc.stream(x))
    host = fleet.stream_host(_x(5, 5).numpy())
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    np.testing.assert_array_equal(host, tc.stream(_x(5, 5)).numpy())
    assert torch.equal(fleet(_x(6, 3)), tc.stream(_x(6, 3)))


@pytest.mark.parametrize("system,bits", SYSTEMS)
def test_fleet_stream_matches_reference(pairs, system, bits):
    """Four logical chips against the reference's (one-device) fleet on
    the same weights, rel ≤ 1e-5 on the rows outside the threshold
    band."""
    jc, tc = pairs[0][system, bits]
    x = np.random.default_rng(3).uniform(0, 1, (37, DIMS[0])).astype(
        np.float32)
    ref = np.asarray(jfleet.shard_chip(jc, 1).stream(jnp.asarray(x)))
    out = shard_chip(tc, 4).stream(torch.from_numpy(x)).numpy()
    clear = np.ones(x.shape[0], bool)
    h = jnp.asarray(x)
    for layer in jc.plan[:-1]:
        pre = np.asarray(jcompile._apply_stream_layer(
            dataclasses.replace(layer, activation="linear"), h, False))
        clear &= ~np.any(np.abs(pre) <= BAND * np.abs(pre).max(), axis=1)
        h = jcompile._apply_stream_layer(layer, h, False)
    assert clear.sum() >= 30
    assert _rel(out[clear], ref[clear]) <= 1e-5


def test_fleet_runs_one_stream_call_per_batch(chip, monkeypatch):
    """The logical chips are folded into the batch: one stream_pipeline
    call over the whole batch, never one per chip."""
    calls = []
    real = tcompile.stream_pipeline

    def spy(plan, x, **kw):
        calls.append(x.shape[0])
        return real(plan, x, **kw)

    from repro_torch.fleet import shard as tshard
    monkeypatch.setattr(tshard, "stream_pipeline", spy)
    shard_chip(chip, 4).stream(_x(1, 13))
    assert calls == [13]


def test_fleet_rejects_analytic_chip_and_bad_sizes(chip):
    analytic = compile_chip((1, (8, 4)), device="cpu")
    with pytest.raises(ValueError, match="analytic-only"):
        shard_chip(analytic, 1)
    with pytest.raises(ValueError, match="analytic-only"):
        FleetRouter(analytic)
    with pytest.raises(ValueError, match="n_chips"):
        shard_chip(chip, 0)
    fleet = shard_chip(chip, 2)
    with pytest.raises(ValueError, match="n_chips"):
        fleet.resize(0)


def test_default_fleet_size_is_one_for_a_cpu_chip(chip):
    fleet = shard_chip(chip)
    assert fleet.n_chips == 1
    fleet.resize(3)
    fleet.resize()
    assert fleet.n_chips == 1
    assert (fleet.d_in, fleet.d_out) == (DIMS[0], DIMS[-1])
    assert shard_chip(chip, 3).total_cores == 3 * chip.total_cores


def test_multi_process_verbs_are_not_ported(chip):
    """The multi-process verbs (ported since: ROADMAP Queue 1 item 6b)
    on a one-process fleet: every chip is local, ``stream_local`` is the
    whole stream, and the lockstep router refuses the fleet."""
    fleet = shard_chip(chip, 2)
    assert fleet.is_distributed is False
    assert fleet.local_chips == [0, 1] and fleet.n_local_chips == 2
    x = _x(1, 2).numpy()
    np.testing.assert_array_equal(fleet.stream_local(x),
                                  fleet.stream_host(x))
    with pytest.raises(ValueError, match="spans processes"):
        trouter.DistributedFleetRouter(fleet)


@pytest.mark.parametrize("system,bits", SYSTEMS)
def test_resize_and_reprogram_compile_nothing(pairs, system, bits):
    tc = pairs[0][system, bits][1]
    tspec, tparams = pairs[1], pairs[2]
    fleet = shard_chip(tc, 4)
    x = _x(2, 11)
    c0 = tcompile.compile_count()
    for n in (2, 4, 1, 3):
        fleet.resize(n)
        assert fleet.n_chips == n
        assert torch.equal(fleet.stream(x), tc.stream(x))
    new = [{"w": -p["w"], "b": p["b"] + 0.1} for p in tparams]
    fleet.reprogram(new)
    assert tcompile.compile_count() == c0
    assert fleet.chip is not tc and fleet.chip.route is tc.route
    assert torch.equal(fleet.stream(x),
                       reprogram_chip(tc, new).stream(x))
    assert tcompile.compile_count() == c0


def test_drifting_fleet_shares_the_source_chips_age():
    """Every member streams at the source chip's age, and the source
    chip's clock advances by the batch; the fleet equals a twin
    chip streamed the same batches."""
    spec = tcl.MLPSpec(DIMS)
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(4),
                          device="cpu")
    noise = NoiseModel(drift_rate=1e-3, program_sigma=0.05, seed=1)
    a = compile_chip(spec, params=params, noise=noise, device="cpu")
    b = compile_chip(spec, params=params, noise=noise, device="cpu")
    fleet = shard_chip(a, 3)
    outs = []
    for k, batch in enumerate((7, 13, 5)):
        x = _x(10 + k, batch)
        age = a.items_streamed
        got = fleet.stream(x)
        assert a.items_streamed == age + batch
        assert torch.equal(got, b.stream(x))
        assert b.items_streamed == a.items_streamed
        outs.append(got)
    x = _x(20, 7)
    assert not torch.equal(fleet.stream(x), compile_chip(
        spec, params=params, noise=noise, device="cpu").stream(x))
    fleet.reprogram(params)
    assert fleet.chip.items_streamed == 0


def test_fleet_rate_validation_warns_raises_and_matches_reference(pairs):
    """A fleet target is validated against replication × n_chips copies
    of the routed fabric, with the reference's message."""
    jc, tc = pairs[0]["memristor", 8]
    per_chip = tc.route.max_items_per_second * tc.replication
    with warnings.catch_warnings():
        warnings.simplefilter("error", ChipRateWarning)
        shard_chip(tc, 2, items_per_second=1.8 * per_chip)
    with pytest.warns(ChipRateWarning,
                      match="shard_chip.*infeasible") as got:
        fleet = shard_chip(tc, 2, items_per_second=1e3 * per_chip)
    assert got[0].filename == __file__       # points at the caller
    # one chip: the reference's (one-device) fleet says the same
    with pytest.warns(ChipRateWarning) as got:
        shard_chip(tc, 1, items_per_second=1e3 * per_chip)
    with pytest.warns(jchip.ChipRateWarning) as want:
        jfleet.shard_chip(jc, 1, items_per_second=1e3 * per_chip)
    assert str(got[0].message) == str(want[0].message)
    with pytest.raises(ValueError, match="infeasible"):
        shard_chip(tc, 2, items_per_second=1e3 * per_chip, strict_rate=True)
    # shrinking below a declared fleet rate is the degraded-mode signal
    ok = shard_chip(tc, 2, items_per_second=1.5 * per_chip)
    with pytest.warns(ChipRateWarning, match="ShardedChip.resize"):
        ok.resize(1)
    assert fleet.n_chips == 2


def test_validate_stream_rate_matches_the_reference(pairs):
    jc, tc = pairs[0]["memristor", 8]
    rate = 50 * tc.route.max_items_per_second
    kw = dict(context="ctx", fabric="copies", remedy="Do less.",
              chip_replicas=2)
    with pytest.warns(ChipRateWarning) as got:
        tcompile.validate_stream_rate(rate, 4, tc.route, False, **kw)
    with pytest.warns(jchip.ChipRateWarning) as want:
        jcompile.validate_stream_rate(rate, 4, jc.route, False, **kw)
    assert str(got[0].message) == str(want[0].message)
    with pytest.raises(ValueError) as t_err:
        tcompile.validate_stream_rate(rate, 4, tc.route, True)
    with pytest.raises(ValueError) as j_err:
        jcompile.validate_stream_rate(rate, 4, jc.route, True)
    assert str(t_err.value) == str(j_err.value).replace(
        "(repro.fleet)", "(repro_torch.fleet)")
    tcompile.validate_stream_rate(0.0, 1, tc.route, True)


def test_serve_is_deprecated_once_per_process(chip, monkeypatch):
    monkeypatch.setattr(tcompile, "_DEPRECATION_WARNED", set())
    fleet = shard_chip(chip, 2)
    with pytest.warns(DeprecationWarning, match="deploy"):
        router = fleet.serve(lanes_per_chip=3)
    assert isinstance(router, FleetRouter) and router.slots == 6
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        fleet.serve()


def test_selftest_passes_on_cpu(capsys):
    assert fmain.main(["--selftest", "--device", "cpu", "--chips", "3"]) == 0
    assert "selftest: PASS" in capsys.readouterr().out


# -------------------- router ------------------------------------------ #
def test_router_drains_and_matches_stream(chip):
    fleet = shard_chip(chip, 2)
    router = FleetRouter(fleet, lanes_per_chip=3)
    assert router.use_kernel and router.slots == 6
    rng = np.random.default_rng(1)
    reqs = [ItemRequest(uid=i, items=rng.uniform(-1, 1, (1 + i, DIMS[0])))
            for i in range(6)]
    for r in reqs:
        assert router.submit(r)
    done = router.run_until_drained()
    assert sorted(st.request.uid for st in done) == list(range(6))
    for st in done:
        want = chip.stream(torch.as_tensor(st.request.items,
                                           dtype=torch.float32)).numpy()
        np.testing.assert_allclose(st.result, want, atol=1e-5)


def test_router_over_a_bare_chip_and_a_twelve_bit_fleet(pairs):
    """A bare CompiledChip is a one-chip fleet; a 12-bit digital fleet
    streams on the router's default kernel path."""
    for tc, n in ((pairs[0]["memristor", 8][1], None),
                  (pairs[0]["digital", 12][1], 2)):
        router = FleetRouter(tc if n is None else shard_chip(tc, n),
                             lanes_per_chip=2)
        items = np.random.default_rng(2).uniform(0, 1, (5, DIMS[0]))
        router.submit(ItemRequest(uid=0, items=items))
        (st,) = router.run_until_drained()
        np.testing.assert_allclose(
            st.result, tc.stream(torch.as_tensor(items, dtype=torch.float32))
            .numpy(), atol=1e-5)


def test_router_admission_control(chip):
    router = FleetRouter(shard_chip(chip, 1), lanes_per_chip=2,
                         queue_limit=2)
    rng = np.random.default_rng(2)
    results = [router.submit(ItemRequest(uid=i,
                                         items=rng.uniform(0, 1, (2, 64))))
               for i in range(5)]
    assert results == [True, True, False, False, False]
    assert router.rejected == 3
    router.step()                     # admits 2 into lanes, queue frees
    assert router.submit(ItemRequest(uid=9,
                                     items=rng.uniform(0, 1, (2, 64))))


def test_router_latency_accounting(chip):
    router = FleetRouter(shard_chip(chip, 1), lanes_per_chip=2)
    rng = np.random.default_rng(3)
    for i in range(4):
        router.submit(ItemRequest(uid=i, items=rng.uniform(0, 1, (3, 64))))
    done = router.run_until_drained()
    for st in done:
        assert st.request.t_submit <= st.t_admit <= st.t_first <= st.t_done
        assert st.done_step >= st.admit_step
    stats = router.stats()
    assert stats.requests == 4 and stats.items == 12 and stats.lanes == 2
    assert stats.items_per_second > 0
    assert 0 < stats.occupancy <= 1
    assert stats.latency_s_p95 >= stats.latency_s_p50 > 0
    waits = [st.wait_s for st in sorted(done, key=lambda s: s.request.uid)]
    assert max(waits[2:]) >= max(waits[:2])


def test_router_step_when_idle_keeps_stepping(chip):
    fleet = shard_chip(chip, 1)
    router = FleetRouter(fleet, lanes_per_chip=2, step_when_idle=True)
    assert router.step() == 0 and router.steps == 1   # idle, but ran
    router.submit(ItemRequest(
        uid=0, items=np.random.default_rng(0).uniform(0, 1, (2, 64))))
    router.run_until_drained()
    idle = FleetRouter(fleet, lanes_per_chip=2)       # default: skip
    assert idle.step() == 0 and idle.steps == 0


def test_router_resize_rebuilds_lanes_without_compiling(chip):
    fleet = shard_chip(chip, 2)
    router = FleetRouter(fleet, lanes_per_chip=2)
    rng = np.random.default_rng(4)
    for i in range(5):
        router.submit(ItemRequest(uid=i, items=rng.uniform(0, 1, (6, 64))))
    router.step()
    c0 = tcompile.compile_count()
    router.resize(1)
    assert (router.slots, router.n_chips, fleet.n_chips) == (2, 1, 1)
    router.step()
    router.resize(3)
    assert (router.slots, router.n_chips) == (6, 3)
    done = router.run_until_drained()
    assert tcompile.compile_count() == c0
    assert sorted(st.request.uid for st in done) == list(range(5))
    assert router.items_emitted == 30


def test_bounded_queue_backpressure():
    q = BoundedQueue(2)
    assert q.offer(1) and q.offer(2)
    assert not q.offer(3)
    assert q.full and len(q) == 2
    assert q.poll() == 1
    assert q.offer(3)
    q.requeue(0)
    assert list(q) == [0, 2, 3] and q.full
    assert [q.poll(), q.poll(), q.poll(), q.poll()] == [0, 2, 3, None]
    with pytest.raises(ValueError, match="capacity"):
        BoundedQueue(0)


def test_stream_source_backpressure_and_drain():
    pipe = SensorPipeline(window=8, stride=8, height=16, width=16)
    src = StreamSource(pipe, n_requests=10, capacity=3)
    assert src.pump() == 3 and src.queue.full
    assert src.pump() == 0 and src.stalls == 2
    taken = [src.take() for _ in range(3)]
    assert [t.uid for t in taken] == [0, 1, 2]
    assert src.pump() == 3
    src.requeue(taken[:2])
    assert [r.uid for r in src.queue][:2] == [0, 1]
    while not src.exhausted:
        src.pump()
        src.take()
    assert src.produced == 10 and src.taken == 12


def test_router_serve_rejects_zero_capacity_queue(chip):
    pipe = SensorPipeline(window=8, stride=8, height=16, width=16)
    src = StreamSource(pipe, n_requests=3, capacity=2)
    router = FleetRouter(shard_chip(chip, 1), lanes_per_chip=2,
                         queue_limit=0)
    with pytest.raises(ValueError, match="queue_limit"):
        router.serve(src, max_steps=5)


def test_router_serve_loop_end_to_end(chip):
    """The closed sensor → router loop: every window is served and
    matches the direct stream, under bounded queues on both sides."""
    pipe = SensorPipeline(window=8, stride=8, height=16, width=16)
    src = StreamSource(pipe, n_requests=7, capacity=2)
    fleet = shard_chip(chip, 2)
    router = FleetRouter(fleet, lanes_per_chip=2, queue_limit=3)
    done = router.serve(src)
    assert len(done) == 7 and src.exhausted
    for st in done:
        np.testing.assert_allclose(
            st.result, fleet.stream(torch.from_numpy(st.request.items))
            .numpy(), atol=1e-5)


def test_merge_stats_rolls_up_counters(chip):
    fleet = shard_chip(chip, 1)
    rng = np.random.default_rng(7)

    def run_router(n_req):
        router = FleetRouter(fleet, lanes_per_chip=2)
        for i in range(n_req):
            router.submit(ItemRequest(uid=i,
                                      items=rng.uniform(0, 1, (2, 64))))
        router.run_until_drained()
        return router.stats()

    a, b = run_router(2), run_router(3)
    m = merge_stats([a, b])
    assert m.requests == 5 and m.items == 10
    assert m.lanes == a.lanes + b.lanes
    assert m.steps == max(a.steps, b.steps)
    assert m.wall_s == max(a.wall_s, b.wall_s)
    assert m.rejected == 0
    assert m.latency_s_p95 == max(a.latency_s_p95, b.latency_s_p95)
    assert m.items_per_second == pytest.approx(10 / m.wall_s)
    one = merge_stats([a])
    assert (one.requests, one.items, one.lanes) == \
        (a.requests, a.items, a.lanes)
    empty = merge_stats([])
    assert empty.requests == 0 and empty.items == 0
    assert "RouterStats" in str(m)


def test_fleet_report_composes_chip_report(chip):
    fleet = shard_chip(chip, 3)
    assert fleet.report().served is None
    router = FleetRouter(fleet, lanes_per_chip=2)
    rng = np.random.default_rng(4)
    for i in range(3):
        router.submit(ItemRequest(uid=i, items=rng.uniform(0, 1, (2, 64))))
    router.run_until_drained()
    rep = fleet.report(router)
    chip_rep = chip.report()
    assert rep.n_chips == 3
    assert rep.cores == 3 * chip_rep.cores
    assert rep.area_mm2 == pytest.approx(3 * chip_rep.area_mm2)
    assert rep.power_mw == pytest.approx(3 * chip_rep.power_mw)
    assert rep.energy_per_item_nj == chip_rep.energy_per_item_nj
    assert rep.capacity_items_per_second == pytest.approx(
        3 * chip_rep.capacity_items_per_second * chip_rep.replication)
    assert rep.routing_limited_items_per_second == pytest.approx(
        3 * chip_rep.routing_limited_items_per_second *
        chip_rep.replication)
    assert rep.served is not None and rep.served.items == 6
    assert rep.served_fraction_of_capacity == pytest.approx(
        rep.served.items_per_second / rep.capacity_items_per_second)
    assert "FleetReport" in str(rep) and "served" in str(rep)


def test_fleet_report_matches_the_reference(pairs):
    """The hardware roll-up of a 3-chip fleet equals the reference's
    (its fleet spans the one CPU device, so its report is scaled from
    the chip's the same way)."""
    for (system, bits), (jc, tc) in pairs[0].items():
        got = shard_chip(tc, 3).report()
        want = jfleet.shard_chip(jc, 1).report()
        for name in ("cores", "area_mm2", "power_mw",
                     "capacity_items_per_second",
                     "routing_limited_items_per_second"):
            assert getattr(got, name) == pytest.approx(
                3 * getattr(want, name), rel=1e-12), (system, bits, name)
        assert got.energy_per_item_nj == pytest.approx(
            want.energy_per_item_nj, rel=1e-12)


# -------------------- router accounting against the reference --------- #
class ToyFleet:
    """Row-pure payload: y = 2x + 1 (the reference's property-test
    fleet)."""
    d_in = 3

    def __init__(self, n_chips=1):
        self.n_chips = n_chips

    def stream(self, x, use_kernel=False):
        return np.asarray(x, np.float32) * 2.0 + 1.0


def _trace(router_cls, request_cls, schedule, *, lanes_per_chip, n_chips,
           queue_limit):
    router = router_cls(ToyFleet(n_chips), lanes_per_chip=lanes_per_chip,
                        queue_limit=queue_limit)
    rng = np.random.default_rng(0)
    log, uid = [], 0
    for lengths, steps_after in schedule:
        for n in lengths:
            items = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
            log.append(router.submit(request_cls(uid=uid, items=items)))
            uid += 1
        for _ in range(steps_after):
            log.append(router.step())
    log.append(len(router.run_until_drained()))
    fin = [(st.request.uid, st.slot, st.admit_step, st.done_step,
            st.result.tobytes()) for st in router.finished]
    return (log, fin, router.steps, router.items_emitted, router.rejected,
            router.slots)


@pytest.mark.parametrize("seed", range(6))
def test_router_accounting_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    schedule = [(list(rng.integers(1, 7, size=rng.integers(0, 6))),
                 int(rng.integers(0, 5))) for _ in range(rng.integers(2, 7))]
    kw = dict(lanes_per_chip=int(rng.integers(1, 4)),
              n_chips=int(rng.integers(1, 4)),
              queue_limit=[None, 1, 3][seed % 3])
    got = _trace(FleetRouter, ItemRequest, schedule, **kw)
    want = _trace(jfleet.FleetRouter, JRequest, schedule, **kw)
    assert got == want


def _states(request_cls, state_cls, stamps):
    out = []
    for uid, (t_submit, t_admit, t_done) in enumerate(stamps):
        st = state_cls(request=request_cls(uid=uid, items=np.zeros((1, 3)),
                                           t_submit=t_submit), slot=0)
        st.t_admit, st.t_done = t_admit, t_done
        out.append(st)
    return out


def test_stats_formulas_equal_the_reference_on_the_same_stamps():
    rng = np.random.default_rng(11)
    parts_t, parts_j = [], []
    for k in range(3):
        sub = np.cumsum(rng.uniform(0, 1e-3, 5 + k))
        stamps = [(s, s + rng.uniform(0, 1e-3), s + rng.uniform(1e-3, 5e-3))
                  for s in sub]
        kw = dict(items=17 + k, steps=9 + k, wall_s=0.25 + 0.1 * k,
                  lanes=4, rejected=k)
        t = trouter.stats_from_states(
            _states(ItemRequest, ItemRequestState, stamps), **kw)
        j = jfleet.router.stats_from_states(
            _states(JRequest, JState, stamps), **kw)
        for name, value in dataclasses.asdict(j).items():
            assert getattr(t, name) == pytest.approx(value, rel=1e-12,
                                                     abs=1e-15), name
        parts_t.append(t)
        parts_j.append(j)
    mt, mj = merge_stats(parts_t), jfleet.merge_stats(parts_j)
    for name, value in dataclasses.asdict(mj).items():
        assert getattr(mt, name) == pytest.approx(value, rel=1e-12,
                                                  abs=1e-15), name
    assert isinstance(mt, RouterStats) and mt.requests == 18
    assert trouter.stats_from_states([], items=0, steps=0, wall_s=0.0,
                                     lanes=1, rejected=0).requests == 0


def test_step_listeners_and_guard_wrap_every_step(chip):
    router = FleetRouter(shard_chip(chip, 1), lanes_per_chip=2)
    seen, wrapped = [], []

    class Guard:
        def run_step(self, step_fn):
            wrapped.append(1)
            return step_fn()

    router.add_step_listener(lambda r: seen.append(r.steps))
    router.attach_ha(Guard())
    router.submit(ItemRequest(uid=0, items=np.zeros((3, 64))))
    router.run_until_drained()
    assert seen == [1, 2, 3] and len(wrapped) == 3
    assert router._wall_s() > 0


def test_launch_counts_stay_zero_on_the_cpu(chip):
    ops.reset_launch_counts()
    shard_chip(chip, 4).stream(_x(1, 9))
    assert set(ops.launch_counts().values()) == {0}


def test_router_records_telemetry_when_configured(chip):
    """Engine-step spans carry the router's tags, and each fleet batch
    is a ``fleet.stream`` span with its rows and chips."""
    tel = tobs.configure()
    try:
        router = FleetRouter(shard_chip(chip, 3), lanes_per_chip=2)
        for i in range(4):
            router.submit(ItemRequest(uid=i, items=np.full((2, 64), 0.5)))
        router.run_until_drained()
        events = tel.tracer.trace_events()
        snap = tel.metrics.snapshot()
    finally:
        tobs.disable()
    steps = [e for e in events if e["name"] == "engine.step"]
    assert len(steps) == router.steps
    assert all(e["args"]["router"] == "FleetRouter" and
               e["args"]["chips"] == 3 and e["args"]["lanes"] == 6
               for e in steps)
    streams = [e for e in events if e["name"] == "fleet.stream"]
    assert [e["args"] for e in streams] == \
        [{"rows": 6, "chips": 3}] * router.steps
    assert snap["counters"]["engine.items"] == router.items_emitted == 8
