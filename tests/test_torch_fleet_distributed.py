"""The port's multi-process fleet (``repro_torch.launch.mesh``,
``repro_torch.fleet`` distributed half, ``repro_torch.obs.dist``)
against the reference, on the CPU.

  * ``assemble_stats`` — the one roll-up formula behind the lockstep
    gather and the heartbeat board — equals the reference's at rel
    1e-12 on random counter rows (counts above 2³¹ included), walls and
    latency vectors, hypothesis-driven; ``allgather_i64`` without a
    group equals the reference's one-process gather on such counts.
  * The mesh: ``make_fleet_mesh`` / ``make_chip_submesh`` /
    ``mesh_spans_processes`` and their refusals.
  * A one-process fleet: ``stream_local`` equals ``stream_host`` to
    the bit on ragged batches, and ``DistributedFleetRouter`` refuses
    it (the reference's ``tests/test_fleet.py`` cases).
  * The lockstep router's own logic in one process, on a hand-built
    two-rank mesh (no group: every reduction is the local flag):
    local lanes, forced idle steps, the ``stream_local`` path, and
    ``degrade_to_local`` evicting and requeueing with no compile.
  * ONE spawned two-rank gloo fleet on the CPU, not marked (it takes a
    few seconds): ``file://`` rendezvous, a supervisor timeout of
    120 s; ``stream_local`` equals the chip at rel 0.0 on each rank's
    rows, every rank steps in lockstep, and ``stats_global`` is the
    same on both ranks and equals ``assemble_stats`` of their rows.
  * The distributed CLI selftest carries the reference's opt-in
    ``distributed`` marker.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.fleet import router as jrouter
from repro.core import crossbar_layer as jcl

from repro_torch.chip import compile as tcompile
from repro_torch.chip import compile_chip
from repro_torch.core import crossbar_layer as tcl
from repro_torch.fleet import (DistributedFleetRouter, FleetRouter,
                               StreamSource, shard_chip)
from repro_torch.fleet import __main__ as fmain
from repro_torch.fleet import ha as tha
from repro_torch.fleet import router as trouter
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import simdev as tsimdev
from repro_torch.obs import allgather_snapshots
from repro_torch.serving.engine import ItemRequest

torch.set_num_threads(1)

DIMS = (64, 32, 10)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def chips():
    """The port's chips on the reference's seeded weights, both
    systems."""
    jspec = jcl.MLPSpec(DIMS, activation="threshold",
                        out_activation="linear")
    jparams = jcl.mlp_init(jax.random.PRNGKey(0), jspec)
    tspec = tcl.MLPSpec(DIMS, activation="threshold",
                        out_activation="linear")
    tparams = tcl.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
        device="cpu")
    return {s: compile_chip(tspec, params=tparams, system=s, device="cpu")
            for s in ("memristor", "digital")}


# -------------------- the roll-up formula ----------------------------- #
COUNT = st.integers(min_value=0, max_value=2**40)
ROWS = st.lists(st.tuples(COUNT, COUNT, COUNT, COUNT, COUNT),
                min_size=1, max_size=5)
TIMES = st.lists(st.floats(min_value=0.0, max_value=1e4,
                           allow_nan=False), max_size=40)


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(rows=ROWS, walls=st.lists(st.floats(min_value=0.0, max_value=1e5,
                                           allow_nan=False),
                                 min_size=1, max_size=5),
       lat=TIMES, wait=TIMES)
def test_assemble_stats_equals_the_reference(rows, walls, lat, wait):
    args = (np.asarray(rows, np.int64), np.asarray(walls),
            np.asarray(lat), np.asarray(wait))
    want = dataclasses.asdict(jrouter.assemble_stats(*args))
    got = dataclasses.asdict(trouter.assemble_stats(*args))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert type(got[key]) is type(w), key
        np.testing.assert_allclose(got[key], w, rtol=1e-12, atol=0,
                                   err_msg=key)


def test_allgather_i64_without_a_group_equals_the_reference():
    """Counters above 2³¹ (and negative ones) cross exactly: gloo
    carries int64 as it is, the reference splits it into int32 halves."""
    counts = np.asarray([2**33 + 5, 2**31, 2**31 - 1, -7, 0, 2**61],
                        np.int64)
    got = trouter.allgather_i64(counts)
    assert got.dtype == np.int64 and got.shape == (1, counts.size)
    np.testing.assert_array_equal(got, jrouter.allgather_i64(counts))


def test_one_process_gathers_are_the_identity():
    assert tmesh.process_count() == 1 and tmesh.process_index() == 0
    assert trouter.any_across_hosts(True) and \
        not trouter.any_across_hosts(False)
    snap = {"counters": {"a": 1}}
    assert allgather_snapshots(snap) == [snap]
    lat, wait = np.asarray([0.5, 0.25]), np.asarray([0.1])
    g = trouter.gather_global_stats(lat, wait, requests=2, items=9,
                                    steps=4, rejected=1, lanes=3,
                                    wall_s=1.5)
    assert g == trouter.assemble_stats([[2, 9, 4, 1, 3]], [1.5], lat, wait)
    with pytest.raises(ValueError, match="CPU tensors"):
        tmesh.allgather(torch.zeros(1, device="meta"))


# -------------------- the mesh ---------------------------------------- #
def test_fleet_mesh_layout_and_refusals():
    m = tmesh.FleetMesh((CPU, CPU, CPU), (2, 2, 2), process_index=1)
    assert (m.size, m.n_processes, m.device) == (6, 3, CPU)
    assert m.local_chips == [2, 3]
    assert tmesh.mesh_spans_processes(m)
    one = tmesh.make_fleet_mesh(3, device="cpu")
    assert one == tmesh.FleetMesh((CPU,), (3,)) and \
        not tmesh.mesh_spans_processes(one)
    assert tmesh.make_fleet_mesh(device="cpu").size == 1
    assert tmesh.make_distributed_fleet_mesh(2, device="cpu") == \
        tmesh.make_fleet_mesh(2, device="cpu")
    for bad, msg in ((lambda: tmesh.make_fleet_mesh(0, device="cpu"),
                      "n_chips"),
                     (lambda: tmesh.FleetMesh((CPU,), (0,)), "n_chips"),
                     (lambda: tmesh.FleetMesh((CPU,), (1, 1)), "per rank"),
                     (lambda: tmesh.FleetMesh((CPU,), (1,), 1),
                      "process_index")):
        with pytest.raises(ValueError, match=msg):
            bad()


def test_chip_submesh_is_single_process():
    m = tmesh.FleetMesh((CPU, CPU), (3, 3), process_index=1)
    sub = tmesh.make_chip_submesh(m, [3, 5])
    assert sub == tmesh.FleetMesh((CPU,), (2,))
    for idx, msg in (([], "at least one"), ([6], "out of range"),
                     ([3, 3], "repeated"), ([0, 4], "other processes")):
        with pytest.raises(ValueError, match=msg):
            tmesh.make_chip_submesh(m, idx)


def test_rank_device_takes_the_cpu_only_when_asked():
    assert tmesh.rank_device("cpu") == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.rank_device()


# -------------------- one process, multi-process verbs ---------------- #
@pytest.mark.parametrize("system", ["memristor", "digital"])
@pytest.mark.parametrize("n_chips", [1, 2, 3])
def test_stream_local_matches_stream_host(chips, system, n_chips):
    """On one process the process-local stream is the whole stream,
    ragged batches included (the reference's
    ``test_stream_local_matches_stream_host``)."""
    fleet = shard_chip(chips[system], n_chips)
    for b in (1, 3, 8):
        x = np.random.default_rng(b).uniform(-1, 1, (b, DIMS[0])) \
            .astype(np.float32)
        y = fleet.stream_local(x)
        assert y.dtype == np.float32 and y.shape == (b, DIMS[-1])
        np.testing.assert_array_equal(y, fleet.stream_host(x))
    assert fleet.n_local_chips == fleet.n_chips == n_chips
    assert fleet.local_chips == list(range(n_chips))
    assert not fleet.is_distributed


def test_distributed_router_requires_distributed_fleet(chips):
    with pytest.raises(ValueError, match="spans processes"):
        DistributedFleetRouter(shard_chip(chips["memristor"], 1))


def test_mesh_device_must_be_the_chips(chips):
    meta = tmesh.FleetMesh((torch.device("meta"),), (2,))
    with pytest.raises(ValueError, match="programmed on"):
        shard_chip(chips["memristor"], mesh=meta)


# -------------------- the lockstep router in one process -------------- #
def _two_rank_fleet(chip, rank=0):
    """A fleet on a hand-built two-rank mesh, as rank ``rank`` sees it:
    without a group every cross-rank reduction is the local value."""
    mesh = tmesh.FleetMesh((CPU, CPU), (2, 2), process_index=rank)
    return shard_chip(chip, mesh=mesh)


def test_distributed_fleet_refuses_the_global_verbs(chips):
    fleet = _two_rank_fleet(chips["memristor"], rank=1)
    assert fleet.is_distributed and fleet.n_chips == 4
    assert fleet.local_chips == [2, 3] and fleet.n_local_chips == 2
    x = np.random.default_rng(0).uniform(-1, 1, (5, DIMS[0])) \
        .astype(np.float32)
    for verb in (fleet.stream, fleet.stream_host):
        with pytest.raises(ValueError, match="stream_local"):
            verb(x)
    np.testing.assert_array_equal(
        fleet.stream_local(x),
        chips["memristor"].stream(torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError, match="spans processes"):
        FleetRouter(fleet)
    with pytest.raises(ValueError, match="steps when idle"):
        DistributedFleetRouter(fleet, step_when_idle=False)


def test_lockstep_router_serves_its_local_lanes(chips, monkeypatch):
    chip = chips["digital"]
    fleet = _two_rank_fleet(chip)
    monkeypatch.setattr(tcompile, "_DEPRECATION_WARNED", set())
    with pytest.warns(DeprecationWarning, match="deploy"):
        router = fleet.serve(lanes_per_chip=3, queue_limit=4)
    assert type(router) is DistributedFleetRouter
    assert router.slots == 6 and router.step_when_idle
    assert router.step() == 0 and router.steps == 1   # idle, but stepped
    pipe = _toy_pipe()
    src = StreamSource.for_host(pipe, host=0, hosts=2, n_requests=5,
                                capacity=2)
    done = router.serve(src)
    assert len(done) == 5 and src.exhausted
    for st in done:
        np.testing.assert_allclose(
            st.result, chip.stream(torch.as_tensor(st.request.items)).numpy(),
            atol=1e-5)
    assert router.stats_global() == router.stats()    # no group
    rep = fleet.report(router)
    assert rep.n_chips == 4 and rep.served.items == router.items_emitted


def _toy_pipe():
    class Pipe:
        def batch(self, step):
            rng = np.random.default_rng(100 + step)
            return rng.uniform(0, 1, (2 + step % 3, DIMS[0])) \
                .astype(np.float32)
    return Pipe()


def test_degrade_to_local_keeps_the_chips_and_the_lanes(chips):
    """A membership change mid-drain: the lockstep router falls onto a
    one-process mesh of its own chips in place — no compile, the
    in-flight lanes evicted and requeued, nothing lost or repeated."""
    chip = chips["memristor"]
    fleet = _two_rank_fleet(chip)
    router = DistributedFleetRouter(fleet, lanes_per_chip=2)
    rng = np.random.default_rng(5)
    reqs = [ItemRequest(uid=i, items=rng.uniform(0, 1, (4 + i, DIMS[0])))
            for i in range(6)]
    for r in reqs:
        router.submit(r)
    router.step()
    router.step()
    c0 = tcompile.compile_count()
    tha.degrade_to_local(router)
    assert tcompile.compile_count() == c0
    assert not fleet.is_distributed and fleet.n_chips == 2
    assert router.slots == 4 and not router.active
    assert not router._spmd_lockstep and not router._local_stream
    assert not router.step_when_idle
    done = router.run_until_drained()
    assert sorted(st.request.uid for st in done) == list(range(6))
    assert router.items_emitted == sum(4 + i for i in range(6))
    for st in done:
        np.testing.assert_allclose(
            st.result, chip.stream(torch.as_tensor(
                st.request.items, dtype=torch.float32)).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="n_chips"):
        tha.local_fleet_mesh(_two_rank_fleet(chip).mesh, 3)
    assert tha.local_fleet_mesh(_two_rank_fleet(chip).mesh, 1) == \
        tmesh.FleetMesh((CPU,), (1,))


def test_metrics_global_merges_the_ranks_registries(chips, tmp_path):
    """In one process the lockstep router's fleet-wide registry is its
    own; the HA server's board roll-up merges a peer's published
    snapshot with this rank's live one."""
    from repro_torch import obs
    obs.configure(trace=False)
    try:
        router = DistributedFleetRouter(_two_rank_fleet(chips["digital"]),
                                        lanes_per_chip=1)
        router.submit(ItemRequest(uid=0, items=np.zeros((2, DIMS[0]),
                                                        np.float32)))
        router.run_until_drained()
        snap = obs.current().metrics.snapshot()
        assert snap["counters"] and router.metrics_global() == snap
        board = tha.HeartbeatBoard(str(tmp_path))
        board.publish(1, {"rank": 1, "metrics": snap})
        server = tha.HAFleetServer(router, StreamSource(_toy_pipe(),
                                                        n_requests=0),
                                   board=board, rank=0, ranks=(0, 1))
        assert server.metrics_global() == obs.merge_snapshots([snap, snap])
    finally:
        obs.disable()


# -------------------- a real two-rank gloo fleet ---------------------- #
def test_two_rank_gloo_fleet_on_the_cpu():
    """Two spawned ranks, one gloo group through a ``file://`` store:
    the shipping worker, at the deep app's width on both systems."""
    summary = fmain.run_distributed_selftest(2, 2, device="cpu",
                                             verbose=False, timeout=120.0)
    workers = [summary["workers"][r] for r in sorted(summary["workers"])]
    assert summary["pass"], workers
    for system in fmain.SYSTEMS:
        rows = [w[system] for w in workers]
        for row in rows:
            assert row["equal_chip"] and row["rel_one_process"] == 0.0
            assert set(row["launches_per_call"].values()) == {0}   # CPU
            assert row["degraded_resized"] == {
                "chips": 4, "lanes": 8, "requests": 6, "equal_chip": True}
        assert len({r["drains"][0]["steps"] for r in rows}) == 1
        want = trouter.assemble_stats(
            [r["counts"] for r in rows], [r["wall_s"] for r in rows],
            np.concatenate([r["lat"] for r in rows]),
            np.concatenate([r["wait"] for r in rows]))
        assert all(r["stats_global"] == dataclasses.asdict(want)
                   for r in rows)
        assert want.requests == 12 and want.lanes == 8
        assert want.items == 12 * fmain.WINDOWS


_MULTI_APP_WORKER = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np, torch
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.deploy import AppSpec, deploy
    from repro_torch.fleet import StreamSource
    from repro_torch.launch.mesh import (init_fleet_group,
                                         make_distributed_fleet_mesh)
    torch.set_num_threads(1)
    rank = init_fleet_group(60.0)
    mesh = make_distributed_fleet_mesh(
        int(os.environ["REPRO_DIST_CHIPS"]), device="cpu")
    gen = torch.Generator().manual_seed(0)
    specs = {"a": MLPSpec((64, 32, 10)), "b": MLPSpec((32, 16, 4))}
    params = {k: mlp_init(s, generator=gen, device="cpu")
              for k, s in specs.items()}
    d = deploy([AppSpec("a", specs["a"], params=params["a"],
                        lanes_per_chip=2),
                AppSpec("b", specs["b"], params=params["b"],
                        system="digital", lanes_per_chip=1,
                        queue_limit=2)], mesh=mesh, device="cpu")

    class Pipe:
        def __init__(self, d_in):
            self.d_in = d_in

        def batch(self, step):
            rng = np.random.default_rng(100 * self.d_in + step)
            return rng.uniform(0, 1, (1 + step % 3, self.d_in))

    sources = {"a": StreamSource.for_host(Pipe(64), n_requests=5,
                                          capacity=2),
               "b": StreamSource.for_host(Pipe(32), n_requests=3 + rank,
                                          capacity=2)}
    done = d.serve(sources)
    direct = all(np.allclose(st.result, d.chip(st.request.key).stream(
        torch.as_tensor(st.request.items, dtype=torch.float32)).numpy(),
        atol=1e-5) for st in done)
    x = np.random.default_rng(rank).uniform(0, 1, (5, 64)).astype(
        np.float32)
    local = d.stream("a", x)
    g = d.stats_global()
    print(json.dumps({
        "rank": rank, "router": type(d.router).__name__,
        "steps": d.router.steps, "done": len(done), "direct": direct,
        "local_equal": bool(torch.equal(local, d.chip("a").stream(
            torch.from_numpy(x)))),
        "global": {k: dataclasses.asdict(v) for k, v in g.apps.items()}
        | {"fleet": dataclasses.asdict(g.fleet)},
        "local": {k: dataclasses.asdict(v) for k, v in
                  d.stats().apps.items()}}))
""")


def test_two_rank_multi_app_deployment_on_the_cpu():
    """Two spawned ranks deploy two tenants onto one mesh spanning the
    gloo group: the lockstep multi-app router drains each rank's feeds
    in the same steps, routed outputs match the direct stream, a rank's
    ``stream`` is its own rows, and ``stats_global`` is the same on
    both ranks — each app's row the sum of the ranks' rows, the fleet
    row the sum of the apps'."""
    results = tsimdev.launch_local_fleet(
        [sys.executable, "-c", _MULTI_APP_WORKER], 2, chips_per_process=2,
        timeout=120.0, poll_s=0.05)
    assert all(r.returncode == 0 for r in results), \
        [r.stderr_tail for r in results]
    ranks = [tsimdev.last_json_line(r.stdout) for r in results]
    assert {r["router"] for r in ranks} == {"DistributedMultiAppRouter"}
    assert len({r["steps"] for r in ranks}) == 1
    assert all(r["direct"] and r["local_equal"] for r in ranks)
    assert [r["done"] for r in ranks] == [5 + 3, 5 + 4]
    glob = ranks[0]["global"]
    assert all(r["global"] == glob for r in ranks)
    for app in ("a", "b"):
        for f in ("requests", "items", "rejected", "lanes"):
            assert glob[app][f] == sum(r["local"][app][f] for r in ranks)
    for f in ("requests", "items", "rejected", "lanes"):
        assert glob["fleet"][f] == glob["a"][f] + glob["b"][f]
    assert glob["a"]["lanes"] == 2 * 4 and glob["b"]["lanes"] == 1 * 4
    assert glob["fleet"]["requests"] == 17


@pytest.mark.distributed
def test_distributed_selftest_cli():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.fleet", "--distributed-selftest",
         "--device", "cpu", "--processes", "3", "--chips-per-process", "1"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": tsimdev.SRC_DIR},
        cwd=tsimdev.REPO_ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    summary = tsimdev.last_json_line(out.stdout)
    assert summary["pass"] and len(summary["workers"]) == 3
