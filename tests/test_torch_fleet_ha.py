"""The port's fault tolerance (``repro_torch.fleet.ha``) and its
launcher (``repro_torch.launch.simdev``) against the reference's
``repro.fleet.ha`` / ``repro.launch.simdev``, on the CPU.

Every scripted case runs the same script on both packages and compares
what they decide: the heartbeat board's files (each package reads the
other's), the failure detector and step guard under one injectable
``FakeClock`` (declared peers, clock spent on retries, exceptions), the
(seed, step)-pure replay and the requeue paths (uids and order), and
two HA servers in one process with one starved of ticks to simulate
its death (uids completed and rejected, the takeover owner, the board
roll-up's counts). The toy payload (y = 2x + 1) is exact in f32, so
outputs are compared with ``assert_array_equal``.

The launcher is driven with torch-free ``python -c`` workers: argument
checks, crash vs clean exit, ``on_failure`` and ``kill_at``. The chaos
CLI — real ranks killed mid-serve, federated and lockstep — carries the
reference's opt-in ``chaos`` marker.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro.fleet import ha as jha
from repro.fleet.router import FleetRouter as JRouter
from repro.fleet.source import BoundedQueue as JQueue
from repro.fleet.source import StreamSource as JSource
from repro.launch import simdev as jsimdev
from repro.deploy.router import DistributedMultiAppRouter as JMultiRouter
from repro.serving.engine import ItemRequest as JRequest

from repro_torch.deploy.router import DistributedMultiAppRouter as TMultiRouter
from repro_torch.fleet import ha as tha
from repro_torch.fleet.router import FleetRouter as TRouter
from repro_torch.fleet.source import BoundedQueue as TQueue
from repro_torch.fleet.source import StreamSource as TSource
from repro_torch.launch import simdev as tsimdev
from repro_torch.serving.engine import ItemRequest as TRequest

torch.set_num_threads(1)

D_IN = 3
# the two packages, as the scripted cases see them
PKGS = {
    "reference": dict(ha=jha, Router=JRouter, Queue=JQueue, Source=JSource,
                      Request=JRequest, MultiRouter=JMultiRouter),
    "port": dict(ha=tha, Router=TRouter, Queue=TQueue, Source=TSource,
                 Request=TRequest, MultiRouter=TMultiRouter),
}


class ToyFleet:
    """Row-pure payload (y = 2x + 1): loss/duplication visible per
    item."""
    d_in = D_IN

    def __init__(self, n_chips=1):
        self.n_chips = n_chips

    def stream(self, x, use_kernel=False):
        return np.asarray(x, np.float32) * 2.0 + 1.0


class ToyPipe:
    """(seed, step)-pure pipeline: any rank can replay any step."""

    def batch(self, step):
        rng = np.random.default_rng(1000 + step)
        return rng.uniform(-1, 1, (2 + step % 3, D_IN)).astype(np.float32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _both(script, tmp_path):
    """Run ``script(pkg, root)`` for each package in its own board
    directory; return {package: result}."""
    out = {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        out[name] = script(pkg, str(root))
    return out


def _agree(script, tmp_path):
    got = _both(script, tmp_path)
    assert got["port"] == got["reference"], got
    return got["port"]


# ---------------------------------------------------------------------- #
# heartbeat board: one file convention, both ways
# ---------------------------------------------------------------------- #
def test_board_written_by_the_port_reads_in_the_reference(tmp_path):
    board = tha.HeartbeatBoard(str(tmp_path))
    payload = {"rank": 1, "beat": 4, "step": 7, "status": "serving",
               "completed": [3, 1_000_001], "source": {"uid_base": 0}}
    board.publish(1, payload)
    board.publish(3, {"rank": 3, "beat": 1})
    assert jsimdev.read_board(str(tmp_path), 1) == payload
    assert jha.HeartbeatBoard(str(tmp_path)).ranks() == [1, 3]
    assert tsimdev.board_path(str(tmp_path), 1) == \
        jsimdev.board_path(str(tmp_path), 1) == str(tmp_path / "rank_1.json")
    board.publish_event("recalibration", {"rank": 1, "age": 5})
    assert jha.HeartbeatBoard(str(tmp_path)).events("recalibration") == \
        [{"rank": 1, "age": 5, "kind": "recalibration"}]


def test_board_written_by_the_reference_reads_in_the_port(tmp_path):
    board = jha.HeartbeatBoard(str(tmp_path))
    board.publish(0, {"rank": 0, "beat": 1, "step": 5, "status": "serving"})
    board.publish(0, {"rank": 0, "beat": 2, "step": 6, "status": "done"})
    port = tha.HeartbeatBoard(str(tmp_path))
    assert tsimdev.read_board(str(tmp_path), 0) == port.read(0) == \
        {"rank": 0, "beat": 2, "step": 6, "status": "done"}
    assert port.read(5) is None and port.ranks() == [0]
    board.publish_event("recalibration", {"rank": 0})
    assert port.events() == jha.HeartbeatBoard(str(tmp_path)).events()


# ---------------------------------------------------------------------- #
# failure detector and step guard: the same decisions on one FakeClock
# ---------------------------------------------------------------------- #
def _detector(pkg, root, peers=(0, 1), rank=0, **cfg_kw):
    ha = pkg["ha"]
    clock = FakeClock()
    cfg = ha.HAConfig(**{"timeout_s": 2.0, "retries": 3, "backoff_s": 0.25,
                         **cfg_kw})
    board = ha.HeartbeatBoard(root)
    det = ha.FailureDetector(board, rank, peers, cfg, clock=clock,
                             sleep=clock.sleep)
    return board, det, clock


def _beating_peer(pkg, root):
    board, det, clock = _detector(pkg, root)
    polls = []
    for beat in range(1, 6):
        board.publish(1, {"rank": 1, "beat": beat, "status": "serving"})
        clock.t += 1.5
        polls.append(sorted(det.poll()))
    return polls, sorted(det.dead), det.alive


def _stalled_peer(pkg, root):
    board, det, clock = _detector(pkg, root)
    board.publish(1, {"rank": 1, "beat": 3, "status": "serving"})
    trace = [sorted(det.poll())]
    clock.t += 1.9
    trace.append(sorted(det.poll()))
    clock.t += 0.2
    t0 = clock.t
    trace.append(sorted(det.poll()))
    trace.append(round(clock.t - t0, 12))       # retry/backoff spent
    trace.append(sorted(det.poll()))
    return trace, sorted(det.dead), det.alive


def _revived_during_confirm(pkg, root):
    board, det, clock = _detector(pkg, root)
    board.publish(1, {"rank": 1, "beat": 1, "status": "serving"})
    det.poll()
    clock.t += 5.0

    def sleep_and_revive(dt):
        clock.sleep(dt)
        board.publish(1, {"rank": 1, "beat": 2, "status": "serving"})

    det._sleep = sleep_and_revive
    return sorted(det.poll()), sorted(det.dead)


def _clean_exit(pkg, root):
    board, det, clock = _detector(pkg, root)
    board.publish(1, {"rank": 1, "beat": 9, "status": "done"})
    clock.t += 100.0
    return sorted(det.poll()), sorted(det.done), sorted(det.dead)


def _start_grace(pkg, root):
    board, det, clock = _detector(pkg, root, start_grace_s=60.0)
    clock.t += 30.0
    first = sorted(det.poll())
    clock.t += 31.0
    return first, sorted(det.poll())


def _confirm_skips_deadline(pkg, root):
    board, det, clock = _detector(pkg, root)
    board.publish(1, {"rank": 1, "beat": 1, "status": "serving"})
    det.poll()
    clock.t += 0.1
    return sorted(det.poll()), sorted(det.confirm()), clock.t


def _guard_runs_the_step(pkg, root):
    board, det, _ = _detector(pkg, root)
    beats = []
    guard = pkg["ha"].StepGuard(det, publish=lambda: beats.append(1))
    return guard.run_step(lambda: 42), beats, guard.steps_guarded


def _guard_translates_failure(pkg, root):
    ha = pkg["ha"]
    board, det, clock = _detector(pkg, root)
    board.publish(1, {"rank": 1, "beat": 1, "status": "serving"})
    det.poll()
    clock.t += 0.1
    guard = ha.StepGuard(det, publish=lambda: None)

    def failing_collective():
        raise RuntimeError("Connection reset by peer")

    try:
        guard.run_step(failing_collective)
    except ha.MembershipChange as mc:
        return mc.dead, type(mc.cause).__name__, str(mc), guard.steps_guarded
    return None


def _guard_reraises(pkg, root):
    board, det, _ = _detector(pkg, root, peers=(0,))
    guard = pkg["ha"].StepGuard(det, publish=lambda: None)
    try:
        guard.run_step(lambda: (_ for _ in ()).throw(
            ValueError("not a membership problem")))
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def _guard_checks_before_the_step(pkg, root):
    ha = pkg["ha"]
    board, det, clock = _detector(pkg, root)
    board.publish(1, {"rank": 1, "beat": 1, "status": "serving"})
    det.poll()
    clock.t += 10.0
    guard = ha.StepGuard(det, publish=lambda: None)
    ran = []
    try:
        guard.run_step(lambda: ran.append(1))
    except ha.MembershipChange as mc:
        return mc.dead, ran, mc.cause
    return None


def _guard_default_beat(pkg, root):
    board, det, _ = _detector(pkg, root)
    guard = pkg["ha"].StepGuard(det)
    guard.run_step(lambda: None)
    guard.run_step(lambda: None)
    return board.read(0)


@pytest.mark.parametrize("script", [
    _beating_peer, _stalled_peer, _revived_during_confirm, _clean_exit,
    _start_grace, _confirm_skips_deadline, _guard_runs_the_step,
    _guard_translates_failure, _guard_reraises,
    _guard_checks_before_the_step, _guard_default_beat,
], ids=lambda f: f.__name__.strip("_"))
def test_detector_and_guard_decide_as_the_reference(script, tmp_path):
    assert _agree(script, tmp_path) is not None


def test_ha_config_checks_as_the_reference():
    for kw in ({"takeover": "drop"}, {"retries": 0}):
        with pytest.raises(ValueError) as t_err:
            tha.HAConfig(**kw)
        with pytest.raises(ValueError) as j_err:
            jha.HAConfig(**kw)
        assert str(t_err.value) == str(j_err.value)
    assert tha.HAConfig() == tha.HAConfig(**{
        f: getattr(jha.HAConfig(), f) for f in
        jha.HAConfig.__dataclass_fields__})


# ---------------------------------------------------------------------- #
# (seed, step)-pure takeover and the requeue paths
# ---------------------------------------------------------------------- #
def _replay(pkg, root):
    ha = pkg["ha"]
    pipe = ToyPipe()
    src = pkg["Source"].for_host(pipe, host=1, hosts=2, n_requests=5,
                                 capacity=2)
    src.pump()
    produced = [src.take(), src.take()]
    snap = ha.source_snapshot(src)
    replayed = ha.replay_requests(pipe, snap)
    assert all(np.array_equal(r.items, p.items)
               for r, p in zip(replayed, produced))
    again = ha.replay_requests(pipe, snap, exclude={1_000_000, 1_000_002})
    endless = pkg["Source"](pipe, n_requests=None, capacity=3)
    endless.pump()
    return (snap, [r.uid for r in replayed],
            [r.items.tolist() for r in replayed], [r.uid for r in again],
            [r.uid for r in ha.replay_requests(
                pipe, ha.source_snapshot(endless))])


def _queue_requeue(pkg, root):
    q = pkg["Queue"](2)
    trace = [q.offer("a"), q.offer("b"), q.offer("c")]
    q.requeue("x")
    trace += [len(q), q.peek(), q.full, q.offer("d")]
    trace += [q.poll() for _ in range(3)] + [q.offer("d")]
    return trace


def _source_requeue(pkg, root):
    src = pkg["Source"](ToyPipe(), n_requests=4, capacity=2)
    trace = [src.pump()]
    r0, r1 = src.take(), src.take()
    src.requeue([r0, r1])
    trace += [src.peek().uid, src.produced, src.pump(), src.stalls]
    trace += [src.take().uid for _ in range(2)]
    trace += [src.pump(), src.produced]
    return trace


def _router_requeue(pkg, root):
    router = pkg["Router"](ToyFleet(1), lanes_per_chip=2, queue_limit=1,
                           use_kernel=False)
    rng = np.random.default_rng(0)

    def mk(uid, n):
        return pkg["Request"](uid=uid, items=rng.uniform(
            -1, 1, (n, D_IN)).astype(np.float32))

    trace = [router.submit(mk(0, 3)), router.submit(mk(1, 2))]
    router.requeue([mk(2, 2), mk(3, 1)])
    trace += [len(router.queue), router.submit(mk(4, 2))]
    while router.queue or router.active:
        router.step()
    trace += [sorted(st.request.uid for st in router.finished),
              router.submit(mk(5, 1)), router.steps, router.items_emitted,
              router.rejected]
    return trace


@pytest.mark.parametrize("script", [_replay, _queue_requeue,
                                    _source_requeue, _router_requeue],
                         ids=lambda f: f.__name__.strip("_"))
def test_takeover_and_requeue_agree_with_the_reference(script, tmp_path):
    _agree(script, tmp_path)


# ---------------------------------------------------------------------- #
# two HA servers, one process: deterministic mid-serve death
# ---------------------------------------------------------------------- #
N_REQ = 6
UID1 = 1_000_000


def _server(pkg, board, rank, *, takeover="replay"):
    ha = pkg["ha"]
    cfg = ha.HAConfig(timeout_s=0.05, retries=2, backoff_s=0.01,
                      idle_sleep_s=0.001, takeover=takeover)
    router = pkg["Router"](ToyFleet(1), lanes_per_chip=2, use_kernel=False)
    pipe = ToyPipe()
    src = pkg["Source"].for_host(pipe, host=rank, hosts=2,
                                 n_requests=N_REQ, capacity=3)
    return ha.HAFleetServer(router, src, board=board, rank=rank,
                            ranks=(0, 1), pipeline=pipe, config=cfg)


def _death(takeover):
    def script(pkg, root):
        board = pkg["ha"].HeartbeatBoard(root)
        victim = _server(pkg, board, 0)
        survivor = _server(pkg, board, 1, takeover=takeover)
        decisions = []
        for _ in range(3):              # both mid-serve, lanes busy …
            decisions += [victim.serve_tick(), survivor.serve_tick()]
        assert victim.router.active and survivor.router.active
        journal = board.read(0)
        time.sleep(0.12)                # … then the victim stops ticking
        done = survivor.serve(max_ticks=5000)
        for st in done:
            np.testing.assert_array_equal(
                st.result, np.asarray(st.request.items) * 2.0 + 1.0)
        gs = survivor.stats_global()
        return {
            "decisions": decisions, "status": journal["status"],
            "dead": sorted(survivor.detector.dead),
            "absorbed": survivor.absorbed,
            "victim_completed": sorted(board.read(0)["completed"]),
            "survivor_completed": sorted(st.request.uid for st in done),
            "rejected": sorted(survivor.rejected_uids),
            "board_rejected": sorted(board.read(1)["rejected_uids"]),
            "stats": (gs.requests, gs.items, gs.lanes, gs.rejected),
            "degraded": survivor.degraded_items_per_second > 0,
        }
    return script


@pytest.mark.parametrize("takeover", ["replay", "reject"])
def test_survivor_takeover_agrees_with_the_reference(takeover, tmp_path):
    got = _agree(_death(takeover), tmp_path)
    victim, survivor = set(got["victim_completed"]), \
        set(got["survivor_completed"])
    assert got["dead"] == [0] and got["absorbed"] == [0]
    assert not victim & survivor
    if takeover == "replay":            # exactly once, nothing lost
        assert victim | survivor == set(range(N_REQ)) | \
            {UID1 + k for k in range(N_REQ)}
        assert got["rejected"] == [] and got["degraded"]
        assert got["stats"][0] == 2 * N_REQ
    else:                               # shed with exact accounting
        assert survivor == {UID1 + k for k in range(N_REQ)}
        assert victim | set(got["rejected"]) == set(range(N_REQ))
        assert got["board_rejected"] == got["rejected"]
        assert got["stats"][0] == N_REQ + len(victim)


def _healthy_pair(pkg, root):
    board = pkg["ha"].HeartbeatBoard(root)
    a, b = _server(pkg, board, 0), _server(pkg, board, 1)
    decisions = {"a": None, "b": None}
    for _ in range(5000):
        if decisions["a"] != "stop":
            decisions["a"] = a.serve_tick()
        if decisions["b"] != "stop":
            decisions["b"] = b.serve_tick()
        if decisions["a"] == decisions["b"] == "stop":
            break
    return (decisions, a.absorbed, b.absorbed,
            sorted(st.request.uid for st in a.router.finished),
            sorted(st.request.uid for st in b.router.finished))


def test_two_healthy_servers_settle_as_the_reference(tmp_path):
    got = _agree(_healthy_pair, tmp_path)
    assert got[0] == {"a": "stop", "b": "stop"} and got[1] == got[2] == []


def test_board_roll_up_equals_the_reference_formula(tmp_path):
    """The board roll-up on the same published rows: the port's
    ``HAFleetServer.stats_global`` vs the reference's, field by field
    (walls and latency stamps are each process's own, so the rows are
    copied across: rank 0's and rank 1's boards are the reference's)."""
    jboard = jha.HeartbeatBoard(str(tmp_path))
    jsurvivor = _server(PKGS["reference"], jboard, 1)
    for _ in range(4):
        jsurvivor.serve_tick()
    jboard.publish(0, {"rank": 0, "beat": 3, "counts": [2, 11, 7, 1, 2],
                       "wall_s": 0.25, "lat": [0.1, 0.3], "wait": [0.01,
                                                                 0.02]})
    tsurvivor = _server(PKGS["port"], tha.HeartbeatBoard(str(tmp_path)), 1)
    # the port's router carries the reference router's live state
    for name in ("finished", "items_emitted", "steps", "rejected", "slots",
                 "_lat_all", "_wait_all", "_t_start", "_t_last"):
        setattr(tsurvivor.router, name, getattr(jsurvivor.router, name))
    want, got = jsurvivor.stats_global(), tsurvivor.stats_global()
    for field in want.__dataclass_fields__:
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-12, atol=0, err_msg=field)


# ---------------------------------------------------------------------- #
# degraded mode of the multi-app router
# ---------------------------------------------------------------------- #
class ToyMember(ToyFleet):
    """A tenant of a lockstep multi-app router: its rows stream locally,
    and a resize onto a mesh (recorded) ends its cross-rank span."""
    is_distributed = True

    def __init__(self):
        super().__init__(n_chips=2)
        self.meshes = []

    def stream_local(self, x, use_kernel=False):
        return self.stream(x)

    def resize(self, n_chips=None, *, mesh=None):
        self.meshes.append(mesh)
        self.is_distributed = False


def _multi_app_degrade(pkg, root):
    """Two tenants mid-drain on a lockstep multi-app router; degrade it
    to local, then drain. The degrade resizes every member onto the
    mesh, keeps each app's lane budget, requeues the in-flight lanes
    and drops the lockstep plane."""
    members = {"a": ToyMember(), "b": ToyMember()}
    router = pkg["MultiRouter"](members, lanes={"a": 2, "b": 1})
    rng = np.random.default_rng(3)
    for uid in range(7):
        router.submit(pkg["Request"](
            uid=uid, key="a" if uid % 3 else "b",
            items=rng.uniform(-1, 1, (2 + uid % 4, D_IN)).astype(
                np.float32)))
    router.step()
    router.step()
    in_flight = sorted(st.request.uid for st in router.active.values())
    pkg["ha"].degrade_to_local(router, mesh="local")
    flags = (router._spmd_lockstep, router._local_stream,
             router.step_when_idle, router.slots, len(router.active),
             sorted(e.request.uid for e in router.queue
                    if hasattr(e, "request")))
    done = router.run_until_drained()
    return {"in_flight": in_flight, "flags": flags,
            "meshes": [m.meshes for m in members.values()],
            "done": [(st.request.key, st.request.uid, st.result.tolist())
                     for st in done],
            "items": dict(router.items_by_key), "steps": router.steps}


def test_multi_app_degrade_to_local_agrees_with_the_reference(tmp_path):
    got = _agree(_multi_app_degrade, tmp_path)
    assert got["meshes"] == [["local"], ["local"]]
    assert got["flags"][:5] == (False, False, False, 3, 0)
    assert got["flags"][5] == got["in_flight"] and got["in_flight"]
    assert sorted(uid for _, uid, _ in got["done"]) == list(range(7))


def test_multi_app_degrade_of_a_deployment_then_resize():
    """A deployment on a hand-built two-rank mesh (no group: every
    reduction is local) gets the lockstep multi-app router; after
    ``degrade_to_local`` its members serve this rank's own chips, and
    ``Deployment.resize`` then works with no compile."""
    import torch

    from repro_torch.chip import compile_count
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.deploy import AppSpec, deploy
    from repro_torch.launch.mesh import FleetMesh

    cpu = torch.device("cpu")
    spec_a, spec_b = MLPSpec((16, 8, 4)), MLPSpec((8, 4))
    gen = torch.Generator().manual_seed(0)
    d = deploy([AppSpec("a", spec_a, params=mlp_init(spec_a, generator=gen,
                                                     device="cpu"),
                        lanes_per_chip=2),
                AppSpec("b", spec_b, params=mlp_init(spec_b, generator=gen,
                                                     device="cpu"),
                        system="digital", lanes_per_chip=1)],
               mesh=FleetMesh((cpu, cpu), (2, 2), process_index=1),
               device="cpu")
    assert type(d.router) is TMultiRouter and d.is_distributed
    assert d.router.slots == 2 * 2 + 1 * 2
    rng = np.random.default_rng(0)
    for i in range(6):
        d.submit("a", rng.uniform(0, 1, (3, 16)).astype(np.float32))
        d.submit("b", rng.uniform(0, 1, (2, 8)).astype(np.float32))
    d.step()
    with pytest.raises(ValueError, match="membership"):
        d.resize(4)
    c0 = compile_count()
    tha.degrade_to_local(d.router)
    assert not d.is_distributed and d.router.slots == 6
    assert d.router.members["a"].n_chips == 2
    d.resize(4)
    assert compile_count() == c0 and d.router.slots == 12
    done = d.run_until_drained()
    assert len(done) == 12 and d.stats().fleet.items == 6 * 3 + 6 * 2
    for st in done:
        want = d.chip(st.request.key).stream(
            torch.from_numpy(st.request.items)).numpy()
        np.testing.assert_allclose(st.result, want, atol=1e-5)


# ---------------------------------------------------------------------- #
# the chaos-capable supervisor (torch-free subprocess workers)
# ---------------------------------------------------------------------- #
def test_launch_validates_chaos_arguments():
    for kw, msg in (({"on_failure": "retry"}, "on_failure"),
                    ({"kill_at": (0, 3)}, "ha_dir"),
                    ({"kill_at": (5, 3), "ha_dir": "/nonexistent"}, "rank"),
                    ({"chips_per_process": 0}, "chips_per_process")):
        with pytest.raises(ValueError, match=msg):
            tsimdev.launch_local_fleet([sys.executable, "-c", "pass"], 1,
                                       **kw)


def test_worker_result_distinguishes_crash_from_kill():
    for mk in (tsimdev.WorkerResult, jsimdev.WorkerResult):
        assert mk(0, 3, "", "boom").crashed
        assert not mk(0, 0, "", "").crashed
        assert not mk(0, -15, "", "", killed=True).crashed
        assert not mk(0, -9, "", "", injected=True).crashed
        tail = mk(0, 1, "", "\n".join(f"line{i}" for i in range(20)))
        assert tail.stderr_tail.splitlines() == \
            [f"line{i}" for i in range(12, 20)]


def test_last_json_line_agrees_with_the_reference():
    out = 'chatter\n{"a": 1}\n  {"b": [2, 3]}\ntrailing log\n\n'
    assert tsimdev.last_json_line(out) == jsimdev.last_json_line(out) == \
        {"b": [2, 3]}
    for mod in (tsimdev, jsimdev):
        with pytest.raises(ValueError, match="no JSON"):
            mod.last_json_line("nothing here\n")


_ENV_WORKER = textwrap.dedent("""
    import json, os
    print(json.dumps({k: os.environ.get(k) for k in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "REPRO_DIST_STORE",
        "REPRO_DIST_CHIPS", "REPRO_FLEET_HA_DIR", "EXTRA")}))
""")


def test_workers_get_the_rendezvous_in_their_environment(tmp_path):
    results = tsimdev.launch_local_fleet(
        [sys.executable, "-c", _ENV_WORKER], 2, chips_per_process=3,
        ha_dir=str(tmp_path), extra_env={"EXTRA": "x"}, timeout=60.0,
        poll_s=0.05)
    envs = [tsimdev.last_json_line(r.stdout) for r in results]
    assert [(e["RANK"], e["WORLD_SIZE"], e["LOCAL_RANK"]) for e in envs] \
        == [("0", "2", "0"), ("1", "2", "1")]
    assert all(e["REPRO_DIST_CHIPS"] == "3" and e["EXTRA"] == "x" and
               e["REPRO_FLEET_HA_DIR"] == str(tmp_path) for e in envs)
    stores = {e["REPRO_DIST_STORE"] for e in envs}
    assert len(stores) == 1              # one store a launch …
    store = stores.pop()
    assert not os.path.exists(os.path.dirname(store))   # … removed after


_CRASH_OR_SERVE = textwrap.dedent("""
    import os, sys, time
    rank = int(os.environ["RANK"])
    if rank == 0:
        print("dying", file=sys.stderr)
        sys.exit(3)
    time.sleep(0.8)
    print("served")
""")


def test_on_failure_continue_lets_survivors_finish():
    dead, alive = tsimdev.launch_local_fleet(
        [sys.executable, "-c", _CRASH_OR_SERVE], 2,
        on_failure="continue", timeout=60.0, poll_s=0.05)
    assert dead.crashed and dead.returncode == 3
    assert "dying" in dead.stderr_tail
    assert alive.returncode == 0 and not alive.killed
    assert "served" in alive.stdout


def test_on_failure_kill_stays_the_default():
    dead, alive = tsimdev.launch_local_fleet(
        [sys.executable, "-c", _CRASH_OR_SERVE], 2, timeout=60.0,
        poll_s=0.05)
    assert dead.crashed and dead.returncode == 3
    assert alive.killed and alive.returncode != 0


_BEATING_WORKER = textwrap.dedent("""
    import json, os, time
    rank = int(os.environ["RANK"])
    root = os.environ["REPRO_FLEET_HA_DIR"]
    for step in range(40):
        path = os.path.join(root, f"rank_{rank}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": rank, "beat": step + 1, "step": step,
                       "status": "serving"}, f)
        os.replace(tmp, path)
        time.sleep(0.05)
    print("finished all steps")
""")


def test_kill_at_injects_at_the_published_step(tmp_path):
    victim, other = tsimdev.launch_local_fleet(
        [sys.executable, "-c", _BEATING_WORKER], 2,
        on_failure="continue", kill_at=(0, 5), ha_dir=str(tmp_path),
        timeout=60.0, poll_s=0.02)
    assert victim.injected and not victim.crashed
    assert victim.returncode not in (0, None)
    journal = tsimdev.read_board(str(tmp_path), 0)
    assert 5 <= journal["step"] < 40         # mid-serve, not at the end
    assert other.returncode == 0 and "finished all steps" in other.stdout


# ---------------------------------------------------------------------- #
# chaos: real ranks, real kills (opt-in, as in the reference)
# ---------------------------------------------------------------------- #
@pytest.mark.chaos
@pytest.mark.parametrize("lockstep,kill_rank", [(False, 0), (True, 1)])
def test_chaos_selftest_cli(lockstep, kill_rank):
    """Kill a rank of a 2-rank fleet mid-serve on the CPU — rank 0 of a
    federated fleet, rank 1 of a lockstep one; the survivor degrades,
    absorbs, accounts exactly and resizes with no compile."""
    cmd = [sys.executable, "-m", "repro_torch.fleet", "--chaos-selftest",
           "--device", "cpu", "--kill-rank", str(kill_rank)]
    out = subprocess.run(cmd + (["--lockstep"] if lockstep else []),
                         capture_output=True, text=True, timeout=570,
                         env={**os.environ, "PYTHONPATH": tsimdev.SRC_DIR},
                         cwd=tsimdev.REPO_ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["pass"] and summary["kill_rank"] == kill_rank
    assert summary["lockstep"] == lockstep
    (survivor,) = summary["workers"].values()
    assert survivor["absorbed"] == [kill_rank]
    assert survivor["degraded"] == lockstep
    assert survivor["compile_delta"] == 0
