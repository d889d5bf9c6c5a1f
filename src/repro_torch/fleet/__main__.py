"""Smoke entry points for the fleet, in one process and over ranks.

``PYTHONPATH=src python -m repro_torch.fleet --selftest`` — the
single-process fleet on the card (or with ``--device cpu``), as
``--chips N`` logical chips (default 2) sharing one programmed image.
Checks that the fleet stream equals the single chip's, that the
continuous-batching router backfills ragged and late traffic and its
outputs match the direct stream, that its latency accounting is
monotone and its stats roll up, that the sensor-stream frontend
respects backpressure and a sensor-fed serve loop drains, that the
fleet report composes the per-chip accounting, and that rate
validation is silent on a feasible rate and warns or raises on an
infeasible one.

``PYTHONPATH=src python -m repro_torch.fleet --distributed-selftest`` —
the multi-process fleet: builds the kernels (on the card), then spawns
``--processes`` ranks (default 2), fresh interpreters in one gloo
process group, each serving ``--chips-per-process`` logical chips
(default 2) of the deep app on both systems. Every rank checks,
against a chip it compiles itself from the same seed (everything is a
pure function of (seed, step), so no reference data crosses ranks):
``stream_local`` on its row block equals the chip's stream of the same
rows bit for bit (three kernel launches a call on the card) and the
one-process stream of the whole batch within rel 1e-6; the lockstep
:class:`DistributedFleetRouter` drains its ``StreamSource.for_host``
feed, its outputs match the direct stream, and ``stats_global`` and
the fleet report account for every rank. The parent checks that every
rank ran the same steps and got the same ``stats_global``, equal to
``assemble_stats`` of the ranks' own rows; exit 0 iff all hold.

``PYTHONPATH=src python -m repro_torch.fleet --chaos-selftest`` — fault
tolerance: spawns a FEDERATED fleet (independent ranks over a shared
heartbeat board, :mod:`repro_torch.fleet.ha`), SIGKILLs ``--kill-rank``
(default 0) the moment its engine step reaches ``--kill-step``
(default 3), and checks that the survivor detects the death, absorbs
the dead rank's feed by replay, finishes degraded, resizes 2 → 4
logical chips with no compile, and that the final board journals
account for every admitted item of every rank exactly once. With
``--lockstep`` the ranks form one gloo group under
:class:`DistributedFleetRouter` instead (kill a rank other than the
survivor you want to watch: ``--kill-rank 1``); the survivor's guarded
collective raises :class:`repro_torch.fleet.ha.MembershipChange` and it
degrades to its own chips in place with no compile.

Every entry point runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import warnings

DEEP = (784, 200, 100, 10)
SYSTEMS = ("memristor", "digital")
KERNEL = {"memristor": "crossbar_mvm", "digital": "int8_matmul_fused"}
LANES_PER_CHIP = 2
FLEET_TOL = 1e-6        # a rank's rows vs the one-process stream of all
#                         rows: the kernels run at another batch size
AAH_CALLS = 200         # any_across_hosts calls timed a rank
LANE_CALLS = 50         # lane-batch stream_local calls timed a rank
WINDOWS = 9             # items a request: SensorPipeline(28, 18) windows


def selftest(verbose: bool = True, device=None, n_chips: int = 2) -> bool:
    import warnings

    import numpy as np
    import torch

    from repro_torch.chip import ChipRateWarning, compile_chip
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, StreamSource, shard_chip
    from repro_torch.runtime import resolve_device
    from repro_torch.serving.engine import ItemRequest

    dev = resolve_device(device)
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + detail + ')' if detail else ''}")

    # one compiled chip, served as n_chips logical chips
    dims = (784, 200, 100, 10)
    spec = MLPSpec(dims, activation="threshold", out_activation="linear")
    params = mlp_init(spec, generator=torch.Generator().manual_seed(0),
                      device=dev)
    chip = compile_chip(spec, params=params, system="memristor",
                        device=dev)
    fleet = shard_chip(chip, n_chips)
    check("fleet of logical chips", fleet.n_chips == n_chips,
          f"{fleet.n_chips} chips on {dev}")

    x = torch.rand((4 * n_chips + 3, 784),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    y, ref = fleet.stream(x), chip.stream(x)
    rel = float(torch.max(torch.abs(y - ref)) /
                torch.clamp(torch.max(torch.abs(ref)), min=1e-12))
    check("sharded stream == single chip", bool(torch.equal(y, ref)),
          f"rel {rel:.1e} over {fleet.n_chips} chips")

    def direct(items):
        return chip.stream(torch.as_tensor(items, dtype=torch.float32)
                           ).cpu().numpy()

    # continuous batching: ragged burst + mid-stream arrivals backfill
    router = FleetRouter(fleet, lanes_per_chip=2)
    rng = np.random.default_rng(2)
    first = [ItemRequest(uid=i, items=rng.uniform(0, 1, (3 + 2 * i, 784)))
             for i in range(3)]
    for r in first:
        router.submit(r)
    for _ in range(2):
        router.step()
    late = [ItemRequest(uid=10 + i, items=rng.uniform(0, 1, (2, 784)))
            for i in range(2 * n_chips)]
    for r in late:
        router.submit(r)
    done = router.run_until_drained()
    check("router drains ragged + late traffic",
          len(done) == len(first) + len(late))
    match = all(np.allclose(st.result, direct(st.request.items), atol=1e-5)
                for st in done)
    check("routed outputs match direct stream", match)
    lat_ok = all(st.request.t_submit <= st.t_admit <= st.t_done
                 for st in done)
    check("latency accounting is monotonic", lat_ok)
    stats = router.stats()
    check("router stats roll up", stats.requests == len(done) and
          stats.items == sum(st.result.shape[0] for st in done),
          str(stats))

    # sensor-stream frontend: windowed items, bounded-queue backpressure
    pipe = SensorPipeline(window=28, stride=18, frames_per_step=1)
    check("sensor windows are chip items", pipe.d_item == dims[0] and
          pipe.items_per_step == 9)
    src = StreamSource(pipe, n_requests=12, capacity=3)
    made = src.pump()
    check("backpressure caps production", made == 3 and
          src.pump() == 0 and src.stalls == 2,
          f"{made} staged of 12, capacity 3, {src.stalls} stalls")
    router2 = FleetRouter(fleet, lanes_per_chip=2, queue_limit=4)
    done2 = sorted(router2.serve(src), key=lambda s: s.request.uid)
    all_items = np.concatenate([st.request.items for st in done2])
    got = np.concatenate([st.result for st in done2])
    check("sensor-fed serve loop drains the stream",
          len(done2) == 12 and src.exhausted)
    check("sensor-fed outputs match direct stream",
          np.allclose(got, direct(all_items), atol=1e-5))

    # fleet report composes the per-chip accounting linearly
    rep = fleet.report(router2)
    chip_rep = chip.report()
    check("fleet report composes per-chip accounting",
          rep.n_chips == n_chips and
          abs(rep.power_mw - n_chips * chip_rep.power_mw) < 1e-9 and
          abs(rep.area_mm2 - n_chips * chip_rep.area_mm2) < 1e-9 and
          rep.served is not None and rep.served.items > 0)

    # compile-time TDM rate validation (both sides)
    feasible_ok = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", ChipRateWarning)
            compile_chip(spec, params=params, items_per_second=1e4,
                         device=dev)
    except ChipRateWarning:
        feasible_ok = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bad = 1e3 * chip.route.max_items_per_second
        compile_chip(spec, params=params, items_per_second=bad, device=dev)
        warned = any(issubclass(w.category, ChipRateWarning)
                     for w in caught)
    raised = False
    try:
        compile_chip(spec, params=params, items_per_second=bad,
                     strict_rate=True, device=dev)
    except ValueError:
        raised = True
    check("rate validation: feasible silent, infeasible warns/raises",
          feasible_ok and warned and raised)

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


# --------------------------------------------------------------------- #
# the multi-process fleet: ranks in one gloo group, or federated
# --------------------------------------------------------------------- #
def _checker(prefix, verbose):
    """A ``check(name, cond)`` that prints one line (after ``prefix``)
    and remembers the verdict in ``check.ok``."""
    def check(name, cond, detail=""):
        check.ok = check.ok and bool(cond)
        if verbose:
            print(f"  {prefix}[{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + str(detail) + ')' if detail else ''}",
                  flush=True)
    check.ok = True
    return check


def _require_built(dev) -> None:
    """A rank never runs ``nvcc``: its parent builds the kernels before
    it spawns the ranks (concurrent builds are safe, but every rank
    would run its own)."""
    if dev.type != "cuda":
        return
    from repro_torch.kernels import build
    missing = [n for n in build.KERNELS
               if not build.library_path(n).exists()]
    if missing:
        raise RuntimeError(f"kernel libraries {missing} are not built: "
                           "the parent builds them before it spawns the "
                           "ranks")


def _build_for(device):
    """The parent's side of :func:`_require_built`: build the kernels
    when the ranks will run on the card. Returns the worker argv's
    device flags."""
    from repro_torch.runtime import resolve_device
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build()
        return []
    return ["--device", "cpu"]


def _counted(path: dict, fn, *args):
    """``fn(*args)``, with the kernel launches it makes added to
    ``path`` — a path's own launches, apart from the streams its checks
    compare it with."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn(*args)
    for k, v in ops.launch_counts().items():
        path[k] = path.get(k, 0) + v - before[k]
    return out


def _deep_chip(system, dev):
    """The deep app at its published width, weights from seed 0 — every
    rank compiles the same chip, so programming moves no bytes."""
    import torch

    from repro_torch.chip import compile_chip
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    spec = MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = mlp_init(spec, generator=torch.Generator().manual_seed(0),
                      device=dev)
    return compile_chip(spec, params=params, system=system, device=dev)


def _direct_ok(chip, done) -> bool:
    """Every routed output matches the chip's direct stream of the
    request's items (lanes batch differently: atol 1e-5)."""
    import numpy as np
    import torch
    return all(np.allclose(
        st.result, chip.stream(torch.as_tensor(
            st.request.items, dtype=torch.float32)).cpu().numpy(),
        atol=1e-5) for st in done)


def distributed_worker(*, device=None, rows=None, requests=None,
                       drains: int = 1, verbose: bool = True) -> int:
    """One rank of the distributed selftest (spawned by
    :func:`run_distributed_selftest`; the rendezvous is in its
    environment). For each system: ``stream_local`` of its block of
    ``rows`` global rows against the chip, then ``drains`` lockstep
    drains of its own ``requests``-frame feed (the first checked, all
    timed); then the cost of ``any_across_hosts``. Prints one JSON
    line; exit 0 iff EVERY rank's checks passed (the verdict is
    allgathered, so all ranks agree)."""
    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.chip import compile_count
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import StreamSource, shard_chip
    from repro_torch.fleet.ha import HAConfig
    from repro_torch.fleet.router import any_across_hosts
    from repro_torch.launch.mesh import (allgather, init_fleet_group,
                                         make_distributed_fleet_mesh,
                                         process_count, rank_device)
    from repro_torch.launch.simdev import CHIPS_ENV
    from repro_torch.obs import allgather_snapshots

    dev = rank_device(device)
    _require_built(dev)
    # the ranks share the host's cores, and a rank's host work is small
    # ops (frames, staging) that intra-op threads only slow down
    torch.set_num_threads(1)
    rank = init_fleet_group(HAConfig().start_grace_s)
    nprocs = process_count()
    check = _checker(f"[rank {rank}] ", verbose)
    chips = int(os.environ.get(CHIPS_ENV, "1"))
    mesh = make_distributed_fleet_mesh(chips, device=dev)
    check("fleet mesh covers every rank's chips",
          mesh.size == nprocs * chips and mesh.n_processes == nprocs)
    rows = 3 * mesh.size if rows is None else rows
    requests = 6 if requests is None else requests
    per_rank = rows // nprocs
    lo = rank * per_rank
    x_global = torch.rand((rows, DEEP[0]),
                          generator=torch.Generator().manual_seed(1)).to(dev)
    x_local = x_global[lo:lo + per_rank]
    pipe = SensorPipeline(window=28, stride=18, frames_per_step=1)
    out = {"rank": rank, "processes": nprocs, "device": str(dev),
           "chips_per_process": chips, "rows": rows}
    chips_by_system = {system: _deep_chip(system, dev)
                       for system in SYSTEMS}
    c0 = compile_count()
    path = {}                   # the path's kernel launches
    for system, chip in chips_by_system.items():
        fleet = shard_chip(chip, mesh=mesh)
        check(f"{system}: fleet is distributed",
              fleet.is_distributed and fleet.n_chips == mesh.size and
              fleet.n_local_chips == chips)
        per_call = {}
        y = _counted(per_call, fleet.stream_local, x_local.cpu().numpy())
        for k, v in per_call.items():
            path[k] = path.get(k, 0) + v
        want = {k: 3 if dev.type == "cuda" and k == KERNEL[system] else 0
                for k in per_call}
        same = chip.stream(x_local).cpu().numpy()
        whole = chip.stream(x_global)[lo:lo + per_rank].cpu().numpy()
        rel = float(np.max(np.abs(y - whole)) /
                    max(np.max(np.abs(whole)), 1e-12))
        check(f"{system}: stream_local == the chip's stream of the same "
              f"rows (bit for bit)", np.array_equal(y, same))
        check(f"{system}: stream_local vs the one-process stream of all "
              f"{rows} rows (rel <= {FLEET_TOL})", rel <= FLEET_TOL,
              f"rel {rel:.3g}")
        check(f"{system}: kernel launches a stream_local call",
              per_call == want, per_call)
        row = {"equal_chip": bool(np.array_equal(y, same)),
               "rel_one_process": rel, "launches_per_call": per_call,
               "drains": []}
        for d in range(drains):
            src = StreamSource.for_host(pipe, n_requests=requests,
                                        capacity=3)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                router = fleet.serve(lanes_per_chip=LANES_PER_CHIP,
                                     queue_limit=4)
            reduce, in_reduce = router._any_across_hosts, [0.0]

            def timed_reduce(flag):             # this rank's wait in
                t0 = time.perf_counter()        # the lockstep reduction
                more = reduce(flag)
                in_reduce[0] += time.perf_counter() - t0
                return more

            router._any_across_hosts = timed_reduce
            done = _counted(path, router.serve, src)
            glob = router.stats_global()
            row["drains"].append({
                "steps": router.steps, "wall_s": glob.wall_s,
                "items": glob.items,
                "items_per_s": glob.items_per_second,
                "steps_per_s": glob.steps / glob.wall_s,
                "local_wall_s": router._wall_s(),
                "in_reduce_s": in_reduce[0]})
            if d:
                continue
            check(f"{system}: the lockstep router drains this rank's "
                  f"feed", type(router).__name__ == "DistributedFleetRouter"
                  and len(done) == requests and src.exhausted)
            check(f"{system}: routed outputs match the direct stream",
                  _direct_ok(chip, done))
            check(f"{system}: latency accounting is monotonic",
                  all(st.request.t_submit <= st.t_admit <= st.t_first
                      <= st.t_done for st in done))
            check(f"{system}: stats_global rolls up every rank",
                  glob.requests == requests * nprocs and
                  glob.items == requests * WINDOWS * nprocs and
                  glob.lanes == LANES_PER_CHIP * mesh.size and
                  glob.steps >= router.steps)
            rep = fleet.report(router)
            check(f"{system}: fleet report serves the global roll-up",
                  rep.n_chips == mesh.size and
                  rep.served.items == requests * WINDOWS * nprocs)
            # what the parent needs to recompute this rank's share of
            # stats_global (float64 repr round-trips through JSON)
            lat, wait = router._latency_arrays()
            row.update(counts=[len(router.finished), router.items_emitted,
                               router.steps, router.rejected, router.slots],
                       wall_s=router._wall_s(),
                       lat=[float(v) for v in lat],
                       wait=[float(v) for v in wait],
                       stats_local=dataclasses.asdict(router.stats()),
                       stats_global=dataclasses.asdict(glob))
        out[system] = row
    check("streams and drains compile nothing", compile_count() == c0)
    check("registry snapshots gather across ranks",
          allgather_snapshots({"rank": rank, "pad": "x" * rank}) ==
          [{"rank": r, "pad": "x" * r} for r in range(nprocs)])
    out["launches"] = path
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["cuda_max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    for _ in range(AAH_CALLS):
        any_across_hosts(True)
    out["any_across_hosts_us"] = (time.perf_counter() - t0) / AAH_CALLS * 1e6
    # one lane batch through stream_local, alone (the other ranks wait
    # in a gather) and with every rank streaming at once: what sharing
    # the device costs a router step
    xb = x_local[:LANES_PER_CHIP * chips].cpu().numpy()
    out["lane_stream_ms"] = {}
    for system, chip in chips_by_system.items():
        fleet = shard_chip(chip, mesh=mesh)

        def lane_ms():
            t0 = time.perf_counter()
            for _ in range(LANE_CALLS):
                fleet.stream_local(xb)
            return (time.perf_counter() - t0) / LANE_CALLS * 1e3

        lane_ms()                               # warm-up
        for r in range(nprocs):
            allgather(torch.zeros(1))
            if r == rank:
                alone = lane_ms()
        allgather(torch.zeros(1))
        out["lane_stream_ms"][system] = {"alone": alone,
                                         "together": lane_ms()}
    verdicts = allgather(torch.tensor([int(check.ok)]))
    out["ok"] = bool(verdicts.sum() == nprocs)
    if verbose:
        print(f"  [rank {rank}] worker: "
              f"{'PASS' if out['ok'] else 'FAIL'}", flush=True)
    print(json.dumps(out), flush=True)   # JSON verdict last, by contract
    dist.destroy_process_group()
    return 0 if out["ok"] else 1


def chaos_worker(*, device=None, lockstep: bool = False, requests=None,
                 verbose: bool = True) -> int:
    """One rank of the chaos fleet (spawned by
    :func:`run_chaos_selftest`): serves its share of one logical
    sensor stream of the deep app (memristor) through
    :class:`repro_torch.fleet.ha.HAFleetServer` — federated over a
    one-process mesh, or (``lockstep``) as one rank of a gloo group
    under the lockstep router — survives the supervisor SIGKILLing a
    peer mid-serve (detect → absorb the dead rank's feed → finish
    degraded), reports the board ``stats_global`` roll-up from THIS
    rank, then resizes to twice its chips with no compile."""
    import numpy as np
    import torch

    from repro_torch.chip import compile_count
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import (DistributedFleetRouter, FleetRouter,
                                   StreamSource, shard_chip)
    from repro_torch.fleet.ha import HAConfig, HAFleetServer, HeartbeatBoard
    from repro_torch.launch.mesh import (init_fleet_group,
                                         make_distributed_fleet_mesh,
                                         rank_device)
    from repro_torch.launch.simdev import CHIPS_ENV, HA_DIR_ENV

    rank = int(os.environ["RANK"])
    nprocs = int(os.environ["WORLD_SIZE"])
    chips = int(os.environ.get(CHIPS_ENV, "2"))
    n_req = 8 if requests is None else requests
    dev = rank_device(device)
    _require_built(dev)
    # the ranks share the host's cores, and a rank's host work is small
    # ops (frames, staging) that intra-op threads only slow down
    torch.set_num_threads(1)
    # step_sleep_s paces serving at a sensor frame cadence — which is
    # also what makes "mid-serve" a real window for the supervisor's
    # kill injection (raw engine steps take about a millisecond)
    config = HAConfig(timeout_s=1.0, retries=3, backoff_s=0.1,
                      step_sleep_s=0.05)
    if lockstep:
        init_fleet_group(config.start_grace_s)
    check = _checker(f"[rank {rank}] ", verbose)
    chip = _deep_chip("memristor", dev)
    c0 = compile_count()
    if lockstep:
        fleet = shard_chip(chip, mesh=make_distributed_fleet_mesh(
            chips, device=dev))
        router = DistributedFleetRouter(fleet, lanes_per_chip=2,
                                        queue_limit=4)
    else:
        fleet = shard_chip(chip, chips)
        router = FleetRouter(fleet, lanes_per_chip=2, queue_limit=4)
    pipe = SensorPipeline(window=28, stride=18, frames_per_step=1)
    src = StreamSource.for_host(pipe, host=rank, hosts=nprocs,
                                n_requests=n_req, capacity=3)
    server = HAFleetServer(
        router, src, board=HeartbeatBoard(os.environ[HA_DIR_ENV]),
        rank=rank, ranks=range(nprocs), pipeline=pipe, config=config)
    path = {}                   # the path's kernel launches
    done = _counted(path, server.serve)

    out = {"rank": rank, "lockstep": lockstep,
           "completed": sorted(st.request.uid for st in done),
           "rejected": sorted(server.rejected_uids),
           "absorbed": server.absorbed,
           "degraded": lockstep and not router._spmd_lockstep,
           "degraded_ips": server.degraded_items_per_second}
    check("own feed drained", src.exhausted)
    check("survivor outputs match the direct stream", _direct_ok(chip, done))
    if server.absorbed:
        # the failover roll-up, assumable by ANY surviving rank: this
        # rank assembles the fleet view from the board (the dead rank's
        # row is its last journal — exactly the work it provably
        # delivered). Requests are exactly-once; items are at-least-once
        # in the crash window (partially-streamed lanes replay whole),
        # hence == on requests, >= on items.
        gs = server.stats_global()
        out["stats_requests"] = gs.requests
        out["stats_items"] = gs.items
        check("board stats_global accounts every request",
              gs.requests == nprocs * n_req)
        check("board stats_global items cover the stream",
              gs.items >= nprocs * n_req * WINDOWS)
        check("degraded throughput > 0",
              server.degraded_items_per_second > 0)
        if lockstep:
            check("the lockstep router degraded to its own chips",
                  out["degraded"] and not fleet.is_distributed and
                  fleet.n_chips == chips)

    # elastic resize to twice the chips: the same programmed plan, no
    # compile, the chip's own rows
    router.resize(2 * chips)
    x = torch.rand((8, DEEP[0]),
                   generator=torch.Generator().manual_seed(2)).to(dev)
    y, ref = _counted(path, fleet.stream, x), chip.stream(x)
    rel = float((y - ref).abs().max() / ref.abs().max().clamp(min=1e-12))
    out.update(resized_chips=fleet.n_chips,
               compile_delta=compile_count() - c0, resize_rel=rel,
               launches=path)
    check("serve, degrade and resize compile nothing; resized rel 0.0",
          fleet.n_chips == 2 * chips and out["compile_delta"] == 0 and
          rel == 0.0)
    out["ok"] = check.ok
    if verbose:
        print(f"  [rank {rank}] chaos worker: "
              f"{'PASS' if check.ok else 'FAIL'}", flush=True)
    print(json.dumps(out), flush=True)   # JSON verdict last, by contract
    if lockstep:
        # the group may hold a dead peer: leave without its teardown
        # (the board is already the durable record)
        sys.stdout.flush()
        os._exit(0 if check.ok else 1)
    return 0 if check.ok else 1


def _worker_results(results, verbose):
    """Each rank's last JSON line (or a failure row), relaying the
    ranks' own lines when verbose."""
    from repro_torch.launch.simdev import last_json_line
    workers = {}
    for r in results:
        if verbose:
            for line in r.stdout.splitlines():
                if line.strip() and not line.startswith("{"):
                    print(f"  {line}")
        try:
            workers[r.rank] = last_json_line(r.stdout)
        except (ValueError, json.JSONDecodeError):
            workers[r.rank] = {"rank": r.rank, "ok": False,
                               "error": r.stderr_tail or "no output"}
    return workers


def run_distributed_selftest(processes: int = 2, chips_per_process: int = 2,
                             *, device=None, rows=None, requests: int = 6,
                             drains: int = 1, verbose: bool = True,
                             timeout: float = 600.0) -> dict:
    """Parent of the distributed selftest: build the kernels (on the
    card), spawn one ``--distributed-worker`` per rank (supervised — a
    dead rank takes the fleet down instead of hanging it), then check
    across the ranks' JSON lines that every rank ran the same steps and
    got the same ``stats_global``, equal to :func:`assemble_stats` of
    the ranks' own counter rows, walls and latency vectors. ``rows`` is
    the global batch (default 3 a chip), split evenly over the ranks.
    Returns the summary; ``summary["pass"]`` is the verdict."""
    import numpy as np

    from repro_torch.fleet.router import assemble_stats
    from repro_torch.launch.simdev import launch_local_fleet

    rows = 3 * processes * chips_per_process if rows is None else rows
    if rows % processes:
        raise ValueError(f"rows {rows} do not split evenly over "
                         f"{processes} ranks")
    argv = [sys.executable, "-m", "repro_torch.fleet",
            "--distributed-worker", "--rows", str(rows), "--requests",
            str(requests), "--drains", str(drains), *_build_for(device)]
    results = launch_local_fleet(argv, processes,
                                 chips_per_process=chips_per_process,
                                 timeout=timeout)
    workers = _worker_results(results, verbose)
    check = _checker("", verbose)
    for r in results:
        check(f"rank {r.rank} passed (exit {r.returncode})",
              r.returncode == 0 and workers[r.rank].get("ok"),
              "" if r.returncode == 0 else r.stderr_tail)
    if check.ok:
        ranks = [workers[r] for r in sorted(workers)]
        for system in SYSTEMS:
            rows_ = [w[system] for w in ranks]
            want = assemble_stats(
                np.asarray([w["counts"] for w in rows_], np.int64),
                np.asarray([w["wall_s"] for w in rows_]),
                np.concatenate([np.asarray(w["lat"], np.float64)
                                for w in rows_]),
                np.concatenate([np.asarray(w["wait"], np.float64)
                                for w in rows_]))
            check(f"{system}: stats_global identical on every rank and "
                  f"== assemble_stats of the ranks' rows",
                  all(w["stats_global"] == dataclasses.asdict(want)
                      for w in rows_))
            check(f"{system}: every rank ran the same steps (lockstep)",
                  all(len({w["drains"][d]["steps"] for w in rows_}) == 1
                      for d in range(drains)))
    return {"pass": bool(check.ok), "processes": processes,
            "chips_per_process": chips_per_process, "rows": rows,
            "requests": requests, "workers": workers}


def run_chaos_selftest(processes: int = 2, kill_rank: int = 0,
                       kill_step: int = 3, n_requests: int = 8, *,
                       lockstep: bool = False, chips_per_process: int = 2,
                       device=None, verbose: bool = True,
                       timeout: float = 600.0) -> dict:
    """Kill a rank mid-serve; check the fleet degrades instead of dying,
    and that the accounting is EXACT.

    Spawns ``--chaos-worker`` ranks (federated, or one gloo group with
    ``lockstep``), lets every rank start serving, then SIGKILLs
    ``kill_rank`` the moment its published engine step reaches
    ``kill_step`` (``launch_local_fleet(kill_at=…)`` — a real external
    crash, not a cooperative exit). The survivors must finish
    degraded; afterwards the parent audits the union of the final
    heartbeat-board journals for the no-drop/no-dup contract: every
    admitted item of every rank's feed — including the dead rank's —
    is accounted exactly once (completed by exactly one rank, or
    explicitly rejected). Returns the summary; ``summary["pass"]`` is
    the verdict."""
    from repro_torch.launch.simdev import launch_local_fleet, read_board

    check = _checker("", verbose)
    ha_dir = tempfile.mkdtemp(prefix="repro_torch_chaos_")
    try:
        argv = [sys.executable, "-m", "repro_torch.fleet",
                "--chaos-worker", "--requests", str(n_requests),
                *(["--lockstep"] if lockstep else []),
                *_build_for(device)]
        results = launch_local_fleet(
            argv, processes, chips_per_process=chips_per_process,
            timeout=timeout, on_failure="continue",
            kill_at=(kill_rank, kill_step), ha_dir=ha_dir, poll_s=0.05)
        victim = results[kill_rank]
        check("victim was chaos-killed mid-serve (not a clean exit)",
              victim.injected and not victim.crashed and
              victim.returncode not in (0, None),
              f"rank {kill_rank} exit {victim.returncode}")
        victim_journal = read_board(ha_dir, kill_rank) or {}
        check("victim died with work still in flight",
              len(victim_journal.get("completed", ())) < n_requests,
              f"{len(victim_journal.get('completed', ()))} of "
              f"{n_requests} done at death")
        workers = _worker_results(
            [r for r in results if r.rank != kill_rank], verbose)
        for r in results:
            if r.rank != kill_rank:
                check(f"survivor {r.rank} finished degraded and passed",
                      r.returncode == 0 and not r.crashed and
                      workers[r.rank].get("ok"), r.stderr_tail)

        # EXACT accounting, audited from outside the fleet: the union
        # of the final board journals must cover every uid of every
        # rank's bounded feed exactly once
        completed, rejected, expected = [], set(), set()
        for rank in range(processes):
            payload = read_board(ha_dir, rank) or {}
            completed.extend(payload.get("completed", ()))
            rejected |= set(payload.get("rejected_uids", ()))
            snap = payload.get("source")
            if snap is not None:
                expected |= {snap["uid_base"] + k
                             for k in range(int(snap["n_requests"]))}
        comp_set = set(completed)
        check("every rank's feed is on the board",
              len(expected) == processes * n_requests,
              f"{len(expected)} uids")
        check("no item completed twice (no dup)",
              len(completed) == len(comp_set))
        check("no item both completed and rejected",
              not (comp_set & rejected))
        check("every admitted item accounted exactly once (no drop)",
              comp_set | rejected == expected,
              f"missing {sorted(expected - comp_set - rejected)[:8]}")
        absorbers = [w for w in workers.values()
                     if kill_rank in w.get("absorbed", ())]
        check("exactly one survivor absorbed the dead rank's feed",
              len(absorbers) == 1)
        if absorbers:
            a = absorbers[0]
            check("a surviving rank reported stats_global for the fleet",
                  a.get("rank") != kill_rank and
                  a.get("stats_requests") == processes * n_requests,
                  f"rank {a.get('rank')}: "
                  f"{a.get('stats_requests')} requests")
            if lockstep:
                check("the survivor's lockstep router degraded in place",
                      a.get("degraded") is True)
        return {"pass": bool(check.ok), "processes": processes,
                "lockstep": lockstep, "kill_rank": kill_rank,
                "kill_step": kill_step, "n_requests": n_requests,
                "completed": len(comp_set), "rejected": len(rejected),
                "victim_completed_at_death":
                    len(victim_journal.get("completed", ())),
                "workers": workers}
    finally:
        shutil.rmtree(ha_dir, ignore_errors=True)

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet")
    ap.add_argument("--selftest", action="store_true",
                    help="run the shard→route→serve smoke check")
    ap.add_argument("--chips", type=int, default=2,
                    help="logical chips in the fleet (default 2)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--distributed-selftest", action="store_true",
                    help="spawn a localhost fleet of ranks (one gloo "
                         "group) and check the multi-process fleet")
    ap.add_argument("--processes", type=int, default=2,
                    help="ranks for the multi-process selftests")
    ap.add_argument("--chips-per-process", type=int, default=2,
                    help="logical chips a rank (default 2)")
    ap.add_argument("--chaos-selftest", action="store_true",
                    help="kill a rank mid-serve and check the fleet "
                         "degrades with exact item accounting")
    ap.add_argument("--lockstep", action="store_true",
                    help="chaos: one gloo group under the lockstep "
                         "router instead of a federated fleet")
    ap.add_argument("--kill-rank", type=int, default=0,
                    help="which rank the chaos selftest kills "
                         "(default 0: also pins rank-0-free stats)")
    ap.add_argument("--kill-step", type=int, default=3,
                    help="engine step at which the victim is killed")
    # spawned, not typed: the workers and what their parent hands them
    for flag in ("--distributed-worker", "--chaos-worker"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag, default in (("--rows", None), ("--requests", None),
                          ("--drains", 1)):
        ap.add_argument(flag, type=int, default=default,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.distributed_worker:
        return distributed_worker(device=args.device, rows=args.rows,
                                  requests=args.requests,
                                  drains=args.drains)
    if args.chaos_worker:
        return chaos_worker(device=args.device, lockstep=args.lockstep,
                            requests=args.requests)
    if args.distributed_selftest:
        summary = run_distributed_selftest(
            args.processes, args.chips_per_process, device=args.device)
    elif args.chaos_selftest:
        summary = run_chaos_selftest(
            args.processes, kill_rank=args.kill_rank,
            kill_step=args.kill_step, lockstep=args.lockstep,
            chips_per_process=args.chips_per_process, device=args.device)
    elif args.selftest:
        return 0 if selftest(device=args.device, n_chips=args.chips) else 1
    else:
        ap.print_help()
        return 2
    print(json.dumps(summary), flush=True)   # JSON verdict last
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
