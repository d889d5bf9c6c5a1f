"""repro_torch.fleet.ha — high availability for streaming fleets.

Port of ``repro.fleet.ha``.

The paper's fabrics are embedded streaming processors fed straight
from sensors; in that deployment a node dying mid-stream must degrade
the fleet, not destroy it. This module is the survival story, built on
two repo primitives that make failure cheap: the program-once plan is
mesh-agnostic (serving it on a rebuilt mesh is ZERO compile passes —
``ShardedChip.resize``/``reprogram``), and every source feed is a pure
function of ``(seed, step)`` (a survivor can replay a dead rank's
exact frames from two integers — ``StreamSource.for_host``).

Failure model:

  * A peer dying between or in the middle of the ranks' gloo
    collectives surfaces on the survivors as a fast gloo error
    (``Connection reset by peer`` within milliseconds), after which
    the survivor's own CUDA work runs on. So a lockstep router CAN
    detect a peer death at its control-plane collective and degrade in
    place: that is :class:`StepGuard` + :func:`degrade_to_local` on
    ``DistributedFleetRouter``. A stalled (not dead) peer fails the
    collective when the group's timeout runs out — the boot grace
    ``HAConfig.start_grace_s``, which is what a lockstep worker hands
    :func:`repro_torch.launch.mesh.init_fleet_group`.
  * The reference's lockstep fleet cannot survive its coordinator
    (rank 0 of a ``jax.distributed`` job) and so runs *federated* to
    tolerate ANY single rank's loss: each rank is an independent
    process with its own one-process ``"chip"`` mesh, and membership,
    accounting and the stats roll-up ride a shared-filesystem
    :class:`HeartbeatBoard` instead of collectives. The port keeps
    both shapes, and :class:`HAFleetServer` drives either.

The reference's ``_mesh_dispatches`` probe measures a jax CPU-client
fault: after a failed gloo collective its multi-device dispatch is
poisoned for good, so the reference degrades to one device. Torch has
no such fault — the collective plane is gloo on the host, and the
rank's CUDA work does not go through it — so :func:`degrade_to_local`
keeps the rank's device and all its logical chips, and there is no
probe.

Exactly-once accounting across a failure: every server journals the
uids it has completed (and explicitly rejected) on the board with each
heartbeat. A survivor absorbing a dead rank replays only the uids NOT
journaled — work the dead host provably delivered is never re-done,
work it merely started is re-admitted (front-of-queue, bypassing
admission limits: ``StreamSource.requeue``). Execution is therefore
at-least-once in the crash window, but the board — the delivery record
— accounts for every admitted item exactly once: completed by exactly
one rank, or explicitly rejected. The chaos selftest asserts this from
the supervisor, over the union of all ranks' journals.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.fleet.router import (RouterStats, assemble_stats,
                                      latency_arrays)
from repro_torch.launch.mesh import FleetMesh
from repro_torch.launch.simdev import board_path, read_board
from repro_torch.obs.core import current as _obs_current
from repro_torch.serving.engine import ItemRequest, ItemRequestState


class MembershipChange(RuntimeError):
    """The fleet lost (at least) one rank: raised out of a guarded
    collective step once the detector's bounded retry/backoff confirms
    who died. ``dead`` is the newly declared rank list; ``cause`` the
    collective's own exception when one triggered the check."""

    def __init__(self, dead, cause: Optional[BaseException] = None):
        self.dead = sorted(dead)
        self.cause = cause
        msg = f"fleet membership changed: rank(s) {self.dead} dead"
        if cause is not None:
            msg += f" (collective failed: {type(cause).__name__})"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class HAConfig:
    """Failure-detection and takeover knobs.

    A peer is *suspected* when its heartbeat counter stops advancing
    for ``timeout_s`` (the step deadline); a suspect is re-polled
    ``retries`` times with exponential backoff starting at
    ``backoff_s`` before being *declared* dead — bounded, so detection
    latency is ~``timeout_s + backoff_s × (2^retries − 1)``, and a
    merely-slow peer whose beat advances during the retries is never
    declared. ``start_grace_s`` covers workers still booting (torch
    import, CUDA context and compile can take tens of seconds): a peer
    that has NEVER published is only suspected after the grace; it is
    also the lockstep group's collective timeout. ``takeover`` picks
    what a survivor does with a dead rank's outstanding items:
    ``"replay"`` re-admits them from the (seed, step)-pure pipeline;
    ``"reject"`` journals them as explicitly rejected (load shedding
    with exact accounting — for fleets that cannot absorb the extra
    traffic degraded). ``step_sleep_s`` paces the serve loop (the
    sensor frame cadence — items arrive in real time, they are not
    pre-staged); the chaos harness also relies on it to make
    "mid-serve" a real window its kill injection can land in."""
    timeout_s: float = 2.0
    retries: int = 3
    backoff_s: float = 0.25
    start_grace_s: float = 60.0
    idle_sleep_s: float = 0.02
    step_sleep_s: float = 0.0
    takeover: str = "replay"

    def __post_init__(self):
        if self.takeover not in ("replay", "reject"):
            raise ValueError("HAConfig.takeover must be 'replay' or "
                             f"'reject', got {self.takeover!r}")
        if self.retries < 1:
            raise ValueError("HAConfig.retries must be >= 1")


class HeartbeatBoard:
    """Shared-filesystem membership/accounting board: one JSON file
    per rank (``rank_<r>.json`` under ``root`` — the filename and the
    ``"step"`` field are shared with the chaos supervisor via
    :func:`repro_torch.launch.simdev.board_path`, and are the
    reference's: either package reads the other's boards). Writes are atomic
    (tmp + rename), so readers see either nothing or a complete
    payload — never a torn one."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._event_n = 0

    def publish(self, rank: int, payload: dict) -> None:
        path = board_path(self.root, rank)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def read(self, rank: int) -> Optional[dict]:
        return read_board(self.root, rank)

    def ranks(self) -> List[int]:
        """Ranks that have published at least once."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith("rank_") and name.endswith(".json"):
                try:
                    out.append(int(name[5:-5]))
                except ValueError:
                    pass
        return sorted(out)

    # ---------------- event journal ------------------------------- #
    # membership changes live in the rank heartbeats; other operational
    # events (recalibration, from repro_torch.variability) are journaled as
    # their OWN append-only atomic files so they can never clobber a
    # heartbeat and survive arbitrarily many publishes.
    def publish_event(self, kind: str, payload: dict) -> str:
        """Journal one operational event (atomic tmp + rename, like
        heartbeats). Files are ``evt_<seq>_<pid>_<kind>.json`` under
        ``root/events``; the (per-process seq, pid) pair makes names
        collision-free across writers. Returns the file path."""
        evdir = os.path.join(self.root, "events")
        os.makedirs(evdir, exist_ok=True)
        name = f"evt_{self._event_n:06d}_{os.getpid()}_{kind}.json"
        self._event_n += 1
        path = os.path.join(evdir, name)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(dict(payload, kind=kind), f)
        os.replace(tmp, path)
        return path

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """All journaled events (optionally one ``kind``), ordered by
        (writer sequence, pid) — a stable total order; cross-process
        interleaving is whatever the sequence numbers say, which is
        enough for the journal's audit purpose."""
        evdir = os.path.join(self.root, "events")
        if not os.path.isdir(evdir):
            return []
        out = []
        for name in sorted(os.listdir(evdir)):
            if not (name.startswith("evt_") and name.endswith(".json")):
                continue
            with open(os.path.join(evdir, name)) as f:
                ev = json.load(f)
            if kind is None or ev.get("kind") == kind:
                out.append(ev)
        return out


class FailureDetector:
    """Heartbeat/step-deadline failure detection over a board.

    Tracks, per peer, the last observed beat counter and WHEN it last
    advanced; :meth:`poll` suspects peers past the deadline and runs
    the bounded retry/backoff confirmation, :meth:`confirm` runs it
    immediately for every live peer (the path a failed collective
    takes — the peer just died, the deadline has not elapsed yet).
    A peer whose last payload says ``status: "done"`` exited cleanly
    and is never declared dead. ``clock``/``sleep`` are injectable so
    the tier-1 suite can drive detection deterministically."""

    def __init__(self, board: HeartbeatBoard, rank: int,
                 ranks: Sequence[int], config: Optional[HAConfig] = None,
                 *, clock=time.monotonic, sleep=time.sleep):
        self.board = board
        self.rank = int(rank)
        self.peers = [int(p) for p in ranks if int(p) != self.rank]
        self.config = config or HAConfig()
        self._clock = clock
        self._sleep = sleep
        t0 = clock()
        # beat -1 = never published (start_grace_s applies)
        self._seen: Dict[int, tuple] = {p: (-1, t0) for p in self.peers}
        self.dead: Set[int] = set()
        self.done: Set[int] = set()

    @property
    def alive(self) -> List[int]:
        """Ranks not declared dead (me + serving/done peers), sorted —
        the deterministic takeover-assignment domain every survivor
        agrees on."""
        return sorted({self.rank} |
                      {p for p in self.peers if p not in self.dead})

    def _refresh(self, peer: int) -> None:
        payload = self.board.read(peer)
        if payload is None:
            return
        beat = int(payload.get("beat", 0))
        if beat != self._seen[peer][0]:
            self._seen[peer] = (beat, self._clock())
        if payload.get("status") == "done":
            self.done.add(peer)

    def _stale(self, peer: int) -> bool:
        beat, t = self._seen[peer]
        grace = self.config.start_grace_s if beat < 0 \
            else self.config.timeout_s
        return self._clock() - t >= grace

    def _confirm_peer(self, peer: int) -> bool:
        """Bounded retry + exponential backoff: True = declared dead
        (its beat never advanced across the retries)."""
        beat = self._seen[peer][0]
        delay = self.config.backoff_s
        for _ in range(self.config.retries):
            self._sleep(delay)
            delay *= 2
            self._refresh(peer)
            if peer in self.done or self._seen[peer][0] != beat:
                return False
        return True

    def _sweep(self, candidates) -> Set[int]:
        newly: Set[int] = set()
        for peer in candidates:
            if peer in self.dead or peer in self.done:
                continue
            if self._confirm_peer(peer):
                self.dead.add(peer)
                newly.add(peer)
        return newly

    def poll(self) -> Set[int]:
        """Refresh every peer; run the confirmation sweep over those
        past their step deadline. Returns the NEWLY declared dead."""
        suspects = []
        for peer in self.peers:
            if peer in self.dead or peer in self.done:
                continue
            self._refresh(peer)
            if peer not in self.done and self._stale(peer):
                suspects.append(peer)
        return self._sweep(suspects)

    def confirm(self) -> Set[int]:
        """A collective just failed under us: confirm every live peer
        NOW (retry/backoff, no deadline wait). Returns the newly
        dead."""
        for peer in self.peers:
            self._refresh(peer)
        return self._sweep(list(self.peers))


class StepGuard:
    """Heartbeat/step-deadline instrumentation around a router's
    (possibly collective) engine step — attach with
    ``router.attach_ha(guard)`` (:class:`repro_torch.fleet.router.TimedStepMixin`).

    Every guarded step: publish a beat BEFORE entering the collective
    (so peers watching this rank's deadline see progress), check the
    peers' deadlines, then run the step; any exception out of the step
    triggers the detector's immediate confirmation sweep, and a
    confirmed death is re-raised as :class:`MembershipChange` (the
    original exception rides along as ``cause``). An exception with NO
    dead peer behind it propagates unchanged."""

    def __init__(self, detector: FailureDetector, publish=None):
        self.detector = detector
        self._publish = publish
        self._beat_n = 0
        self.steps_guarded = 0

    def beat(self) -> None:
        if self._publish is not None:
            self._publish()
            return
        self._beat_n += 1
        self.detector.board.publish(self.detector.rank, {
            "rank": self.detector.rank, "beat": self._beat_n,
            "step": self.steps_guarded, "status": "serving"})

    def run_step(self, fn):
        self.beat()
        newly = self.detector.poll()
        if newly:
            raise MembershipChange(newly)
        try:
            out = fn()
        except MembershipChange:
            raise
        except Exception as e:
            newly = self.detector.confirm()
            if newly:
                raise MembershipChange(newly, cause=e) from e
            raise
        self.steps_guarded += 1
        return out

    def call(self, fn, *args):
        """Guard a control-plane collective (``any_across_hosts``)
        the same way as an engine step."""
        return self.run_step(lambda: fn(*args))


# ------------------------------------------------------------------- #
# (seed, step)-pure takeover: replay a dead host's feed
# ------------------------------------------------------------------- #
def source_snapshot(source) -> dict:
    """The five integers that make a :class:`StreamSource` feed
    replayable by anyone: published with every heartbeat, consumed by
    :func:`replay_requests` on the absorbing survivor."""
    return {
        "start_step": source.next_step
        - source.produced * source.step_stride,
        "step_stride": source.step_stride,
        "uid_base": source.uid_base,
        "n_requests": source.n_requests,
        "produced": source.produced,
    }


def replay_requests(pipeline, snapshot: dict,
                    exclude=()) -> List[ItemRequest]:
    """Reconstruct a dead host's outstanding requests from its last
    journaled source snapshot: request ``k`` is exactly
    ``pipeline.batch(start_step + k·step_stride)`` with uid
    ``uid_base + k`` — (seed, step)-purity means no request bytes ever
    needed to cross hosts for this to be possible. Bounded streams
    replay the never-produced tail too; an endless stream can only
    replay its produced window. Uids in ``exclude`` (journaled
    completed/rejected — work provably delivered) are skipped."""
    n = snapshot["n_requests"]
    n = int(snapshot["produced"]) if n is None else int(n)
    exclude = set(exclude)
    out = []
    for k in range(n):
        uid = snapshot["uid_base"] + k
        if uid in exclude:
            continue
        step = snapshot["start_step"] + k * snapshot["step_stride"]
        items = np.asarray(pipeline.batch(step), np.float32)
        out.append(ItemRequest(uid=uid, items=items))
    return out


# ------------------------------------------------------------------- #
# degraded mode for lockstep routers
# ------------------------------------------------------------------- #
def local_fleet_mesh(mesh: FleetMesh,
                     n_chips: Optional[int] = None) -> FleetMesh:
    """A one-process ``"chip"`` mesh over THIS rank's device of
    ``mesh``, with its logical chips (default: all of this rank's
    chips) — what a survivor rebuilds on after a membership change,
    since the global mesh still names the dead ranks."""
    local = len(mesh.local_chips)
    n = local if n_chips is None else int(n_chips)
    if not 1 <= n <= local:
        raise ValueError(f"local_fleet_mesh: n_chips {n} not in "
                         f"[1, {local}]")
    return FleetMesh((mesh.device,), (n,))


def degrade_to_local(router, mesh: Optional[FleetMesh] = None) -> None:
    """Fall a lockstep router out of its dead collectives onto this
    rank's own chips, in place: serve the programmed plan on a
    one-process mesh (ZERO compile passes), rebuild the lane pool with
    in-flight lanes evicted and front-requeued (no drop/dup/re-stream),
    and drop the collective control plane — the router keeps its
    counters and finished states, so accounting survives the failure.
    After this, the router behaves exactly like its single-process
    parent class.

    Default mesh: this rank's device with all its logical chips
    (:func:`local_fleet_mesh`). The reference falls back to one device
    once a collective has failed (its jax CPU client's fault, see the
    module docstring); the rank's CUDA work here never goes through
    the failed gloo plane, so it keeps every chip. The multi-app
    router's degrade (per-member resize) comes with ``deploy``."""
    if mesh is None:
        mesh = local_fleet_mesh(router.fleet.mesh)
    router.resize(mesh=mesh)
    router._local_stream = False
    router._spmd_lockstep = False
    router.step_when_idle = False


# ------------------------------------------------------------------- #
# the HA serving loop
# ------------------------------------------------------------------- #
class HAFleetServer:
    """Drive one host's router + source as a member of a fault-
    tolerant fleet.

    Works over both fleet shapes: a *federated* host (a plain
    ``FleetRouter`` over a one-process mesh — survives ANY peer's
    death, including rank 0's) and a *lockstep* host
    (``DistributedFleetRouter`` — a :class:`StepGuard` is attached so
    the control-plane collective itself detects peer death, and on
    :class:`MembershipChange` the router is degraded to local in
    place). Each loop tick: pump/admit from the bounded source,
    publish a heartbeat (beat counter, engine step, source snapshot,
    completed/rejected uid journal, live counters + raw latencies),
    poll the failure detector, then step/skip/stop. A declared death
    triggers the deterministic takeover assignment
    ``owner = alive[dead_rank % len(alive)]`` — every survivor
    computes the same owner from the same board — and the owner
    re-admits the dead rank's un-journaled items via
    ``source.requeue`` (front-of-queue, replayed from the pipeline)
    or journals them as rejected (``HAConfig.takeover``).

    ``stats_global()`` is the failover roll-up: assembled from the
    board by ANY surviving rank — no host-0 pinning, no collective —
    through the same :func:`repro_torch.fleet.router.assemble_stats` formula
    as the lockstep gather, so the two paths cannot drift."""

    def __init__(self, router, source, *, board: HeartbeatBoard,
                 rank: int, ranks: Sequence[int], pipeline=None,
                 key: Optional[str] = None,
                 config: Optional[HAConfig] = None,
                 detector: Optional[FailureDetector] = None):
        self.router = router
        self.source = source
        self.board = board
        self.rank = int(rank)
        self.pipeline = pipeline
        self.key = key
        self.config = config or HAConfig()
        self.detector = detector or FailureDetector(
            board, self.rank, ranks, self.config)
        self.absorbed: List[int] = []
        self.rejected_uids: List[int] = []
        self._beat_n = 0
        self._t_failure: Optional[float] = None
        self._t_done: Optional[float] = None
        self._items_at_failure = 0
        if hasattr(router, "attach_ha"):
            router.attach_ha(StepGuard(self.detector,
                                       publish=self.publish))

    # ---------------- heartbeat / journal --------------------------- #
    def publish(self, status: str = "serving") -> None:
        """One heartbeat: liveness (beat/step), the replayable source
        snapshot, the exactly-once journal (completed/rejected uids),
        and the live counters + raw latency vectors the board roll-up
        needs. Atomic on the board."""
        self._beat_n += 1
        r = self.router
        lat, wait = self._bounded_latencies()
        payload = {
            "rank": self.rank,
            "beat": self._beat_n,
            "step": r.steps,
            "status": status,
            "counts": [len(r.finished), r.items_emitted, r.steps,
                       r.rejected, r.slots],
            "wall_s": r._wall_s(),
            "lat": [float(v) for v in lat],
            "wait": [float(v) for v in wait],
            "completed": [st.request.uid for st in r.finished],
            "rejected_uids": list(self.rejected_uids),
            "absorbed": list(self.absorbed),
            "source": source_snapshot(self.source),
        }
        tel = _obs_current()
        if tel.metrics.enabled:
            # ride the heartbeat: a surviving rank can assemble the
            # fleet-wide registry view from the board alone (bounded —
            # histogram reservoirs cap the payload)
            payload["metrics"] = tel.metrics.snapshot()
        self.board.publish(self.rank, payload)

    def _bounded_latencies(self):
        """The router's bounded latency reservoirs when it keeps them
        (every repro_torch router does); raw extraction only for toy
        routers in the property tests."""
        arrays = getattr(self.router, "_latency_arrays", None)
        if arrays is not None:
            return arrays()
        return latency_arrays(self.router.finished)

    # ---------------- failure handling ------------------------------ #
    def _journaled_or_held_uids(self) -> Set[int]:
        """Uids that must NOT be replayed: every rank's journaled
        completed/rejected, plus everything this router already holds
        (finished, active, queued) and this source has staged."""
        r = self.router
        uids = {st.request.uid for st in r.finished}
        uids |= {st.request.uid for st in r.active.values()}
        for entry in r.queue:
            uids.add(entry.request.uid
                     if isinstance(entry, ItemRequestState)
                     else entry.uid)
        uids |= {req.uid for req in self.source.queue}
        uids |= set(self.rejected_uids)
        for peer in self.board.ranks():
            payload = self.board.read(peer)
            if payload is None or peer == self.rank:
                continue
            uids |= set(payload.get("completed", ()))
            uids |= set(payload.get("rejected_uids", ()))
        return uids

    def _on_failure(self, newly: Set[int]) -> None:
        tel = _obs_current()
        if newly and tel.active:
            # the membership change lands on the same timeline as the
            # engine steps that felt it
            tel.tracer.instant(
                "ha.membership_change", cat="ha",
                args={"rank": self.rank, "dead": sorted(newly),
                      "all_dead": sorted(self.detector.dead)})
            tel.metrics.counter("ha.membership_changes").inc(
                len(newly))
        if newly and self._t_failure is None:
            self._t_failure = time.perf_counter()
            self._items_at_failure = self.router.items_emitted
        if getattr(self.router, "_spmd_lockstep", False):
            degrade_to_local(self.router)
        # deterministic assignment over ALL dead ranks (revisited each
        # failure, so a cascade — the absorber itself dying — reassigns
        # its original AND taken-over feeds to the remaining survivors)
        alive = self.detector.alive
        exclude = self._journaled_or_held_uids()
        for dead_rank in sorted(self.detector.dead):
            if dead_rank in self.absorbed or \
                    alive[dead_rank % len(alive)] != self.rank:
                continue
            self.absorbed.append(dead_rank)
            if tel.active:
                tel.tracer.instant(
                    "ha.takeover", cat="ha",
                    args={"rank": self.rank, "dead_rank": dead_rank,
                          "mode": "replay" if self.pipeline is not None
                          and self.config.takeover != "reject"
                          else "reject"})
                tel.metrics.counter("ha.takeovers").inc()
            payload = self.board.read(dead_rank) or {}
            snap = payload.get("source")
            if snap is None:
                continue                # died before producing anything
            if self.pipeline is None or self.config.takeover == "reject":
                n = snap["n_requests"]
                n = int(snap["produced"]) if n is None else int(n)
                self.rejected_uids.extend(
                    snap["uid_base"] + k for k in range(n)
                    if snap["uid_base"] + k not in exclude)
                continue
            reqs = replay_requests(self.pipeline, snap, exclude=exclude)
            if self.key is not None:
                for req in reqs:
                    req.key = self.key
            self.source.requeue(reqs)

    # ---------------- the loop -------------------------------------- #
    def _peers_settled(self) -> bool:
        """True when every peer is done or dead — the federated stop
        condition (a survivor must keep serving the absorbed feed, and
        an idle host must outlive peers that may still fail)."""
        det = self.detector
        for peer in det.peers:
            if peer in det.dead or peer in det.done:
                continue
            det._refresh(peer)
            if peer not in det.done:
                return False
        return True

    def serve_tick(self) -> str:
        """One HA loop iteration; returns ``"step"``/``"skip"``/
        ``"stop"``. Split out from :meth:`serve` so the tier-1 suite
        can interleave multiple servers in one process and starve one
        of ticks to simulate its death deterministically."""
        self.source.pump()
        while True:
            req = self.source.peek()
            if req is None:
                break
            if self.key is not None and req.key is None:
                req.key = self.key
            if not self.router.submit(req):
                break
            self.source.take()
        try:
            newly = self.detector.poll()
            if newly:
                self._on_failure(newly)
            decision = self._decision()
            # status reflects drained-ness, not process exit: a host
            # that is idle-but-waiting publishes "done" so its settled
            # peers can stop (otherwise two drained hosts would wait on
            # each other forever), yet keeps ticking — a death can
            # revive it to "serving" with the absorbed feed
            self.publish(status="serving" if decision == "step"
                         else "done")
            if decision == "step":
                self.router.step()
        except MembershipChange as mc:
            self._on_failure(set(mc.dead))
            decision = "skip"
        return decision

    def _decision(self) -> str:
        more_local = bool(self.router.queue or self.router.active
                          or not self.source.exhausted)
        if getattr(self.router, "_spmd_lockstep", False):
            return "step" if self.router._any_across_hosts(more_local) \
                else "stop"
        if more_local:
            return "step"
        return "stop" if self._peers_settled() else "skip"

    def serve(self, max_ticks: int = 1_000_000) -> List:
        """Run the HA loop to completion: until this host's feed (plus
        anything absorbed) is drained AND every peer is done or dead.
        Publishes the final ``status: "done"`` journal — the moment
        this host's results count as delivered. Returns the finished
        states."""
        for _ in range(max_ticks):
            decision = self.serve_tick()
            if decision == "stop":
                break
            if decision == "skip":
                time.sleep(self.config.idle_sleep_s)
            elif self.config.step_sleep_s > 0:
                time.sleep(self.config.step_sleep_s)
        self._t_done = time.perf_counter()
        self.publish(status="done")
        return self.router.finished

    # ---------------- degraded-mode metrics ------------------------- #
    @property
    def degraded_items_per_second(self) -> float:
        """Throughput AFTER the first membership change (0.0 if none
        happened, or none has been served since)."""
        if self._t_failure is None:
            return 0.0
        t1 = self._t_done if self._t_done is not None \
            else time.perf_counter()
        span = t1 - self._t_failure
        items = self.router.items_emitted - self._items_at_failure
        return items / span if span > 0 else 0.0

    # ---------------- failover stats roll-up ------------------------ #
    def stats_global(self) -> RouterStats:
        """Fleet-wide roll-up assembled from the board by THIS rank —
        any surviving rank, no collectives, no host-0 pinning. My row
        comes from live state; each peer contributes its last
        published counters and raw latency vectors (for a dead peer:
        precisely the work it provably delivered). Exact when peers
        are done; a live peer's row is as fresh as its last beat."""
        r = self.router
        lat, wait = self._bounded_latencies()
        rows = [[len(r.finished), r.items_emitted, r.steps,
                 r.rejected, r.slots]]
        walls = [r._wall_s()]
        lats, waits = [np.asarray(lat, np.float64)], \
            [np.asarray(wait, np.float64)]
        for peer in self.board.ranks():
            if peer == self.rank:
                continue
            payload = self.board.read(peer)
            if payload is None or "counts" not in payload:
                continue
            rows.append([int(c) for c in payload["counts"]])
            walls.append(float(payload.get("wall_s", 0.0)))
            lats.append(np.asarray(payload.get("lat", ()), np.float64))
            waits.append(np.asarray(payload.get("wait", ()), np.float64))
        return assemble_stats(np.asarray(rows, np.int64),
                              np.asarray(walls),
                              np.concatenate(lats) if lats else [],
                              np.concatenate(waits) if waits else [])

    def metrics_global(self) -> dict:
        """Fleet-wide merge of the ``repro_torch.obs`` registry
        snapshots on the board (peers' last-published rows; for a dead
        peer, what it provably recorded) plus this rank's live registry
        — the no-collective twin of
        :meth:`repro_torch.fleet.DistributedFleetRouter.metrics_global`,
        callable by any surviving rank."""
        from repro_torch.obs import current, merge_snapshots

        snaps = [current().metrics.snapshot()]
        for peer in self.board.ranks():
            if peer == self.rank:
                continue
            payload = self.board.read(peer)
            if payload and payload.get("metrics"):
                snaps.append(payload["metrics"])
        return merge_snapshots(snaps)
