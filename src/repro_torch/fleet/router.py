"""Continuous-batching request router over a chip fleet.

Port of ``repro.fleet.router``. The fixed-slot
:class:`repro_torch.chip.ChipEngine` binds the generic slot-scheduled
streaming contract to ONE chip; the router binds it to a
:class:`repro_torch.fleet.ShardedChip`: ``lanes_per_chip × n_chips``
lanes, one batched fleet step per engine step, slot backfill between
steps (arriving requests drop into lanes the moment one frees, never
stalling resident streams), bounded-queue admission control for
upstream backpressure, and per-request latency accounting
(submit → admit → first item → done, in both seconds and engine steps).

``serve(source)`` is the closed loop the paper's I/O model assumes: a
sensor-stream frontend (:mod:`repro_torch.fleet.source`) pumps windowed
items under backpressure while the router streams the active set —
continuous traffic, not a pre-staged burst.

:class:`DistributedFleetRouter` is the multi-process shape of the same
contract, for a fleet whose mesh spans ranks
(:func:`repro_torch.launch.mesh.make_distributed_fleet_mesh`). Every
rank owns the lanes of ITS chips (``lanes_per_chip × n_local_chips``),
feeds them from its own (seed, step)-pure source, and streams its own
rows on its own device (``ShardedChip.stream_local``): request payloads
and results never leave the rank that owns them. The ranks keep in
lockstep over the gloo control plane only — every loop iteration
reduces the ranks' "anything left?" flags (:func:`any_across_hosts`),
so every rank runs the same number of engine steps and stops on the
same iteration, idle steps included (``step_when_idle``).
``stats_global()`` gathers every rank's counters and raw latencies and
returns the exact fleet-wide :class:`RouterStats` on every rank.
Gloo carries int64 and float64 natively, so counters and latencies
cross ranks unsplit and unrounded (the reference splits counters into
int32 halves and sends latencies as float32: jax's x32 CPU client).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import allgather, process_count, process_index
from repro_torch.serving.engine import (ItemRequest, ItemRequestState,
                                        ItemStreamScheduler)

# the fleet speaks the same request language as the chip engine
FleetRequest = ItemRequest


@dataclasses.dataclass(frozen=True)
class RouterStats:
    """Roll-up of one router run (latencies over finished requests)."""
    requests: int
    items: int
    steps: int
    wall_s: float
    items_per_second: float
    occupancy: float                    # items / (steps × lanes)
    wait_s_mean: float                  # submit → lane admission
    latency_s_mean: float               # submit → last item
    latency_s_p50: float
    latency_s_p95: float
    rejected: int                       # submits refused (queue full)
    lanes: int = 0                      # slots behind these numbers

    def __str__(self) -> str:
        return (f"RouterStats[{self.requests} req / {self.items} items "
                f"in {self.steps} steps, {self.wall_s * 1e3:.1f} ms: "
                f"{self.items_per_second:.0f} items/s, occupancy "
                f"{self.occupancy:.0%}, latency p50 "
                f"{self.latency_s_p50 * 1e3:.1f} ms / p95 "
                f"{self.latency_s_p95 * 1e3:.1f} ms]")


def latency_arrays(finished):
    """Per-request (latency, wait) vectors over finished states — the
    one place the extraction idiom lives (stats, merges, gathers)."""
    lat = np.asarray([st.latency_s for st in finished]) \
        if finished else np.zeros((0,))
    wait = np.asarray([st.wait_s for st in finished]) \
        if finished else np.zeros((0,))
    return lat, wait


def stats_from_states(finished, *, items: int, steps: int, wall_s: float,
                      lanes: int, rejected: int,
                      lat_res=None, wait_res=None) -> RouterStats:
    """Assemble one :class:`RouterStats` from finished request states
    plus the engine counters — the one formula behind the single-app
    router, the multi-app router's per-tenant rows and its fleet
    roll-up (so per-app and fleet numbers can never drift apart).

    ``lat_res``/``wait_res`` (``repro_torch.obs.Reservoir``) are the bounded
    accounting the keyed scheduler maintains per finish: means come
    from the reservoir's exact count/sum, percentiles from its
    retained samples — identical to the raw per-state lists for runs
    up to the reservoir size, bounded-memory after. Without them the
    historic extract-from-states path runs (exact, unbounded)."""
    if lat_res is not None and wait_res is not None:
        lat = lat_res.values
        return RouterStats(
            requests=len(finished),
            items=items,
            steps=steps,
            wall_s=wall_s,
            items_per_second=items / wall_s if wall_s else 0.0,
            occupancy=items / max(steps * lanes, 1),
            wait_s_mean=wait_res.mean,
            latency_s_mean=lat_res.mean,
            latency_s_p50=float(np.percentile(lat, 50))
            if lat.size else 0.0,
            latency_s_p95=float(np.percentile(lat, 95))
            if lat.size else 0.0,
            rejected=rejected,
            lanes=lanes,
        )
    lat, wait = latency_arrays(finished)
    return RouterStats(
        requests=len(finished),
        items=items,
        steps=steps,
        wall_s=wall_s,
        items_per_second=items / wall_s if wall_s else 0.0,
        occupancy=items / max(steps * lanes, 1),
        wait_s_mean=float(wait.mean()) if wait.size else 0.0,
        latency_s_mean=float(lat.mean()) if lat.size else 0.0,
        latency_s_p50=float(np.percentile(lat, 50)) if lat.size else 0.0,
        latency_s_p95=float(np.percentile(lat, 95)) if lat.size else 0.0,
        rejected=rejected,
        lanes=lanes,
    )


def merge_stats(stats: Sequence[RouterStats]) -> RouterStats:
    """Pure (no-communication) roll-up of per-host RouterStats.

    Counters (requests, items, rejected) add exactly; lanes add (the
    fleet's lanes are the hosts' disjoint lanes); steps and wall take
    the max (lockstep hosts step together, stragglers dominate wall);
    throughput is total items over the longest wall; occupancy is
    recomputed from the summed per-host lane-step products; latency
    means are request-weighted. Percentiles CANNOT be merged from
    percentiles — here they take the max across hosts (a conservative
    upper bound, exact when one host dominates). When the raw
    latencies are reachable, prefer
    :meth:`DistributedFleetRouter.stats_global`, which gathers them
    and is exact.
    """
    if not stats:
        return RouterStats(0, 0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                           0, 0)
    requests = sum(s.requests for s in stats)
    items = sum(s.items for s in stats)
    wall = max(s.wall_s for s in stats)
    lane_steps = sum(s.steps * s.lanes for s in stats)
    w = [s.requests for s in stats]
    wsum = sum(w) or 1
    return RouterStats(
        requests=requests,
        items=items,
        steps=max(s.steps for s in stats),
        wall_s=wall,
        items_per_second=items / wall if wall else 0.0,
        occupancy=items / lane_steps if lane_steps else 0.0,
        wait_s_mean=sum(s.wait_s_mean * n
                        for s, n in zip(stats, w)) / wsum,
        latency_s_mean=sum(s.latency_s_mean * n
                           for s, n in zip(stats, w)) / wsum,
        latency_s_p50=max(s.latency_s_p50 for s in stats),
        latency_s_p95=max(s.latency_s_p95 for s in stats),
        rejected=sum(s.rejected for s in stats),
        lanes=sum(s.lanes for s in stats),
    )


class TimedStepMixin:
    """Wall-clock stamping shared by every router engine (single-app
    and multi-app): the first step starts the clock, every step moves
    the last-step stamp, ``_wall_s`` is the span the throughput and
    occupancy numbers divide by.

    Also the attachment point for high-availability instrumentation
    (:mod:`repro_torch.fleet.ha`): with a guard attached, every engine
    step is wrapped by :meth:`StepGuard.run_step` — a heartbeat
    published BEFORE entering the step, a step-deadline check of the
    peers, and translation of a failed collective into
    :class:`repro_torch.fleet.ha.MembershipChange` after the detector's
    bounded retry/backoff confirms who died.
    """

    _t_start: Optional[float] = None
    _t_last: float = 0.0
    _ha_guard = None
    _step_listeners: tuple = ()

    def attach_ha(self, guard) -> None:
        """Attach a :class:`repro_torch.fleet.ha.StepGuard` (heartbeat +
        step-deadline failure detection around every engine step)."""
        self._ha_guard = guard

    def add_step_listener(self, fn) -> None:
        """Register ``fn(router)`` to run after every completed engine
        step — the observability hook ``repro_torch.variability`` uses
        for canary scoring and closed-loop recalibration. Listeners run on
        the engine thread between steps (the only point where a live
        reprogram is safe) and their exceptions propagate: a failing
        monitor is a serving failure, not a silent skip."""
        self._step_listeners = (*self._step_listeners, fn)

    def step(self) -> int:
        if self._t_start is None:
            self._t_start = time.perf_counter()
        step_fn = super().step
        emitted = step_fn() if self._ha_guard is None \
            else self._ha_guard.run_step(step_fn)
        self._t_last = time.perf_counter()
        for fn in self._step_listeners:
            fn(self)
        return emitted

    def _wall_s(self) -> float:
        return (self._t_last - self._t_start) \
            if self._t_start is not None else 0.0


def stream_member(member, batch: np.ndarray, *,
                  use_kernel: bool = True,
                  local: bool = False) -> np.ndarray:
    """Host-side dispatch to a fleet member's preferred stream verb:
    ``stream_local`` on a mesh that spans ranks (each rank's own rows),
    else the host-to-host ``stream_host`` when the payload offers one,
    else plain ``stream`` (a tensor on the card is read back to the
    host)."""
    if local:
        return member.stream_local(batch, use_kernel=use_kernel)
    host = getattr(member, "stream_host", None)
    if host is not None:
        return host(batch, use_kernel=use_kernel)
    out = member.stream(batch, use_kernel=use_kernel)
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


class LockstepDrainMixin:
    """Drain loop for SPMD routers: the local "anything left?" test is
    replaced by an all-ranks OR so every rank executes the same number
    of steps and breaks on the same iteration.

    ``_spmd_lockstep`` is the degraded-mode switch: after a membership
    change (:func:`repro_torch.fleet.ha.degrade_to_local` flips it False
    on the instance) the surviving rank can no longer join collectives
    with the dead peers, so every cross-rank reduction falls back to
    its local value and the router behaves like its single-process
    parent — same lanes, same counters, same accounting.
    """

    _spmd_lockstep = True

    def _any_across_hosts(self, flag: bool) -> bool:
        if not self._spmd_lockstep:
            return bool(flag)
        guard = getattr(self, "_ha_guard", None)
        if guard is not None:
            return guard.call(any_across_hosts, flag)
        return any_across_hosts(flag)

    def run_until_drained(self, max_steps: int = 10_000) -> List:
        steps = 0
        while steps < max_steps:
            if not self._any_across_hosts(
                    bool(self.queue or self.active)):
                break
            self.step()
            steps += 1
        return self.finished


class FleetRouter(TimedStepMixin, ItemStreamScheduler):
    """StreamingEngine over a :class:`repro_torch.fleet.ShardedChip` (or
    any payload with ``.stream(batch)`` and ``.d_in`` — a bare
    ``CompiledChip`` is a 1-chip fleet). Streams through the chip's
    kernels by default (``use_kernel``), as the chip engine does."""

    def __init__(self, fleet, *, lanes_per_chip: int = 4,
                 use_kernel: bool = True,
                 queue_limit: Optional[int] = None,
                 step_when_idle: bool = False,
                 latency_reservoir: int = 4096):
        # a bare CompiledChip compiled without weights has plan=None
        # (ShardedChip already rejects those at shard time)
        if getattr(fleet, "plan", 1) is None:
            raise ValueError("FleetRouter needs a streamable chip "
                             "(compiled with weights); this one is "
                             "analytic-only")
        if getattr(fleet, "is_distributed", False) and \
                not isinstance(self, DistributedFleetRouter):
            raise ValueError(
                "this fleet's mesh spans processes; one rank cannot "
                "route for chips it does not drive — use "
                "DistributedFleetRouter (every rank runs one, in "
                "lockstep, over its local lanes)")
        n_chips = getattr(fleet, "n_chips", 1)
        super().__init__(fleet.d_in if hasattr(fleet, "d_in")
                         else fleet.dims[0],
                         slots=lanes_per_chip * self._lane_chips(fleet),
                         queue_limit=queue_limit,
                         step_when_idle=step_when_idle,
                         latency_reservoir=latency_reservoir)
        self.fleet = fleet
        self.n_chips = n_chips
        self.lanes_per_chip = lanes_per_chip
        self.use_kernel = use_kernel

    @staticmethod
    def _lane_chips(fleet) -> int:
        """How many chips this router schedules lanes for — all of
        them here; only the local ones in the distributed variant."""
        return getattr(fleet, "n_chips", 1)

    # ---------------- payload ------------------------------------- #
    # True on the SPMD variant (each rank streams its local rows);
    # degraded mode flips it back off on the instance
    _local_stream = False

    def _stream_batch(self, batch: np.ndarray) -> np.ndarray:
        return stream_member(self.fleet, batch, use_kernel=self.use_kernel,
                             local=self._local_stream)

    # ---------------- elastic resize ------------------------------- #
    @property
    def mesh(self):
        """The ``"chip"`` mesh the fleet serves on."""
        return self.fleet.mesh

    def resize(self, n_chips: Optional[int] = None, *, mesh=None) -> None:
        """Live fleet resize (grow OR shrink) under traffic: resize the
        payload (``ShardedChip.resize`` — zero compile passes; ``mesh``
        rebuilds it on another mesh, as a survivor does after a
        membership change), then rebuild this router's lane pool to
        ``lanes_per_chip × chips``, evicting and front-requeueing the
        in-flight lanes so nothing is dropped, duplicated or
        re-streamed. Payloads without a ``resize`` method (a toy fleet
        in the property tests) just have ``n_chips`` reassigned."""
        fleet_resize = getattr(self.fleet, "resize", None)
        if fleet_resize is not None:
            fleet_resize(n_chips, mesh=mesh)
        elif n_chips is not None and hasattr(self.fleet, "n_chips"):
            self.fleet.n_chips = n_chips
        else:
            raise ValueError(
                f"resize: {type(self.fleet).__name__} has no resize() "
                "and no n_chips to reassign")
        self.n_chips = getattr(self.fleet, "n_chips", n_chips)
        self.resize_slots(self.lanes_per_chip * self._lane_chips(self.fleet))

    # ---------------- the closed serving loop ---------------------- #
    def serve(self, source, *,
              max_steps: int = 100_000) -> List[ItemRequestState]:
        """Drain a bounded source end-to-end under backpressure.

        Each iteration: let the source produce into its bounded queue
        (it stops when full — backpressure), admit as many waiting
        requests as this router's admission queue accepts (a rejected
        request stays queued at the source, un-dropped), then run one
        batched fleet step — or stop/skip, per :meth:`_serve_decision`.
        Returns the finished states.

        ``max_steps`` bounds loop ITERATIONS, not just engine steps, so
        the loop terminates even if admission never makes progress.
        """
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError(
                f"{type(self).__name__}.serve() needs queue_limit >= "
                "1: a zero-capacity admission queue can never admit a "
                "request, so the serve loop could not make progress")
        for _ in range(max_steps):
            source.pump()
            while True:
                req = source.peek()
                if req is None or not self.submit(req):
                    break
                source.take()
            decision = self._serve_decision(source)
            if decision == "stop":
                break
            if decision == "step":
                self.step()
        return self.finished

    def _serve_decision(self, source) -> str:
        """After pump+admit: ``"step"`` to run one engine step,
        ``"skip"`` to loop again without stepping, ``"stop"`` to end
        the serve loop."""
        if self.queue or self.active:
            return "step"
        if source.exhausted:
            return "stop"
        source.pump()
        if source.peek() is None:
            return "stop"               # source dry and nothing queued
        return "skip"

    # ---------------- observability -------------------------------- #
    def _obs_tags(self):
        return {"router": type(self).__name__, "chips": self.n_chips,
                "lanes": self.slots}

    # ---------------- accounting ----------------------------------- #
    def _latency_arrays(self):
        """Bounded per-request (latency, wait) vectors — the
        scheduler's finish-time reservoirs, NOT re-extracted from the
        unbounded finished-state list (exact for runs up to the
        reservoir size; what the cross-rank gathers and the HA board
        publish, so their wire/board size is bounded too)."""
        return self._lat_all.values, self._wait_all.values

    def stats(self) -> RouterStats:
        return stats_from_states(self.finished,
                                 items=self.items_emitted,
                                 steps=self.steps,
                                 wall_s=self._wall_s(),
                                 lanes=self.slots,
                                 rejected=self.rejected,
                                 lat_res=self._lat_all,
                                 wait_res=self._wait_all)


class DistributedFleetRouter(LockstepDrainMixin, FleetRouter):
    """The router's SPMD shape for a fleet whose mesh spans ranks.

    EVERY rank of the process group constructs one of these over its
    :class:`ShardedChip` (same chip, same mesh) and drives it with the
    same call sequence. Each rank schedules only its local chips'
    lanes, feeds them from its own source and streams them on its own
    device; request payloads and results never leave the rank that
    owns them. The cross-rank surface is the control plane only: the
    lockstep reduction (:meth:`_any_across_hosts`) and the stat gathers
    (:meth:`stats_global`, :meth:`metrics_global`), on gloo.

    Lockstep obligations the base class cannot see are handled here:
    ``step_when_idle`` is forced on (an idle rank steps as the busy ones
    do, so every rank counts the same steps), and the drain/serve loops
    replace their local "anything left?" tests with an all-ranks
    reduction so every rank breaks on the same iteration.
    """

    def __init__(self, fleet, *, lanes_per_chip: int = 4,
                 use_kernel: bool = True,
                 queue_limit: Optional[int] = None,
                 step_when_idle: bool = True):
        if not getattr(fleet, "is_distributed", False):
            raise ValueError(
                "DistributedFleetRouter needs a fleet whose mesh "
                "spans processes (make_distributed_fleet_mesh in a "
                "process group); on one process use FleetRouter")
        # accepted (ShardedChip.serve forwards router kwargs blindly)
        # but not optional: a rank skipping its idle steps would fall
        # out of step with the ranks that still have traffic
        if not step_when_idle:
            raise ValueError(
                "DistributedFleetRouter always steps when idle: the "
                "ranks step in lockstep, and a locally idle rank that "
                "skipped its steps would fall out of step with the "
                "ranks that still have traffic")
        super().__init__(fleet, lanes_per_chip=lanes_per_chip,
                         use_kernel=use_kernel, queue_limit=queue_limit,
                         step_when_idle=True)

    @staticmethod
    def _lane_chips(fleet) -> int:
        return fleet.n_local_chips

    # ---------------- payload ------------------------------------- #
    # (local slots, d_in) → (local slots, d_out): each rank streams its
    # lanes' rows on its own device
    _local_stream = True

    # ---------------- lockstep control plane ----------------------- #
    def _serve_decision(self, source) -> str:
        """The fleet-wide continue/stop decision: the serve loop runs
        until NO rank has queued, active, or un-pumped traffic, so a
        rank that drained early keeps stepping with the busy ranks.
        Lockstep holds because every rank reduces the same flags on the
        same iteration — there is no local "skip" path. Degraded mode
        (``_spmd_lockstep`` off) falls back to the single-process
        decision."""
        if not self._spmd_lockstep:
            return FleetRouter._serve_decision(self, source)
        more = bool(self.queue or self.active or
                    not source.exhausted)
        return "step" if self._any_across_hosts(more) else "stop"

    # ---------------- fleet-wide accounting ------------------------ #
    def stats_global(self) -> RouterStats:
        """The exact fleet-wide roll-up, assembled on every rank (ranks
        get identical results; any rank can report — there is no
        rank-0 pinning). Counters are allgathered; per-request
        latency/wait vectors are padded to the fleet-wide max length
        and allgathered too, so the percentiles are computed over every
        finished request in the fleet — not merged from per-rank
        percentiles. Collective: every rank must call together. In
        degraded mode (after a membership change) the dead peers cannot
        join a collective, so this returns the LOCAL stats — the
        fleet-wide roll-up across survivors is then the heartbeat-board
        one (:meth:`repro_torch.fleet.ha.HAFleetServer.stats_global`)."""
        if not self._spmd_lockstep or process_count() == 1:
            return self.stats()
        lat, wait = self._latency_arrays()
        return gather_global_stats(
            lat, wait, requests=len(self.finished),
            items=self.items_emitted, steps=self.steps,
            rejected=self.rejected, lanes=self.slots,
            wall_s=self._wall_s())

    def _obs_tags(self):
        tags = FleetRouter._obs_tags(self)
        tags["host"] = process_index()
        return tags

    def metrics_global(self) -> dict:
        """Fleet-wide merge of every rank's ``repro_torch.obs`` registry
        snapshot (collective while in lockstep — every rank must call
        together and every rank gets the same merged view; degraded
        mode falls back to the local snapshot)."""
        from repro_torch.obs import allgather_snapshots, current, \
            merge_snapshots

        snap = current().metrics.snapshot()
        if not self._spmd_lockstep or process_count() == 1:
            return snap
        return merge_snapshots(allgather_snapshots(snap))


# ------------------------------------------------------------------- #
# cross-rank primitives (gloo, CPU tensors: the control plane)
# ------------------------------------------------------------------- #
def any_across_hosts(flag: bool) -> bool:
    """OR-reduce a python bool over all ranks (one tiny gloo allgather;
    every rank must call this together)."""
    if process_count() == 1:
        return bool(flag)
    flags = allgather(torch.tensor([1 if flag else 0], dtype=torch.int32))
    return bool(flags.sum() > 0)


def allgather_i64(counts: np.ndarray) -> np.ndarray:
    """Allgather a (n,) int64 counter vector → (ranks, n). Gloo
    carries int64 as it is, so every int64 count crosses exactly
    (the reference's int32 halves are exact below 2⁶², the same
    values)."""
    counts = torch.from_numpy(np.ascontiguousarray(counts, np.int64))
    return allgather(counts).numpy()


def allgather_latencies(lat: np.ndarray, wait: np.ndarray,
                        n_max: int):
    """Allgather per-request latency/wait vectors, NaN-padded to the
    fleet-wide max length ``n_max`` (float64 on the wire: no rounding).
    Returns the concatenated fleet-wide (lat, wait), rank-major, with
    the padding stripped."""
    if not n_max:
        return np.zeros((0,)), np.zeros((0,))
    pad = np.full((2, n_max), np.nan, np.float64)
    pad[0, :lat.size] = lat
    pad[1, :wait.size] = wait
    gathered = allgather(torch.from_numpy(pad)).numpy()
    lat_all = gathered[:, 0, :].ravel()
    wait_all = gathered[:, 1, :].ravel()
    return lat_all[~np.isnan(lat_all)], wait_all[~np.isnan(wait_all)]


def assemble_stats(counts_all: np.ndarray, walls_all: np.ndarray,
                   lat_all: np.ndarray,
                   wait_all: np.ndarray) -> RouterStats:
    """The exact fleet-wide roll-up FORMULA, independent of how the
    per-rank rows got here: ``counts_all`` is a (ranks, 5) int array
    of (requests, items, steps, rejected, lanes) rows, ``walls_all``
    the per-rank wall clocks, ``lat_all``/``wait_all`` the
    concatenated per-request vectors. Shared by the collective
    :func:`gather_global_stats` and the heartbeat-board roll-up
    (:mod:`repro_torch.fleet.ha`), so lockstep and degraded-mode
    accounting can never drift apart."""
    counts_all = np.asarray(counts_all, np.int64).reshape(-1, 5)
    total_items = int(counts_all[:, 1].sum())
    lane_steps = int((counts_all[:, 2] * counts_all[:, 4]).sum())
    wall = float(np.asarray(walls_all).max()) if np.size(walls_all) \
        else 0.0
    lat_all = np.asarray(lat_all, np.float64).ravel()
    wait_all = np.asarray(wait_all, np.float64).ravel()
    return RouterStats(
        requests=int(counts_all[:, 0].sum()),
        items=total_items,
        steps=int(counts_all[:, 2].max()) if counts_all.size else 0,
        wall_s=wall,
        items_per_second=total_items / wall if wall else 0.0,
        occupancy=total_items / lane_steps if lane_steps else 0.0,
        wait_s_mean=float(wait_all.mean()) if wait_all.size else 0.0,
        latency_s_mean=float(lat_all.mean()) if lat_all.size else 0.0,
        latency_s_p50=float(np.percentile(lat_all, 50))
        if lat_all.size else 0.0,
        latency_s_p95=float(np.percentile(lat_all, 95))
        if lat_all.size else 0.0,
        rejected=int(counts_all[:, 3].sum()),
        lanes=int(counts_all[:, 4].sum()),
    )


def gather_global_stats(lat: np.ndarray, wait: np.ndarray, *,
                        requests: int, items: int, steps: int,
                        rejected: int, lanes: int,
                        wall_s: float) -> RouterStats:
    """Assemble the exact cross-rank :class:`RouterStats` from this
    rank's numbers (collective: every rank must call together)."""
    counts_all = allgather_i64(np.asarray(
        [requests, items, steps, rejected, lanes], np.int64))
    walls_all = allgather(torch.tensor([float(wall_s)],
                                       dtype=torch.float64)).numpy()
    # pad to the fleet-wide max VECTOR length, not the max request
    # count: the vectors are bounded reservoirs (repro_torch.obs), so
    # the wire size stays bounded however long the serve ran
    sizes_all = allgather_i64(np.asarray([lat.size, wait.size], np.int64))
    lat_all, wait_all = allgather_latencies(np.asarray(lat, np.float64),
                                            np.asarray(wait, np.float64),
                                            int(sizes_all.max()))
    return assemble_stats(counts_all, walls_all, lat_all, wait_all)
