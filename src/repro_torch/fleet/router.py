"""Continuous-batching request router over a chip fleet.

Port of the single-process half of ``repro.fleet.router``. The
fixed-slot :class:`repro_torch.chip.ChipEngine` binds the generic
slot-scheduled streaming contract to ONE chip; the router binds it to a
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

The multi-process router (``DistributedFleetRouter``, its lockstep
drain and the cross-host stat gathers) is not ported yet (ROADMAP.md,
Queue 1 item 6b).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

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
    upper bound, exact when one host dominates).
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

    Also the attachment point for high-availability instrumentation:
    with a guard attached (:meth:`attach_ha`), every engine step is
    wrapped by the guard's ``run_step``. The guards (``fleet/ha.py``)
    are not ported yet, so nothing attaches one here.
    """

    _t_start: Optional[float] = None
    _t_last: float = 0.0
    _ha_guard = None
    _step_listeners: tuple = ()

    def attach_ha(self, guard) -> None:
        """Attach a step guard (heartbeat + step-deadline failure
        detection around every engine step): any object whose
        ``run_step(step_fn)`` runs the step and returns its result."""
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
                  use_kernel: bool = True) -> np.ndarray:
    """Host-side dispatch to a fleet member's preferred stream verb:
    the host-to-host ``stream_host`` when the payload offers one, else
    plain ``stream`` (a tensor on the card is read back to the host)."""
    host = getattr(member, "stream_host", None)
    if host is not None:
        return host(batch, use_kernel=use_kernel)
    out = member.stream(batch, use_kernel=use_kernel)
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


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
        n_chips = getattr(fleet, "n_chips", 1)
        super().__init__(fleet.d_in if hasattr(fleet, "d_in")
                         else fleet.dims[0],
                         slots=lanes_per_chip * n_chips,
                         queue_limit=queue_limit,
                         step_when_idle=step_when_idle,
                         latency_reservoir=latency_reservoir)
        self.fleet = fleet
        self.n_chips = n_chips
        self.lanes_per_chip = lanes_per_chip
        self.use_kernel = use_kernel

    # ---------------- payload ------------------------------------- #
    def _stream_batch(self, batch: np.ndarray) -> np.ndarray:
        return stream_member(self.fleet, batch, use_kernel=self.use_kernel)

    # ---------------- elastic resize ------------------------------- #
    def resize(self, n_chips: Optional[int] = None) -> None:
        """Live fleet resize (grow OR shrink) under traffic: resize the
        payload (``ShardedChip.resize`` — zero compile passes), then
        rebuild this router's lane pool to ``lanes_per_chip × chips``,
        evicting and front-requeueing the in-flight lanes so nothing is
        dropped, duplicated or re-streamed. Payloads without a
        ``resize`` method (a toy fleet in the property tests) just have
        ``n_chips`` reassigned."""
        fleet_resize = getattr(self.fleet, "resize", None)
        if fleet_resize is not None:
            fleet_resize(n_chips)
        elif n_chips is not None and hasattr(self.fleet, "n_chips"):
            self.fleet.n_chips = n_chips
        else:
            raise ValueError(
                f"resize: {type(self.fleet).__name__} has no resize() "
                "and no n_chips to reassign")
        self.n_chips = getattr(self.fleet, "n_chips", n_chips)
        self.resize_slots(self.lanes_per_chip * self.n_chips)

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
    def stats(self) -> RouterStats:
        return stats_from_states(self.finished,
                                 items=self.items_emitted,
                                 steps=self.steps,
                                 wall_s=self._wall_s(),
                                 lanes=self.slots,
                                 rejected=self.rejected,
                                 lat_res=self._lat_all,
                                 wait_res=self._wait_all)
