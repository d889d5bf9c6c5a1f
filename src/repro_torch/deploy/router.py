"""The multi-app continuous-batching router.

Port of ``repro.deploy.router``. This is
:class:`repro_torch.fleet.FleetRouter`'s single ``_stream_batch``
generalized to co-resident tenants: every app owns a block of lanes
(tagged by app name), and each engine step dispatches each app's
``(lanes_app, d_in_app)`` batch to THAT app's programmed plan through
its :class:`repro_torch.fleet.ShardedChip` member
(:func:`repro_torch.fleet.router.stream_member`) — one batched stream
call per app per engine step runs the whole multi-tenant fleet with no
re-programming traffic. Every member streams on the one device its
chips were programmed on.

:class:`DistributedMultiAppRouter` is the shape for a deployment whose
mesh spans ranks, as :class:`repro_torch.fleet.DistributedFleetRouter`
is for one app: every rank routes its own chips' lanes for EVERY app
and streams its own rows on its own device (``stream_local``). Only
the control plane crosses ranks, on gloo — the lockstep "anything
left?" reduction and the stat and registry gathers — so the per-step
dispatch schedule is pinned (every app, declaration order, idle or
not) and every rank runs the same steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.fleet.router import (LockstepDrainMixin, RouterStats,
                                      TimedStepMixin, gather_global_stats,
                                      stats_from_states, stream_member)
from repro_torch.launch.mesh import process_count, process_index
from repro_torch.serving.engine import (ItemRequest,
                                        KeyedItemStreamScheduler,
                                        StreamSpec)


@dataclasses.dataclass(frozen=True)
class DeploymentStats:
    """Per-app rows plus the fleet-wide roll-up, from the same engine
    counters — the per-app requests/items/rejected/lanes sum EXACTLY
    to the fleet row by construction.

    ``variability`` (set by ``Deployment.stats`` when accuracy
    monitors / recalibrators are attached) carries the per-app canary
    accuracy series and recalibration events."""
    apps: Dict[str, RouterStats]
    fleet: RouterStats
    variability: Optional[Dict[str, Any]] = None

    def __str__(self) -> str:
        lines = [f"  {name:>12s}: {stats}"
                 for name, stats in self.apps.items()]
        for name, entry in (self.variability or {}).items():
            monitor = entry.get("monitor") or {}
            recal = entry.get("recalibration") or {}
            lines.append(
                f"  {name:>12s}: canary_acc="
                f"{monitor.get('latest_accuracy')} "
                f"recals={recal.get('recals', 0)}")
        return "\n".join([f"DeploymentStats[fleet: {self.fleet}]"]
                         + lines)


class MultiAppRouter(TimedStepMixin, KeyedItemStreamScheduler):
    """Keyed streaming engine over ``{app: member}`` fleet members
    (each member: a :class:`repro_torch.fleet.ShardedChip`, or anything
    with ``stream_host(batch)``/``d_in``).

    ``lanes``/``queue_limits`` are per-app budgets. Requests must carry
    ``key=app_name`` (:meth:`submit_app` stamps it). ``use_kernel``
    (the default) streams through the chips' kernels.
    """

    def __init__(self, members: Mapping[str, Any], *,
                 lanes: Mapping[str, int],
                 queue_limits: Optional[Mapping[str, Optional[int]]] = None,
                 use_kernel: bool = True,
                 step_when_idle: bool = False):
        if not members:
            raise ValueError("MultiAppRouter needs at least one member")
        queue_limits = queue_limits or {}
        streams = {}
        for name, member in members.items():
            chip = getattr(member, "chip", member)
            if getattr(chip, "plan", 1) is None:
                raise ValueError(
                    f"app {name!r} is analytic-only (compiled without "
                    "weights): report() works, but it cannot join a "
                    "streaming router")
            streams[name] = StreamSpec(member.d_in, lanes[name],
                                       queue_limits.get(name))
        super().__init__(streams, step_when_idle=step_when_idle)
        self.members = dict(members)
        self.use_kernel = use_kernel
        self._uid = 0

    # ---------------- payload ------------------------------------- #
    _local_stream = False        # distributed variant flips this

    def _stream_batch_key(self, key, batch: np.ndarray) -> np.ndarray:
        return stream_member(self.members[key], batch,
                             use_kernel=self.use_kernel,
                             local=self._local_stream)

    # ---------------- member lane-lifecycle hooks ------------------- #
    # Members that bind per-lane device state to the lane lifecycle
    # expose ``on_admit(lane, state)`` / ``on_release(lane)``; lanes
    # are member-relative (slot minus the app's block base). Sensor
    # members expose neither and pay one getattr per lifecycle event.
    def _notify_admit(self, slot: int, st) -> None:
        key = self._slot_key[slot]
        hook = getattr(self.members[key], "on_admit", None)
        if hook is not None:
            hook(slot - self._base[key], st)

    def _begin(self, req, slot):
        st = super()._begin(req, slot)
        self._notify_admit(slot, st)
        return st

    def _resume(self, st, slot):
        st = super()._resume(st, slot)
        self._notify_admit(slot, st)
        return st

    def _release(self, st) -> None:
        key = self._slot_key[st.slot]
        hook = getattr(self.members[key], "on_release", None)
        if hook is not None:
            hook(st.slot - self._base[key])
        super()._release(st)

    # ---------------- submission ----------------------------------- #
    def submit_app(self, app: str, items) -> Optional[ItemRequest]:
        """Wrap ``items`` into a request tagged for ``app`` and submit
        it; returns the request, or None if the app's admission queue
        refused it (backpressure). A pre-built :class:`ItemRequest` is
        submitted as-is, with its uid/key stamped here."""
        if app not in self.members:
            raise ValueError(f"unknown app {app!r} (deployed: "
                             f"{sorted(self.members)})")
        if isinstance(items, ItemRequest):
            req = items
            req.uid, req.key = self._uid, app
        else:
            req = ItemRequest(uid=self._uid, items=items, key=app)
        self._uid += 1
        return req if self.submit(req) else None

    # ---------------- the closed serving loop ---------------------- #
    def serve(self, sources: Mapping[str, Any], *,
              max_steps: int = 100_000) -> List:
        """Drain one bounded source per app under backpressure — the
        multi-tenant shape of :meth:`repro_torch.fleet.FleetRouter.serve`:
        pump every source, admit as much as each app's admission queue
        accepts (rejected requests stay queued at their source), run
        one keyed engine step; stop when nothing is queued, active or
        un-pumped anywhere. Returns the finished states (all apps; each
        state's ``request.key`` says whose)."""
        unknown = set(sources) - set(self.members)
        if unknown:
            raise ValueError(f"serve: sources for unknown apps "
                             f"{sorted(unknown)}")
        for name in sources:
            limit = self._streams[name].queue_limit
            if limit is not None and limit < 1:
                raise ValueError(
                    f"serve: app {name!r} has queue_limit 0 — a "
                    "zero-capacity admission queue can never admit a "
                    "request, so the serve loop could not make "
                    "progress")
        for _ in range(max_steps):
            for name, src in sources.items():
                src.pump()
                while True:
                    req = src.peek()
                    if req is None:
                        break
                    if req.key is None:
                        req.key = name
                    elif req.key != name:
                        raise ValueError(
                            f"serve: source for app {name!r} produced "
                            f"a request tagged {req.key!r}")
                    if not self.submit(req):
                        break
                    src.take()
            decision = self._serve_decision(sources)
            if decision == "stop":
                break
            if decision == "step":
                self.step()
        return self.finished

    def _serve_decision(self, sources) -> str:
        if self.queue or self.active:
            return "step"
        if all(src.exhausted for src in sources.values()):
            return "stop"
        for src in sources.values():
            src.pump()
        if all(src.peek() is None for src in sources.values()):
            return "stop"               # sources dry, nothing queued
        return "skip"

    # ---------------- elastic resize ------------------------------- #
    @property
    def mesh(self):
        """The ``"chip"`` mesh the tenants serve on (the first
        member's: a heterogeneous fleet gives each system its own
        submesh of the one device)."""
        return next(iter(self.members.values())).mesh

    def resize(self, n_chips: Optional[int] = None, *, mesh=None,
               lanes: Optional[Mapping[str, int]] = None) -> None:
        """Live fleet resize under traffic, as
        :meth:`repro_torch.fleet.FleetRouter.resize`: every member's
        programmed plan is served on ``n_chips`` chips or on ``mesh``
        (``ShardedChip.resize`` — zero compile passes), then the per-app
        lane blocks are rebuilt (:meth:`resize_lanes`; ``lanes``,
        default each app's current budget)."""
        for member in self.members.values():
            member.resize(n_chips, mesh=mesh)
        self.resize_lanes(lanes or {})

    def resize_lanes(self, lanes: Mapping[str, int]) -> None:
        """Live per-app lane-budget change — what :meth:`resize` does
        after resizing the members: every app's lane block is rebuilt to its
        new budget, in-flight lanes are evicted and requeued at the
        front (no drop, no dup, no re-streaming — progress is
        preserved), and all counters carry over. Apps missing from
        ``lanes`` keep their current budget; queue limits are
        untouched."""
        streams = {
            name: StreamSpec(spec.d_in, lanes.get(name, spec.lanes),
                             spec.queue_limit)
            for name, spec in self._streams.items()}
        self.resize_streams(streams)

    # ---------------- observability -------------------------------- #
    def _obs_tags(self):
        return {"router": type(self).__name__,
                "apps": ",".join(map(str, self.members)),
                "lanes": self.slots}

    # ---------------- accounting ----------------------------------- #
    def _finished_for(self, app: str) -> list:
        return [st for st in self.finished if st.request.key == app]

    def stats_app(self, app: str) -> RouterStats:
        """One tenant's row (lanes/occupancy against ITS budget);
        latency percentiles ride the app's bounded reservoir (exact for
        runs up to the reservoir size)."""
        return stats_from_states(self._finished_for(app),
                                 items=self.items_by_key[app],
                                 steps=self.steps,
                                 wall_s=self._wall_s(),
                                 lanes=self._streams[app].lanes,
                                 rejected=self.rejected_by_key[app],
                                 lat_res=self._lat_by_key[app],
                                 wait_res=self._wait_by_key[app])

    def stats(self) -> DeploymentStats:
        fleet = stats_from_states(self.finished,
                                  items=self.items_emitted,
                                  steps=self.steps,
                                  wall_s=self._wall_s(),
                                  lanes=self.slots,
                                  rejected=self.rejected,
                                  lat_res=self._lat_all,
                                  wait_res=self._wait_all)
        return DeploymentStats(
            apps={name: self.stats_app(name) for name in self.members},
            fleet=fleet)


class DistributedMultiAppRouter(LockstepDrainMixin, MultiAppRouter):
    """The multi-app router's lockstep shape over ranks (see module
    doc).

    Every rank of the process group constructs one over the same
    members (whose mesh spans the ranks) and drives it with the same
    call sequence. ``step_when_idle`` is forced on: every app's batched
    step runs on every rank on every engine step, in declaration
    order, so every rank counts the same steps.
    """

    def __init__(self, members, *, lanes, queue_limits=None,
                 use_kernel: bool = True):
        for name, member in members.items():
            if not getattr(member, "is_distributed", False):
                raise ValueError(
                    f"app {name!r}: member's mesh does not span "
                    "processes; on one process use MultiAppRouter")
        super().__init__(members, lanes=lanes, queue_limits=queue_limits,
                         use_kernel=use_kernel, step_when_idle=True)

    # (local lanes, d_in) → (local lanes, d_out): each rank streams its
    # lanes' rows on its own device
    _local_stream = True

    def _serve_decision(self, sources) -> str:
        if not self._spmd_lockstep:
            return MultiAppRouter._serve_decision(self, sources)
        more = bool(self.queue or self.active or
                    not all(s.exhausted for s in sources.values()))
        return "step" if self._any_across_hosts(more) else "stop"

    def stats_global(self) -> DeploymentStats:
        """Exact fleet-wide per-app + roll-up stats (collective: every
        rank must call together; any rank can report the result — no
        rank-0 pinning). Each app's counters and raw latencies gather
        separately, in declaration order, then the fleet row gathers
        the totals — percentiles are computed over every finished
        request in the fleet, never merged from per-rank percentiles.
        In degraded mode (after a membership change) collectives with
        the dead peers are impossible, so this returns the LOCAL stats
        — use the heartbeat-board roll-up for the cross-survivor
        view."""
        if not self._spmd_lockstep or process_count() == 1:
            return self.stats()
        wall = self._wall_s()
        apps = {}
        for name in self.members:
            fin = self._finished_for(name)
            apps[name] = gather_global_stats(
                self._lat_by_key[name].values,
                self._wait_by_key[name].values, requests=len(fin),
                items=self.items_by_key[name], steps=self.steps,
                rejected=self.rejected_by_key[name],
                lanes=self._streams[name].lanes, wall_s=wall)
        fleet = gather_global_stats(
            self._lat_all.values, self._wait_all.values,
            requests=len(self.finished),
            items=self.items_emitted, steps=self.steps,
            rejected=self.rejected, lanes=self.slots, wall_s=wall)
        return DeploymentStats(apps=apps, fleet=fleet)

    def _obs_tags(self):
        tags = MultiAppRouter._obs_tags(self)
        tags["host"] = process_index()
        return tags

    def metrics_global(self) -> dict:
        """Fleet-wide merge of every rank's ``repro_torch.obs``
        registry snapshot (collective while in lockstep; degraded mode
        falls back to the local snapshot) — what
        :meth:`repro_torch.deploy.Deployment.metrics` serves on a
        distributed deployment."""
        from repro_torch.obs import (allgather_snapshots, current,
                                     merge_snapshots)

        snap = current().metrics.snapshot()
        if not self._spmd_lockstep or process_count() == 1:
            return snap
        return merge_snapshots(allgather_snapshots(snap))
