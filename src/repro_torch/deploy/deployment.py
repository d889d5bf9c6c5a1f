"""deploy(spec): one declarative call from specs to a served fabric.

Port of ``repro.deploy.deployment``. What the call does, in order, per
app: resolve the network (paper app name / MLPSpec+params /
ProgrammedMLP), ``compile_chip`` it for the app's system at its SLO on
the deployment's device (one full map→route→program pass), then serve
the programmed plan as a :class:`repro_torch.fleet.ShardedChip` on the
one shared ``"chip"`` mesh (its own system's submesh on a
heterogeneous fleet). The returned :class:`Deployment` owns the
multi-app router over those members and speaks every serving verb —
plus the two the multi-tenant story adds: per-app stats inside one
fleet roll-up, and :meth:`Deployment.reprogram`, the live §III.D
weight swap that re-encodes ONE tenant's tiles with no recompile of
anything (asserted via :func:`repro_torch.chip.compile_count`).

The logical chips of a mesh live on the one device and share its
programmed image (:mod:`repro_torch.fleet.shard`), so every tenant's
batch is one ``stream_pipeline`` call — the chip's own kernel launches
— and a heterogeneous fleet's systems are submeshes of logical chips
on that device. Weights of a paper app come from ``mlp_init`` with a
``torch.Generator`` seeded from ``AppSpec.seed``: the reference's
``jax.random`` draws cannot be replayed, so comparisons hand weights
across as ``params``.

A language-model tenant (an ``AppSpec`` whose network is a
transformer config) compiles through :func:`repro_torch.lm.compile_lm`
and joins the router as a :class:`repro_torch.lm.LMMember`: requests
carry token prompts (:meth:`Deployment.submit_tokens`), one engine step
is one greedy decode step of every lane, and the tenant is priced by
its analytic chip, which ``compile_lm`` builds lazily and this module
builds at deploy time to validate the tenant's rate, as the reference
does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import torch

from repro_torch.chip.compile import (CompiledChip, compile_chip,
                                      validate_stream_rate)
from repro_torch.core.crossbar_layer import MLPSpec, ProgrammedMLP, mlp_init
from repro_torch.core.neural_core import CoreGeometry
from repro_torch.deploy.report import DeploymentReport, deployment_report
from repro_torch.deploy.router import (DeploymentStats,
                                       DistributedMultiAppRouter,
                                       MultiAppRouter)
from repro_torch.deploy.spec import AppSpec, DeploymentSpec
from repro_torch.fleet.shard import ShardedChip
from repro_torch.launch.mesh import (FleetMesh, make_chip_submesh,
                                     make_fleet_mesh, mesh_spans_processes,
                                     rank_device)

def _resolve_network(app: AppSpec, device: torch.device):
    """→ (networks-arg for compile_chip, params, compile kwargs)."""
    net = app.network
    if isinstance(net, str):
        from repro_torch.configs.paper_apps import APPS

        cfg = APPS.get(net)
        if cfg is None:
            raise ValueError(f"app {app.name!r}: unknown paper app "
                             f"{net!r} (known: {sorted(APPS)})")
        nets = cfg.nets(app.system)
        rate = app.items_per_second or cfg.items_per_second
        kw = dict(items_per_second=rate,
                  sensor_flags=cfg.sensor_flags(app.system),
                  deps=cfg.net_deps(app.system),
                  tsv_bits_per_item=cfg.tsv_bits_per_item)
        if len(nets) == 1 and nets[0][0] == 1 and not app.analytic:
            # single-net paper app: streamable, with deterministic
            # weights unless the spec brought its own
            spec = MLPSpec(nets[0][1], activation="threshold",
                           out_activation="linear")
            params = app.params if app.params is not None else mlp_init(
                spec, generator=torch.Generator().manual_seed(app.seed),
                device=device)
            return spec, params, kw
        if app.params is not None:
            raise ValueError(
                f"app {app.name!r}: paper app {net!r} maps to "
                f"{len(nets)} networks for system {app.system!r}; "
                "params only apply to single-net apps")
        return nets, None, kw           # analytic-only tenant
    if isinstance(net, ProgrammedMLP) and app.analytic:
        raise ValueError(f"app {app.name!r}: a ProgrammedMLP is "
                         "already programmed state — analytic=True "
                         "does not apply")
    # an MLPSpec, a ProgrammedMLP, or bare net tuples (analytic-only)
    return net, app.params, dict(items_per_second=app.items_per_second)


def _is_lm_network(net) -> bool:
    """LM tenants declare themselves by shape: a transformer config
    (``family``/``num_layers``) instead of an MLP spec/tuple — the same
    duck-typing ``compile_chip`` uses to point misrouted configs at
    ``repro_torch.lm.compile_lm``."""
    return hasattr(net, "family") and hasattr(net, "num_layers")


@dataclasses.dataclass
class _Member:
    """One deployed tenant: its spec, compile, and fleet placement
    (``sharded`` is None for analytic-only tenants)."""
    spec: AppSpec
    chip: CompiledChip
    sharded: Optional[ShardedChip]
    mlp_spec: Optional[MLPSpec]         # for reprogram
    params: Any = None                  # last-programmed weights


class Deployment:
    """A live multi-app fabric (build with :func:`deploy`)."""

    def __init__(self, spec: DeploymentSpec):
        self.spec = spec
        self.chip_systems: Optional[tuple] = None
        self._submeshes: Dict[str, FleetMesh] = {}
        if spec.mesh is not None:
            if not isinstance(spec.mesh, FleetMesh):
                raise ValueError(
                    f"deploy: mesh must be a repro_torch.launch.mesh."
                    f"FleetMesh (got {type(spec.mesh).__name__})")
            self.mesh = spec.mesh
            if spec.device is not None and \
                    rank_device(spec.device) != self.mesh.device:
                raise ValueError(
                    f"deploy: the mesh puts this process's chips on "
                    f"{self.mesh.device}, not on device={spec.device!r}")
        elif spec.chip_systems is not None:
            # heterogeneous fleet: one logical chip per declared entry,
            # each app placed on the submesh of its own system's chips
            self.mesh = make_fleet_mesh(len(spec.chip_systems),
                                        device=spec.device)
            self.chip_systems = spec.chip_systems
            for system in sorted(set(spec.chip_systems)):
                idx = [i for i, s in enumerate(spec.chip_systems)
                       if s == system]
                self._submeshes[system] = \
                    make_chip_submesh(self.mesh, idx)
        else:
            self.mesh = make_fleet_mesh(spec.n_chips, device=spec.device)
        self.device = self.mesh.device
        self.n_chips = self.mesh.size
        self._closed = False

        self._members: Dict[str, _Member] = {}
        self._monitors: Dict[str, Any] = {}
        self._recals: Dict[str, Any] = {}
        for app in spec.apps:
            if _is_lm_network(app.network):
                self._members[app.name] = self._deploy_lm(app, spec)
                continue
            networks, params, kw = _resolve_network(app, self.device)
            app_mesh = self._submeshes.get(app.system, self.mesh)
            app_chips = app_mesh.size
            # validate the SLO exactly once, at the scope that serves
            # it (the app's fleet placement) — the compile defers, and
            # the one diagnostic carries both capacity levels
            chip = compile_chip(networks, params=params,
                                system=app.system,
                                geom=CoreGeometry(*app.geom)
                                if app.geom is not None else None,
                                weight_bits=app.weight_bits,
                                noise=app.noise,
                                strict_rate=spec.strict_rate,
                                validate_rate=False, device=self.device,
                                **kw)
            rate = kw.get("items_per_second", 0.0)
            sharded = None
            if chip.plan is not None:
                sharded = ShardedChip(
                    chip, app_mesh,
                    items_per_second=rate,
                    strict_rate=spec.strict_rate)
            else:
                # analytic-only tenants never build a ShardedChip, so
                # their SLO is validated here, at the same fleet scope
                validate_stream_rate(
                    rate, chip.replication * app_chips,
                    chip.route, spec.strict_rate,
                    context="deploy",
                    fabric=(f"fleet replica(s) ({app_chips} chip(s) x "
                            f"{chip.replication} replica(s))"),
                    remedy=("Add chips of this app's system, use a "
                            "larger core geometry, or lower the "
                            "app's items_per_second SLO."),
                    stacklevel=4,
                    chip_replicas=chip.replication)
            mlp_spec = networks if isinstance(networks, MLPSpec) else None
            self._members[app.name] = _Member(app, chip, sharded,
                                              mlp_spec, params)

        streamable = {name: m.sharded
                      for name, m in self._members.items()
                      if m.sharded is not None}
        self.router: Optional[MultiAppRouter] = None
        if streamable:
            # each router schedules lanes for the chips it drives: all
            # of the member's chips in one process (its own submesh on
            # a heterogeneous fleet), only this rank's on a mesh that
            # spans ranks (so the fleet-wide budget still sums to
            # lanes_per_chip × n_chips)
            distributed = self.is_distributed
            lanes = {name: self._members[name].spec.lanes_per_chip *
                     (member.n_local_chips if distributed
                      else member.n_chips)
                     for name, member in streamable.items()}
            limits = {name: (self._members[name].spec.queue_limit
                             if self._members[name].spec.queue_limit
                             is not None else spec.queue_limit)
                      for name in streamable}
            cls = DistributedMultiAppRouter if distributed \
                else MultiAppRouter
            self.router = cls(streamable, lanes=lanes,
                              queue_limits=limits,
                              use_kernel=spec.use_kernel)

    # ---------------- LM tenants (repro_torch.lm) ------------------- #
    def _deploy_lm(self, app: AppSpec, spec: DeploymentSpec) -> _Member:
        """Compile and place one language-model tenant: the
        transformer's per-layer linears map through
        :func:`repro_torch.lm.compile_lm` onto programmed tile plans on
        the deployment's device, and a :class:`repro_torch.lm.LMMember`
        joins the shared router next to the sensor members —
        ``items_per_second`` reads as tokens/second and
        ``lanes_per_chip`` as concurrent decode sequences."""
        from repro_torch import lm as lm_lib

        if mesh_spans_processes(self.mesh):
            raise ValueError(
                f"app {app.name!r}: LM tenants are single-process — "
                "decode is one batched call over the lanes, not an SPMD "
                "collective")
        if app.analytic:
            raise ValueError(
                f"app {app.name!r}: analytic=True does not apply to "
                "an LM tenant — compile_lm(...).report() is the "
                "sizing surface")
        if app.noise is not None:
            raise ValueError(
                f"app {app.name!r}: noise models are not wired "
                "through compile_lm yet (sensor tenants only)")
        app_mesh = self._submeshes.get(app.system, self.mesh)
        app_chips = app_mesh.size
        model = lm_lib.TransformerParams(app.network, app.params) \
            if app.params is not None else app.network
        clm = lm_lib.compile_lm(model, system=app.system,
                                geometry=app.geom,
                                tokens_per_second=app.items_per_second,
                                seed=app.seed, device=self.device)
        # same fleet-scope SLO validation as the analytic sensor path:
        # compile_lm defers (its chip is built here, on first access),
        # the one diagnostic carries both levels
        validate_stream_rate(
            app.items_per_second, clm.chip.replication * app_chips,
            clm.chip.route, spec.strict_rate, context="deploy",
            fabric=(f"fleet replica(s) ({app_chips} chip(s) x "
                    f"{clm.chip.replication} replica(s))"),
            remedy=("Add chips of this app's system, use a larger "
                    "core geometry, or lower the app's tokens/second "
                    "SLO."),
            stacklevel=5, chip_replicas=clm.chip.replication)
        member = lm_lib.LMMember(
            clm, lanes=app.lanes_per_chip * app_chips,
            cache_len=app.cache_len or lm_lib.DEFAULT_CACHE_LEN,
            n_chips=app_chips, mesh=app_mesh)
        return _Member(app, clm.chip, member, None, clm.params)

    def _lm_member(self, app: str) -> _Member:
        m = self._streaming_member(app)
        if not getattr(m.sharded, "is_lm", False):
            raise TypeError(
                f"app {app!r} is a sensor tenant — submit_tokens is "
                "the LM verb; use submit/stream")
        return m

    # ---------------- introspection -------------------------------- #
    @property
    def is_distributed(self) -> bool:
        """True while the streaming tenants' chips span ranks. After
        :func:`repro_torch.fleet.ha.degrade_to_local` the members serve
        this rank's own chips and this turns False (so :meth:`resize`
        works on the survivor)."""
        members = [m.sharded for m in self._members.values()
                   if m.sharded is not None]
        if members:
            return any(s.is_distributed for s in members)
        return self.mesh is not None and mesh_spans_processes(self.mesh)

    @property
    def apps(self) -> List[str]:
        return list(self._members)

    def chip(self, app: str) -> CompiledChip:
        return self._member(app).chip

    def app_chips(self, app: str) -> int:
        """How many fleet chips serve ``app`` — the whole mesh on a
        homogeneous fleet, the app's system's submesh on a
        heterogeneous one."""
        m = self._member(app)
        if self.chip_systems is None:
            return self.n_chips
        return self._submeshes[m.spec.system].size

    def params(self, app: str):
        """The app's last-programmed weight parameters (None for
        tenants deployed from bare shapes or pre-programmed state) —
        what a plain recalibration re-flashes."""
        return self._member(app).params

    def _member(self, app: str) -> _Member:
        if self._closed:
            raise RuntimeError("deployment is closed")
        m = self._members.get(app)
        if m is None:
            raise ValueError(f"unknown app {app!r} (deployed: "
                             f"{sorted(self._members)})")
        return m

    def _streaming_member(self, app: str) -> _Member:
        m = self._member(app)
        if m.sharded is None:
            raise ValueError(
                f"app {app!r} is analytic-only (no weights): report() "
                "works, but stream/submit/serve need programmed state")
        return m

    def _live_router(self) -> MultiAppRouter:
        if self._closed:
            raise RuntimeError("deployment is closed")
        if self.router is None:
            raise ValueError("no streamable app in this deployment "
                             "(every tenant is analytic-only)")
        return self.router

    # ---------------- serving verbs -------------------------------- #
    def stream(self, app: str, x, *,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
        """One-shot batch through ``app``'s fleet placement: x (...,
        d_in) tensor or array → (..., d_out) on the deployment's device
        — the arithmetic of ``shard_chip(...).stream`` (the member IS a
        ShardedChip), hence equal to it to the bit. On a mesh that
        spans ranks, ``x`` is this rank's rows and the result a CPU
        tensor of this rank's outputs (``ShardedChip.stream_local``)."""
        m = self._streaming_member(app)
        if getattr(m.sharded, "is_lm", False):
            raise TypeError(
                f"app {app!r} is an LM tenant — one-shot stream is a "
                "sensor verb; use submit_tokens (or CompiledLM."
                "prefill/decode directly)")
        uk = self.spec.use_kernel if use_kernel is None else use_kernel
        if m.sharded.is_distributed:
            return torch.from_numpy(m.sharded.stream_local(x, use_kernel=uk))
        return m.sharded.stream(x, use_kernel=uk)

    def submit(self, app: str, items) -> bool:
        """Queue one item-stream request for ``app`` on the shared
        router; False = that app's admission queue is full."""
        m = self._streaming_member(app)
        if getattr(m.sharded, "is_lm", False):
            raise TypeError(
                f"app {app!r} is an LM tenant — its requests carry a "
                "token prompt, not an item array; use submit_tokens")
        return self._live_router().submit_app(app, items) is not None

    def submit_tokens(self, app: str, prompt,
                      max_new_tokens: int = 16) -> bool:
        """Queue one decode request for LM tenant ``app``: prefill the
        prompt on admission, then stream ``max_new_tokens`` greedy
        tokens — one token per engine step per lane, through the same
        keyed scheduler (and the same per-app accounting) as the
        sensor items. False = the app's admission queue is full."""
        from repro_torch.lm import lm_request

        m = self._lm_member(app)
        prompt = tuple(int(t) for t in prompt)
        budget = m.sharded.cache_len
        if len(prompt) + max_new_tokens > budget:
            raise ValueError(
                f"submit_tokens: prompt ({len(prompt)}) + "
                f"max_new_tokens ({max_new_tokens}) exceeds the "
                f"app's KV cache_len ({budget}) — raise "
                "AppSpec.cache_len or shorten the request")
        req = lm_request(prompt, max_new_tokens)
        return self._live_router().submit_app(app, req) is not None

    def generated_tokens(self, app: str) -> Dict[int, List[int]]:
        """``{request uid: generated token ids}`` for every FINISHED
        request of LM tenant ``app``."""
        from repro_torch.lm import tokens_from_state

        self._lm_member(app)
        return {st.request.uid: tokens_from_state(st)
                for st in self._live_router()._finished_for(app)}

    def step(self) -> int:
        return self._live_router().step()

    def run_until_drained(self, max_steps: int = 10_000) -> List:
        return self._live_router().run_until_drained(max_steps)

    def serve(self, sources: Union[Mapping[str, Any], Any], *,
              max_steps: int = 100_000) -> List:
        """Closed serving loop over per-app bounded sources
        (``{app: StreamSource}``; a bare source binds to the single
        streamable app)."""
        router = self._live_router()
        if not isinstance(sources, Mapping):
            if len(router.members) != 1:
                raise ValueError(
                    "serve: a bare source is ambiguous with "
                    f"{len(router.members)} streamable apps — pass "
                    "{app_name: source}")
            sources = {next(iter(router.members)): sources}
        return router.serve(sources, max_steps=max_steps)

    # ---------------- variability observability -------------------- #
    def attach_monitor(self, app: str, canary, *, reference=None,
                       every_steps: int = 1):
        """Attach a :class:`repro_torch.variability.AccuracyMonitor` to
        ``app``: its canary batch is scored every ``every_steps``
        engine steps (router step listener) and the series surfaces in
        :meth:`stats` / :meth:`variability_report`. Returns the
        monitor. The chip is resolved per probe, so live reprograms are
        always scored against current state."""
        m = self._streaming_member(app)
        if getattr(m.sharded, "is_lm", False):
            raise NotImplementedError(
                f"app {app!r} is an LM tenant — accuracy monitors "
                "score an MLP canary batch against the programmed "
                "chip; LM quality tracking is future work")
        from repro_torch.variability.monitor import AccuracyMonitor

        monitor = AccuracyMonitor(lambda: self._member(app).chip,
                                  canary, reference=reference,
                                  every_steps=every_steps, name=app)
        self._monitors[app] = monitor
        self._live_router().add_step_listener(monitor.on_step)
        return monitor

    def attach_recalibration(self, app: str, *, policy=None,
                             monitor=None, canary=None,
                             params_fn=None, board=None,
                             rank: int = 0, every_steps: int = 1):
        """Close the loop for ``app``: SLO breaches on the (attached
        or given) monitor trigger live :meth:`reprogram` — zero
        compile passes, journaled on ``board`` (a
        :class:`repro_torch.fleet.ha.HeartbeatBoard`) when given.
        Returns the :class:`repro_torch.variability.Recalibrator`."""
        from repro_torch.variability.recal import Recalibrator

        if monitor is None:
            monitor = self._monitors.get(app)
        if monitor is None:
            if canary is None:
                raise ValueError(
                    "attach_recalibration: no monitor attached for "
                    f"{app!r} — pass canary= (or monitor=) so breach "
                    "detection has something to score")
            monitor = self.attach_monitor(app, canary,
                                          every_steps=every_steps)
        recal = Recalibrator(self, app, monitor, policy,
                             params_fn=params_fn, board=board,
                             rank=rank)
        self._recals[app] = recal
        self._live_router().add_step_listener(recal.on_step)
        return recal

    def variability_report(self) -> Dict[str, Any]:
        """Per-app drift/accuracy series + recalibration events — the
        non-ideal-device companion to the Tables II–VI report."""
        out: Dict[str, Any] = {}
        for app in set(self._monitors) | set(self._recals):
            m = self._members.get(app)
            entry: Dict[str, Any] = {
                "noise": dataclasses.asdict(m.spec.noise)
                if m is not None and m.spec.noise is not None else None,
                "items_streamed": m.chip.items_streamed
                if m is not None else 0,
            }
            monitor = self._monitors.get(app)
            if monitor is not None:
                entry["monitor"] = monitor.summary()
            recal = self._recals.get(app)
            if recal is not None:
                entry["recalibration"] = recal.summary()
            out[app] = entry
        return out

    def _with_variability(self,
                          stats: DeploymentStats) -> DeploymentStats:
        if not self._monitors and not self._recals:
            return stats
        return dataclasses.replace(
            stats, variability=self.variability_report())

    # ---------------- accounting ----------------------------------- #
    def stats(self) -> DeploymentStats:
        return self._with_variability(self._live_router().stats())

    def stats_global(self) -> DeploymentStats:
        """:meth:`stats` across ranks (collective on a deployment that
        spans ranks: every rank must call together)."""
        router = self._live_router()
        if hasattr(router, "stats_global"):
            return self._with_variability(router.stats_global())
        return self._with_variability(router.stats())

    # ---------------- observability (repro_torch.obs) --------------- #
    def metrics(self) -> dict:
        """The ``repro_torch.obs`` registry snapshot behind this
        deployment (counters/gauges/bounded histograms; empty unless
        ``repro_torch.obs.configure()`` ran). Across ranks, this merges
        every rank's registry (collective while in lockstep)."""
        if self._closed:
            raise RuntimeError("deployment is closed")
        from repro_torch import obs

        router = self.router
        if router is not None and hasattr(router, "metrics_global"):
            return router.metrics_global()
        return obs.current().metrics.snapshot()

    def trace(self, path: str) -> str:
        """Write the process trace (Chrome trace-event JSON — load at
        ui.perfetto.dev or chrome://tracing) and return ``path``: step
        phases, per-request spans, chip compile/stream timing, HA and
        recalibration instants."""
        if self._closed:
            raise RuntimeError("deployment is closed")
        from repro_torch import obs

        return obs.current().tracer.write(path)

    def report(self) -> DeploymentReport:
        """Multi-app Tables II–VI composition (+ served stats when the
        router has run). Across ranks this is a collective — the served
        side gathers like every other verb."""
        if self._closed:
            raise RuntimeError("deployment is closed")
        served = None
        if self.router is not None and self.router.steps:
            served = self.stats_global() if self.is_distributed \
                else self.stats()
        chips = {name: m.chip for name, m in self._members.items()}
        if self.chip_systems is None:
            return deployment_report(chips, self.n_chips, served)
        # heterogeneous: each app's row scales by ITS submesh size
        per_app = {name: self.app_chips(name) for name in chips}
        return deployment_report(chips, per_app, served,
                                 total_chips=self.n_chips)

    # ---------------- elastic resize ------------------------------- #
    def resize(self, n_chips: Optional[int] = None, *,
               mesh: Optional[FleetMesh] = None) -> None:
        """Grow or shrink the fleet under live traffic with ZERO
        compile passes (pinned via :func:`repro_torch.chip.compile_count`):
        every member's programmed plan is served on the new ``"chip"``
        mesh (:meth:`repro_torch.fleet.ShardedChip.resize`), then the
        router's per-app lane budgets are rebuilt to
        ``lanes_per_chip × n_chips``; in-flight lanes are evicted and
        requeued at the FRONT with their progress intact, so nothing
        is dropped, duplicated or re-streamed and all accounting
        carries over. Call between engine steps.

        Only for chips this process drives: resizing a fleet that spans
        ranks is a membership change, which is
        :mod:`repro_torch.fleet.ha`'s job (``degrade_to_local`` /
        ``HAFleetServer``); after it, the survivor resizes here."""
        if self._closed:
            raise RuntimeError("deployment is closed")
        if self.is_distributed:
            raise ValueError(
                "resize: this deployment's mesh spans processes — a "
                "multi-process topology change is a membership "
                "change; use repro_torch.fleet.ha (degrade_to_local / "
                "HAFleetServer) instead")
        if self.chip_systems is not None:
            raise ValueError(
                "resize: this is a heterogeneous (chip_systems) fleet "
                "— its chip count is the per-system allocation; "
                "re-deploy with a new chip_systems tuple (or re-run "
                "repro_torch.tune) instead of resizing in place")
        if mesh is None:
            mesh = make_fleet_mesh(n_chips, device=self.device)
        for m in self._members.values():
            if getattr(m.sharded, "is_lm", False):
                # fresh per-lane KV cache FIRST: the router's requeued
                # lanes re-admit through on_admit, which re-prefills
                # each continuation into it
                m.sharded.resize(lanes=m.spec.lanes_per_chip * mesh.size)
        self.mesh = mesh
        self.n_chips = mesh.size
        if self.router is not None:        # its members: every streamer
            self.router.resize(
                mesh=mesh,
                lanes={name: self._members[name].spec.lanes_per_chip *
                       self.n_chips for name in self.router.members})

    # ---------------- the live weight swap ------------------------- #
    def reprogram(self, app: str, params) -> None:
        """Swap ONE tenant's weights with no recompile of the fabric:
        re-encode tile state for the same compiled topology
        (:func:`repro_torch.chip.reprogram_chip` — map/route untouched,
        ``compile_count`` unchanged). The other tenants' lanes never
        notice; in-flight lanes of this app see the new weights from
        their next item on — §III.D program-once, made a live
        operation. Call between engine steps."""
        m = self._streaming_member(app)
        if getattr(m.sharded, "is_lm", False):
            raise NotImplementedError(
                f"app {app!r} is an LM tenant — live reprogram is a "
                "sensor-tenant verb for now; recompile via "
                "repro_torch.lm.compile_lm and redeploy")
        # weight_bits/device_model/r_seg ride on the chip itself
        # (CompiledChip.program_kw) — the swap re-encodes exactly the
        # way the compile did
        kw = {"spec": m.mlp_spec} if m.mlp_spec is not None else {}
        m.sharded.reprogram(params, **kw)
        m.chip = m.sharded.chip
        m.params = params

    def close(self) -> None:
        """Tear the deployment down: drop plan/mesh references so
        device buffers free, and refuse further verbs."""
        if self._closed:
            return
        self._closed = True
        self._members.clear()
        self._monitors.clear()
        self._recals.clear()
        self.router = None
        self.mesh = None

    def __enter__(self) -> "Deployment":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        if self._closed:
            return "Deployment[closed]"
        kinds = [f"{name}:{m.spec.system}"
                 + ("" if m.sharded is not None else "(analytic)")
                 for name, m in self._members.items()]
        return (f"Deployment[{', '.join(kinds)} on {self.n_chips} "
                f"chip(s){' (distributed)' if self.is_distributed else ''}]")


def deploy(spec: Union[DeploymentSpec, Sequence[AppSpec], AppSpec],
           **kw) -> Deployment:
    """THE entry point: declarative spec in, live fabric out.

    Accepts a full :class:`DeploymentSpec`, a sequence of
    :class:`AppSpec`, or one bare :class:`AppSpec`; ``**kw`` (n_chips,
    mesh, chip_systems, queue_limit, use_kernel, strict_rate, device)
    build the DeploymentSpec in the shorthand forms. Runs on the card
    unless ``device="cpu"`` is asked for.
    """
    if isinstance(spec, AppSpec):
        spec = DeploymentSpec(apps=(spec,), **kw)
    elif not isinstance(spec, DeploymentSpec):
        spec = DeploymentSpec(apps=tuple(spec), **kw)
    elif kw:
        raise ValueError("deploy: pass topology kwargs inside the "
                         "DeploymentSpec, not alongside it")
    return Deployment(spec)
