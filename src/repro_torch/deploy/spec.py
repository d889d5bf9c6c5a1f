"""Declarative deployment specs.

Port of ``repro.deploy.spec``, with the same fields, validation and
error texts, and two differences:

  * ``DeploymentSpec.use_kernel`` defaults to ``True``, the port's
    convention (the chip, the fleet and its routers all stream through
    the hand-written kernels by default); ``False`` is the einsum path,
    kept for comparisons.
  * ``DeploymentSpec.device`` names where the deployment's chips are
    programmed and stream: ``None`` (the default) is the card, and
    ``"cpu"`` must be asked for — the explicit device every entry point
    of the port takes. It is resolved when the deployment is built, so
    an analytic spec (``repro_torch.tune``) can be declared anywhere.

The paper's processor is explicitly multi-application — Tables II–VI
size the SAME core/fabric design for five sensor benchmarks. A
:class:`DeploymentSpec` says WHAT should run — which apps, on which
system, at what rate, with what lane/admission budget — and one fabric
topology for all of them; :func:`repro_torch.deploy.deploy` turns it
into a live :class:`repro_torch.deploy.Deployment`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.core.systems import normalize_system
from repro_torch.runtime import DeviceLike


def _check_queue_limit(limit, context: str) -> None:
    """``queue_limit`` semantics, pinned: ``None`` = unbounded
    admission, positive = bounded. Zero is an explicit error — it would
    be ambiguous between "unbounded" (falsy) and "reject everything" (a
    zero-capacity queue can never admit, so serving could never make
    progress)."""
    if limit is None:
        return
    if not isinstance(limit, int) or isinstance(limit, bool) \
            or limit < 1:
        raise ValueError(
            f"{context}: queue_limit must be a positive int or None "
            f"(got {limit!r}); None means unbounded admission — a "
            "queue_limit of 0 would be a zero-capacity queue that can "
            "never admit a request")


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """One tenant application.

    ``network`` is one of
      * a paper app name (``repro_torch.configs.paper_apps.APPS`` key,
        e.g. ``"deep"``) — single-net apps get deterministic
        ``mlp_init`` weights from a ``torch.Generator`` seeded with
        ``seed`` unless ``params`` overrides them, so they stream out
        of the box; multi-net apps (edge, motion) deploy analytic-only
        (report works, stream raises);
      * an :class:`repro_torch.core.crossbar_layer.MLPSpec` — pass
        ``params`` to stream, omit for analytic-only;
      * a :class:`repro_torch.core.crossbar_layer.ProgrammedMLP` —
        already-programmed state;
      * a language-model config (anything with ``family`` and
        ``num_layers``, e.g. ``repro_torch.configs.qwen1p5_0p5b``) —
        compiled by ``repro_torch.lm.compile_lm`` (``params``: its
        parameter tree, else a seeded init) and served one greedy
        token per engine step per lane; ``cache_len`` is its per-lane
        KV ring (default ``repro_torch.lm.DEFAULT_CACHE_LEN``).

    ``system`` accepts any alias (``"memristor"``/``"1t1m"`` /
    ``"digital"``/``"sram"``); ``items_per_second`` is the tenant's SLO
    (validated against the routed TDM fabric × fleet at deploy time);
    ``geom`` pins the tile geometry as a ``(rows, cols)`` pair (None →
    the system's paper optimum — what ``repro_torch.tune`` sets when
    the search picks a non-default geometry). ``lanes_per_chip`` ×
    fleet chips is the tenant's lane budget and ``queue_limit`` its
    admission bound: a positive int bounds admission, ``None`` (the
    default) defers to the deployment-wide default, itself ``None`` =
    unbounded; 0 is an explicit error. ``analytic=True`` deploys a
    report-only tenant — no weight synthesis, no tile programming.

    ``noise`` (a :class:`repro_torch.variability.NoiseModel`, or None
    for ideal devices) compiles this tenant onto non-ideal memristors —
    the operating regime ``Deployment.attach_monitor`` /
    ``attach_recalibration`` exist for. The all-zero model runs the
    same path as ``noise=None``; digital tenants ignore it.
    """
    name: str
    network: Any
    params: Any = None
    system: str = "memristor"
    items_per_second: float = 0.0
    lanes_per_chip: int = 4
    queue_limit: Optional[int] = None
    seed: int = 0
    weight_bits: int = 8
    analytic: bool = False
    noise: Any = None
    geom: Optional[Tuple[int, int]] = None
    cache_len: Optional[int] = None     # LM tenants: per-lane KV ring

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError("AppSpec: every app needs a non-empty "
                             "string name")
        if self.lanes_per_chip < 1:
            raise ValueError(f"AppSpec {self.name!r}: lanes_per_chip "
                             "must be >= 1")
        _check_queue_limit(self.queue_limit, f"AppSpec {self.name!r}")
        if self.geom is not None:
            geom = tuple(self.geom)
            if len(geom) != 2 or not all(
                    isinstance(g, int) and g >= 1 for g in geom):
                raise ValueError(
                    f"AppSpec {self.name!r}: geom must be a "
                    f"(rows, cols) pair of positive ints (got "
                    f"{self.geom!r})")
            object.__setattr__(self, "geom", geom)
        if self.analytic and self.params is not None:
            raise ValueError(f"AppSpec {self.name!r}: analytic=True "
                             "is report-only — params would never be "
                             "programmed")
        if self.cache_len is not None and (
                not isinstance(self.cache_len, int)
                or isinstance(self.cache_len, bool)
                or self.cache_len < 2):
            raise ValueError(
                f"AppSpec {self.name!r}: cache_len must be an int "
                f">= 2 or None (got {self.cache_len!r})")
        # normalize eagerly so a bad alias fails at spec build, not
        # mid-deploy
        object.__setattr__(self, "system",
                           normalize_system(self.system,
                                            context=f"AppSpec "
                                                    f"{self.name!r}"))


@dataclasses.dataclass(frozen=True)
class DeploymentSpec:
    """A set of apps plus ONE fabric topology they co-reside on.

    ``n_chips`` sizes a fresh one-process ``"chip"`` mesh of logical
    chips on ``device`` (default: one a visible card); pass ``mesh``
    instead to reuse a launcher mesh — including a
    ``make_distributed_fleet_mesh`` spanning ranks, which makes every
    verb on the resulting deployment lockstep across ranks.
    ``chip_systems`` instead builds a HETEROGENEOUS fleet: one entry
    per chip naming its system (e.g. ``("memristor", "digital")``),
    each app placed on the submesh of its own system's chips —
    memristor and digital chips co-resident in one fleet, which is what
    ``repro_torch.tune`` emits when the cheapest fabric is mixed.
    ``queue_limit`` is the default per-app admission bound (``None`` =
    unbounded; 0 is an explicit error); ``strict_rate`` turns
    infeasible per-app SLOs into errors instead of
    :class:`repro_torch.chip.ChipRateWarning`. ``use_kernel`` and
    ``device``: see the module docstring.
    """
    apps: Tuple[AppSpec, ...]
    n_chips: Optional[int] = None
    mesh: Any = None
    queue_limit: Optional[int] = None
    use_kernel: bool = True
    strict_rate: bool = False
    chip_systems: Optional[Tuple[str, ...]] = None
    device: DeviceLike = None

    def __post_init__(self):
        apps = tuple(self.apps)
        object.__setattr__(self, "apps", apps)
        if not apps:
            raise ValueError("DeploymentSpec: at least one AppSpec")
        names = [a.name for a in apps]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"DeploymentSpec: duplicate app names "
                             f"{sorted(dupes)}")
        if self.mesh is not None and self.n_chips is not None:
            raise ValueError("DeploymentSpec: pass n_chips OR mesh, "
                             "not both (the mesh fixes the chip count)")
        _check_queue_limit(self.queue_limit, "DeploymentSpec")
        if self.chip_systems is not None:
            if self.n_chips is not None or self.mesh is not None:
                raise ValueError(
                    "DeploymentSpec: chip_systems fixes both the chip "
                    "count and each chip's system — don't pass "
                    "n_chips or mesh alongside it")
            systems = tuple(
                normalize_system(s, context="DeploymentSpec "
                                            "chip_systems")
                for s in self.chip_systems)
            if not systems:
                raise ValueError("DeploymentSpec: chip_systems needs "
                                 "at least one chip")
            object.__setattr__(self, "chip_systems", systems)
            missing = sorted({a.system for a in apps} - set(systems))
            if missing:
                raise ValueError(
                    f"DeploymentSpec: app system(s) {missing} have no "
                    f"chip in chip_systems={list(systems)} — every "
                    "app needs at least one chip of its own system")


def single_app(network, params=None, *, name: str = "app",
               system: str = "memristor", n_chips: Optional[int] = None,
               **kw) -> DeploymentSpec:
    """Shorthand for the one-tenant spec (the compile→shard→route path
    as one call)."""
    app_kw = {k: kw.pop(k) for k in
              ("items_per_second", "lanes_per_chip", "queue_limit",
               "seed", "weight_bits", "analytic", "noise", "geom",
               "cache_len")
              if k in kw}
    return DeploymentSpec(
        apps=(AppSpec(name, network, params=params, system=system,
                      **app_kw),),
        n_chips=n_chips, **kw)
