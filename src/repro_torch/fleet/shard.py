"""Serving one compiled chip as a fleet of identical logical chips.

Port of ``repro.fleet.shard``. The paper scales a single streaming
multicore chip; the fleet scales the *chip*: ``shard_chip`` serves the
chips of a 1-D ``"chip"`` mesh (:class:`repro_torch.launch.mesh.FleetMesh`)
from one :class:`repro_torch.chip.CompiledChip`'s programmed plan and
deals the item batch across them (data-parallel replica fan-out — the
§V.C replication argument lifted from cores-within-a-chip to
chips-within-a-fleet).

The reference places one plan copy on every device of a mesh and runs
``stream_pipeline`` on each device's shard. Here a process — a rank —
drives one device, and its logical chips live on that device and share
its one programmed image, so the chip axis is folded into the batch, as
``stream_pipeline`` already folds the replica axis: a batch is streamed
in ONE ``stream_pipeline`` call — the launches of one chip's batch,
never a loop over the chips — and the fleet's rows are the single
chip's. Dealing rows out to chips (the reference pads a batch to
``n_chips × per`` rows) has no work to do while every logical chip
shares the one device and its one image.

The mesh may span ranks (:func:`repro_torch.launch.mesh.make_distributed_fleet_mesh`
in a gloo process group): each rank compiles its own identical chip
from the same seed (programming the fleet moves no bytes between
ranks) and serves its own row block through :meth:`ShardedChip.stream_local`
— its rows in, its outputs back, on its own device. One rank per GPU
is the torch form of the reference's one plan copy per GPU
(``replicate_to_mesh``). The global-batch ``stream`` / ``stream_host``
verbs refuse on such a mesh: a rank cannot stream the other ranks'
rows, and pretending otherwise would mean shipping every batch through
one rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.chip.compile import (CompiledChip, reprogram_chip,
                                      stream_pipeline, validate_stream_rate,
                                      warn_once_deprecated)
from repro_torch.launch.mesh import (FleetMesh, make_fleet_mesh,
                                     mesh_spans_processes, rank_device)
from repro_torch.obs.core import current as _obs_current

_REMEDY = ("Add chips to the fleet, use a larger core geometry, or lower "
           "the fleet target rate.")


@dataclasses.dataclass
class ShardedChip:
    """One compiled chip served as the ``mesh``'s identical logical
    chips.

    ``stream`` streams the batch through the one programmed plan —
    identical to the single chip, ``n_chips``× the lanes.
    ``serve``/``report`` mirror the CompiledChip verbs at fleet scale.
    On a mesh that spans ranks use ``stream_local`` (and ``serve``,
    which then gives the lockstep router); see the module docstring.

    ``items_per_second`` is an optional FLEET-level target rate,
    validated against ``replication × n_chips`` copies of the chip's
    routed TDM fabric: infeasible targets warn
    (:class:`repro_torch.chip.ChipRateWarning`) or, with
    ``strict_rate=True``, raise. When the fleet target IS the rate the
    compile already validated (``chip.rate_validated``), the check is
    skipped: fleet capacity is chip capacity × n_chips, so the
    compile's verdict already covers it.
    """
    chip: CompiledChip
    mesh: FleetMesh
    items_per_second: float = 0.0
    strict_rate: bool = False

    def __post_init__(self):
        if self.chip.plan is None:
            raise ValueError(
                "shard_chip needs a streamable chip (compiled with "
                "weights); this one is analytic-only")
        self._check_mesh(self.mesh)
        if not (self.chip.rate_validated and
                self.items_per_second == self.chip.items_per_second):
            # point the warning at shard_chip's caller: stacklevel
            # counts validate_stream_rate(1) → _validate(2) →
            # __post_init__(3) → dataclass __init__(4) → shard_chip(5)
            # → user(6)
            self._validate("shard_chip", stacklevel=6)

    def _validate(self, context: str, stacklevel: int) -> None:
        validate_stream_rate(
            self.items_per_second, self.chip.replication * self.n_chips,
            self.chip.route, self.strict_rate, context=context,
            fabric=(f"fleet replica(s) ({self.n_chips} chip(s) x "
                    f"{self.chip.replication} replica(s))"),
            remedy=_REMEDY, stacklevel=stacklevel,
            chip_replicas=self.chip.replication)

    def _check_mesh(self, mesh: FleetMesh) -> None:
        if mesh.device != rank_device(self.chip.device):
            raise ValueError(
                f"the mesh puts this process's chips on {mesh.device}, "
                f"but the chip is programmed on {self.chip.device}")

    # ------------------------------------------------------------ #
    @property
    def n_chips(self) -> int:
        return self.mesh.size

    @property
    def is_distributed(self) -> bool:
        """True when the fleet's mesh spans ranks."""
        return mesh_spans_processes(self.mesh)

    @property
    def local_chips(self) -> list:
        """This process's chips (their places on the ``"chip"`` axis),
        in row-block order."""
        return self.mesh.local_chips

    @property
    def n_local_chips(self) -> int:
        return len(self.local_chips)

    @property
    def d_in(self) -> int:
        return self.chip.dims[0]

    @property
    def d_out(self) -> int:
        return self.chip.dims[-1]

    @property
    def total_cores(self) -> int:
        return self.chip.total_cores * self.n_chips

    @property
    def has_drift(self) -> bool:
        return self.chip.has_drift

    def _age(self) -> Optional[torch.Tensor]:
        """The fleet's drift age, an f32 fill on the chip's device (None
        when the chip's devices do not drift). Every member shares the
        source chip's clock: the members are copies of the SAME
        programmed (and thus equally aged) physical image."""
        if not self.has_drift:
            return None
        return torch.full((), float(self.chip.items_streamed),
                          dtype=torch.float32, device=self.chip.device)

    # ------------------------------------------------------------ #
    def _stream(self, x, use_kernel: bool, span: str,
                args: dict) -> torch.Tensor:
        """x (..., d_in) → (..., d_out) on the chip's device, in x's
        dtype, through ONE ``stream_pipeline`` call. Under drift the
        batch sees the source chip's age, and the source chip's clock
        advances by the batch (each rank advances its own copy of the
        clock by its OWN rows; equal rows a call keep the ranks' ages
        in agreement)."""
        tel = _obs_current()
        t0 = time.perf_counter() if tel.active else 0.0
        x = torch.as_tensor(x, device=self.chip.device)
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        B = xf.shape[0]
        age = self._age()
        out = stream_pipeline(self.chip.plan, xf, use_kernel=use_kernel,
                              replication=self.chip.replication, age=age)
        if age is not None:
            self.chip.advance_age(B)
        if tel.active:
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            tel.tracer.complete(span, t0, time.perf_counter() - t0, tid=0,
                                cat="fleet", args={"rows": int(B), **args})
        return out.reshape(*lead, out.shape[-1]).to(x.dtype)

    def stream(self, x, *, use_kernel: bool = True) -> torch.Tensor:
        """Stream a batch through the fleet: x (..., d_in) tensor or
        array → (..., d_out) on the chip's device, in x's dtype
        (:meth:`_stream`). Refuses on a mesh that spans ranks: use
        :meth:`stream_local` there."""
        if self.is_distributed:
            raise ValueError(
                "stream/stream_host serve the whole fleet's batch from "
                "this process, but the mesh spans "
                f"{self.mesh.n_processes} processes. Use "
                "stream_local(x_local): every rank passes its own rows "
                "and reads back its own outputs.")
        return self._stream(x, use_kernel, "fleet.stream",
                            {"chips": self.n_chips})

    def stream_host(self, x, *, use_kernel: bool = True) -> np.ndarray:
        """Host-to-host fleet stream: x (..., d_in) → (..., d_out) as a
        float32 numpy array — the router's hot path. The batch is
        staged to the chip's device, streamed (:meth:`stream`) and
        read back."""
        out = self.stream(torch.as_tensor(np.asarray(x, np.float32)),
                          use_kernel=use_kernel)
        return out.cpu().numpy()

    def stream_local(self, x, *, use_kernel: bool = True) -> np.ndarray:
        """Process-local stream: x (..., d_in) is THIS rank's rows;
        returns this rank's (..., d_out) outputs as a float32 numpy
        array. The rows are streamed on this rank's device through the
        one ``stream_pipeline`` call, so no item bytes ever cross ranks
        — the fleet-scale analogue of the paper's sensors feeding each
        chip's TSV interface directly. On a one-process mesh it equals
        :meth:`stream_host` (one process owns all rows)."""
        out = self._stream(torch.as_tensor(np.asarray(x, np.float32)),
                           use_kernel, "fleet.stream_local",
                           {"local_chips": self.n_local_chips})
        return out.cpu().numpy()

    def __call__(self, x, **kw) -> torch.Tensor:
        return self.stream(x, **kw)

    def resize(self, n_chips: Optional[int] = None, *,
               mesh: Optional[FleetMesh] = None) -> None:
        """Elastic resize: serve the SAME programmed plan on a new
        ``"chip"`` mesh (grown, shrunk, or rebuilt on a survivor after
        a membership change) — nothing is re-placed and nothing
        compiles (``compile_count()`` is the pin). Default: a
        one-process mesh of ``n_chips`` logical chips on the chip's
        device (:func:`repro_torch.launch.mesh.make_fleet_mesh`); pass
        ``mesh`` to rebuild on another one
        (:func:`repro_torch.fleet.ha.local_fleet_mesh`). The fleet rate
        target is re-validated against the new capacity: shrinking
        below the declared ``items_per_second`` warns (or raises under
        ``strict_rate``), the degraded-mode SLO signal."""
        if mesh is None:
            mesh = make_fleet_mesh(n_chips, device=self.chip.device)
        self._check_mesh(mesh)
        self.mesh = mesh
        self._validate("ShardedChip.resize", stacklevel=4)

    def reprogram(self, params, **kw) -> None:
        """Live weight swap: re-encode ``params`` into tile state for
        the SAME compiled fabric (:func:`repro_torch.chip.reprogram_chip`:
        map/route never run). Call between engine steps; in-flight
        lanes see the new weights on their next item, exactly like
        re-flashing a crossbar mid-stream."""
        self.chip = reprogram_chip(self.chip, params, **kw)

    def serve(self, *, lanes_per_chip: int = 4, **kw):
        """A continuous-batching router over this fleet: a
        :class:`repro_torch.fleet.FleetRouter`, or its lockstep variant
        :class:`repro_torch.fleet.DistributedFleetRouter` when the mesh
        spans ranks.

        Deprecated as a user entry point: ``deploy()`` wires the same
        router from one declarative spec (and adds multi-app
        co-residency). Semantics unchanged; warns once per process."""
        warn_once_deprecated(
            "ShardedChip.serve",
            "ShardedChip.serve() is deprecated as a direct entry "
            "point; declare the fleet with repro_torch.deploy.deploy(spec) "
            "and use Deployment.submit/serve (same router underneath)")
        from repro_torch.fleet.router import (DistributedFleetRouter,
                                              FleetRouter)
        router = DistributedFleetRouter if self.is_distributed \
            else FleetRouter
        return router(self, lanes_per_chip=lanes_per_chip, **kw)

    def report(self, router=None):
        """Fleet-level roll-up of the per-chip Tables II–VI report."""
        from repro_torch.fleet.report import fleet_report
        return fleet_report(self, router)


def shard_chip(chip: CompiledChip, n_chips: Optional[int] = None, *,
               mesh: Optional[FleetMesh] = None,
               items_per_second: float = 0.0,
               strict_rate: bool = False) -> ShardedChip:
    """Serve one compiled chip as ``n_chips`` logical chips on its
    device (default: the visible CUDA devices for a card's chip, 1 for
    a CPU chip; more are allowed, since the chips are logical), or on
    an existing ``mesh`` — a ``make_distributed_fleet_mesh`` spanning
    ranks included. ``items_per_second`` declares the rate target for
    the WHOLE fleet; it is validated against ``replication × n_chips``
    copies of the chip's routed TDM fabric (warn / ``strict_rate=True``
    raise) — the single-chip compile cannot have vouched for it."""
    if mesh is None:
        mesh = make_fleet_mesh(n_chips, device=chip.device)
    return ShardedChip(chip, mesh, items_per_second=items_per_second,
                       strict_rate=strict_rate)
