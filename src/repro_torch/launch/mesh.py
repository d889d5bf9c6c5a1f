"""The fleet's ``"chip"`` mesh over ranks, and the gloo control plane.

Port of the fleet half of ``repro.launch.mesh``. In the reference a
mesh is a ``jax.sharding.Mesh`` of devices, and a multi-process mesh
places one plan copy on every local device of each process. Here one
rank drives one device — one rank per GPU is the torch form of "one
plan copy per GPU" — and a rank's logical chips are folded into its
batch (:mod:`repro_torch.fleet.shard`). A :class:`FleetMesh` records,
per rank, its device and its number of logical chips; the ``"chip"``
axis runs over them rank-major, so rank r's chips hold a contiguous
row block of a fleet batch. A multi-GPU placement inside one process
is not offered: a process drives the one device its rank names.

Design decisions:

1. **Gloo only, no NCCL.** What crosses ranks is the control plane —
   the lockstep "anything left?" reduction and tiny stat gathers —
   never request payloads or results, which stay on the rank (and the
   device) that owns them. So the process group is gloo over CPU
   tensors (:func:`allgather` refuses a CUDA tensor: gloo does not
   gather them, and nothing here moves item rows between ranks).
   Every rank of a one-card machine shares ``cuda:0``, where NCCL
   between two ranks would not run in any case.
2. **Rendezvous through a ``file://`` store** in a directory made fresh
   for each launch (:func:`repro_torch.launch.simdev.launch_local_fleet`),
   so no free TCP port is picked and raced for; the group's timeout is
   always given explicitly (:func:`init_fleet_group`), in tens of
   seconds — with the 30-minute default a stalled (not dead) peer would
   hang its survivors for half an hour.

The training substrate's meshes (:func:`make_production_mesh`,
:func:`make_debug_mesh`) are ``torch.distributed.device_mesh.DeviceMesh``
objects over the group's ranks, one rank per mesh position, with the
reference's axis names (``pod``, ``data``, ``model``): the device type
is this rank's (:func:`rank_device`: ``cpu`` when asked for, else the
card). Their collectives ride the same gloo group (decision 1: a
one-card machine cannot run NCCL between two ranks). The rule table
reads only a mesh's axis names and sizes (:func:`mesh_axis_sizes`), so
a :class:`MeshShape` stands in for a production mesh of 256 or 512
positions where no such group exists.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.simdev import STORE_ENV
from repro_torch.runtime import DeviceLike, resolve_device


# ------------------------------------------------------------------- #
# the process group (gloo, control plane only)
# ------------------------------------------------------------------- #
def _grouped() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks in this process's group; 1 without a group."""
    import torch.distributed as dist
    return dist.get_world_size() if _grouped() else 1


def process_index() -> int:
    """This process's rank in its group; 0 without a group."""
    import torch.distributed as dist
    return dist.get_rank() if _grouped() else 0


def init_fleet_group(timeout_s: float) -> int:
    """Join this worker's gloo process group from the environment
    :func:`repro_torch.launch.simdev.launch_local_fleet` gives it
    (``RANK``, ``WORLD_SIZE`` and the ``file://`` store's path).
    ``timeout_s`` bounds the rendezvous and every collective: a peer
    that does not arrive within it fails the call instead of hanging
    it. Returns this rank."""
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    dist.init_process_group(
        backend="gloo", init_method=f"file://{os.environ[STORE_ENV]}",
        rank=rank, world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return rank


def allgather(t: torch.Tensor) -> torch.Tensor:
    """All-gather a CPU tensor over the process group → (ranks,
    *t.shape) in rank order (collective: every rank must call together,
    with the same shape and dtype). Without a group: ``t`` with a
    leading axis of one."""
    if t.device.type != "cpu":
        raise ValueError(f"allgather: the control plane gathers CPU "
                         f"tensors only (gloo), got one on {t.device}")
    t = t.contiguous()
    if not _grouped():
        return t.unsqueeze(0).clone()
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out)


# ------------------------------------------------------------------- #
# the mesh
# ------------------------------------------------------------------- #
def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``"cpu"`` when asked for, else the card —
    ``cuda:{LOCAL_RANK % device_count}``, so on a one-card machine
    every rank shares ``cuda:0``. Raises (never falls back to the CPU)
    when the card is asked for and none is visible."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A 1-D ``"chip"`` mesh over ranks: rank r drives ``devices[r]``
    and serves ``chips[r]`` logical chips; chips are numbered
    rank-major. ``process_index`` is this process's rank in the mesh
    (0 for a one-process mesh)."""
    devices: Tuple[torch.device, ...]
    chips: Tuple[int, ...]
    process_index: int = 0

    def __post_init__(self):
        if not self.chips or len(self.devices) != len(self.chips):
            raise ValueError(f"FleetMesh: one device and one chip count "
                             f"per rank, got {len(self.devices)} and "
                             f"{len(self.chips)}")
        if any(int(c) < 1 for c in self.chips):
            raise ValueError(f"FleetMesh: every rank needs n_chips >= 1, "
                             f"got {list(self.chips)}")
        if not 0 <= self.process_index < len(self.chips):
            raise ValueError(f"FleetMesh: process_index "
                             f"{self.process_index} not in "
                             f"[0, {len(self.chips)})")

    @property
    def size(self) -> int:
        """Logical chips on the ``"chip"`` axis."""
        return sum(self.chips)

    @property
    def n_processes(self) -> int:
        return len(self.chips)

    @property
    def device(self) -> torch.device:
        """This process's device."""
        return self.devices[self.process_index]

    @property
    def local_chips(self) -> list:
        """This process's chips (their places on the ``"chip"`` axis),
        in row-block order."""
        lo = sum(self.chips[:self.process_index])
        return list(range(lo, lo + self.chips[self.process_index]))


def make_fleet_mesh(n_chips: Optional[int] = None, *,
                    device: DeviceLike = None) -> FleetMesh:
    """A one-process mesh of ``n_chips`` logical chips on this rank's
    device (:func:`rank_device`; default chips: the visible CUDA
    devices for the card, 1 for the CPU). More chips than devices are
    allowed: the chips are logical and share the device's one
    programmed image."""
    dev = rank_device(device)
    if n_chips is None:
        n_chips = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_chips < 1:
        raise ValueError(f"make_fleet_mesh: n_chips must be >= 1, got "
                         f"{n_chips}")
    return FleetMesh((dev,), (int(n_chips),))


def make_distributed_fleet_mesh(chips_per_process: Optional[int] = None,
                                *, device: DeviceLike = None
                                ) -> FleetMesh:
    """A ``"chip"`` mesh spanning every rank of the process group
    (rank-major, so each rank's chips hold a contiguous row block —
    the layout :meth:`repro_torch.fleet.ShardedChip.stream_local`
    serves). Collective: every rank must call together.

    Every rank contributes the same number of chips
    (``chips_per_process``, default 1: a rank drives one device).
    The counts and devices are exchanged over the group, so every rank
    builds the same mesh from the same gathered rows — a rank-divergent
    mesh would surface later as a hang or a shape mismatch, not an
    error — and every rank raises alike when the counts differ. Without
    a group this is :func:`make_fleet_mesh`."""
    dev = rank_device(device)
    per = 1 if chips_per_process is None else int(chips_per_process)
    if process_count() == 1:
        return make_fleet_mesh(per, device=dev)
    rows = allgather(torch.tensor(
        [per, int(dev.type == "cuda"), -1 if dev.index is None
         else dev.index], dtype=torch.int64)).tolist()
    counts = [r[0] for r in rows]
    if len(set(counts)) != 1 or counts[0] < 1:
        raise ValueError(
            f"make_distributed_fleet_mesh: every process must contribute "
            f"the same number (>= 1) of chips; per-process counts: "
            f"{dict(enumerate(counts))}")
    devices = tuple(torch.device("cuda", i) if cuda else torch.device("cpu")
                    for _, cuda, i in rows)
    return FleetMesh(devices, tuple(counts), process_index=process_index())


def make_chip_submesh(mesh: FleetMesh, indices: Sequence[int]) -> FleetMesh:
    """A one-process ``"chip"`` mesh over a subset of ``mesh``'s chips —
    the heterogeneous-fleet building block (``deploy`` gives each chip
    system its own submesh of the one fleet). ``indices`` index the
    ``"chip"`` axis; every one must be a distinct chip of this process:
    a submesh is single-process, as in the reference."""
    indices = [int(i) for i in indices]
    if not indices:
        raise ValueError("make_chip_submesh: at least one chip index")
    bad = [i for i in indices if not 0 <= i < mesh.size]
    if bad:
        raise ValueError(f"make_chip_submesh: indices {bad} out of range "
                         f"for a {mesh.size}-chip mesh")
    if len(set(indices)) != len(indices):
        raise ValueError(f"make_chip_submesh: repeated indices {indices}")
    foreign = sorted(set(indices) - set(mesh.local_chips))
    if foreign:
        raise ValueError(f"make_chip_submesh: chips {foreign} belong to "
                         f"other processes; a submesh is single-process")
    return FleetMesh((mesh.device,), (len(indices),))


def mesh_spans_processes(mesh: FleetMesh) -> bool:
    """True when the mesh's chips live in more than one process — the
    signal that a fleet serves its rows rank by rank
    (``stream_local``) under a lockstep router."""
    return mesh.n_processes > 1


# ------------------------------------------------------------------- #
# the training substrate's (pod, data, model) meshes
# ------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without its ranks: what the rule
    table reads (:func:`mesh_axis_sizes`), for planning a mesh larger
    than the process group at hand."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over every rank of the group
    (rank-major, as ``jax.make_mesh`` orders devices). Collective."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if process_count() != n:
        raise ValueError(
            f"a {dict(zip(axes, shape))} mesh needs {n} ranks; this "
            f"process group has {process_count()} (launch them with "
            f"repro_torch.launch.simdev.launch_local_fleet)")
    dev = rank_device(device)
    if dev.type == "cuda":
        # before the mesh: it would otherwise pick cuda:LOCAL_RANK
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_devices: Optional[int] = None, model: int = 2, *,
                    device: DeviceLike = None):
    """A (data, model) mesh over the group's ranks — for tests and the
    launcher; ``model`` is cut to a divisor of the rank count."""
    n = n_devices or process_count()
    model = math.gcd(model, n)
    return make_mesh((n // model, model), ("data", "model"), device)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_degree(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def tp_degree(mesh) -> int:
    return mesh_axis_sizes(mesh).get("model", 1)
