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

``make_production_mesh``, ``make_debug_mesh``, ``dp_degree`` and
``tp_degree`` belong to the training substrate (ROADMAP Queue 1 item
9) and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

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
