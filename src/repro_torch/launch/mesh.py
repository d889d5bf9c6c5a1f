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

1. **gloo for the host, a staged backend or NCCL for the card.** The
   fleet's control plane — the lockstep "anything left?" reduction and
   tiny stat gathers — crosses ranks as CPU tensors on gloo, never
   request payloads or results, which stay on the rank (and the
   device) that owns them (:func:`allgather` refuses a CUDA tensor).
   The training substrate's collectives carry the card's tensors, and
   who serves them depends on how many cards the ranks have
   (:func:`group_backend`): with a card a rank, NCCL
   (``"cpu:gloo,cuda:nccl"``); when ranks share a card, where NCCL
   refuses two ranks on one device, the ``"staged"`` backend
   (``"cpu:gloo,cuda:staged"``, ``csrc/staged_backend.cpp``). gloo
   itself takes the card's tensors in the plain c10d collectives, but
   its functional all-gather of a CUDA tensor — DTensor's first
   redistribution — kills the process (torch 2.11). The staged backend
   copies each collective's tensors to pinned host buffers, runs
   gloo's own op on them, waits, and copies the results back, so a
   collective has finished when its call returns. It counts the
   bytes it copies and its seconds (:func:`staged_bytes`,
   :func:`staged_seconds`), and an op it does not implement raises,
   naming the op. It is C++ because a backend must be a
   ``c10d::Backend``: the functional collectives reach a group's
   backend from C++, never a Python ``ProcessGroup``'s methods. It is
   built at first use (:func:`build_staged_backend`), not at import.
   :func:`init_fleet_group` joins plain gloo unless asked otherwise:
   only the callers that issue DTensor's collectives on the card (the
   launcher across ranks, the sharded steps' ranks) pass
   :func:`group_backend` of their device.
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
card). Their collectives ride the group's backend for that device
(decision 1), and so do their sub-groups, which inherit the group's
backend string. The rule table
reads only a mesh's axis names and sizes (:func:`mesh_axis_sizes`), so
a :class:`MeshShape` stands in for a production mesh of 256 or 512
positions where no such group exists.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import hashlib
import importlib.util
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.build import BUILD_DIR
from repro_torch.launch.simdev import STORE_ENV
from repro_torch.runtime import DeviceLike, resolve_device


# ------------------------------------------------------------------- #
# the process group
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


STAGED = "staged"
STAGED_SOURCE = Path(__file__).resolve().parent / "csrc" / \
    "staged_backend.cpp"
_STAGED_MODULE = "repro_staged_backend"
# every staged backend this process made (one a group and sub-group)
_staged_backends: list = []


def group_backend(device: DeviceLike = None) -> str:
    """The backend string for ranks on ``device`` (decision 1): plain
    gloo for CPU ranks; for ranks on the card (``None`` is the card),
    NCCL when this host has a card for each of its ranks
    (``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``), else the staged
    backend."""
    if torch.device("cuda" if device is None else device).type == "cpu":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    cuda = "nccl" if torch.cuda.device_count() >= local else STAGED
    return f"cpu:gloo,cuda:{cuda}"


def init_fleet_group(timeout_s: float, backend: str = "gloo") -> int:
    """Join this worker's process group from the environment
    :func:`repro_torch.launch.simdev.launch_local_fleet` gives it
    (``RANK``, ``WORLD_SIZE`` and the ``file://`` store's path).
    ``timeout_s`` bounds the rendezvous and every collective: a peer
    that does not arrive within it fails the call instead of hanging
    it. ``backend``: a backend string, plain gloo (the fleet's control
    plane) unless given: :func:`group_backend` for ranks whose DTensor
    collectives carry the card's tensors, ``"cpu:staged"`` to run the
    staged backend on CPU ranks. Returns this rank."""
    import torch.distributed as dist

    if STAGED in backend:
        register_staged_backend()
    rank = int(os.environ["RANK"])
    dist.init_process_group(
        backend=backend, init_method=f"file://{os.environ[STORE_ENV]}",
        rank=rank, world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return rank


def cuda_backend(group=None) -> str:
    """The name of the backend that serves CUDA tensors in ``group``
    (the default group when None): ``"gloo"``, ``"nccl"``,
    ``"staged"``."""
    import torch.distributed as dist

    name = str(dist.get_backend(group))
    pairs = dict(p.split(":", 1) for p in name.split(",") if ":" in p)
    return pairs.get("cuda", name)


def _staged_command(out: Path) -> list:
    import sysconfig

    from torch.utils import cpp_extension

    lib = cpp_extension.library_paths()[0]
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return [os.environ.get("CXX", "c++"), "-O2", "-std=c++20", "-shared",
            "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            f"-DTORCH_EXTENSION_NAME={_STAGED_MODULE}",
            "-DTORCH_API_INCLUDE_EXTENSION_H",
            *[f"-I{p}" for p in cpp_extension.include_paths()],
            f"-I{sysconfig.get_paths()['include']}", str(STAGED_SOURCE),
            "-o", str(out), f"-L{lib}", "-lc10", "-ltorch", "-ltorch_cpu",
            "-ltorch_python", f"-Wl,-rpath,{lib}"]


def staged_library_path() -> Path:
    """Where the staged backend's module lives: keyed by its source,
    the torch it is built against and the compile command."""
    digest = hashlib.sha256(STAGED_SOURCE.read_bytes())
    digest.update(f"{torch.__version__} {sys.version}".encode())
    digest.update(" ".join(_staged_command(Path("out"))).encode())
    return BUILD_DIR / f"{_STAGED_MODULE}-{digest.hexdigest()[:12]}.so"


def build_staged_backend() -> float:
    """Compile the staged backend with the host's C++ compiler against
    this torch's headers, under ``build/repro_torch/``, unless it is
    built. Returns the seconds the build took (0.0 when it was built);
    raises with the compiler's output when it fails."""
    target = staged_library_path()
    if target.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(_staged_command(tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"repro_torch: the staged backend's build "
                           f"failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def _staged_module():
    import torch.distributed  # noqa: F401  (binds c10d's Backend type)

    build_staged_backend()
    spec = importlib.util.spec_from_file_location(_STAGED_MODULE,
                                                  staged_library_path())
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _make_staged(store, rank: int, size: int, timeout):
    import torch.distributed as dist

    host = dist.ProcessGroupGloo(dist.PrefixStore("host/", store), rank,
                                 size, timeout)
    backend = _staged_module().StagedBackend(host, rank, size)
    _staged_backends.append(backend)
    return backend


@functools.lru_cache(maxsize=None)
def register_staged_backend() -> None:
    """Make ``"staged"`` a backend name ``init_process_group`` and
    ``new_group`` take (for ``cpu`` and ``cuda`` tensors), building it
    first when it is not built. Once a process."""
    import torch.distributed as dist

    _staged_module()
    dist.Backend.register_backend(STAGED, _make_staged,
                                  devices=["cpu", "cuda"])


def staged_bytes() -> int:
    """Bytes the staged backends of this process have copied between
    the card (or, on CPU ranks, the tensors' own memory) and host
    buffers, both ways, since they were made."""
    return sum(b.staged_bytes() for b in _staged_backends)


def staged_seconds() -> float:
    """Seconds on the host's clock that the staged backends of this
    process have spent in their collectives (copies, gloo's op and its
    wait), since they were made."""
    return sum(b.staged_seconds() for b in _staged_backends)


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
