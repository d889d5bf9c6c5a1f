"""Localhost multi-process fleets: spawn and supervise one worker per rank.

Port of the process half of ``repro.launch.simdev``. A fleet of ranks
runs as fresh interpreters, one per rank — never ``fork``: a parent
that has initialised CUDA cannot fork safely — and the ranks that form
a lockstep fleet join one gloo process group
(:func:`repro_torch.launch.mesh.init_fleet_group`) through a
``file://`` store in a temporary directory made fresh for each launch.
No TCP port is picked here and bound later by a worker, so launches
running side by side (a test run under xdist) cannot race for one.

  * :func:`launch_local_fleet` — spawn the workers and babysit them:
    with ``on_failure="kill"`` the moment ANY worker dies the
    survivors are terminated (a rank blocked in a collective or in the
    rendezvous waiting for a dead peer would otherwise wait out the
    group's timeout); ``kill_at`` injects a SIGKILL at a chosen
    serving step for the chaos harness.
  * :func:`board_path` / :func:`read_board` — the heartbeat-board file
    convention shared with :mod:`repro_torch.fleet.ha`.
  * :func:`last_json_line` — the subprocess result convention.

The reference's ``simulated_device_env`` / ``run_simulated`` pin XLA's
simulated CPU device count into a child's environment before jax
initialises. Torch has no such setting — a rank's logical chips are
folded into its batch (:mod:`repro_torch.fleet.shard`) — so they have
no counterpart here. Nothing here imports torch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

# the directory holding the ``repro_torch`` package (…/src) — children
# get it on PYTHONPATH so they run from any cwd
SRC_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_ROOT = os.path.dirname(SRC_DIR)

# the rendezvous a worker reads (besides RANK, WORLD_SIZE, LOCAL_RANK)
STORE_ENV = "REPRO_DIST_STORE"        # the file:// store's path
CHIPS_ENV = "REPRO_DIST_CHIPS"        # logical chips per rank
HA_DIR_ENV = "REPRO_FLEET_HA_DIR"     # heartbeat-board directory


def last_json_line(stdout: str) -> dict:
    """Parse the last JSON line of a subprocess's stdout — the
    convention every subprocess here uses to report results past its
    own chatter (scans backwards, so trailing log lines don't break
    the contract)."""
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    for ln in reversed(lines):
        if ln.lstrip().startswith("{"):
            return json.loads(ln)
    raise ValueError("subprocess emitted no JSON result line")


# ------------------------------------------------------------------- #
# heartbeat-board file convention (shared with repro_torch.fleet.ha)
# ------------------------------------------------------------------- #
# The HA layer's heartbeat board is one JSON file per rank in a shared
# directory; the FILENAME and the ``"step"`` field are the only parts
# the supervisor needs — it polls them to inject a worker kill at a
# chosen serving step. The full payload schema lives with the writer,
# repro_torch.fleet.ha.HeartbeatBoard, which imports these helpers so
# the convention cannot fork. It is the reference's convention, file
# for file: either package reads the other's boards.
def board_path(root: str, rank: int) -> str:
    """Path of one rank's heartbeat file."""
    return os.path.join(root, f"rank_{int(rank)}.json")


def read_board(root: str, rank: int) -> Optional[dict]:
    """Read one rank's latest heartbeat payload; None when the rank
    has not published yet (writers replace atomically, so a payload is
    either absent or complete)."""
    try:
        with open(board_path(root, rank)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


@dataclasses.dataclass
class WorkerResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str
    killed: bool = False          # terminated by supervisor cleanup
    injected: bool = False        # SIGKILLed on purpose (chaos kill_at)

    @property
    def crashed(self) -> bool:
        """Died on its own (nonzero exit the supervisor neither
        injected nor caused by cleanup) — the clean-exit/crash
        distinction the chaos harness keys on."""
        return (not self.killed and not self.injected
                and self.returncode not in (0, None))

    @property
    def stderr_tail(self) -> str:
        """The last few stderr lines — what a failure report wants."""
        return "\n".join(self.stderr.strip().splitlines()[-8:])


def launch_local_fleet(argv: Sequence[str], n_processes: int, *,
                       chips_per_process: int = 1,
                       timeout: float = 600.0,
                       extra_env: Optional[Dict[str, str]] = None,
                       poll_s: float = 0.2,
                       on_failure: str = "kill",
                       kill_at: Optional[Sequence[int]] = None,
                       ha_dir: Optional[str] = None
                       ) -> List[WorkerResult]:
    """Spawn ``n_processes`` localhost workers and supervise them to
    completion.

    Each worker runs ``argv`` (e.g. ``[sys.executable, "-m",
    "repro_torch.fleet", "--distributed-worker"]``) in a fresh
    interpreter, with this process's environment plus ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` (every rank is on this host, so
    gloo is pointed at the loopback), the ``file://`` store's path, the
    logical chips a rank, the board directory when there is one,
    ``extra_env``, and this tree's ``src`` on ``PYTHONPATH``. The store
    lives in a temporary directory made for this launch and removed
    after it.

    ``on_failure`` picks the supervision contract:

    * ``"kill"`` (default): the moment ANY worker exits non-zero — or
      the deadline passes — every survivor is terminated instead of
      being left blocked on a collective (or the rendezvous) that can
      never complete.
    * ``"continue"``: a worker death is an EVENT, not a shutdown —
      survivors run on (the HA serve loop's degraded mode); only the
      deadline terminates stragglers. :attr:`WorkerResult.crashed`
      and :attr:`WorkerResult.stderr_tail` tell clean exits from
      crashes afterwards.

    ``kill_at=(rank, step)`` is the chaos-injection primitive: the
    supervisor polls ``rank``'s heartbeat file under ``ha_dir`` (see
    :func:`read_board`) and SIGKILLs the worker the moment its
    published ``"step"`` reaches ``step`` — a real external crash
    mid-serve, not a cooperative exit. The injected kill is marked
    ``injected`` (not ``crashed``) and under ``"continue"`` does not
    shut the fleet down.

    Worker stdout/stderr are staged in temp files, never pipes, so a
    chatty worker cannot deadlock the supervisor. Every worker is
    ended before this returns.
    """
    if on_failure not in ("kill", "continue"):
        raise ValueError(f"on_failure must be 'kill' or 'continue', "
                         f"got {on_failure!r}")
    if kill_at is not None:
        kill_rank, kill_step = int(kill_at[0]), int(kill_at[1])
        if not 0 <= kill_rank < n_processes:
            raise ValueError(f"kill_at rank {kill_rank} not in "
                             f"[0, {n_processes})")
        if ha_dir is None:
            raise ValueError("kill_at needs ha_dir: the supervisor "
                             "watches the victim's heartbeat file to "
                             "time the kill")
    if chips_per_process < 1:
        raise ValueError(f"chips_per_process must be >= 1, got "
                         f"{chips_per_process}")
    store_dir = tempfile.mkdtemp(prefix="repro_torch_fleet_")
    store = os.path.join(store_dir, "store")
    procs: List[subprocess.Popen] = []
    outs, errs = [], []
    results: List[Optional[WorkerResult]] = [None] * n_processes
    injected = [False] * n_processes
    try:
        base = dict(os.environ)
        path = base.get("PYTHONPATH", "")
        if SRC_DIR not in path.split(os.pathsep):
            base["PYTHONPATH"] = SRC_DIR + (os.pathsep + path if path
                                            else "")
        base.setdefault("GLOO_SOCKET_IFNAME", "lo")
        base.update({"WORLD_SIZE": str(n_processes), STORE_ENV: store,
                     CHIPS_ENV: str(int(chips_per_process))})
        if ha_dir is not None:
            base[HA_DIR_ENV] = ha_dir
        for rank in range(n_processes):
            env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank),
                       **(extra_env or {}))
            out = tempfile.TemporaryFile(mode="w+t")
            err = tempfile.TemporaryFile(mode="w+t")
            outs.append(out)
            errs.append(err)
            procs.append(subprocess.Popen(
                list(argv), stdout=out, stderr=err, text=True, env=env,
                cwd=REPO_ROOT))

        deadline = time.monotonic() + timeout
        failed = False
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if kill_at is not None and not injected[kill_rank] and \
                    codes[kill_rank] is None:
                beat = read_board(ha_dir, kill_rank)
                if beat is not None and \
                        beat.get("step", -1) >= kill_step:
                    procs[kill_rank].kill()      # SIGKILL: a crash
                    injected[kill_rank] = True
            uninjected_death = any(
                c is not None and c != 0 and not injected[i]
                for i, c in enumerate(codes))
            if time.monotonic() > deadline:
                failed = True
                break
            if on_failure == "kill" and (
                    uninjected_death or
                    any(injected[i] and c is not None
                        for i, c in enumerate(codes))):
                failed = True
                break
            time.sleep(poll_s)

        killed = [False] * n_processes
        if failed:
            for i, p in enumerate(procs):
                if p.poll() is None:
                    killed[i] = True
                    p.terminate()
            grace = time.monotonic() + 10.0
            for p in procs:
                while p.poll() is None and time.monotonic() < grace:
                    time.sleep(poll_s)
                if p.poll() is None:
                    p.kill()
                    p.wait()

        for rank, p in enumerate(procs):
            outs[rank].seek(0)
            errs[rank].seek(0)
            results[rank] = WorkerResult(
                rank=rank, returncode=p.returncode,
                stdout=outs[rank].read(), stderr=errs[rank].read(),
                killed=killed[rank], injected=injected[rank])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs + errs:
            f.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return results  # type: ignore[return-value]

