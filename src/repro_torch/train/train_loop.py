"""Train loop: auto-resume, atomic checkpoints, straggler watchdog,
metrics stream.

Port of ``repro.train.train_loop``. The loop is thin: every step is the
``train_step`` of :mod:`repro_torch.train.steps`. A step's time is taken
on the host's clock after a synchronise of the loss's device (the
reference's ``jax.block_until_ready``), so it covers the card's work.

  * crash/restart → ``latest_step`` + exact pipeline resume;
  * stragglers → the watchdog flags steps slower than
    ``straggler_factor ×`` the rolling median; the hook is where a
    fleet controller would evict or replace the slow host — here it
    logs and counts.

``placements=`` (the reference's ``shardings=``) reshards a resumed
checkpoint onto the installed mesh; without it a restore places each
leaf on the device of the leaf it replaces. Under a process group every
rank runs the loop, and its checkpoints are collective
(``checkpoint.save``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 32


@dataclasses.dataclass
class StragglerWatchdog:
    factor: float
    window: int
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if dt > self.factor * med:
                self.flagged += 1
                return True
        return False


def _wait(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run(loop_cfg: TrainLoopConfig, *, train_step: Callable,
        params, opt_state, pipeline: TokenPipeline,
        placements=None, log_path: Optional[str] = None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
        on_checkpoint: Optional[Callable[[int, float], None]] = None
        ) -> Dict[str, Any]:
    """Run (or resume) training; returns final state + stats.
    ``on_checkpoint(step, seconds)`` follows each save, with its wall
    on the host's clock."""
    start = 0
    latest = ckpt_lib.latest_step(loop_cfg.ckpt_dir)
    if latest is not None:
        (params, opt_state), manifest = ckpt_lib.restore(
            loop_cfg.ckpt_dir, latest, (params, opt_state),
            placements=placements)
        start = manifest["step"]
        if manifest["pipeline"].get("seed", pipeline.seed) != \
                pipeline.seed:
            raise ValueError("resume with a different data seed")

    def save(at: int) -> None:
        t0 = time.perf_counter()
        ckpt_lib.save(loop_cfg.ckpt_dir, at, (params, opt_state),
                      pipeline_state=pipeline.state(at).as_dict(),
                      keep=loop_cfg.keep)
        if on_checkpoint is not None:
            on_checkpoint(at, time.perf_counter() - t0)

    watchdog = StragglerWatchdog(loop_cfg.straggler_factor,
                                 loop_cfg.straggler_window)
    logf = open(log_path, "a") if log_path else None
    metrics_hist: List[Dict] = []
    try:
        for step in range(start, loop_cfg.total_steps):
            batch = pipeline.batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch)
            _wait(metrics["loss"])
            dt = time.perf_counter() - t0

            if watchdog.observe(dt) and on_straggler is not None:
                on_straggler(step, dt)

            if step % loop_cfg.log_every == 0 or \
                    step == loop_cfg.total_steps - 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step, step_time_s=round(dt, 4))
                metrics_hist.append(rec)
                if logf:
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()

            if loop_cfg.ckpt_every and \
                    (step + 1) % loop_cfg.ckpt_every == 0:
                save(step + 1)

        if loop_cfg.ckpt_every:
            save(loop_cfg.total_steps)
    finally:
        if logf:
            logf.close()
    return {"params": params, "opt_state": opt_state,
            "metrics": metrics_hist, "stragglers": watchdog.flagged,
            "resumed_from": latest}
