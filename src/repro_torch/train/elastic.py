"""Elastic scaling: resume a job on a different rank count/topology.

Port of ``repro.train.elastic``. Because (a) checkpoints store unsharded
global arrays and (b) a batch is a pure function of (seed, step),
elasticity reduces to:

  1. build the *new* mesh from whatever ranks exist now,
  2. re-derive placements from the same logical rules on that mesh,
  3. ``restore(..., placements=new)`` — reshard-on-load,
  4. continue from the manifest's step; the data pipeline yields the
     identical global batch stream.

``remesh()`` packages 1–3. A mesh here spans the ranks of the process
group (one rank a mesh position), so a job that lost ranks restarts as
fewer processes and calls ``remesh`` in each; both functions are
collective. ``tests/test_torch_elastic.py`` runs 8 ranks, checkpoints,
and resumes on 4, checking the loss trajectory is unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.rules import make_rules
from repro_torch.runtime import DeviceLike
from repro_torch.sharding import axis_rules
from repro_torch.train import checkpoint as ckpt_lib


def best_mesh_for(n_devices: int, model_parallel: int = 1, *,
                  device: DeviceLike = None):
    """Largest (data, model) mesh for the surviving rank count."""
    model = math.gcd(model_parallel, n_devices)
    return mesh_lib.make_mesh((n_devices // model, model),
                              ("data", "model"), device)


def remesh(ckpt_dir: str, step: Optional[int], cfg, *,
           mesh=None, mode: str = "train",
           global_batch: int = 8) -> Tuple[Any, Any, Any, int]:
    """Restore (params, opt_state) against a fresh mesh; returns
    (params, opt_state, mesh, step)."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.optim.adamw import AdamW, constant_schedule

    if step is None:
        step = ckpt_lib.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    mesh = mesh or best_mesh_for(mesh_lib.process_count())
    rules = make_rules(cfg, mesh, mode, global_batch=global_batch)
    with axis_rules(mesh, rules):
        psh = specs_lib.param_shardings(cfg, mesh)
        pshapes = specs_lib.param_shapes(cfg)
        opt = AdamW(lr=constant_schedule(1e-3))
        oshapes = specs_lib.opt_shapes(cfg, opt, pshapes)
        osh = specs_lib.opt_shardings(psh, mesh)
    (params, opt_state), manifest = ckpt_lib.restore(
        ckpt_dir, step, (pshapes, oshapes), placements=(psh, osh),
        mesh=mesh)
    return params, opt_state, mesh, manifest["step"]
