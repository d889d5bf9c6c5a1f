"""Atomic, resumable checkpointing (fault-tolerance substrate).

Port of ``repro.train.checkpoint``, on the reference's on-disk layout
byte for byte, so a checkpoint written by either package restores in
the other:

  <dir>/step_<N>/                manifest.json — step, pipeline state,
                                   extra, and per leaf its shape, dtype
                                   and crc32
                                 arrays.npz — {keystr path: ndarray}
  <dir>/step_<N>.tmp-<pid>       staging; renamed atomically

A leaf's key is the string ``jax.tree_util.keystr`` gives its path
(``[0]['embed']['table']`` for the params of a ``(params, opt_state)``
tree, ``[1].step`` and ``[1].m['stack']['wq']`` for the
``AdamWState``): :mod:`repro_torch.pytree` walks a tree in JAX's order.

Guarantees, as the reference's:
  * atomicity — a checkpoint is visible iff complete: written into a
    temporary directory, published by one ``os.replace``; readers see
    only published steps, and the next save collects a crashed
    writer's staging directory;
  * resumability — ``latest_step``/``restore`` recover params,
    optimizer state and the data-pipeline state; with the pipeline's
    batch-is-a-function-of-step rule, training resumes exactly;
  * integrity — every leaf's dtype and shape are in the manifest and
    checked on restore, and a crc32 catches corruption.

Arrays are gathered to the host and stored unsharded (global arrays).
Under a process group ``save`` is collective: every rank gathers each
DTensor leaf whole (``full_tensor``, itself a collective — never on
rank 0 alone), rank 0 alone writes, and a barrier holds every rank
until the step is published. ``restore`` places each leaf on the
device of the corresponding leaf of ``tree_like``, or, given
``placements`` (a tree of DTensor placements of the same structure,
``repro_torch.sharding.tree_shardings``' output), distributes it onto
the mesh — the reference's reshard-on-load, so a run resumes on another
mesh (``train.elastic``). A save whose step is already published writes
nothing (the reference writes the staging directory, then discards it).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.pytree import flatten_with_path, tree_map, unflatten_like


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bfloat16 leaves have no numpy "
                            "dtype here; store them as float32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, *,
         pipeline_state: Optional[Dict] = None,
         extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write the checkpoint for ``step``; returns the published path.
    Collective under a process group (see the module docstring)."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not grouped:
        return _write(ckpt_dir, final, step, flatten_with_path(tree),
                      pipeline_state, extra, keep)
    from torch.distributed.tensor import DTensor

    # every rank gathers (collectives), rank 0 writes
    flat = [(path, leaf.full_tensor() if isinstance(leaf, DTensor)
             else leaf) for path, leaf in flatten_with_path(tree)]
    if dist.get_rank() == 0:
        _write(ckpt_dir, final, step, flat, pipeline_state, extra, keep)
    dist.barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int, flat, pipeline_state,
           extra, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(final):
        _gc(ckpt_dir, keep)
        return final
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)

    arrays: Dict[str, np.ndarray] = {}
    manifest = {"step": step, "pipeline": pipeline_state or {},
                "extra": extra or {}, "leaves": {}}
    for path, leaf in flat:
        arr = _to_numpy(leaf)
        arrays[path] = arr
        manifest["leaves"][path] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "crc": _crc(arr)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = published_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    # clear stale staging dirs from crashed writers
    for name in os.listdir(ckpt_dir):
        if ".tmp-" in name:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def published_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp" not in name and \
                os.path.exists(os.path.join(ckpt_dir, name,
                                            "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = published_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, tree_like, *, placements=None,
            mesh=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``: every leaf a tensor
    on the device of the corresponding ``tree_like`` leaf (the CPU where
    that leaf is no tensor, or is on ``meta``), or, given ``placements``,
    a DTensor on ``mesh`` (default: the installed one) placed so —
    reshard-on-load. Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        for keypath, like in flatten_with_path(tree_like):
            meta = manifest["leaves"][keypath]
            arr = npz[keypath]
            if list(arr.shape) != meta["shape"] or \
                    str(arr.dtype) != meta["dtype"]:
                raise ValueError(f"corrupt leaf {keypath}")
            if _crc(arr) != meta["crc"]:
                raise ValueError(f"checksum mismatch at {keypath}")
            dev = like.device if isinstance(like, torch.Tensor) and \
                like.device.type != "meta" else "cpu"
            if not arr.flags.writeable:
                arr = np.array(arr)
            leaves.append(torch.from_numpy(arr).to(dev))
    tree = unflatten_like(tree_like, leaves)
    if placements is not None:
        from repro_torch import sharding

        mesh = mesh or sharding.current_mesh()
        tree = sharding.tree_distribute(
            tree_map(lambda t: t.to(mesh.device_type), tree), placements,
            mesh)
    return tree, manifest
