"""Multi-pod dry run: one step of every (architecture × input shape ×
mesh) cell, counted on a fake mesh, allocating nothing.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell's step with 512 placeholder XLA devices and reads XLA's memory and
cost analyses. The port runs the step itself, eagerly, on the rank 0
of a ``"fake"`` process group of the mesh's size (256 or 512: every
collective returns at once and sends nothing), over a real
``DeviceMesh`` built by :mod:`repro_torch.launch.mesh`:

  * parameters, AdamW state, batch and caches are DTensors whose local
    shards lie on the ``meta`` device (shapes, dtypes and strides, no
    storage), placed by :mod:`repro_torch.launch.specs` and the rule
    table of :mod:`repro_torch.launch.rules`, exactly as a sharded step
    places them. ``meta`` rather than ``FakeTensorMode``: under a fake
    mode DTensor's own bookkeeping (the offsets of a strided shard,
    which it computes with tensors and reads back) is faked too and
    fails, where on ``meta`` it runs on the host as it would on a rank;
  * one train, prefill or decode step of :mod:`repro_torch.train.steps`
    runs under three counters: :func:`roofline.device_flop_counter`
    (FLOPs of this rank's local products), :class:`roofline.
    CollectiveCounter` (the collectives DTensor issues, charged by the
    ring model) and ``torch.distributed._tools.mem_tracker.MemTracker``
    (the live bytes of this rank's storages; its peak, with the
    parameters, optimizer state and inputs, is the cell's peak).

The eager run goes through every layer, so the FLOPs and collectives
are counted in full: the reference's finite-difference extrapolation
over unrolled depths is not needed, and ``counting_run.method`` reads
``"full-run"``. ``lower_s`` is the time to place the cell's inputs and
``compile_s`` the counted run's, both on the host.

The fake group is process-global: one process dry-runs one mesh size
at a time (:func:`fake_group` re-forms it when the size changes), and
tests run the dry run in a subprocess.

Usage:
  python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --reduced          # every reduced cell, ~minutes
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --mesh single # one full-width cell

JSON goes to ``--out`` (default ``build/dryrun``, ignored by git; the
reference's committed ``experiments/dryrun`` is not written).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Tuple

DEFAULT_OUT = "build/dryrun"


# --------------------------------------------------------------------- #
# the fake group and its meshes
# --------------------------------------------------------------------- #
def fake_group(n: int) -> None:
    """Make this process rank 0 of a ``"fake"`` group of ``n`` ranks
    (re-formed when it has another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over a fake group of its size."""
    from repro_torch.launch import mesh as mesh_lib

    fake_group(math.prod(shape))
    return mesh_lib.make_mesh(tuple(shape), tuple(axes), "cpu")


def production_mesh(multi: bool):
    """The reference's 16×16 (data, model) or 2×16×16 (pod, data,
    model) mesh over a fake group of 256 or 512 ranks."""
    from repro_torch.launch import mesh as mesh_lib

    fake_group(512 if multi else 256)
    return mesh_lib.make_production_mesh(multi_pod=multi, device="cpu")


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.shape))


# --------------------------------------------------------------------- #
# one cell
# --------------------------------------------------------------------- #
def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch.pytree import leaves

    total = 0
    for x in leaves(tree):
        t = x.to_local() if isinstance(x, DTensor) else x
        total += t.numel() * t.element_size()
    return total


def _cell_inputs(cfg, shape_cfg, mesh, shape):
    """(step, args, accum) of the cell: its step function and its
    ``meta`` inputs, placed as a sharded step places them (on ``mesh``;
    not at all when it is None, ``shape`` standing in for it)."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.rules import effective_dp
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.sharding import tree_distribute
    from repro_torch.train import steps as steps_lib

    mode = shape_cfg.kind
    placed = mesh is not None

    def place(tree, where):
        return tree_distribute(tree, where, mesh) if placed else tree

    psh = specs_lib.param_shardings(cfg, mesh) if placed else None
    params = specs_lib.param_shapes(cfg)
    if mode == "train":
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        params, state = place(
            (params, opt.init(params)),
            (psh, specs_lib.opt_shardings(psh, mesh) if placed else None))
        bshapes, _ = specs_lib.batch_specs(cfg, shape_cfg, shape,
                                           with_labels=True)
        # the batch is every rank's whole (the seeded pipeline's)
        step, accum = steps_lib.make_train_step(
            cfg, opt, global_batch=shape_cfg.global_batch,
            dp=effective_dp(cfg, mesh) if placed else 1)
        return step, (params, state, bshapes), accum
    params = place(params, psh)
    if mode == "prefill":
        bshapes, bsh = specs_lib.batch_specs(cfg, shape_cfg, shape,
                                             with_labels=False)
        return (steps_lib.make_prefill_step(cfg),
                (params, place(bshapes, bsh)), 1)
    (cshape, tshape, pshape), (cshard, tshard, pshard) = \
        specs_lib.decode_specs(cfg, shape_cfg, shape)
    return (steps_lib.make_decode_step(cfg),
            (params, place(cshape, cshard), place(tshape, tshard),
             place(pshape, pshard)), 1)


@contextlib.contextmanager
def _shape_inference_uncounted():
    """DTensor infers an op's output shape by running the op once at its
    global shape under a fake mode. That is not this rank's work: the
    counters are suspended while it runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def uncounted(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = uncounted
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def count_step(step, args, *, mesh, rules):
    """Run ``step(*args)`` once under the three counters → (flops per
    device, CollectiveStats, peak live bytes per device on the
    arguments' device, argument bytes per device, seconds)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import roofline
    from repro_torch.pytree import leaves
    from repro_torch.sharding import axis_rules

    arg_leaves = leaves(args)
    mt = MemTracker()
    mt.track_external(*arg_leaves)
    flops = roofline.device_flop_counter()
    coll = roofline.CollectiveCounter()
    t0 = time.perf_counter()
    with axis_rules(mesh, rules), _shape_inference_uncounted(), mt, \
            flops, coll:
        out = step(*args)
    seconds = time.perf_counter() - t0
    del out
    dev = next(x.device for x in arg_leaves)
    snap = mt.get_tracker_snapshot("peak")
    peak = snap[dev]["Total"] if dev in snap else 0
    return (float(flops.get_total_flops()), coll.stats, int(peak),
            _local_bytes(args), seconds)


def lower_cell(cfg, shape_cfg, mesh, *, verbose: bool = True) -> dict:
    """Place and run one cell's step on ``mesh`` (a ``DeviceMesh`` over
    a fake group) under the counters; returns the reference's result
    dict. ``mesh=None`` is one device: the one-process step, with no
    placement at all (what one card runs). The eager run counts every
    layer, so there is no separate counting variant."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline
    from repro_torch.launch.rules import effective_dp, kv_repeat_for, \
        make_rules
    from repro_torch.sharding import axis_rules

    shape = mesh if mesh is not None else \
        mesh_lib.MeshShape(("data", "model"), (1, 1))
    n_dev = math.prod(shape.shape)
    tp = mesh_lib.tp_degree(shape)
    cfg = cfg.replace(kv_repeat=kv_repeat_for(cfg, tp))
    dp = effective_dp(cfg, shape)
    mode = shape_cfg.kind
    rules = make_rules(cfg, shape, mode,
                       global_batch=shape_cfg.global_batch) \
        if mesh is not None else {}
    t0 = time.perf_counter()
    with axis_rules(mesh, rules):
        step, args, accum = _cell_inputs(cfg, shape_cfg, mesh, shape)
        t_lower = time.perf_counter() - t0
        # the parameters (and the optimizer state) on this rank
        state_bytes = _local_bytes(args[:2] if mode == "train" else args[0])
        flops_dev, coll, peak, arg_bytes, t_run = count_step(
            step, args, mesh=mesh, rules=rules)
        del args, step
    bytes_dev = roofline.analytic_memory_bytes(
        cfg, shape_cfg, n_devices=n_dev, dp=dp, tp=tp, accum=accum)
    tt = roofline.terms(flops_dev, bytes_dev, coll.wire_bytes)
    mf = roofline.model_flops(cfg, shape_cfg)
    total = flops_dev * n_dev
    res = {
        "arch": cfg.name, "shape": shape_cfg.name, "mode": mode,
        "mesh": _mesh_name(shape),
        "axes": list(mesh.mesh_dim_names) if mesh is not None else [],
        "n_devices": n_dev,
        "grad_accum": accum,
        "kv_repeat": cfg.kv_repeat,
        "counting": True,
        "lower_s": t_lower, "compile_s": t_run,
        "memory": {"argument_bytes": arg_bytes,
                   "state_bytes": state_bytes,
                   "temp_bytes": max(peak - arg_bytes, 0),
                   "peak_bytes_per_device": max(peak, arg_bytes)},
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev},
        "collectives": {"wire_bytes_per_device": coll.wire_bytes,
                        "raw_bytes_per_device": coll.raw_bytes,
                        "by_op": coll.by_op, "counts": coll.counts,
                        "source": "full-run"},
        "counting_run": {"method": "full-run", "flops_dev": flops_dev,
                         "wire_bytes_dev": coll.wire_bytes,
                         "by_op": coll.by_op, "counts": coll.counts,
                         "compile_s": t_run},
        "roofline": tt,
        "model_flops": mf,
        "hlo_flops_total": total,
        "useful_flops_frac": (mf / total) if total else None,
        "status": "ok",
    }
    if verbose:
        gib = res["memory"]["peak_bytes_per_device"] / 2**30
        useful = res["useful_flops_frac"]
        print(f"  {cfg.name:>22s} {shape_cfg.name:>12s} {res['mesh']:>9s} "
              f"run={t_run:6.1f}s peak={gib:8.3f}GiB "
              f"dom={tt['dominant']:<10s} bound={tt['bound_s']*1e3:9.3f}ms "
              f"useful={useful and round(useful, 3)}",
              flush=True)
    return res


def counting_terms(cfg, shape_cfg, mesh, *, verbose: bool = True) -> dict:
    """The cell's counted FLOPs and collectives (``counting_run``): one
    full eager run, so no extrapolation over depth."""
    return lower_cell(cfg, shape_cfg, mesh, verbose=verbose)["counting_run"]


def lower_cell_full(cfg, shape_cfg, mesh, *, verbose: bool = True,
                    with_counting: bool = True) -> dict:
    """The cell's result with its roofline terms. The one eager run
    gives both the memory fit and the counts, so ``with_counting`` only
    says whether the roofline keys are kept (the reference keeps them
    for single-pod cells alone)."""
    res = lower_cell(cfg, shape_cfg, mesh, verbose=verbose)
    if not with_counting:
        for k in ("counting_run", "roofline"):
            res.pop(k)
    return res


# --------------------------------------------------------------------- #
# the sweep
# --------------------------------------------------------------------- #
def run_cell(arch: str, shape_name: str, multi: bool, *, reduced: bool,
             out: Optional[Path] = None, force: bool = False,
             verbose: bool = True) -> dict:
    """One cell of the sweep, on its production mesh: its result, a
    skip with ``applicable``'s reason, or an error (recorded, not
    raised). Written to ``out/<arch>__<shape>__<single|multi>.json``
    when ``out`` is given (an existing file is kept unless ``force``)."""
    from repro_torch.configs import SHAPES_BY_NAME, applicable, \
        get_config, get_reduced

    tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
    path = None if out is None else out / f"{tag}.json"
    if path is not None and path.exists() and not force:
        return json.loads(path.read_text())
    cfg = get_reduced(arch) if reduced else get_config(arch)
    shape_cfg = SHAPES_BY_NAME[shape_name]
    ok, reason = applicable(cfg, shape_cfg)
    mesh_name = "2x16x16" if multi else "16x16"
    if not ok:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skip", "reason": reason}
        if verbose:
            print(f"  {arch:>22s} {shape_name:>12s} SKIP: {reason}",
                  flush=True)
    else:
        try:
            # single-pod cells carry the roofline; multi-pod cells prove
            # shardability and fit, as the reference's do
            res = lower_cell_full(cfg, shape_cfg, production_mesh(multi),
                                  verbose=verbose, with_counting=not multi)
        except Exception as e:  # noqa: BLE001 - record, keep going
            res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-4000:]}
            if verbose:
                print(f"  {arch:>22s} {shape_name:>12s} ERROR: {e!r}",
                      flush=True)
    if path is not None:
        path.write_text(json.dumps(res, indent=1))
    return res


def main(argv=None):
    from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--reduced", action="store_true",
                    help="use reduced configs (CI smoke)")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have JSON")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES_BY_NAME) if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    # one mesh size at a time: the fake group is process-global
    for multi in meshes:
        for arch in archs:
            for shape_name in shapes:
                res = run_cell(arch, shape_name, multi,
                               reduced=args.reduced, out=outdir,
                               force=args.force)
                n_fail += res["status"] == "error"
    with contextlib.suppress(Exception):
        import torch.distributed as dist
        dist.destroy_process_group()
    print(f"dry-run complete; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
