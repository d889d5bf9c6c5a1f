"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 200 --global-batch 8 --seq-len 128 --reduced \
      --ckpt-dir /tmp/run1 [--device cpu] [--model-parallel 2]

Port of ``repro.launch.train``: the reference's flags plus ``--device``
(the card unless ``cpu`` is asked for) and ``--log-every`` (the loop's
metrics cadence, 10 as the reference's). Each checkpoint save prints
its seconds. :func:`setup` builds the
model's seeded parameters on the device, AdamW with the reference's
cosine schedule (warm-up ``steps // 20``) and the procedural token
pipeline; :func:`main` runs them through the fault-tolerant train loop
(auto-resume, atomic checkpoints, straggler watchdog). ``--reduced``
takes the width-scaled config (``configs.get_reduced``).

A process that is one rank of a group (``WORLD_SIZE`` > 1, as
``repro_torch.launch.simdev.launch_local_fleet`` starts it: every rank
runs this launcher with the same flags) joins the process group and
builds ``make_debug_mesh(model=--model-parallel)`` over the ranks, sets
``kv_repeat`` for the mesh's TP degree, derives the rule table and
places the parameters and AdamW state as DTensors; every rank runs the
loop, and checkpoints are gathered on every rank and written by rank 0.
It prints ``mesh: {...} (dp=…, tp=…)`` as the reference does. Every
family's sharded step is held to one process's (``SHARDED_FAMILIES``:
the dense, vlm and audio stacks, and the MoE, hybrid and xLSTM
stacks). Ranks on the CPU (``--device cpu``) join a gloo group; ranks
on the card (the default) join the group ``launch.mesh.group_backend``
chooses: the staged backend where they share a card (their
collectives go through pinned host buffers), NCCL where each has a
card of its own. One process has no mesh, and there
``--model-parallel`` above 1 raises, naming the ranks it would need.

One deliberate difference: the pipeline draws tokens over the model's
vocab (``cfg.vocab_size``). The reference draws over ``padded_vocab``,
so where the config pads its vocab (qwen1.5-0.5B: 151,936 → 152,064)
some labels fall in the pad columns, whose logits ``cross_entropy``
masks to -1e30, and each adds 1e30 to the loss (ROADMAP R9). Where the
vocab is not padded (the reduced configs) the two are the same.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


# seconds a rank waits for a peer in the rendezvous or a collective
GROUP_TIMEOUT_S = 300.0
# the families whose sharded step is held to one process's (ROADMAP 9h)
SHARDED_FAMILIES = ("dense", "vlm", "audio", "moe", "hybrid", "ssm")


def _ranks() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def setup(args: argparse.Namespace) -> Dict[str, Any]:
    """Everything a run of ``args`` trains with: the config, device,
    optimizer, pipeline, seeded parameters and optimizer state, the
    train step and its microbatch count, and the loop's config; under
    a group also the mesh, its rule table and the placements a resumed
    checkpoint is distributed to (None on one process). Joins the group
    when there is one."""
    ranks = _ranks()
    if ranks == 1 and args.model_parallel > 1:
        raise ValueError(
            f"--model-parallel {args.model_parallel} needs a (data, "
            f"model) mesh of at least {args.model_parallel} ranks; this "
            f"process is not one rank of a group (start the ranks with "
            f"repro_torch.launch.simdev.launch_local_fleet)")
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.train_loop import TrainLoopConfig

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if ranks > 1 and cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"{args.arch} across ranks: the {cfg.family} family's sharded "
            f"step is not checked yet (ROADMAP item 9h)")
    dev = mesh_lib.rank_device(args.device)
    opt = AdamW(lr=cosine_schedule(args.lr, max(args.steps // 20, 1),
                                   args.steps))
    mesh, rules, placements, sizes = None, {}, None, {"data": 1}
    if ranks > 1:
        from repro_torch.launch import specs as specs_lib
        from repro_torch.launch.rules import kv_repeat_for, make_rules
        from repro_torch.sharding import axis_rules, tree_distribute

        mesh_lib.init_fleet_group(GROUP_TIMEOUT_S,
                                  backend=mesh_lib.group_backend(dev))
        mesh = mesh_lib.make_debug_mesh(model=args.model_parallel,
                                        device=dev)
        sizes = mesh_lib.mesh_axis_sizes(mesh)
        cfg = cfg.replace(kv_repeat=kv_repeat_for(
            cfg, mesh_lib.tp_degree(mesh)))
        rules = make_rules(cfg, mesh, "train",
                           global_batch=args.global_batch)
        with axis_rules(mesh, rules):
            psh = specs_lib.param_shardings(cfg, mesh)
            placements = (psh, specs_lib.opt_shardings(psh, mesh))
            # every rank draws the same full tree, then keeps its shards
            whole = model_lib.init_params(cfg, args.seed, device=dev)
            params, opt_state = tree_distribute(
                (whole, opt.init(whole)), placements, mesh)
            del whole
        step, accum = steps_lib.make_train_step(
            cfg, opt, global_batch=args.global_batch,
            dp=mesh_lib.dp_degree(mesh))
    else:
        params = model_lib.init_params(cfg, args.seed, device=dev)
        opt_state = opt.init(params)
        step, accum = steps_lib.make_train_step(
            cfg, opt, global_batch=args.global_batch, dp=1)
    return {"cfg": cfg, "device": dev, "optimizer": opt,
            "pipeline": TokenPipeline(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq_len,
                                      global_batch=args.global_batch,
                                      seed=args.seed),
            "params": params, "opt_state": opt_state,
            "train_step": step, "accum": accum, "mesh": mesh,
            "mesh_sizes": sizes, "rules": rules, "placements": placements,
            "loop": TrainLoopConfig(total_steps=args.steps,
                                    ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every,
                                    log_every=args.log_every)}


def main(argv=None):
    from repro_torch.sharding import axis_rules
    from repro_torch.train.train_loop import run

    args = parse_args(argv)
    s = setup(args)
    sizes = s["mesh_sizes"]
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    tp = sizes.get("model", 1)
    grouped = _ranks() > 1
    where = f"mesh: {sizes}" if grouped else f"device: {s['device']}"
    # the ranks' metrics are equal: rank 0 alone appends them to the log
    log = args.log if args.log and (not grouped or
                                    int(os.environ["RANK"]) == 0) else None
    print(f"{where} (dp={dp}, tp={tp}); arch={s['cfg'].name}"
          f"{' (reduced)' if args.reduced else ''}", flush=True)
    with axis_rules(s["mesh"], s["rules"]):
        out = run(s["loop"], train_step=s["train_step"], params=s["params"],
                  opt_state=s["opt_state"], pipeline=s["pipeline"],
                  placements=s["placements"], log_path=log,
                  on_straggler=lambda st, dt: print(
                      f"[watchdog] step {st} straggled: {dt:.3f}s"),
                  on_checkpoint=lambda st, dt: print(
                      f"[checkpoint] step {st} saved in {dt:.3f}s",
                      flush=True))
    hist = out["metrics"]
    if hist:
        print(f"steps {hist[0]['step']}→{hist[-1]['step']}: "
              f"loss {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f} "
              f"(resumed_from={out['resumed_from']}, "
              f"stragglers={out['stragglers']}, accum={s['accum']})",
              flush=True)
    return out


if __name__ == "__main__":
    main()
