"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 200 --global-batch 8 --seq-len 128 --reduced \
      --ckpt-dir /tmp/run1 [--device cpu]

Port of ``repro.launch.train``: the reference's flags plus ``--device``
(the card unless ``cpu`` is asked for) and ``--log-every`` (the loop's
metrics cadence, 10 as the reference's). :func:`setup` builds the
model's seeded parameters on the device, AdamW with the reference's
cosine schedule (warm-up ``steps // 20``) and the procedural token
pipeline; :func:`main` runs them through the fault-tolerant train loop
(auto-resume, atomic checkpoints, straggler watchdog). ``--reduced``
takes the width-scaled config (``configs.get_reduced``).

One card has no mesh: ``--model-parallel`` above 1 raises, naming the
sharding slice (ROADMAP Queue 1 item 9), and the data-parallel degree
is 1.

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


def setup(args: argparse.Namespace) -> Dict[str, Any]:
    """Everything a run of ``args`` trains with: the config, device,
    optimizer, pipeline, seeded parameters and optimizer state, the
    train step and its microbatch count, and the loop's config."""
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs a device mesh; tensor parallelism "
            "belongs to the sharding slice (ROADMAP Queue 1 item 9)")
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime import resolve_device
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.train_loop import TrainLoopConfig

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt = AdamW(lr=cosine_schedule(args.lr, max(args.steps // 20, 1),
                                   args.steps))
    params = model_lib.init_params(cfg, args.seed, device=dev)
    step, accum = steps_lib.make_train_step(
        cfg, opt, global_batch=args.global_batch, dp=1)
    return {"cfg": cfg, "device": dev, "optimizer": opt,
            "pipeline": TokenPipeline(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq_len,
                                      global_batch=args.global_batch,
                                      seed=args.seed),
            "params": params, "opt_state": opt.init(params),
            "train_step": step, "accum": accum,
            "loop": TrainLoopConfig(total_steps=args.steps,
                                    ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every,
                                    log_every=args.log_every)}


def main(argv=None):
    from repro_torch.train.train_loop import run

    args = parse_args(argv)
    s = setup(args)
    print(f"device: {s['device']} (dp=1, tp=1); arch={s['cfg'].name}"
          f"{' (reduced)' if args.reduced else ''}", flush=True)
    out = run(s["loop"], train_step=s["train_step"], params=s["params"],
              opt_state=s["opt_state"], pipeline=s["pipeline"],
              log_path=args.log or None,
              on_straggler=lambda st, dt: print(
                  f"[watchdog] step {st} straggled: {dt:.3f}s"))
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
