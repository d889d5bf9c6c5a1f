"""Smoke entry point for the LM tenant stack.

``PYTHONPATH=src python -m repro_torch.lm --selftest`` — one process,
``--chips N`` logical chips (default 2), on the card unless
``--device cpu`` is given. What it pins (the reference selftest's
checks):

  * ``compile_lm`` on the width-scaled qwen config matches the dense
    ``models/model.py`` forward at rel ≤ 1e-6 (1e-5 on the card, where
    the crossbar kernel runs 3×TF32) — prefill logits, prefill cache
    and a per-slot decode step — on BOTH systems (memristor and
    digital tile geometries);
  * a ``deploy()`` duo — the ``deep`` sensor app and the LM tenant on
    the one shared ``"chip"`` mesh — serves mixed traffic through the
    one keyed router, and every generated token stream equals the
    dense ``serving.Engine``'s output exactly;
  * the per-app stats rows sum EXACTLY to the fleet roll-up, and the
    deployment report prices the LM tenant's Tables II–VI row next to
    the sensor row;
  * ``repro_torch.obs`` telemetry: the ``lm.tokens`` counter equals the
    LM app's emitted item count exactly, and the per-token
    ``lm.decode_latency_s`` histogram is populated.

Exit 0 iff every check passes.
"""
from __future__ import annotations

import argparse
import sys


def selftest(verbose: bool = True, device=None, n_chips: int = 2) -> bool:
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs import qwen1p5_0p5b
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
    from repro_torch.lm import TransformerParams, compile_lm
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import resolve_device
    from repro_torch.serving.engine import Engine, Request

    dev = resolve_device(device)
    tol = 1e-6 if dev.type == "cpu" else 1e-5
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + detail + ')' if detail else ''}")

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    tel = obs.configure(trace=False)
    try:
        # -- mapped forward == dense forward, both systems ----------- #
        cfg = qwen1p5_0p5b.reduced().replace(compute_dtype="float32",
                                             decode_per_slot=True)
        params = model_lib.init_params(cfg, 0, device=dev)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, size=(2, 9))
        d_logits, d_cache = model_lib.prefill(cfg, params, {"tokens": toks})
        step = np.asarray([[3], [5]], np.int32)
        pos = np.asarray([9, 9], np.int32)
        dl, _ = model_lib.decode_step(cfg, params, d_cache, step, pos)
        for system in ("memristor", "digital"):
            clm = compile_lm(TransformerParams(cfg, params), system=system,
                             device=dev)
            m_logits, m_cache = clm.prefill(toks)
            r = rel(m_logits, d_logits)
            check(f"prefill logits match dense ({system})", r <= tol,
                  f"rel {r:.1e}")
            r = max(rel(m_cache[k], d_cache[k]) for k in d_cache)
            check(f"prefill cache matches dense ({system})", r <= tol,
                  f"rel {r:.1e}")
            ml, _ = clm.decode(m_cache, step, pos)
            r = rel(ml, dl)
            check(f"decode logits match dense ({system})", r <= tol,
                  f"rel {r:.1e}")
        check("lm.compiles counted",
              tel.metrics.snapshot()["counters"].get("lm.compiles") == 2)

        # -- sensor + LM duo on one shared mesh ---------------------- #
        dep = deploy(DeploymentSpec(apps=(
            AppSpec("sensor", "deep", items_per_second=100.0,
                    lanes_per_chip=2),
            AppSpec("lm", cfg, params=params, items_per_second=50.0,
                    lanes_per_chip=2, cache_len=64),
        ), n_chips=n_chips, device=dev))
        check("duo co-resident on the fleet",
              dep.n_chips == n_chips and dep.apps == ["sensor", "lm"])

        prompts = [list(rng.integers(0, cfg.vocab_size, size=n))
                   for n in (5, 3, 7, 4, 6)]
        for p in prompts:
            check("submit_tokens admits",
                  dep.submit_tokens("lm", p, max_new_tokens=6))
        sensor_batches = [rng.uniform(0, 1, (3 + i, 784)).astype(np.float32)
                          for i in range(3)]
        for b in sensor_batches:
            dep.submit("sensor", b)
        dep.run_until_drained()
        got = dep.generated_tokens("lm")
        check("every LM request finished", len(got) == len(prompts))

        eng = Engine(cfg, params, slots=len(prompts), cache_len=64)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        eng.run_until_drained()
        oracle = [st.generated for st in
                  sorted(eng.finished, key=lambda st: st.request.uid)]
        mapped = [got[uid] for uid in sorted(got)]
        check("generated tokens == dense serving.Engine, per request",
              mapped == oracle)

        stats = dep.stats()
        roll = {f: sum(getattr(s, f) for s in stats.apps.values())
                for f in ("requests", "items", "rejected", "lanes")}
        check("per-app stats roll up EXACTLY to the fleet row",
              all(roll[f] == getattr(stats.fleet, f) for f in roll) and
              stats.apps["lm"].items == 6 * len(prompts) and
              stats.apps["sensor"].items ==
              sum(b.shape[0] for b in sensor_batches), str(roll))

        rep = dep.report()
        check("LM tenant prices a Tables II-VI row next to the sensor row",
              set(rep.apps) == {"sensor", "lm"} and
              rep.apps["lm"].area_mm2 > 0 and
              abs(rep.area_mm2 - sum(f.area_mm2
                                     for f in rep.apps.values())) < 1e-9)

        # -- telemetry: exact token accounting ----------------------- #
        snap = dep.metrics()
        check("lm.tokens counter == LM items emitted",
              snap["counters"].get("lm.tokens") == stats.apps["lm"].items,
              f"counter {snap['counters'].get('lm.tokens')} vs items "
              f"{stats.apps['lm'].items}")
        hist = snap["histograms"].get("lm.decode_latency_s")
        check("per-token decode-latency histogram populated",
              hist is not None and hist["count"] >= 1 and hist["p50"] > 0)
        dep.close()
    finally:
        obs.disable()

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.lm")
    ap.add_argument("--selftest", action="store_true",
                    help="run the LM-tenant smoke check")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--chips", type=int, default=2,
                    help="logical chips in the fleet (default 2)")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    return 0 if selftest(device=args.device, n_chips=args.chips) else 1


if __name__ == "__main__":
    sys.exit(main())
