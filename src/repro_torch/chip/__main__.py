"""Smoke entry point:  PYTHONPATH=src python -m repro_torch.chip --selftest

Compiles the paper's deep-app MLP (784→200→100→10) onto 1T1M cores on
the card (or with ``--device cpu``), checks that the mapped stream
through the kernels matches the programmed dense einsum path, that the
report agrees with the cost model's Tables II–VI deep-app accounting
and its power decomposes, that the TDM schedule is conflict-free, and
that the serving engine drains a small request burst correctly. Exit
code 0 iff all checks pass.
"""
from __future__ import annotations

import argparse
import sys


def selftest(verbose: bool = True, device=None) -> bool:
    import numpy as np
    import torch

    from repro_torch.chip import ChipRequest, compile_chip
    from repro_torch.configs.paper_apps import APPS
    from repro_torch.core.costmodel import specialized_cost
    from repro_torch.core.crossbar_layer import (MLPSpec, mlp_init,
                                                 program_mlp,
                                                 programmed_mlp_apply)
    from repro_torch.runtime import resolve_device

    dev = resolve_device(device)
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + detail + ')' if detail else ''}")

    dims = (784, 200, 100, 10)
    spec = MLPSpec(dims, activation="threshold", out_activation="linear")
    params = mlp_init(spec, generator=torch.Generator().manual_seed(0),
                      device=dev)
    chip = compile_chip(spec, params=params, system="memristor",
                        items_per_second=1000.0, device=dev)

    x = torch.rand((128, 784),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    y = chip.stream(x)
    oracle = programmed_mlp_apply(program_mlp(params, spec,
                                              mode="crossbar"), x)
    rel = float(torch.max(torch.abs(y - oracle)) /
                torch.clamp(torch.max(torch.abs(oracle)), min=1e-12))
    path = "kernels" if dev.type == "cuda" else "plain versions"
    check(f"stream ({path} on {dev.type}) matches the programmed dense "
          f"einsum path", rel <= 1e-5, f"max rel {rel:.2e}")
    check("output shape", tuple(y.shape) == (128, 10))

    rep = chip.report()
    # chip.report must agree with the independent cost-model assembly
    # of the Tables II–VI rows
    ref = specialized_cost(APPS["deep"], "memristor")
    check("report reproduces the Tables II-VI deep-app accounting",
          rep.cores_per_replica == ref.mapping.cores_per_replica,
          f"{rep.cores_per_replica} cores/replica")
    check("report power decomposes", abs(
        rep.power_mw - (rep.leak_mw + rep.compute_mw + rep.routing_mw +
                        rep.tsv_mw)) < 1e-9)

    # TDM schedule feasibility: no slot overlap on any link
    overlaps = 0
    for entries in chip.route.schedule.values():
        spans = sorted((s, s + n) for _, s, n in entries)
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            overlaps += a1 > b0
    check("TDM schedule is conflict-free", overlaps == 0)

    eng = chip.serve(slots=3)
    rng = np.random.default_rng(2)
    reqs = [ChipRequest(uid=i, items=rng.uniform(0, 1, (2 + i, 784)))
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    check("serving engine drains all requests", len(done) == 5)
    served_ok = all(
        np.allclose(st.result,
                    chip.stream(torch.from_numpy(st.request.items)
                                ).cpu().numpy(),
                    atol=1e-5)
        for st in done)
    check("served outputs match direct stream", served_ok)

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.chip")
    ap.add_argument("--selftest", action="store_true",
                    help="run the compile→program→stream smoke check")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    return 0 if selftest(device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
