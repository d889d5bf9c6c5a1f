"""Smoke entry point for the declarative deployment.

``PYTHONPATH=src python -m repro_torch.deploy --selftest`` — one
process, two co-resident tenants on ``--chips N`` logical chips
(default 2), on the card unless ``--device cpu`` is given:

  * ``deploy()`` single-app stream == the ``compile_chip`` →
    ``shard_chip`` path bit for bit (memristor AND digital): both run
    the same ``stream_pipeline`` call;
  * a 2-app deployment serves mixed traffic through the one multi-app
    router with every routed output matching the direct stream (lanes
    batch differently: atol 1e-5, as the fleet selftest), and the
    per-app stats rows summing EXACTLY to the fleet roll-up
    (requests, items, rejected, lanes);
  * per-app sensor sources drain through the one router;
  * ``reprogram`` swaps one tenant's weights with NO compile pass
    (``repro_torch.chip.compile_count`` pinned across the call), the
    swapped tenant equals a freshly compiled chip bit for bit and the
    other tenant is unchanged;
  * the deployment report composes the per-app Tables II–VI accounting
    linearly and folds the served roll-up in; a closed deployment
    refuses verbs.

Exit 0 iff every check passes.
"""
from __future__ import annotations

import argparse
import sys


def selftest(verbose: bool = True, device=None, n_chips: int = 2) -> bool:
    import numpy as np
    import torch

    from repro_torch.chip import compile_chip, compile_count
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.data import SensorPipeline
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
    from repro_torch.fleet import StreamSource, shard_chip
    from repro_torch.runtime import resolve_device

    dev = resolve_device(device)
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + detail + ')' if detail else ''}")

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    # -- single-app deploy == the shard_chip path, both systems ------ #
    dims = (64, 48, 10)
    spec_a = MLPSpec(dims, activation="threshold", out_activation="linear")
    params_a = mlp_init(spec_a, generator=seeded(0), device=dev)
    x = torch.rand((4 * n_chips + 3, dims[0]), generator=seeded(1)).to(dev)
    for system in ("memristor", "digital"):
        legacy = shard_chip(compile_chip(spec_a, params=params_a,
                                         system=system, device=dev),
                            n_chips)
        d1 = deploy(AppSpec("a", spec_a, params=params_a, system=system),
                    n_chips=n_chips, device=dev)
        check(f"single-app deploy == shard_chip path ({system}, bit for "
              f"bit)", torch.equal(d1.stream("a", x), legacy.stream(x)))
        d1.close()

    # -- two co-resident apps over one mesh -------------------------- #
    dims_b = (32, 16, 4)
    spec_b = MLPSpec(dims_b, activation="threshold",
                     out_activation="linear")
    params_b = mlp_init(spec_b, generator=seeded(7), device=dev)
    d = deploy(DeploymentSpec(apps=(
        AppSpec("alpha", spec_a, params=params_a, system="1t1m",
                lanes_per_chip=2),
        AppSpec("beta", spec_b, params=params_b, system="sram",
                lanes_per_chip=1, queue_limit=8),
    ), n_chips=n_chips, device=dev))
    check("deployment spans the mesh's chips and both tenants",
          d.n_chips == n_chips and d.apps == ["alpha", "beta"],
          f"{d.n_chips} logical chips on {d.device}")

    rng = np.random.default_rng(2)
    sub_a = [rng.uniform(0, 1, (3 + i, dims[0])).astype(np.float32)
             for i in range(4)]
    sub_b = [rng.uniform(0, 1, (2 + i, dims_b[0])).astype(np.float32)
             for i in range(5)]
    for items in sub_a:
        d.submit("alpha", items)
    for items in sub_b:
        d.submit("beta", items)
    done = list(d.run_until_drained())
    check("mixed traffic drains", len(done) == len(sub_a) + len(sub_b))
    chip_a, chip_b = d.chip("alpha"), d.chip("beta")
    diff = max(float(np.max(np.abs(
        st.result - (chip_a if st.request.key == "alpha" else chip_b)
        .stream(torch.from_numpy(st.request.items).to(dev)).cpu()
        .numpy()))) for st in done)
    check("routed outputs match each app's direct stream (atol 1e-5)",
          diff <= 1e-5, f"max |diff| {diff:.1e}")

    stats = d.stats()
    roll = {
        "requests": sum(s.requests for s in stats.apps.values()),
        "items": sum(s.items for s in stats.apps.values()),
        "rejected": sum(s.rejected for s in stats.apps.values()),
        "lanes": sum(s.lanes for s in stats.apps.values()),
    }
    check("per-app stats roll up EXACTLY to the fleet row",
          roll["requests"] == stats.fleet.requests ==
          len(sub_a) + len(sub_b) and
          roll["items"] == stats.fleet.items ==
          sum(a.shape[0] for a in sub_a) +
          sum(b.shape[0] for b in sub_b) and
          roll["rejected"] == stats.fleet.rejected and
          roll["lanes"] == stats.fleet.lanes == 3 * n_chips,
          str(roll))

    # -- sensor-fed closed loop over per-app sources ----------------- #
    pipe = SensorPipeline(window=8, stride=8, height=16, width=32,
                          frames_per_step=1)

    class _Proj:
        """Tenants stream different widths off ONE sensor stream: each
        frame's windows are projected (cropped or tiled) to the
        tenant's item width."""

        def __init__(self, width):
            self.width = width

        def batch(self, step):
            full = np.asarray(pipe.batch(step), np.float32)
            reps = -(-self.width // full.shape[1])
            return np.tile(full, (1, reps))[:, :self.width]

    src_a = StreamSource(_Proj(dims[0]), n_requests=5, capacity=3)
    src_b = StreamSource(_Proj(dims_b[0]), n_requests=6, capacity=3)
    served = d.serve({"alpha": src_a, "beta": src_b})
    check("per-app sources drain through the one router",
          src_a.exhausted and src_b.exhausted and
          len(served) == len(done) + 11)

    # -- live reprogram: no compile pass ----------------------------- #
    params_a2 = mlp_init(spec_a, generator=seeded(42), device=dev)
    before_b = d.stream("beta", sub_b[0])
    n_compiles = compile_count()
    d.reprogram("alpha", params_a2)
    check("reprogram runs ZERO compile passes",
          compile_count() == n_compiles, f"compile_count {compile_count()}")
    ref2 = shard_chip(compile_chip(spec_a, params=params_a2,
                                   system="memristor", device=dev),
                      n_chips)
    check("reprogrammed tenant == freshly compiled chip (bit for bit)",
          torch.equal(d.stream("alpha", x), ref2.stream(x)))
    check("other tenant unchanged by the swap",
          torch.equal(d.stream("beta", sub_b[0]), before_b))

    # -- report composition ------------------------------------------ #
    rep = d.report()
    area = sum(f.area_mm2 for f in rep.apps.values())
    check("deployment report composes per-app accounting",
          set(rep.apps) == {"alpha", "beta"} and
          abs(rep.area_mm2 - area) < 1e-12 and
          rep.apps["alpha"].n_chips == n_chips and
          rep.served is not None and
          rep.served.fleet.items == d.stats().fleet.items)
    d.close()
    closed_ok = False
    try:
        d.stream("alpha", x)
    except RuntimeError:
        closed_ok = True
    check("closed deployment refuses verbs", closed_ok)

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.deploy")
    ap.add_argument("--selftest", action="store_true",
                    help="run the declarative-deployment smoke check")
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
