"""Smoke entry point:  PYTHONPATH=src python -m repro_torch.fleet --selftest

The single-process fleet on the card (or with ``--device cpu``), as
``--chips N`` logical chips (default 2) sharing one programmed image.
Checks that the fleet stream equals the single chip's, that the
continuous-batching router backfills ragged and late traffic and its
outputs match the direct stream, that its latency accounting is
monotone and its stats roll up, that the sensor-stream frontend
respects backpressure and a sensor-fed serve loop drains, that the
fleet report composes the per-chip accounting, and that rate
validation is silent on a feasible rate and warns or raises on an
infeasible one. Exit code 0 iff all checks pass. The multi-process
selftests are not ported yet (ROADMAP.md, Queue 1 item 6b).
"""
from __future__ import annotations

import argparse
import sys


def selftest(verbose: bool = True, device=None, n_chips: int = 2) -> bool:
    import warnings

    import numpy as np
    import torch

    from repro_torch.chip import ChipRateWarning, compile_chip
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, StreamSource, shard_chip
    from repro_torch.runtime import resolve_device
    from repro_torch.serving.engine import ItemRequest

    dev = resolve_device(device)
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + detail + ')' if detail else ''}")

    # one compiled chip, served as n_chips logical chips
    dims = (784, 200, 100, 10)
    spec = MLPSpec(dims, activation="threshold", out_activation="linear")
    params = mlp_init(spec, generator=torch.Generator().manual_seed(0),
                      device=dev)
    chip = compile_chip(spec, params=params, system="memristor",
                        device=dev)
    fleet = shard_chip(chip, n_chips)
    check("fleet of logical chips", fleet.n_chips == n_chips,
          f"{fleet.n_chips} chips on {dev}")

    x = torch.rand((4 * n_chips + 3, 784),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    y, ref = fleet.stream(x), chip.stream(x)
    rel = float(torch.max(torch.abs(y - ref)) /
                torch.clamp(torch.max(torch.abs(ref)), min=1e-12))
    check("sharded stream == single chip", bool(torch.equal(y, ref)),
          f"rel {rel:.1e} over {fleet.n_chips} chips")

    def direct(items):
        return chip.stream(torch.as_tensor(items, dtype=torch.float32)
                           ).cpu().numpy()

    # continuous batching: ragged burst + mid-stream arrivals backfill
    router = FleetRouter(fleet, lanes_per_chip=2)
    rng = np.random.default_rng(2)
    first = [ItemRequest(uid=i, items=rng.uniform(0, 1, (3 + 2 * i, 784)))
             for i in range(3)]
    for r in first:
        router.submit(r)
    for _ in range(2):
        router.step()
    late = [ItemRequest(uid=10 + i, items=rng.uniform(0, 1, (2, 784)))
            for i in range(2 * n_chips)]
    for r in late:
        router.submit(r)
    done = router.run_until_drained()
    check("router drains ragged + late traffic",
          len(done) == len(first) + len(late))
    match = all(np.allclose(st.result, direct(st.request.items), atol=1e-5)
                for st in done)
    check("routed outputs match direct stream", match)
    lat_ok = all(st.request.t_submit <= st.t_admit <= st.t_done
                 for st in done)
    check("latency accounting is monotonic", lat_ok)
    stats = router.stats()
    check("router stats roll up", stats.requests == len(done) and
          stats.items == sum(st.result.shape[0] for st in done),
          str(stats))

    # sensor-stream frontend: windowed items, bounded-queue backpressure
    pipe = SensorPipeline(window=28, stride=18, frames_per_step=1)
    check("sensor windows are chip items", pipe.d_item == dims[0] and
          pipe.items_per_step == 9)
    src = StreamSource(pipe, n_requests=12, capacity=3)
    made = src.pump()
    check("backpressure caps production", made == 3 and
          src.pump() == 0 and src.stalls == 2,
          f"{made} staged of 12, capacity 3, {src.stalls} stalls")
    router2 = FleetRouter(fleet, lanes_per_chip=2, queue_limit=4)
    done2 = sorted(router2.serve(src), key=lambda s: s.request.uid)
    all_items = np.concatenate([st.request.items for st in done2])
    got = np.concatenate([st.result for st in done2])
    check("sensor-fed serve loop drains the stream",
          len(done2) == 12 and src.exhausted)
    check("sensor-fed outputs match direct stream",
          np.allclose(got, direct(all_items), atol=1e-5))

    # fleet report composes the per-chip accounting linearly
    rep = fleet.report(router2)
    chip_rep = chip.report()
    check("fleet report composes per-chip accounting",
          rep.n_chips == n_chips and
          abs(rep.power_mw - n_chips * chip_rep.power_mw) < 1e-9 and
          abs(rep.area_mm2 - n_chips * chip_rep.area_mm2) < 1e-9 and
          rep.served is not None and rep.served.items > 0)

    # compile-time TDM rate validation (both sides)
    feasible_ok = True
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", ChipRateWarning)
            compile_chip(spec, params=params, items_per_second=1e4,
                         device=dev)
    except ChipRateWarning:
        feasible_ok = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bad = 1e3 * chip.route.max_items_per_second
        compile_chip(spec, params=params, items_per_second=bad, device=dev)
        warned = any(issubclass(w.category, ChipRateWarning)
                     for w in caught)
    raised = False
    try:
        compile_chip(spec, params=params, items_per_second=bad,
                     strict_rate=True, device=dev)
    except ValueError:
        raised = True
    check("rate validation: feasible silent, infeasible warns/raises",
          feasible_ok and warned and raised)

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet")
    ap.add_argument("--selftest", action="store_true",
                    help="run the shard→route→serve smoke check")
    ap.add_argument("--chips", type=int, default=2,
                    help="logical chips in the fleet (default 2)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    return 0 if selftest(device=args.device, n_chips=args.chips) else 1


if __name__ == "__main__":
    sys.exit(main())
