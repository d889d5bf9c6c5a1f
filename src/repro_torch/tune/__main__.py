"""Smoke entry point for the fabric autotuner.

``PYTHONPATH=src python -m repro_torch.tune --selftest`` — one process,
on the card unless ``--device cpu`` is given. The scenario is the
heterogeneity case from the module docs: two tenants with the same
SLO where one (``ocr`` at 12-bit weights) fails the analog IR-drop
precision bound on EVERY memristor geometry, plus a power budget that
prices every all-digital fabric out. Checks:

  * the unconstrained search already picks the heterogeneous fabric,
    and its cost is <= every feasible homogeneous assignment on the
    frontier (non-vacuous: all-digital IS feasible unconstrained);
  * under a binding power budget between the heterogeneous cost and
    the cheapest homogeneous cost, every homogeneous assignment is
    rejected "over power budget" and the tuner still lands the same
    heterogeneous fabric inside budget;
  * the emitted spec deploys as declared (a mixed ``chip_systems``
    fleet of 2 logical chips on the one device), its
    ``deployment_report`` reproduces the tuner's predicted area/power
    at 1e-9 and shows every app's analytic capacity meeting its SLO;
  * each tenant streams bit for bit as its single-system
    ``compile_chip`` → ``shard_chip`` path (the 12-bit ocr tenant
    through the raw int8 kernel's byte planes);
  * mixed traffic over the heterogeneous fleet drains with the per-app
    stats rows summing EXACTLY to the fleet roll-up;
  * infeasible searches fail loudly with the gate named (all-memristor
    at 12 bits → IR-drop; absurd budget → over power budget).

Exit 0 iff every check passes.
"""
from __future__ import annotations

import argparse
import sys

SLO = 1e5


def selftest(verbose: bool = True, device=None) -> bool:
    import numpy as np
    import torch

    from repro_torch.chip import compile_chip
    from repro_torch.configs.paper_apps import APPS
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.core.neural_core import CoreGeometry
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
    from repro_torch.fleet import shard_chip
    from repro_torch.runtime import resolve_device
    from repro_torch.tune import TuneBudget, tune

    dev = resolve_device(device)
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + detail + ')' if detail else ''}")

    spec = DeploymentSpec(apps=(
        AppSpec("deep", "deep", items_per_second=SLO),
        AppSpec("ocr", "ocr", items_per_second=SLO, weight_bits=12),
    ), device=dev)

    # -- unconstrained search: heterogeneity from the IR-drop gate --- #
    free = tune(spec)
    check("12-bit tenant fails EVERY memristor geometry (IR-drop)",
          all(not c.feasible and "IR-drop" in c.reason
              for c in free.candidates
              if c.app == "ocr" and c.system == "memristor"))
    hetero = (free.assignment["deep"].system == "memristor" and
              free.assignment["ocr"].system == "digital" and
              set(free.chip_systems) == {"memristor", "digital"})
    check("cheapest fabric is heterogeneous (deep->1T1M, ocr->digital)",
          hetero, str([(a, p.system, p.geometry)
                       for a, p in sorted(free.assignment.items())]))
    homog = [f for f in free.frontier if f.feasible and f.homogeneous]
    sel = [f for f in free.frontier if f.selected]
    check("feasible homogeneous candidates exist unconstrained "
          "(comparison is non-vacuous)", len(homog) >= 1,
          f"{len(homog)} homogeneous points")
    check("heterogeneous fabric costs <= every feasible homogeneous "
          "candidate", len(sel) == 1 and
          all(sel[0].cost_key() <= f.cost_key() for f in homog),
          f"{free.power_mw:.1f} mW vs homogeneous min "
          f"{min((f.power_mw for f in homog), default=float('nan')):.1f}"
          f" mW")

    # -- binding power budget: homogeneous priced out ---------------- #
    cheapest_homog = min(f.power_mw for f in homog)
    budget = TuneBudget(power_mw=(free.power_mw + cheapest_homog) / 2)
    tuned = tune(spec, budget)
    check("budgeted search lands the same heterogeneous fabric "
          "inside budget",
          tuned.chip_systems == free.chip_systems and
          tuned.power_mw <= budget.power_mw,
          f"{tuned.power_mw:.1f} <= {budget.power_mw:.1f} mW")
    check("every homogeneous assignment rejected 'over power budget'",
          all(not f.feasible and "over power budget" in f.reason
              for f in tuned.frontier if f.homogeneous))

    # -- the emitted spec deploys as declared ------------------------ #
    d = deploy(tuned.spec)
    check("deployment is the tuned mixed fleet",
          d.chip_systems == tuned.chip_systems and
          d.n_chips == tuned.n_chips == 2,
          f"{list(d.chip_systems)} on {d.device}")
    rep = d.report()
    r_area = abs(rep.area_mm2 - tuned.area_mm2) / tuned.area_mm2
    r_pow = abs(rep.power_mw - tuned.power_mw) / tuned.power_mw
    check("deployment_report reproduces the tuner's cost at 1e-9",
          r_area < 1e-9 and r_pow < 1e-9,
          f"rel area {r_area:.1e}, rel power {r_pow:.1e}")
    check("every app's analytic capacity meets its SLO",
          all(rep.apps[a].capacity_items_per_second >= SLO
              for a in ("deep", "ocr")))

    # -- bit for bit against each app's single-system path ----------- #
    rng = np.random.default_rng(0)
    batches = {}
    for name in ("deep", "ocr"):
        pt = tuned.assignment[name]
        cfg = APPS[name]
        dims = cfg.nets(pt.system)[0][1]
        mspec = MLPSpec(dims, activation="threshold",
                        out_activation="linear")
        app = next(a for a in tuned.spec.apps if a.name == name)
        params = mlp_init(mspec,
                          generator=torch.Generator().manual_seed(app.seed),
                          device=dev)
        legacy = shard_chip(
            compile_chip(mspec, params=params, system=pt.system,
                         geom=CoreGeometry(*pt.geom),
                         weight_bits=app.weight_bits,
                         items_per_second=SLO,
                         sensor_flags=cfg.sensor_flags(pt.system),
                         deps=cfg.net_deps(pt.system),
                         tsv_bits_per_item=cfg.tsv_bits_per_item,
                         device=dev),
            n_chips=1)
        x = torch.from_numpy(
            rng.uniform(0, 1, (5, dims[0])).astype(np.float32)).to(dev)
        batches[name] = [
            rng.uniform(0, 1, (2 + i, dims[0])).astype(np.float32)
            for i in range(3)]
        check(f"{name} streams == its {pt.system} {pt.geometry} "
              f"shard_chip path (bit for bit)",
              torch.equal(d.stream(name, x), legacy.stream(x)))

    # -- mixed traffic on the mixed fleet: exact roll-up ------------- #
    for name, subs in batches.items():
        for items in subs:
            d.submit(name, items)
    done = list(d.run_until_drained())
    n_req = sum(len(s) for s in batches.values())
    check("mixed traffic drains through the one router",
          len(done) == n_req)
    stats = d.stats()
    roll = {
        "requests": sum(s.requests for s in stats.apps.values()),
        "items": sum(s.items for s in stats.apps.values()),
        "rejected": sum(s.rejected for s in stats.apps.values()),
        "lanes": sum(s.lanes for s in stats.apps.values()),
    }
    check("per-app stats roll up EXACTLY to the fleet row on the "
          "mixed fleet",
          roll["requests"] == stats.fleet.requests == n_req and
          roll["items"] == stats.fleet.items ==
          sum(a.shape[0] for subs in batches.values() for a in subs)
          and roll["rejected"] == stats.fleet.rejected and
          roll["lanes"] == stats.fleet.lanes, str(roll))
    d.close()

    # -- infeasible searches fail loudly with the gate named --------- #
    irdrop_named = False
    try:
        tune(spec, systems=("memristor",))
    except ValueError as e:
        irdrop_named = "IR-drop" in str(e)
    check("all-memristor search at 12 bits raises with IR-drop named",
          irdrop_named)
    budget_named = False
    try:
        tune(spec, TuneBudget(power_mw=1.0))
    except ValueError as e:
        budget_named = "over power budget" in str(e)
    check("absurd budget raises with the binding gate named",
          budget_named)

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--selftest", action="store_true",
                    help="run the fabric-autotuner smoke check")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    return 0 if selftest(device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
