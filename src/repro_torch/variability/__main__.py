"""Smoke entry point for non-ideal devices and recalibration:

    PYTHONPATH=src python -m repro_torch.variability --selftest

Port of ``repro.variability.__main__``, on the card unless
``--device cpu`` is given. Exercises the whole non-ideal-device story
end to end: σ=0 bit-identity against the ideal path (memristor and
digital), programming noise / stuck-cell perturbation, temporal drift
aging the streamed arithmetic (age 0 equals the ideal chip; reprogram
resets the age and restores the output exactly, with zero compile
passes), and the closed loop on a live ``deploy()`` — canary monitor →
SLO breach → live zero-recompile recalibration journaled on the HA
heartbeat board. Exit code 0 iff all checks pass.
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def selftest(verbose: bool = True, device=None) -> bool:
    import numpy as np
    import torch

    from repro_torch.chip.compile import (compile_chip, compile_count,
                                          reprogram_chip)
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.deploy import AppSpec, deploy
    from repro_torch.fleet.ha import HeartbeatBoard
    from repro_torch.runtime import resolve_device
    from repro_torch.variability import NoiseModel, RecalPolicy

    dev = resolve_device(device)
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        ok = ok and bool(cond)
        if verbose:
            print(f"  [{'ok' if cond else 'FAIL'}] {name}"
                  f"{'  (' + detail + ')' if detail else ''}")

    spec = MLPSpec((64, 48, 10), activation="threshold",
                   out_activation="linear")
    params = mlp_init(spec, generator=torch.Generator().manual_seed(0),
                      device=dev)
    x = torch.rand((64, 64), generator=torch.Generator().manual_seed(1)
                   ).to(dev)

    def stream(noise=None, system="memristor"):
        return compile_chip(spec, params=params, system=system,
                            noise=noise, device=dev).stream(x)

    # ---- σ=0 is bit-identical to the ideal path ------------------ #
    ideal = stream()
    check("sigma=0 NoiseModel bit-identical (memristor)",
          torch.equal(ideal, stream(NoiseModel())))
    check("sigma=0 NoiseModel bit-identical (digital)",
          torch.equal(stream(system="digital"),
                      stream(NoiseModel(), system="digital")))

    # ---- programming-time effects perturb ------------------------ #
    noisy = stream(NoiseModel(program_sigma=0.3))
    check("write noise perturbs the stream",
          not torch.equal(noisy, ideal) and bool(noisy.isfinite().all()))
    stuck = stream(NoiseModel(stuck_on_frac=0.05, stuck_off_frac=0.05))
    check("stuck cells perturb the stream",
          not torch.equal(stuck, ideal) and bool(stuck.isfinite().all()))

    # ---- drift ages the chip; reprogram resets it ---------------- #
    chip = compile_chip(spec, params=params,
                        noise=NoiseModel(drift_rate=2e-3), device=dev)
    fresh = chip.stream(x, advance_age=False)
    check("drifting chip at age 0 matches ideal", torch.equal(fresh, ideal))
    for _ in range(10):
        chip.stream(x)
    aged = chip.stream(x, advance_age=False)
    check("drift moves the streamed output with age",
          chip.items_streamed == 640 and not torch.equal(aged, fresh),
          f"age {chip.items_streamed}")
    c0 = compile_count()
    chip = reprogram_chip(chip, params)
    restored = chip.stream(x, advance_age=False)
    check("reprogram resets age and restores the output exactly",
          chip.items_streamed == 0 and torch.equal(restored, fresh))
    check("reprogram ran zero compile passes", compile_count() - c0 == 0)

    # ---- the closed loop over a live deployment ------------------ #
    canary = torch.rand((128, 64),
                        generator=torch.Generator().manual_seed(2)).numpy()
    with tempfile.TemporaryDirectory() as tmp, \
            deploy(AppSpec("app", spec, params=params,
                           noise=NoiseModel(drift_rate=5e-3)),
                   n_chips=1, device=dev) as dep:
        board = HeartbeatBoard(tmp)
        monitor = dep.attach_monitor("app", canary, every_steps=4)
        recal = dep.attach_recalibration(
            "app", policy=RecalPolicy(slo=0.99, cooldown_steps=8),
            board=board)
        c0 = compile_count()
        rng = np.random.default_rng(0)
        for _ in range(30):
            dep.submit("app", rng.random((64, 64), dtype=np.float32))
        dep.run_until_drained()
        accs = [s.accuracy for s in monitor.samples]
        check("canary accuracy dips below the SLO under drift",
              min(accs) < 0.99, f"min {min(accs):.3f}")
        check("closed loop recalibrates", len(recal.events) > 0,
              f"{len(recal.events)} event(s)")
        check("serving + recalibration ran zero compile passes",
              compile_count() - c0 == 0)
        # "restores" = the probe the recalibrator re-scores right after
        # each reprogram (the last periodic probe can land mid-breach,
        # inside the cooldown window — the drift tax the policy's
        # cooldown accepts, not a failure)
        restored_accs = [e.accuracy_after for e in recal.events]
        check("recalibration restores canary accuracy",
              bool(restored_accs) and min(restored_accs) >= 0.99,
              f"min restored {min(restored_accs, default=float('nan')):.3f}")
        check("events journaled on the HA board",
              len(board.events("recalibration")) == len(recal.events))
        stats = dep.stats()
        check("stats carry the variability plane",
              stats.variability is not None
              and "app" in stats.variability
              and stats.variability["app"]["monitor"]["probes"]
              == len(monitor.samples))

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.variability")
    ap.add_argument("--selftest", action="store_true",
                    help="run the non-ideal-device / recalibration "
                         "smoke check")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    return 0 if selftest(device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
