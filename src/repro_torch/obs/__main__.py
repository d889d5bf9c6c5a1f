"""Smoke entry point for the telemetry layer.

``PYTHONPATH=src python -m repro_torch.obs --selftest`` — port of
``repro.obs.__main__``: one process, on the card unless ``--device
cpu`` is given, ``--chips N`` logical chips (default 2). Serves a
two-tenant deployment with telemetry configured and checks:

  * registry counters equal the router's own accounting exactly
    (items, steps, per-app finished/rejected);
  * a rejected submit still carries ``t_submit`` and is counted per
    key in the registry;
  * ``RouterStats`` percentiles off the bounded reservoir are
    IDENTICAL to percentiles of the raw finished-state latencies for
    a run shorter than the reservoir;
  * per-step phase durations (admit/dispatch/device_step/gather/
    finish) sum to the measured step wall-clock within 10%, the
    measured phase breakdown is printed, and ``device_step`` takes
    more than half of the step;
  * ``chip.compile`` and ``chip.stream`` spans are recorded, every
    stream span with a zero compile delta and, on the card, a device
    time resolved after one synchronise (the call itself never waits);
  * ``Deployment.trace(path)`` writes a loadable Chrome trace: every
    complete span carries pid/tid/ts/dur, phases nest inside their
    step span, async begin/end events pair up.

Exit 0 iff every check passes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def selftest(verbose: bool = True, device=None, n_chips: int = 2) -> bool:
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core.crossbar_layer import MLPSpec, mlp_init
    from repro_torch.obs.trace import phase_breakdown, trace_ok
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
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

    tel = obs.configure()
    check("telemetry configured", obs.current() is tel and tel.active)

    # -- a two-tenant deployment under full telemetry --------------- #
    dims_a, dims_b = (48, 32, 10), (24, 12, 4)
    spec_a = MLPSpec(dims_a, activation="threshold",
                     out_activation="linear")
    spec_b = MLPSpec(dims_b, activation="threshold",
                     out_activation="linear")
    d = deploy(DeploymentSpec(apps=(
        AppSpec("alpha", spec_a,
                params=mlp_init(spec_a,
                                generator=torch.Generator().manual_seed(0),
                                device=dev),
                lanes_per_chip=2),
        AppSpec("beta", spec_b,
                params=mlp_init(spec_b,
                                generator=torch.Generator().manual_seed(1),
                                device=dev),
                lanes_per_chip=1, queue_limit=2),
    ), n_chips=n_chips, device=dev))
    rng = np.random.default_rng(0)
    accepted = 0
    for i in range(6):
        accepted += d.submit("alpha", rng.uniform(
            0, 1, (3 + i % 4, dims_a[0])).astype(np.float32))
    for i in range(5):
        # beta's queue_limit=2 back-pressures some of these on purpose
        accepted += d.submit("beta", rng.uniform(
            0, 1, (2 + i % 3, dims_b[0])).astype(np.float32))
    done = list(d.run_until_drained())
    stats = d.stats()
    check("two-tenant traffic drains", accepted >= 8 and
          len(done) == accepted, f"{len(done)}/{accepted} finished")

    # -- counters == router accounting ------------------------------ #
    c = d.metrics()["counters"]
    router = d.router
    check("engine.items counter == router items_emitted",
          c.get("engine.items") == router.items_emitted ==
          stats.fleet.items,
          f"{c.get('engine.items')} vs {router.items_emitted}")
    check("engine.steps counter == router steps",
          c.get("engine.steps") == router.steps)
    check("per-app finished counters == per-app stats rows",
          all(c.get(f"engine.requests_finished|key={app}")
              == stats.apps[app].requests for app in ("alpha", "beta")))

    # -- rejected submits: stamped + counted per key ----------------- #
    backlog = []
    rejected_req = None
    while rejected_req is None and len(backlog) < 50:
        req = ItemRequest(uid=10_000 + len(backlog),
                          items=np.zeros((1, dims_b[0]), np.float32),
                          key="beta")
        if router.submit(req):
            backlog.append(req)
        else:
            rejected_req = req
    check("a rejected submit still carries t_submit",
          rejected_req is not None and rejected_req.t_submit > 0.0)
    check("rejects counted per key in the registry",
          d.metrics()["counters"].get("engine.rejected|key=beta")
          == router.rejected_by_key["beta"]
          == router.rejected > 0)
    d.run_until_drained()

    # -- reservoir percentiles == raw-list percentiles --------------- #
    lat_raw = np.asarray([st.latency_s for st in router.finished])
    s = d.stats().fleet
    check("reservoir p50/p95 identical to raw-list percentiles "
          "(run < reservoir size)",
          s.latency_s_p50 == float(np.percentile(lat_raw, 50)) and
          s.latency_s_p95 == float(np.percentile(lat_raw, 95)),
          f"p50 {s.latency_s_p50 * 1e3:.2f} ms")

    # -- phase timings tile the step wall-clock ---------------------- #
    events = tel.tracer.trace_events()
    brk = phase_breakdown(events)
    step_total = brk["step_us"]
    phase_total = sum(brk["phases"].values())
    check("step and phase spans recorded",
          brk["steps"] == router.steps and
          sum(1 for e in events if e.get("cat") == "phase")
          >= brk["steps"])
    ratio = phase_total / step_total if step_total else 0.0
    check("phase durations sum to step wall-clock within 10%",
          0.90 <= ratio <= 1.02, f"sum(phases)/sum(steps) = {ratio:.4f}")
    if verbose and step_total:
        split = ", ".join(
            f"{name} {100 * dur / step_total:.1f}%"
            for name, dur in sorted(brk["phases"].items(),
                                    key=lambda kv: -kv[1]))
        print(f"  measured phase breakdown: {split}")
    device_share = brk["phases"].get("device_step", 0.0) / max(step_total,
                                                                1e-12)
    check("device_step dominates the step (the host scatter/gather "
          "is not the bottleneck)", device_share > 0.5,
          f"device_step {100 * device_share:.1f}%")

    # -- chip-level spans -------------------------------------------- #
    d.chip("alpha").stream(torch.zeros((2, dims_a[0]), device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    left = tel.tracer.resolve_device_times()
    chips = [e for e in tel.tracer.trace_events() if e.get("cat") == "chip"]
    streams = [e for e in chips if e["name"] == "chip.stream"]
    check("chip compile and stream spans recorded, zero stream-time "
          "compile delta",
          any(e["name"] == "chip.compile" for e in chips) and streams and
          all(e.get("args", {}).get("compile_delta", 0) == 0
              for e in streams))
    timed = [e for e in chips if "device_ms" in e["args"]]
    want = [e for e in chips if e["name"] != "chip.compile"] \
        if dev.type == "cuda" else []
    check("chip spans carry device times on the card, resolved after "
          "one synchronise", left == 0 and timed == want,
          f"{len(timed)} of {len(want)} timed")

    # -- trace file: loadable, schema-valid, nested ------------------ #
    with tempfile.TemporaryDirectory(prefix="repro_torch_obs_") as tmp:
        path = d.trace(os.path.join(tmp, "trace.json"))
        with open(path) as f:
            doc = json.load(f)
    check("trace file loads: spans carry pid/tid/ts/dur, phases nest "
          "in their step, async request events pair up",
          trace_ok(doc, len(router.finished)),
          f"{len(doc.get('traceEvents', []))} events")

    d.close()
    obs.disable()
    check("disable() returns the inert pair", not obs.current().active)

    if verbose:
        print(f"selftest: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    ap.add_argument("--selftest", action="store_true",
                    help="run the telemetry smoke check")
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
