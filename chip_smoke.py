#!/usr/bin/env python3
"""Chip smoke: drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

The main path is the paper's program-once / stream-many inference of
the deep sensor app (784→200→100→10, threshold hidden layers) at its
published width, on both systems: ``compile_chip`` (split → pack →
place → route → program) → ``CompiledChip.stream`` → ``chip.serve``.
The memristor system streams through the crossbar kernel
(``csrc/crossbar_mvm.cu``), the digital system through the int8 MAC
kernel (``csrc/int8_matmul.cu``); both are built here from source.

Phases, each of which ends the run with a non-zero exit on failure:
  1. kernel vs plain version on the card, at the deep app's shapes, on
     the test sweep and at the serving batches 1 and 4 (crossbar: both
     modes, f32 and bf16, ragged batches, 16-column tiles; int8: fused
     and raw, signed and unsigned codes, unaligned rows);
  2. stream: 16,384 items through each system's chip, with the kernel
     launch counters showing three launches a call, checked layer by
     layer against the einsum (plain) path on the card;
  3. serve: ``chip.serve(slots=4)`` drains 8 requests whose outputs
     equal the direct stream;
  4. times: CUDA events over many launches after warm-up, for each
     kernel, its plain version and one PyTorch call computing the same
     function, at the pace the host launches them (``ms``, ``plain_ms``,
     ``library_ms``) and queued behind a sleep so that they time the
     card's own work (``device_ms``, ``plain_device_ms``,
     ``library_device_ms``), with the least time the card could take on
     the kernel's route (the bound); the same at the serving batches 4
     and 1; stream items/s of the kernel and einsum paths in
     alternating rounds, with the device's busy time from
     ``torch.profiler``; and engine steps/s, the median of three drains
     after a warm-up drain;
  5. variability: the deep app on the memristor system with a noisy,
     drifting ``NoiseModel`` (write σ, stuck cells, IR drop, drift):
     8 calls of 16,384 items, three crossbar launches each, checked
     layer by layer against the einsum path at ages 0, 16,384 and
     114,688; the drift clock; ``NoiseModel()`` equal to no model on
     both systems; ``reprogram_chip`` with no compile; the canary
     recalibration loop back to accuracy 1.0; and the drifting chip's
     stream times against the ideal chip's;
  6. paper apps: every app's ``compile_app(...).report()`` and RISC
     cost against ``tests/golden/fleet_tables.json`` at 1e-9, and every
     weighted net of the five apps streamed (16,384 items) through the
     kernels on both systems, checked layer by layer;
  7. wide digital: the deep app on the digital system at 12-bit codes,
     streamed (16,384 items) through the raw int8 kernel in byte planes
     (four launches a layer) and equal to the einsum path to the bit;
     the raw kernel against its plain version at the plane shapes; a
     ``serve()`` drain; the raw kernel's times and bound, and the wide
     stream's items/s against the einsum path's;
  8. fleet: the deep app on both systems as ``shard_chip(chip, 4)``,
     four logical chips on the one card: streams of 16,384 and 4,097
     items against the chip's, resize 4→2→4 and reprogram with no
     compile, phase 5's drifting chip as a fleet at three ages against
     the chip, a ``FleetRouter`` draining a sensor-fed ``StreamSource``
     (32 requests of 9 windows) whose outputs match the direct stream,
     and ``fleet.report``; then fleet and chip timed alternately (ms a
     batch, device busy time, kernels a batch) and router steps/s
     beside ``chip.serve(slots=16)`` on the same requests;
  9. ranks: the deep app as a fleet of 2 processes × 2 logical chips
     sharing the card, spawned as fresh interpreters in one gloo group
     (``python -m repro_torch.fleet --distributed-worker``): each
     rank's ``stream_local`` on its 8,192 rows against the chip (bit
     for bit, three launches a call) and the one-process stream (rel
     ≤ 1e-6), the lockstep ``DistributedFleetRouter`` on each rank's
     sensor feed, ``stats_global`` identical on both ranks and equal to
     ``assemble_stats`` of their rows; a lockstep fleet losing rank 1
     and a federated one losing rank 0 mid-serve, the survivor
     absorbing the dead feed with every uid completed once and no
     compile; the cost of one ``any_across_hosts``, a lane batch's
     ``stream_local`` in each rank alone and with both ranks on the
     card, each rank's CUDA memory, and the lockstep router's
     aggregate rate beside one process's ``FleetRouter`` with the same
     lanes and requests.

 10. deploy: the declarative entry point (``repro_torch.deploy``) on
     the deep app: (a) ``deploy()`` of one app on each system equal to
     ``shard_chip(compile_chip(...))`` bit for bit with the chip's
     three launches a batch; (b) a memristor and an 8-bit digital
     tenant on 2 logical chips serving 32 requests of 16 items each off
     two ``StreamSource``s, every routed output against the direct
     stream, the per-app stats rolled up exactly, with (e)
     ``repro_torch.obs`` on: the phase shares of a served step and a
     Chrome trace written under ``build/`` and reloaded; (c) ``tune()``
     on the reference tune selftest's spec (deep and 12-bit ocr at 1e5
     items/s) and ``deploy(tuned.spec)``: deep on memristor 128×64, ocr
     on digital 128×64 through the raw int8 kernel's byte planes (new
     shapes: K = 2500 → 60 → 26), its report equal to the tuner's at
     1e-9, each tenant's 16,384 items checked against the einsum path
     (memristor rel ≤ 1e-5 layer by layer, 12 bits to the bit), and a
     mixed drain; (d) the canary loop on a deployed drifting deep
     tenant, journaled on a heartbeat board, with no compile. Then the
     two-tenant router's steps/s beside one ``FleetRouter`` with the
     same lanes, and each tuned tenant's ms a batch and busy time.

The ``kernels`` line counts each kernel's launches on the main path
(phases 2–3) and in phases 5–10 (phase 9: what the ranks report; a
killed rank reports nothing).

It prints the card's name and power limit first, one JSON line per
measurement, the kernel table as one ``{"kernels": [...]}`` line, and
``{"ok": true, "device": {...}}`` last. Without a CUDA card, or
without the repository's ``src/`` beside it, it exits non-zero and
prints no result. It never falls back to the CPU or to a plain
version.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances (max |diff| / max |plain|), with their reasons
TOL_F32 = 1e-5     # crossbar kernel, f32: sums run in another order
TOL_BF16 = 1e-2    # crossbar kernel, bf16 x: the kernel rounds the combined
#                    tile to bf16 (as the TPU kernel does), the plain
#                    version keeps it f32
TOL_I8 = 1e-6      # fused int8: the same int32 sum and epilogue rounding
BAND = 1e-5        # threshold units may flip only within this × max|pre|

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound's rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # IEEE f32 on the CUDA cores (no TF32)
TF32_FLOPS = 494.7e12      # TF32 tensor cores
INT8_OPS = 1979e12
TF32_PRODUCTS = 3          # the crossbar kernel's f32 route: 3×TF32

DEEP = (784, 200, 100, 10)
STREAM_B = 16384
STREAM_ROUNDS = 5      # × (einsum, kernel, kernel, einsum) stream timings
SERVE_BATCHES = (4, 1)  # kernel times at the engine's batches (slots = 4)
SERVE_DRAINS = 3       # engine drains timed after one warm-up drain
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock: covers 20 launches

# phase 5: the deep app on non-ideal devices. The drift rate moves the
# canary's answers past the SLO within one batch of 16,384 items, and
# the output by far more than rel 1e-3 at the oldest checked age.
DRIFT_RATE = 1e-7
NOISE_KW = dict(program_sigma=0.1, stuck_on_frac=0.01, stuck_off_frac=0.01,
                ir_drop_r_seg=1.0, drift_rate=DRIFT_RATE, seed=0)
DRIFT_CALLS = 8                 # streamed calls: ages 0 .. 7 × 16,384
DRIFT_CHECK_CALLS = (0, 1, 7)   # the ages checked against plain
CANARY_ROWS = 256
CANARY_SLO = 0.99
CANARY_STEPS = 4
REPORT_RTOL = 1e-9      # the golden Tables II–VI pins' own tolerance

WIDE_BITS = 12          # phase 7: two byte planes of input and synapses
FLEET_CHIPS = 4         # phase 8: logical chips on the one card
FLEET_RAGGED_B = 4097   # a batch that 4 chips do not divide
FLEET_TOL = 1e-6        # fleet vs chip: K1 runs at another batch size
FLEET_LANES = 4         # router lanes a chip: 16 lanes, as serve(slots=16)
FLEET_REQUESTS = 32     # sensor frames (9 windows of 28×28 each)
RANKS = 2               # phase 9: processes sharing the one card
RANK_CHIPS = 2          # logical chips a rank
RANK_REQUESTS = 32      # sensor frames a rank's feed
RANK_DRAINS = 4         # lockstep drains a rank; the first warms up
DEPLOY_CHIPS = 2        # phase 10: logical chips of a deployment
DEPLOY_LANES = 4        # lanes a chip for each tenant: 8 a tenant, 16 in all
DEPLOY_REQUESTS = 32    # requests a tenant
DEPLOY_ITEMS = 16       # items a request
TUNE_SLO = 1e5          # the reference tune selftest's SLO for both tenants
VAR_LANES = 128         # lanes a chip of the drifting tenant: 256 rows a step
VAR_ITEMS = 160         # items a request of the drifting tenant: 160 steps


class SmokeFailure(Exception):
    pass


def _rel(a, b) -> float:
    a = a.double()
    b = b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _line(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------- #
# phase 1: kernels vs plain versions
# --------------------------------------------------------------------- #
def _cb_operands(torch, gen, dev, B, R, C, rows, cols):
    x = torch.rand((B, R, rows), generator=gen, device=dev) * 2 - 1
    gp = 8e-9 + torch.rand((R, C, rows, cols), generator=gen,
                           device=dev) * 8e-6
    gn = 8e-9 + torch.rand((R, C, rows, cols), generator=gen,
                           device=dev) * 8e-6
    sc = (0.2 + 2.8 * torch.rand((R, C, cols), generator=gen, device=dev)
          ) / (gp + gn).sum(2)
    bias = torch.randn(C * cols, generator=gen, device=dev) * 0.1
    return x, gp, gn, sc, bias


def phase_kernels(torch, ops, ref, dev) -> int:
    gen = torch.Generator(device=dev).manual_seed(0)
    deep = [(STREAM_B, 7, 4, 128, 64), (STREAM_B, 2, 2, 128, 64),
            (STREAM_B, 1, 1, 128, 64)]
    # the test sweep, the serving batches (1, 4) at the deep app's first
    # layer, and 16-column tiles several of which share a block tile
    sweep = [(1, 1, 1, 128, 64), (8, 1, 1, 128, 128), (200, 3, 2, 128, 64),
             (128, 2, 3, 64, 32), (5, 4, 1, 32, 16), (STREAM_B - 1, 7, 4,
                                                       128, 64),
             (1, 7, 4, 128, 64), (4, 7, 4, 128, 64), (37, 2, 5, 32, 16)]
    checks = 0
    worst = {"crossbar_f32": 0.0, "crossbar_bf16": 0.0, "int8_fused": 0.0}
    for shape in deep + sweep:
        x, gp, gn, sc, bias = _cb_operands(torch, gen, dev, *shape)
        acts = ("linear", "threshold", "sigmoid", "relu", "tanh") \
            if shape in sweep else ("linear",)
        for act in acts:
            out = ops.crossbar_mvm(x, gp, gn, sc, bias, activation=act)
            plain = ref.crossbar_mvm_ref(x, gp, gn, sc, bias, activation=act)
            if act == "threshold":
                # ±1 rails: a flip is allowed only in the near-zero band
                pre = ref.crossbar_mvm_ref(x, gp, gn, sc, bias)
                near = pre.abs() <= BAND * pre.abs().max()
                _require(bool(((out != plain) & ~near).sum() == 0),
                         f"crossbar threshold {shape}")
            else:
                e = _rel(out, plain)
                worst["crossbar_f32"] = max(worst["crossbar_f32"], e)
                _require(e <= TOL_F32, f"crossbar {act} {shape}: rel {e:.3g}")
            checks += 1
        out = ops.crossbar_mvm(x, gp, gn, sc, partials=True)
        e = _rel(out, ref.crossbar_mvm_partials_ref(x, gp, gn, sc))
        worst["crossbar_f32"] = max(worst["crossbar_f32"], e)
        _require(e <= TOL_F32, f"crossbar partials {shape}: rel {e:.3g}")
        xb = x.to(torch.bfloat16)
        for partials in (False, True):
            if partials:
                out = ops.crossbar_mvm(xb, gp, gn, sc, partials=True)
                plain = ref.crossbar_mvm_partials_ref(xb, gp, gn, sc)
            else:
                out = ops.crossbar_mvm(xb, gp, gn, sc, bias)
                plain = ref.crossbar_mvm_ref(xb, gp, gn, sc, bias)
            e = _rel(out, plain)
            worst["crossbar_bf16"] = max(worst["crossbar_bf16"], e)
            _require(e <= TOL_BF16, f"crossbar bf16 {shape}: rel {e:.3g}")
        checks += 3
    for B in (STREAM_B, 37, 4, 1):
        for K, N in ((784, 200), (200, 100), (100, 10)):
            w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                              dtype=torch.int8)
            s = torch.rand(N, generator=gen, device=dev) * 1e-2
            o = torch.randn(N, generator=gen, device=dev)
            for dtype, lo, hi in ((torch.uint8, 0, 256),
                                  (torch.int8, -128, 128)):
                x = torch.randint(lo, hi, (B, K), generator=gen, device=dev,
                                  dtype=dtype)
                _require(torch.equal(ops.int8_matmul(x, w),
                                     ref.int8_matmul_ref(x, w)),
                         f"int8 raw {B, K, N, dtype} not exact")
                for act in ("linear", "threshold", "sigmoid", "tanh"):
                    e = _rel(ops.int8_matmul(x, w, s, o, activation=act),
                             ref.int8_matmul_fused_ref(x, w, s, o,
                                                       activation=act))
                    worst["int8_fused"] = max(worst["int8_fused"], e)
                    _require(e <= TOL_I8, f"int8 fused {act} {B, K, N}: "
                                          f"rel {e:.3g}")
                checks += 5
    torch.cuda.synchronize()
    _line({"phase": "kernels_vs_plain", "checks": checks,
           "worst_rel": worst, "tol": {"crossbar_f32": TOL_F32,
                                       "crossbar_bf16": TOL_BF16,
                                       "int8_fused": TOL_I8,
                                       "int8_raw": "exact"}})
    return checks


# --------------------------------------------------------------------- #
# phases 2-3: the main path
# --------------------------------------------------------------------- #
def _layerwise_check(torch, tcompile, tq, chip, x, system, age=None):
    """Each layer's kernel pre-activation vs the einsum path's on the
    same input (the einsum path's previous activations), at drift
    ``age`` (an f32 scalar tensor) where the chip drifts; threshold
    units may differ only in the near-zero band. Returns the number of
    such flips and a mask of the rows with none: on those rows the two
    end-to-end streams see identical activations at every layer."""
    h = x
    flips = 0
    clear = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for i, layer in enumerate(chip.plan):
        lin = dataclasses.replace(layer, activation="linear")
        pre_k = tcompile._apply_stream_layer(lin, h, True, age)
        pre_p = tcompile._apply_stream_layer(lin, h, False, age)
        e = _rel(pre_k, pre_p)
        _require(e <= TOL_F32, f"{system} layer {i} pre-activation rel "
                               f"{e:.3g}")
        act = tq.make_activation(layer.activation)
        if layer.activation == "threshold":
            near = pre_p.abs() <= BAND * pre_p.abs().max()
            differ = act(pre_k) != act(pre_p)
            _require(not bool((differ & ~near).any()),
                     f"{system} layer {i}: a threshold unit outside the "
                     f"near-zero band took the other rail")
            flips += int(differ.sum())
            clear &= ~differ.any(dim=1)
        h = act(pre_p)
    return flips, clear


def phase_main_path(torch, ops, tcompile, tq, tcl, chip_mod, dev, name):
    """compile → stream 16,384 items → serve 8 requests, on both
    systems, with every launch counter reset just before and read just
    after."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    rng_items = torch.Generator().manual_seed(2)
    items = [torch.rand((3 + i % 4, DEEP[0]), generator=rng_items).numpy()
             for i in range(8)]
    chips, outs, steps, per_call = {}, {}, {}, {}

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for system in ("memristor", "digital"):
        params = tcl.mlp_init(spec,
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
        chip = chip_mod.compile_chip(spec, params=params, system=system,
                                     device=dev)
        before = ops.launch_counts()
        outs[system] = chip.stream(x)
        after = ops.launch_counts()
        per_call[system] = {k: after[k] - before[k] for k in after}
        eng = chip.serve(slots=4)
        for uid, it in enumerate(items):
            eng.submit(chip_mod.ChipRequest(uid=uid, items=it))
        done = eng.run_until_drained()
        _require(len(done) == 8, f"{system}: served {len(done)} of 8")
        steps[system] = (eng, done)
        chips[system] = chip
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    _line({"phase": "main_path", "launches": launches,
           "launches_per_stream_call": per_call,
           "engine_steps": {s: steps[s][0].steps for s in steps},
           "seconds": main_s})

    # every kernel of the path went through, 3 launches per call
    _require(per_call["memristor"]["crossbar_mvm"] == 3,
             f"memristor stream launches {per_call['memristor']}")
    _require(per_call["digital"]["int8_matmul_fused"] == 3,
             f"digital stream launches {per_call['digital']}")
    _require(launches["crossbar_mvm"] ==
             3 * (1 + steps["memristor"][0].steps),
             f"crossbar launches {launches['crossbar_mvm']}")
    _require(launches["int8_matmul_fused"] ==
             3 * (1 + steps["digital"][0].steps),
             f"int8 launches {launches['int8_matmul_fused']}")

    for system, chip in chips.items():
        out = outs[system]
        _require(tuple(out.shape) == (STREAM_B, DEEP[-1]),
                 f"{system} stream shape {tuple(out.shape)}")
        _require(bool(torch.isfinite(out).all()), f"{system}: non-finite")
        flips, clear = _layerwise_check(torch, tcompile, tq, chip, x,
                                        system)
        plain = chip.stream(x, use_kernel=False)
        e = _rel(out[clear], plain[clear])
        _require(e <= TOL_F32, f"{system} stream vs plain rel {e:.3g}")
        eng, done = steps[system]
        served_diff = max(
            float((torch.from_numpy(st.result) -
                   chip.stream(torch.from_numpy(st.request.items).to(dev))
                   .cpu()).abs().max())
            for st in done)
        # the reference selftest's bound: lanes batch differently
        _require(served_diff <= 1e-5, f"{system}: served outputs differ "
                                      f"from the direct stream by "
                                      f"{served_diff:.3g}")
        _line({"phase": "stream_and_serve", "system": system,
               "items": STREAM_B, "stream_vs_plain_rel": e,
               "threshold_flips_in_band": flips,
               "rows_compared": int(clear.sum()),
               "served_requests": len(done), "engine_steps": eng.steps,
               "items_emitted": eng.items_emitted,
               "served_max_abs_diff_vs_direct_stream": served_diff,
               "card": name})
    return chips, launches


# --------------------------------------------------------------------- #
# phase 4: times
# --------------------------------------------------------------------- #
def _time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean ms a call, CUDA events around ``iters`` calls after
    ``warmup``, at the pace the host launches them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean ms a call of the card's own work: the calls are queued behind
    a sleep on the stream, so the events see them back to back whatever
    the host's launch overhead. The sleep must outlast the queueing; if
    it ran out first, the measurement is taken again with a longer one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        starved = start.query()
        torch.cuda.synchronize()
        if not starved:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise SmokeFailure("device timing: the host could not queue the calls "
                       "within the sleep")


def _quartiles(values):
    v = sorted(values)
    n = len(v)
    return v[n // 2], v[n // 4], v[(3 * n) // 4]


def _device_busy(torch, chip, x, use_kernel: bool, wall_ms: float) -> dict:
    """Device time of one streamed batch, summed over the CUDA kernels
    a profiler sees in 5 batches, beside the batch's wall time (CUDA
    events, without the profiler): the device's idle share, and the
    kernels that take the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            chip.stream(x, use_kernel=use_kernel)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels) / n
    if busy_us <= 0:
        return {"device_busy_ms": "not measured",
                "device_idle_share": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"device_busy_ms": busy_us / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
            "kernels_per_batch": sum(e.count for e in kernels) / n,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / n / 1e3
                               for e in top}}


def _bound(nbytes: float, ops_: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / rate * 1e3
    return t_bytes, t_ops


# a kernel row's times: (key, timer, which callable)
TIME_KEYS = (("ms", "_time_ms", 0), ("plain_ms", "_time_ms", 1),
             ("library_ms", "_time_ms", 2), ("device_ms", "_device_ms", 0),
             ("plain_device_ms", "_device_ms", 1),
             ("library_device_ms", "_device_ms", 2))


def _times(torch, kernel, plain, library) -> dict:
    """A kernel row's times of the kernel, its plain version and the
    library call: at the host's launch pace (``_time_ms``: ``ms``,
    ``plain_ms``, ``library_ms``, which include the Python wrapper's
    overhead where it is the longer) and the card's own time
    (``_device_ms``: the same keys with ``device_``)."""
    fns = (kernel, plain, library)
    timers = {"_time_ms": _time_ms, "_device_ms": _device_ms}
    return {key: timers[timer](torch, fns[i]) for key, timer, i in TIME_KEYS}


def _kernel_row(name, source, replaces, launches, layers):
    """Sum per-layer numbers into one row: the times of one streamed
    batch (one launch per layer)."""
    t_bytes = sum(r["bytes_ms"] for r in layers)
    t_ops = sum(r["ops_ms"] for r in layers)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in layers),
           "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in layers),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           **{key: sum(r[key] for r in layers) for key, _, _ in TIME_KEYS}}
    if "ops_ms_f32_cuda_cores" in layers[0]:
        row["bound_ms_f32_cuda_cores"] = sum(
            max(r["bytes_ms"], r["ops_ms_f32_cuda_cores"]) for r in layers)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
    return row


def phase_times(torch, ops, ref, tcompile, tcl, chip_mod, chips, launches,
                dev, name):
    rows_cb, rows_i8, rows_raw, rows_serve = [], [], [], []
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(3)).to(dev)

    # crossbar kernel, partials mode, on the memristor chip's own tiles
    # and each layer's own input
    h = x
    for i, layer in enumerate(chips["memristor"].plan):
        p = layer.tiles
        R, C, rows, cols = p.gp.shape
        xt = tcl.tile_inputs(p, h)
        w_fold = tcl.folded_weights(p, torch.float32).permute(
            0, 2, 1, 3).reshape(R, rows, C * cols).contiguous()
        xr = xt.transpose(0, 1)
        out = ops.crossbar_mvm(xt, p.gp, p.gn, p.scale, partials=True)
        plain = ref.crossbar_mvm_partials_ref(xt, p.gp, p.gn, p.scale)
        e = _rel(out, plain)
        _require(e <= TOL_F32, f"crossbar layer {i} (chip operands): rel "
                               f"{e:.3g}")
        nbytes = 4 * (xt.numel() + 2 * p.gp.numel() + p.scale.numel() +
                      out.numel())
        flops = 2 * STREAM_B * R * rows * C * cols
        # the route the kernel takes (3×TF32 on the tensor cores), and
        # the IEEE f32 CUDA-core bound the first kernel was held to
        t_bytes, t_ops = _bound(nbytes, TF32_PRODUCTS * flops, TF32_FLOPS)
        t_ops_f32 = _bound(nbytes, flops, F32_FLOPS)[1]
        rows_cb.append({
            "kernel": "crossbar_mvm", "layer": i,
            "shape": [STREAM_B, R, C, rows, cols], "mode": "partials",
            "max_abs_err": float((out - plain).abs().max()),
            **_times(torch,
                     lambda: ops.crossbar_mvm(xt, p.gp, p.gn, p.scale,
                                              partials=True),
                     lambda: ref.crossbar_mvm_partials_ref(
                         xt, p.gp, p.gn, p.scale),
                     lambda: torch.matmul(xr, w_fold)),
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "ops_ms_f32_cuda_cores": t_ops_f32})
        for b in SERVE_BATCHES:
            xs = xt[:b]
            rows_serve.append({
                "kernel": "crossbar_mvm", "layer": i, "batch": b,
                **_times(torch,
                         lambda: ops.crossbar_mvm(xs, p.gp, p.gn, p.scale,
                                                  partials=True),
                         lambda: ref.crossbar_mvm_partials_ref(
                             xs, p.gp, p.gn, p.scale),
                         lambda: torch.matmul(xs.transpose(0, 1), w_fold))})
        h = tcompile._apply_stream_layer(layer, h, False)

    # int8 kernel, fused, on the digital chip's own synapses and codes
    h = x
    for i, layer in enumerate(chips["digital"].plan):
        p = layer.tiles
        xq = tcl.quantize_inputs(p, h).to(torch.uint8)
        offset = p.offset + layer.bias
        K, N = p.wq.shape
        out = ops.int8_matmul(xq, p.wq, p.scale, offset)
        plain = ref.int8_matmul_fused_ref(xq, p.wq, p.scale, offset)
        e = _rel(out, plain)
        _require(e <= TOL_I8, f"int8 layer {i} (chip operands): rel {e:.3g}")
        nbytes = xq.numel() + p.wq.numel() + 8 * N + 4 * out.numel()
        t_bytes, t_ops = _bound(nbytes, 2 * STREAM_B * K * N, INT8_OPS)
        wf = p.wq.float()

        def lib_fused():
            return torch.addcmul(offset, xq.float() @ wf, p.scale)

        rows_i8.append({
            "kernel": "int8_matmul_fused", "layer": i,
            "shape": [STREAM_B, K, N],
            "max_abs_err": float((out - plain).abs().max()),
            **_times(torch,
                     lambda: ops.int8_matmul(xq, p.wq, p.scale, offset),
                     lambda: ref.int8_matmul_fused_ref(xq, p.wq, p.scale,
                                                       offset),
                     lib_fused),
            "bytes_ms": t_bytes, "ops_ms": t_ops})
        for b in SERVE_BATCHES:
            xs = xq[:b]
            rows_serve.append({
                "kernel": "int8_matmul_fused", "layer": i, "batch": b,
                **_times(torch,
                         lambda: ops.int8_matmul(xs, p.wq, p.scale, offset),
                         lambda: ref.int8_matmul_fused_ref(
                             xs, p.wq, p.scale, offset),
                         lambda: torch.addcmul(offset, xs.float() @ wf,
                                               p.scale))})
        raw = ops.int8_matmul(xq, p.wq)
        _require(torch.equal(raw, ref.int8_matmul_ref(xq, p.wq)),
                 f"int8 raw layer {i} (chip operands) not exact")
        nbytes_raw = xq.numel() + p.wq.numel() + 4 * raw.numel()
        rb, ro = _bound(nbytes_raw, 2 * STREAM_B * K * N, INT8_OPS)
        rows_raw.append({
            "kernel": "int8_matmul_raw", "layer": i,
            "shape": [STREAM_B, K, N],
            "max_abs_err": float((raw - ref.int8_matmul_ref(xq, p.wq))
                                 .abs().max()),
            **_times(torch, lambda: ops.int8_matmul(xq, p.wq),
                     lambda: ref.int8_matmul_ref(xq, p.wq),
                     lambda: xq.float() @ wf),
            "bytes_ms": rb, "ops_ms": ro})
        h = tcompile._apply_stream_layer(layer, h, False)
    for r in rows_cb + rows_i8 + rows_raw + rows_serve:
        r["card"] = name
        _line(r)
    # the serving batches: each kernel's times summed over the 3 layers,
    # the launches of one engine step
    serve = {}
    for r in rows_serve:
        sums = serve.setdefault(r["kernel"], {}).setdefault(
            str(r["batch"]), {key: 0.0 for key, _, _ in TIME_KEYS})
        for key in sums:
            sums[key] += r[key]
    _line({"serving_batch_kernel_ms": serve, "card": name})

    kernels = [
        _kernel_row("crossbar_mvm", "src/repro_torch/kernels/csrc/"
                    "crossbar_mvm.cu", "src/repro/kernels/crossbar_mvm.py:54",
                    launches["crossbar_mvm"], rows_cb),
        _kernel_row("int8_matmul_fused", "src/repro_torch/kernels/csrc/"
                    "int8_matmul.cu", "src/repro/kernels/int8_matmul.py:48",
                    launches["int8_matmul_fused"], rows_i8),
    ]

    # end to end: stream items/s at B = 16,384, in alternating rounds
    # (einsum, kernel, kernel, einsum) so the two paths share the card's
    # state; then where the time goes (profiler); then engine steps/s
    for system, chip in chips.items():
        times = {True: [], False: []}
        for _ in range(STREAM_ROUNDS):
            for use_kernel in (False, True, True, False):
                times[use_kernel].append(_time_ms(
                    torch, lambda: chip.stream(x, use_kernel=use_kernel),
                    iters=10))
        for use_kernel, ms in times.items():
            med, q1, q3 = _quartiles(ms)
            _line({"metric": "stream_items_per_s", "system": system,
                   "use_kernel": use_kernel, "batch": STREAM_B,
                   "ms_per_batch_median": med, "ms_per_batch_q1": q1,
                   "ms_per_batch_q3": q3, "runs": len(ms),
                   "items_per_s": STREAM_B / med * 1e3,
                   **_device_busy(torch, chip, x, use_kernel, med),
                   "card": name})
        rates = []
        for _ in range(1 + SERVE_DRAINS):   # the first drain warms up
            eng = chip.serve(slots=4)
            gen = torch.Generator().manual_seed(4)
            for uid in range(32):
                eng.submit(chip_mod.ChipRequest(
                    uid=uid, items=torch.rand((16, DEEP[0]),
                                              generator=gen).numpy()))
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            rates.append(eng.steps / (time.perf_counter() - t0))
        _line({"metric": "engine_steps_per_s", "system": system,
               "slots": 4, "steps": eng.steps, "drains": rates[1:],
               "warm_up_drain": rates[0],
               "steps_per_s": _quartiles(rates[1:])[0], "card": name})
    return kernels


# --------------------------------------------------------------------- #
# phase 5: non-ideal devices
# --------------------------------------------------------------------- #
class StandInDeployment:
    """What the recalibrator drives: one app on one chip, reprogrammed
    in place through ``reprogram_chip`` (zero compile passes)."""

    def __init__(self, chip_mod, chip, params):
        self._reprogram = chip_mod.reprogram_chip
        self.chip = chip
        self._params = params

    def params(self, app):
        return self._params

    def reprogram(self, app, params):
        self.chip = self._reprogram(self.chip, params)


def _deltas(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_variability(torch, ops, tcompile, tq, tcl, chip_mod, var, dev,
                      card):
    """The deep app on non-ideal memristor devices: a noisy, drifting
    chip streamed at ages 0 .. (DRIFT_CALLS - 1) × 16,384 through the
    crossbar kernel, the ideal model's identity, reprogram and the
    canary recalibration loop. Launch counters reset just before and
    read just after; the kernel-vs-plain checks come after the read."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(5)).to(dev)
    canary = torch.rand((CANARY_ROWS, DEEP[0]),
                        generator=torch.Generator().manual_seed(6)).numpy()
    noise = var.NoiseModel(**NOISE_KW)
    drift_only = var.NoiseModel(drift_rate=DRIFT_RATE, seed=0)

    ops.reset_launch_counts()
    chip = chip_mod.compile_chip(spec, params=params, noise=noise,
                                 device=dev)
    outs, per_call = {}, []
    for call in range(DRIFT_CALLS):
        age = chip.items_streamed
        _require(age == call * STREAM_B, f"drift clock {age} at call {call}")
        before = ops.launch_counts()
        out = chip.stream(x)
        per_call.append(_deltas(ops.launch_counts(), before)["crossbar_mvm"])
        if call in DRIFT_CHECK_CALLS:
            outs[age] = out
    probe_age = chip.items_streamed
    chip.stream(x, advance_age=False)
    _require(chip.items_streamed == probe_age == DRIFT_CALLS * STREAM_B,
             f"a probe moved the clock: {chip.items_streamed}")
    # the ideal model is the same code path as no model, on both systems
    identical = {}
    for system in ("memristor", "digital"):
        a = chip_mod.compile_chip(spec, params=params, system=system,
                                  device=dev)
        b = chip_mod.compile_chip(spec, params=params, system=system,
                                  noise=var.NoiseModel(), device=dev)
        identical[system] = bool(torch.equal(a.stream(x), b.stream(x))) \
            and all(layer.drift is None for layer in b.plan)
    # reprogram: no compile, the clock back to 0, and on a drift-only
    # model the re-flashed chip streams the age-0 output again
    ro = chip_mod.compile_chip(spec, params=params, noise=drift_only,
                               device=dev)
    fresh = ro.stream(x, advance_age=False)
    for _ in range(3):
        ro.stream(x)
    aged = ro.stream(x, advance_age=False)
    c0 = chip_mod.compile_count()
    re_noisy = chip_mod.reprogram_chip(chip, params)
    re_drift = chip_mod.reprogram_chip(ro, params)
    reprogram_delta = chip_mod.compile_count() - c0
    restored = re_drift.stream(x, advance_age=False)
    # the canary loop over a stand-in deployment of the drift-only chip
    # (write noise re-rolls at a reprogram, so only a drift-only chip
    # can come back to its attach-time answers exactly)
    dep = StandInDeployment(chip_mod,
                            chip_mod.compile_chip(spec, params=params,
                                                  noise=drift_only,
                                                  device=dev), params)
    monitor = var.AccuracyMonitor(lambda: dep.chip, canary, name="deep")
    recal = var.Recalibrator(dep, "deep", monitor,
                             var.RecalPolicy(slo=CANARY_SLO))
    c1 = chip_mod.compile_count()
    monitor.score()
    for _ in range(CANARY_STEPS):
        dep.chip.stream(x)
        monitor.on_step(None)
        recal.on_step(None)
    canary_delta = chip_mod.compile_count() - c1
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    _require(per_call == [3] * DRIFT_CALLS,
             f"drifting stream launches per call {per_call}")
    _require(all(identical.values()), f"NoiseModel() differs from no model "
                                      f"{identical}")
    _require(reprogram_delta == 0 and re_noisy.items_streamed == 0 and
             re_drift.items_streamed == 0,
             f"reprogram: compile delta {reprogram_delta}")
    _require(not torch.equal(aged, fresh), "drift did not move the output")
    _require(bool(torch.equal(restored, fresh)),
             "the reprogrammed drift-only chip differs from its age-0 output")
    accs = monitor.series()["accuracy"]
    _require(bool(recal.events), f"the canary never breached: {accs}")
    _require(min(accs) < CANARY_SLO and canary_delta == 0 and
             all(e.accuracy_after == 1.0 and e.compile_delta == 0
                 for e in recal.events),
             f"canary loop: {accs}, compile delta {canary_delta}")

    # kernel vs plain, layer by layer, at each checked age
    checks = []
    ages = sorted(outs)
    for age in ages:
        age_t = torch.full((), float(age), dtype=torch.float32, device=dev)
        flips, clear = _layerwise_check(torch, tcompile, tq, chip, x,
                                        "memristor (drifting)", age_t)
        plain = tcompile.stream_pipeline(chip.plan, x, use_kernel=False,
                                         age=age_t)
        e = _rel(outs[age][clear], plain[clear])
        _require(e <= TOL_F32, f"drifting stream at age {age}: rel {e:.3g}")
        _require(bool(torch.isfinite(outs[age]).all()), f"non-finite at "
                                                        f"age {age}")
        checks.append({"age": age, "stream_vs_plain_rel": e,
                       "threshold_flips_in_band": flips,
                       "rows_compared": int(clear.sum())})
    moved = _rel(outs[ages[-1]], outs[ages[0]])
    _require(moved > 1e-3, f"drift moved the output by only rel {moved:.3g} "
                           f"at age {ages[-1]}")
    _line({"phase": "variability", "noise": NOISE_KW,
           "launches_per_stream_call": per_call, "launches": launches,
           "checks": checks, "tol": TOL_F32,
           "output_moved_rel_oldest_vs_age0": moved,
           "noise_model_ideal_equal_to_none": identical,
           "reprogram_compile_delta": reprogram_delta,
           "drift_only_reprogram_restores_age0": True,
           "canary": {"rows": CANARY_ROWS, "slo": CANARY_SLO,
                      "drift_rate": DRIFT_RATE, "series": monitor.series(),
                      "recals": len(recal.events),
                      "accuracy_after": [e.accuracy_after
                                         for e in recal.events],
                      "compile_delta": canary_delta},
           "card": card})
    return chip, x, launches


def phase_variability_times(torch, chip_mod, tcl, drifting, x, dev, card):
    """The drifting chip's stream against the ideal chip's on the kernel
    path, in alternating rounds (ideal, drifting, drifting, ideal), and
    both chips' device busy time."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    chips = {"ideal": chip_mod.compile_chip(spec, params=params, device=dev),
             "drifting": drifting}
    times = {k: [] for k in chips}
    for _ in range(STREAM_ROUNDS):
        for k in ("ideal", "drifting", "drifting", "ideal"):
            times[k].append(_time_ms(torch, lambda: chips[k].stream(x),
                                     iters=10))
    for k, ms in times.items():
        med, q1, q3 = _quartiles(ms)
        _line({"metric": "variability_stream_items_per_s", "chip": k,
               "system": "memristor", "use_kernel": True, "batch": STREAM_B,
               "ms_per_batch_median": med, "ms_per_batch_q1": q1,
               "ms_per_batch_q3": q3, "runs": len(ms),
               "items_per_s": STREAM_B / med * 1e3,
               **_device_busy(torch, chips[k], x, True, med), "card": card})


# --------------------------------------------------------------------- #
# phase 6: the paper's five apps
# --------------------------------------------------------------------- #
def _close(got, want, path):
    if isinstance(want, dict):
        _require(isinstance(got, dict) and set(got) == set(want),
                 f"{path}: keys")
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        _require(len(got) == len(want), f"{path}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        # equal covers the infinite rates (a fabric with no mesh link)
        _require(got == want or
                 abs(got - want) <= REPORT_RTOL * abs(want) + 1e-12,
                 f"{path}: {got!r} != {want!r}")
    else:
        _require(got == want, f"{path}: {got!r} != {want!r}")


def _app_nets(apps, app_id, system):
    nets = []
    for _, dims in apps[app_id].nets(system):
        if tuple(dims) not in nets:
            nets.append(tuple(dims))
    return nets


def phase_paper_apps(torch, ops, tcompile, tq, tcl, chip_mod, dev, card):
    """Every app's Tables II–VI report against the golden file, then
    every weighted net of every app streamed through the kernels on both
    systems (counters reset just before, read just after), then checked
    layer by layer against the einsum path."""
    from repro_torch.configs.paper_apps import APPS
    from repro_torch.core.costmodel import risc_cost
    with open(os.path.join(ROOT, "tests", "golden",
                           "fleet_tables.json")) as f:
        golden = json.load(f)["apps"]
    reports = 0
    for app_id, app in APPS.items():
        for key, system in (("1t1m", "memristor"), ("digital", "digital")):
            rep = chip_mod.compile_app(app, system, device=dev).report()
            _close(rep.to_dict(), golden[app_id][key], f"{app_id}.{key}")
            reports += 1
        risc = dataclasses.asdict(risc_cost(app))
        risc.pop("mapping")
        risc.pop("route")
        _close(risc, golden[app_id]["risc"], f"{app_id}.risc")
        reports += 1

    runs = []
    ops.reset_launch_counts()
    for app_id in APPS:
        for system in ("memristor", "digital"):
            for k, dims in enumerate(_app_nets(APPS, app_id, system)):
                spec = tcl.MLPSpec(dims, activation="threshold",
                                   out_activation="linear")
                params = tcl.mlp_init(
                    spec, generator=torch.Generator().manual_seed(10 + k),
                    device=dev)
                chip = chip_mod.compile_chip(spec, params=params,
                                             system=system, device=dev)
                x = torch.rand((STREAM_B, dims[0]),
                               generator=torch.Generator().manual_seed(k)
                               ).to(dev)
                before = ops.launch_counts()
                out = chip.stream(x)
                runs.append((app_id, system, dims, chip, x, out,
                             _deltas(ops.launch_counts(), before)))
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    rows = []
    for app_id, system, dims, chip, x, out, per_call in runs:
        key = "crossbar_mvm" if system == "memristor" else \
            "int8_matmul_fused"
        _require(per_call[key] == len(dims) - 1,
                 f"{app_id} {system} {dims}: launches {per_call}")
        _require(tuple(out.shape) == (STREAM_B, dims[-1]) and
                 bool(torch.isfinite(out).all()),
                 f"{app_id} {system} {dims}: output")
        flips, clear = _layerwise_check(torch, tcompile, tq, chip, x,
                                        f"{app_id} {system} {dims}")
        plain = chip.stream(x, use_kernel=False)
        e = _rel(out[clear], plain[clear])
        _require(e <= TOL_F32, f"{app_id} {system} {dims}: stream vs "
                               f"plain rel {e:.3g}")
        rows.append({"app": app_id, "system": system, "dims": list(dims),
                     "tiles": [list(layer.tiles.gp.shape[:2])
                               if system == "memristor" else
                               list(layer.tiles.wq.shape)
                               for layer in chip.plan],
                     "launches": per_call[key], "stream_vs_plain_rel": e,
                     "threshold_flips_in_band": flips,
                     "rows_compared": int(clear.sum())})
    _line({"phase": "paper_apps", "reports_equal_golden": reports,
           "report_rtol": REPORT_RTOL, "nets": rows, "items": STREAM_B,
           "launches": launches, "tol": TOL_F32, "card": card})
    return launches


# --------------------------------------------------------------------- #
# phase 7: wide digital codes through the raw int8 kernel's byte planes
# --------------------------------------------------------------------- #
def _layer_planes(torch, tcl, chip, x):
    """Each wide layer's input-code and synapse byte planes on the
    einsum path's own activations: [(layer, x planes, w planes)]."""
    from repro_torch.chip import compile as tcompile
    h, out = x, []
    for i, layer in enumerate(chip.plan):
        p = layer.tiles
        xq = tcl.quantize_inputs(p, h.to(torch.float32))
        out.append((i, tcl.unsigned_byte_planes(xq, -(-p.bits // 8)),
                    p.planes))
        h = tcompile._apply_stream_layer(layer, h, False)
    return out


def phase_wide_digital(torch, ops, ref, tcl, chip_mod, dev, card):
    """The deep app on the digital system at 12-bit codes: stream and
    serve through the raw int8 kernel's byte planes (counters reset
    just before, read just after), then the stream against the einsum
    path (to the bit) and the raw kernel against its plain version at
    the plane shapes."""
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(7)).to(dev)
    gen = torch.Generator().manual_seed(8)
    items = [torch.rand((3 + i % 4, DEEP[0]), generator=gen).numpy()
             for i in range(8)]

    ops.reset_launch_counts()
    chip = chip_mod.compile_chip(spec, params=params, system="digital",
                                 weight_bits=WIDE_BITS, device=dev)
    before = ops.launch_counts()
    out = chip.stream(x)
    per_call = _deltas(ops.launch_counts(), before)
    eng = chip.serve(slots=4)
    for uid, it in enumerate(items):
        eng.submit(chip_mod.ChipRequest(uid=uid, items=it))
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    planes = [tuple(layer.tiles.planes.shape) for layer in chip.plan]
    per_layer = (-(-WIDE_BITS // 8)) * chip.plan[0].tiles.planes.shape[0]
    _require(per_call == {"crossbar_mvm": 0, "int8_matmul_fused": 0,
                          "int8_matmul_raw": per_layer * len(chip.plan)},
             f"wide digital stream launches {per_call}")
    _require(len(done) == len(items), f"wide digital: served {len(done)}")
    _require(launches["int8_matmul_raw"] ==
             per_layer * len(chip.plan) * (1 + eng.steps),
             f"wide digital launches {launches}")
    plain = chip.stream(x, use_kernel=False)
    _require(bool(torch.equal(out, plain)),
             f"wide digital stream differs from the einsum path: rel "
             f"{_rel(out, plain):.3g}")
    _require(tuple(out.shape) == (STREAM_B, DEEP[-1]) and
             bool(torch.isfinite(out).all()), "wide digital output")
    served_equal = all(
        torch.equal(torch.from_numpy(st.result),
                    chip.stream(torch.from_numpy(st.request.items)
                                .to(dev)).cpu()) for st in done)
    _require(served_equal, "wide digital: served outputs differ from the "
                           "direct stream")
    checks = 0
    for i, xp, wp in _layer_planes(torch, tcl, chip, x):
        for a in range(xp.shape[0]):
            for b in range(wp.shape[0]):
                _require(torch.equal(ops.int8_matmul(xp[a], wp[b]),
                                     ref.int8_matmul_ref(xp[a], wp[b])),
                         f"raw int8 layer {i} planes ({a}, {b}) not exact")
                checks += 1
    _line({"phase": "wide_digital", "bits": WIDE_BITS, "items": STREAM_B,
           "planes": planes, "launches_per_stream_call": per_call,
           "launches": launches, "stream_equal_to_einsum_path": True,
           "served_requests": len(done), "engine_steps": eng.steps,
           "served_equal_to_direct_stream": True,
           "raw_plane_checks_exact": checks, "card": card})
    return chip, x, launches


def phase_wide_digital_times(torch, ops, ref, tcl, chip, x, launches, card):
    """The raw int8 kernel's row of the ``kernels`` line (``launches``:
    the main path's): per layer, the plane products of one streamed
    batch (one launch each), against the plain version and one PyTorch
    matmul a product, with the bound; then the wide stream's items/s
    through the planes and on the einsum path, alternating."""
    rows = []
    for i, xp, wp in _layer_planes(torch, tcl, chip, x):
        pairs = [(a, b) for a in range(xp.shape[0])
                 for b in range(wp.shape[0])]
        B, K = xp.shape[1:]
        N = wp.shape[2]
        wf = [w.float() for w in wp]
        err = max(float((ops.int8_matmul(xp[a], wp[b]) -
                         ref.int8_matmul_ref(xp[a], wp[b])).abs().max())
                  for a, b in pairs)
        # each x and w plane read once, each int32 product written once
        nbytes = (xp.shape[0] * B * K + wp.shape[0] * K * N +
                  4 * len(pairs) * B * N)
        t_bytes, t_ops = _bound(nbytes, len(pairs) * 2 * B * K * N,
                                INT8_OPS)
        rows.append({
            "kernel": "int8_matmul_raw", "layer": i, "bits": WIDE_BITS,
            "plane_products": len(pairs), "shape": [B, K, N],
            "max_abs_err": err,
            **_times(torch,
                     lambda: [ops.int8_matmul(xp[a], wp[b])
                              for a, b in pairs],
                     lambda: [ref.int8_matmul_ref(xp[a], wp[b])
                              for a, b in pairs],
                     lambda: [xp[a].float() @ wf[b] for a, b in pairs]),
            "bytes_ms": t_bytes, "ops_ms": t_ops, "card": card})
    for r in rows:
        _line(r)
    # the wide stream end to end, planes and einsum path alternating
    times = {True: [], False: []}
    for _ in range(STREAM_ROUNDS):
        for use_kernel in (False, True, True, False):
            times[use_kernel].append(_time_ms(
                torch, lambda: chip.stream(x, use_kernel=use_kernel),
                iters=10))
    for use_kernel, ms in times.items():
        med, q1, q3 = _quartiles(ms)
        _line({"metric": "wide_digital_stream_items_per_s",
               "bits": WIDE_BITS, "use_kernel": use_kernel,
               "batch": STREAM_B, "ms_per_batch_median": med,
               "ms_per_batch_q1": q1, "ms_per_batch_q3": q3,
               "runs": len(ms), "items_per_s": STREAM_B / med * 1e3,
               **_device_busy(torch, chip, x, use_kernel, med), "card": card})
    return _kernel_row("int8_matmul_raw", "src/repro_torch/kernels/csrc/"
                       "int8_matmul.cu", "src/repro/kernels/int8_matmul.py:36",
                       launches["int8_matmul_raw"], rows)


# --------------------------------------------------------------------- #
# phase 8: the fleet — four logical chips on the one card
# --------------------------------------------------------------------- #
def _fleet_vs_chip(torch, got, want):
    e = _rel(got, want)
    _require(e <= FLEET_TOL and tuple(got.shape) == tuple(want.shape),
             f"fleet vs chip rel {e:.3g}")
    return {"equal": bool(torch.equal(got, want)), "rel": e}


def phase_fleet(torch, ops, tcompile, tcl, chip_mod, drifting, dev, card):
    """The deep app on both systems as four logical chips on the one
    card (counters reset just before, read just after): streams of
    16,384 and 4,097 items, resize 4 → 2 → 4, reprogram, the drifting
    chip as a fleet at three ages, a sensor-fed router drain and the
    report; then each result against the chip's."""
    import numpy as np

    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, StreamSource, shard_chip
    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    params2 = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(9),
                           device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(10)).to(dev)
    pipe = SensorPipeline(window=28, stride=18)
    _require(pipe.d_item == DEEP[0] and pipe.items_per_step == 9,
             "sensor windows are not the deep app's items")
    chips = {s: chip_mod.compile_chip(spec, params=params, system=s,
                                      device=dev)
             for s in ("memristor", "digital")}

    ops.reset_launch_counts()
    c0 = chip_mod.compile_count()
    got, per_batch, routers = {}, {}, {}
    for system, chip in chips.items():
        fleet = shard_chip(chip, FLEET_CHIPS)
        before = ops.launch_counts()
        got[system, "batch"] = fleet.stream(x)
        per_batch[system] = _deltas(ops.launch_counts(), before)
        got[system, "ragged"] = fleet.stream(x[:FLEET_RAGGED_B])
        for n in (2, FLEET_CHIPS):
            fleet.resize(n)
            got[system, f"resize_{n}"] = fleet.stream(x)
        fleet.reprogram(params2)
        got[system, "reprogram"] = fleet.stream(x)
        router = FleetRouter(fleet, lanes_per_chip=FLEET_LANES)
        source = StreamSource(pipe, n_requests=FLEET_REQUESTS, capacity=8)
        done = sorted(router.serve(source), key=lambda st: st.request.uid)
        routers[system] = (fleet, router, source, done)
    ages, drift_fleet = [], shard_chip(drifting, FLEET_CHIPS)
    for _ in range(3):
        ages.append(drifting.items_streamed)
        got["drifting", ages[-1]] = drift_fleet.stream(x)
    compile_delta = chip_mod.compile_count() - c0
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    _require(compile_delta == 0, f"fleet compile delta {compile_delta}")
    kernel = {"memristor": "crossbar_mvm", "digital": "int8_matmul_fused"}
    for system, per in per_batch.items():
        want = {k: 3 if k == kernel[system] else 0 for k in per}
        _require(per == want, f"{system} fleet batch launches {per}")
    _require([b - a for a, b in zip(ages, ages[1:])] == [STREAM_B] * 2 and
             drifting.items_streamed == ages[-1] + STREAM_B,
             f"fleet drift clock {ages}, {drifting.items_streamed}")
    results = {}
    for system, chip in chips.items():
        re = chip_mod.reprogram_chip(chip, params2)
        want = {"batch": chip.stream(x),
                "ragged": chip.stream(x[:FLEET_RAGGED_B]),
                "resize_2": chip.stream(x),
                f"resize_{FLEET_CHIPS}": chip.stream(x),
                "reprogram": re.stream(x)}
        results[system] = {k: _fleet_vs_chip(torch, got[system, k], w)
                           for k, w in want.items()}
        fleet, router, source, done = routers[system]
        _require(len(done) == FLEET_REQUESTS and source.exhausted and
                 all(st.result.shape == (9, DEEP[-1]) for st in done),
                 f"{system} router drained {len(done)}")
        items = torch.from_numpy(np.concatenate([st.request.items
                                                 for st in done])).to(dev)
        direct = fleet.stream(items).cpu()
        served = torch.from_numpy(np.concatenate([st.result for st in done]))
        diff = float((served - direct).abs().max())
        # the reference selftest's bound: lanes batch differently
        _require(diff <= 1e-5, f"{system} router outputs differ from the "
                               f"direct stream by {diff:.3g}")
        rep = fleet.report(router)
        chip_rep = chip.report()
        _require(rep.n_chips == FLEET_CHIPS and
                 abs(rep.power_mw - FLEET_CHIPS * chip_rep.power_mw) < 1e-9
                 and rep.served.items == FLEET_REQUESTS * 9,
                 f"{system} fleet report {rep}")
        results[system]["router"] = {
            "requests": len(done), "steps": router.steps,
            "lanes": router.slots, "items": router.items_emitted,
            "served_equal_to_direct_stream": bool(torch.equal(served,
                                                              direct)),
            "served_max_abs_diff": diff,
            "report_capacity_items_per_s": rep.capacity_items_per_second}
    drift = {}
    for age in ages:
        age_t = torch.full((), float(age), dtype=torch.float32, device=dev)
        want = tcompile.stream_pipeline(drifting.plan, x, use_kernel=True,
                                        replication=drifting.replication,
                                        age=age_t)
        drift[age] = _fleet_vs_chip(torch, got["drifting", age], want)
    _line({"phase": "fleet", "chips": FLEET_CHIPS, "on": "one card",
           "items": STREAM_B, "ragged_items": FLEET_RAGGED_B,
           "tol": FLEET_TOL, "launches_per_fleet_batch": per_batch,
           "compile_delta": compile_delta, "systems": results,
           "drifting": {str(a): d for a, d in drift.items()},
           "launches": launches, "card": card})
    return chips, x, launches


def phase_fleet_times(torch, chip_mod, chips, x, card):
    """Fleet and single chip alternating in one process (chip, fleet,
    fleet, chip): ms a batch, device busy time, idle share and kernels a
    batch, with the fleet held to the chip's kernels and busy time; then
    router steps/s beside ``chip.serve(slots=16)`` on the same
    requests, the median of three drains after a warm-up."""
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, shard_chip
    pipe = SensorPipeline(window=28, stride=18)
    requests = [pipe.batch(step).numpy() for step in range(FLEET_REQUESTS)]
    for system, chip in chips.items():
        paths = {"chip": chip, "fleet": shard_chip(chip, FLEET_CHIPS)}
        times = {k: [] for k in paths}
        for _ in range(STREAM_ROUNDS):
            for k in ("chip", "fleet", "fleet", "chip"):
                times[k].append(_time_ms(torch, lambda: paths[k].stream(x),
                                         iters=10))
        busy = {}
        for k, ms in times.items():
            med, q1, q3 = _quartiles(ms)
            busy[k] = _device_busy(torch, paths[k], x, True, med)
            _line({"metric": "fleet_stream_items_per_s", "system": system,
                   "path": k, "chips": FLEET_CHIPS if k == "fleet" else 1,
                   "batch": STREAM_B, "ms_per_batch_median": med,
                   "ms_per_batch_q1": q1, "ms_per_batch_q3": q3,
                   "runs": len(ms), "items_per_s": STREAM_B / med * 1e3,
                   **busy[k], "card": card})
        if all(b["device_busy_ms"] != "not measured"
               for b in busy.values()):
            _require(busy["fleet"]["kernels_per_batch"] <=
                     busy["chip"]["kernels_per_batch"] + 2,
                     f"{system} fleet kernels a batch {busy}")
            _require(busy["fleet"]["device_busy_ms"] <=
                     1.05 * busy["chip"]["device_busy_ms"],
                     f"{system} fleet device busy {busy}")
        engines = {
            "fleet_router": lambda: FleetRouter(
                paths["fleet"], lanes_per_chip=FLEET_LANES),
            "chip_engine": lambda: chip.serve(
                slots=FLEET_LANES * FLEET_CHIPS)}
        rates = {k: [] for k in engines}
        steps = {}
        for _ in range(1 + SERVE_DRAINS):   # the first round warms up
            for k, make in engines.items():
                eng = make()
                for uid, it in enumerate(requests):
                    eng.submit(chip_mod.ChipRequest(uid=uid, items=it))
                t0 = time.perf_counter()
                eng.run_until_drained()
                torch.cuda.synchronize()
                rates[k].append(eng.steps / (time.perf_counter() - t0))
                steps[k] = eng.steps
        for k, r in rates.items():
            _line({"metric": "fleet_router_steps_per_s", "system": system,
                   "engine": k, "lanes": FLEET_LANES * FLEET_CHIPS,
                   "requests": FLEET_REQUESTS, "steps": steps[k],
                   "drains": r[1:], "warm_up_drain": r[0],
                   "steps_per_s": _quartiles(r[1:])[0], "card": card})


# --------------------------------------------------------------------- #
# phase 9: the fleet over ranks — processes sharing the one card
# --------------------------------------------------------------------- #
def _ranks_failed(summary) -> str:
    """What a failed multi-process run says about itself."""
    bad = {r: w.get("error") or {k: w[k] for k in w if k not in
                                 ("memristor", "digital")}
           for r, w in summary["workers"].items() if not w.get("ok")}
    return json.dumps(bad)[:2000] if bad else "a parent-side check failed"


def phase_ranks(torch, chip_mod, device, card):
    """The deep app as a fleet of RANKS ranks × RANK_CHIPS logical chips
    sharing the one card: the parent builds the kernels, spawns the
    ranks (fresh interpreters, one gloo group through a ``file://``
    store) through ``launch_local_fleet`` and reads each rank's last
    JSON line. Lockstep fleet, both systems: each rank's
    ``stream_local`` on its block of STREAM_B rows equals the chip's
    stream of the same rows bit for bit with three kernel launches a
    call and the one-process stream within FLEET_TOL; the lockstep
    router drains each rank's ``StreamSource.for_host`` feed
    RANK_DRAINS times with the same steps on every rank; ``stats_global``
    is identical on every rank and equal to ``assemble_stats`` of the
    ranks' own rows; each rank's lockstep router then degrades to its
    own chips, resizes to twice them and drains locally, its stream
    equal to the chip's. Then rank 1 of a lockstep fleet and rank 0 of a
    federated one are killed mid-serve, and the survivor absorbs the
    dead feed with every uid accounted once and no compile. Last, the
    lockstep router's aggregate rate against one process's
    ``FleetRouter`` with the same lanes and requests. Returns the ranks'
    kernel launches (the victims', killed, are not reported)."""
    from repro_torch.data import SensorPipeline
    from repro_torch.fleet import FleetRouter, StreamSource, shard_chip
    from repro_torch.fleet import __main__ as fmain
    on_card = torch.device("cuda" if device is None else device).type == \
        "cuda"
    t0 = time.perf_counter()
    dist = fmain.run_distributed_selftest(
        RANKS, RANK_CHIPS, device=device, rows=STREAM_B,
        requests=RANK_REQUESTS, drains=RANK_DRAINS, verbose=False,
        timeout=300.0)
    dist_s = time.perf_counter() - t0
    _require(dist["pass"], f"fleet of ranks: {_ranks_failed(dist)}")
    workers = [dist["workers"][r] for r in sorted(dist["workers"])]
    launches = {}
    for w in workers:
        for k, v in w["launches"].items():
            launches[k] = launches.get(k, 0) + v
    systems = {}
    for system in fmain.SYSTEMS:
        rows = [w[system] for w in workers]
        for row in rows:
            per = row["launches_per_call"]
            want = {k: 3 if on_card and k == fmain.KERNEL[system] else 0
                    for k in per}
            _require(per == want and row["equal_chip"] and
                     row["rel_one_process"] <= FLEET_TOL,
                     f"{system} rank stream_local: {per}, "
                     f"rel {row['rel_one_process']}")
            _require(row["degraded_resized"]["equal_chip"] and
                     row["degraded_resized"]["chips"] == 2 * RANK_CHIPS,
                     f"{system} rank degrade + resize: "
                     f"{row['degraded_resized']}")
        drains = rows[0]["drains"]
        timed = drains[1:] or drains
        systems[system] = {
            "launches_per_stream_local_call": [r["launches_per_call"]
                                               for r in rows],
            "equal_to_chip": [r["equal_chip"] for r in rows],
            "rel_one_process": [r["rel_one_process"] for r in rows],
            "steps_per_rank": [r["counts"][2] for r in rows],
            "degraded_resized": [r["degraded_resized"] for r in rows],
            "stats_global": rows[0]["stats_global"],
            "lockstep_drains": drains,
            # each rank's seconds a drain in the lockstep reduction
            "lockstep_in_reduce_s": [[d["in_reduce_s"] for d in r["drains"]]
                                     for r in rows],
            "lockstep_items_per_s": _quartiles(
                [d["items_per_s"] for d in timed])[0],
            "lockstep_steps_per_s": _quartiles(
                [d["steps_per_s"] for d in timed])[0]}

    chaos = {}
    for name, lockstep, kill_rank in (("lockstep_degrade", True, 1),
                                      ("federated_chaos", False, 0)):
        t0 = time.perf_counter()
        res = fmain.run_chaos_selftest(
            RANKS, kill_rank=kill_rank, kill_step=3, lockstep=lockstep,
            chips_per_process=RANK_CHIPS, device=device, verbose=False,
            timeout=300.0)
        _require(res["pass"], f"{name}: {_ranks_failed(res)}")
        (survivor,) = res["workers"].values()
        _require(survivor["compile_delta"] == 0 and
                 survivor["absorbed"] == [kill_rank] and
                 survivor["degraded"] == lockstep and
                 survivor["resize_rel"] == 0.0,
                 f"{name} survivor {survivor}")
        for k, v in survivor["launches"].items():
            launches[k] = launches.get(k, 0) + v
        chaos[name] = {
            "killed_rank": kill_rank, "kill_step": 3,
            "survivor": survivor["rank"],
            "uids_completed_once": res["completed"],
            "rejected": res["rejected"],
            "victim_completed_at_death": res["victim_completed_at_death"],
            "degraded_in_place": survivor["degraded"],
            "compile_delta": survivor["compile_delta"],
            "board_stats_requests": survivor["stats_requests"],
            "board_stats_items": survivor["stats_items"],
            "resized_chips": survivor["resized_chips"],
            "resize_rel": survivor["resize_rel"],
            "degraded_items_per_s": survivor["degraded_ips"],
            "seconds": time.perf_counter() - t0}
    _line({"phase": "ranks", "ranks": RANKS, "chips_per_rank": RANK_CHIPS,
           "on": "one card", "rows": STREAM_B, "tol": FLEET_TOL,
           "requests_per_rank": RANK_REQUESTS,
           "lanes_per_rank": fmain.LANES_PER_CHIP * RANK_CHIPS,
           "systems": systems, **chaos, "seconds": dist_s,
           "launches": launches, "card": card})
    _line({"metric": "any_across_hosts_us", "ranks": RANKS,
           "calls": fmain.AAH_CALLS,
           "per_rank": [w["any_across_hosts_us"] for w in workers],
           "card": card})
    _line({"metric": "rank_lane_stream_ms", "rows": fmain.LANES_PER_CHIP *
           RANK_CHIPS, "calls": fmain.LANE_CALLS,
           "per_rank": [w["lane_stream_ms"] for w in workers], "card": card})
    if on_card:
        _line({"metric": "rank_cuda_max_memory_allocated_bytes",
               "per_rank": [w["cuda_max_memory_allocated_bytes"]
                            for w in workers], "card": card})

    # the same lanes and requests served by one process's FleetRouter
    dev = torch.device("cuda", 0) if on_card else torch.device(device)
    pipe = SensorPipeline(window=28, stride=18)
    for system in fmain.SYSTEMS:
        fleet = shard_chip(fmain._deep_chip(system, dev), RANKS * RANK_CHIPS)
        rates = []
        for _ in range(RANK_DRAINS):
            router = FleetRouter(fleet, lanes_per_chip=fmain.LANES_PER_CHIP,
                                 queue_limit=4)
            router.serve(StreamSource(pipe, n_requests=RANKS * RANK_REQUESTS,
                                      capacity=3))
            s = router.stats()
            _require(s.requests == RANKS * RANK_REQUESTS,
                     f"one-process router served {s.requests}")
            rates.append({"steps": s.steps, "wall_s": s.wall_s,
                          "items_per_s": s.items_per_second,
                          "steps_per_s": s.steps / s.wall_s})
        timed = rates[1:] or rates
        one = {"items_per_s": _quartiles([r["items_per_s"]
                                          for r in timed])[0],
               "steps_per_s": _quartiles([r["steps_per_s"]
                                          for r in timed])[0]}
        lock = systems[system]
        _line({"metric": "ranks_router_rate", "system": system,
               "lanes": fmain.LANES_PER_CHIP * RANKS * RANK_CHIPS,
               "requests": RANKS * RANK_REQUESTS,
               "lockstep_ranks": RANKS,
               "lockstep_items_per_s": lock["lockstep_items_per_s"],
               "lockstep_steps_per_s": lock["lockstep_steps_per_s"],
               "lockstep_drains": lock["lockstep_drains"],
               "one_process_items_per_s": one["items_per_s"],
               "one_process_steps_per_s": one["steps_per_s"],
               "one_process_drains": rates,
               "first_drain_is_warm_up": len(rates) > 1, "card": card})
    return launches


# --------------------------------------------------------------------- #
# phase 10: the declarative deployment and the tuner
# --------------------------------------------------------------------- #
class _Frames:
    """A (seed, step)-pure request pipeline: DEPLOY_ITEMS deep-app items
    a step."""

    def __init__(self, torch, seed):
        self.torch, self.seed = torch, seed

    def batch(self, step):
        gen = self.torch.Generator().manual_seed(1000 * self.seed + step)
        return self.torch.rand((DEPLOY_ITEMS, DEEP[0]),
                               generator=gen).numpy()


def _roll_up(stats):
    """The per-app rows' sums beside the fleet row's counters."""
    keys = ("requests", "items", "rejected", "lanes")
    apps = {k: sum(getattr(s, k) for s in stats.apps.values())
            for k in keys}
    fleet = {k: getattr(stats.fleet, k) for k in keys}
    return apps, fleet


def _served_diff(torch, d, done, dev):
    """Max |routed output − the tenant's direct stream| over ``done``."""
    import numpy as np
    diff = 0.0
    for app in {st.request.key for st in done}:
        mine = [st for st in done if st.request.key == app]
        items = torch.from_numpy(np.concatenate([st.request.items
                                                 for st in mine])).to(dev)
        served = torch.from_numpy(np.concatenate([st.result
                                                  for st in mine]))
        diff = max(diff, float((served - d.stream(app, items).cpu())
                               .abs().max()))
    return diff


def phase_deploy(torch, ops, ref, tcompile, tq, tcl, chip_mod, var, dev,
                 card):
    """(a) single-app ``deploy()`` against ``shard_chip``, (b)+(e) the
    two-tenant served drain under telemetry, (c) the tuned heterogeneous
    fabric, (d) the canary loop on a deployed drifting tenant. The
    path's launches are counted around each path call (``on_path``);
    the checks against ``shard_chip``, the direct stream and the einsum
    path run outside it."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs.paper_apps import APPS
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
    from repro_torch.fleet import StreamSource, shard_chip
    from repro_torch.fleet.ha import HeartbeatBoard
    from repro_torch.obs.trace import phase_breakdown, trace_ok
    from repro_torch.tune import tune

    t_phase = time.perf_counter()
    path = {k: 0 for k in ops.launch_counts()}

    def on_path(fn, *args):
        before = ops.launch_counts()
        out = fn(*args)
        for k, v in _deltas(ops.launch_counts(), before).items():
            path[k] += v
        return out, _deltas(ops.launch_counts(), before)

    spec = tcl.MLPSpec(DEEP, activation="threshold", out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device=dev)
    x = torch.rand((STREAM_B, DEEP[0]),
                   generator=torch.Generator().manual_seed(12)).to(dev)
    kernel = {"memristor": "crossbar_mvm", "digital": "int8_matmul_fused"}
    lines = {}

    # (a) one app on each system: the chip's stream, the chip's launches
    single = {}
    for system in ("memristor", "digital"):
        d = deploy(AppSpec("deep", spec, params=params, system=system),
                   n_chips=DEPLOY_CHIPS, device=dev)
        y, per = on_path(d.stream, "deep", x)
        want = shard_chip(chip_mod.compile_chip(spec, params=params,
                                                system=system, device=dev),
                          DEPLOY_CHIPS).stream(x)
        _require(per == {k: 3 if k == kernel[system] else 0 for k in per},
                 f"deploy {system} launches a batch {per}")
        _require(bool(torch.equal(y, want)),
                 f"deploy {system} differs from shard_chip: rel "
                 f"{_rel(y, want):.3g}")
        single[system] = {"launches_per_batch": per,
                          "equal_to_shard_chip": True}
    lines["single_app"] = single

    # (b) + (e): two tenants on DEPLOY_CHIPS chips, served under
    # telemetry; the trace goes under build/ and is read back
    two = deploy(DeploymentSpec(apps=(
        AppSpec("deep_memristor", spec, params=params,
                lanes_per_chip=DEPLOY_LANES),
        AppSpec("deep_digital", spec, params=params, system="digital",
                lanes_per_chip=DEPLOY_LANES)), n_chips=DEPLOY_CHIPS,
        device=dev))
    sources = {app: StreamSource(_Frames(torch, i),
                                 n_requests=DEPLOY_REQUESTS, capacity=8)
               for i, app in enumerate(two.apps)}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tel = obs.configure()
    try:
        done, per = on_path(two.serve, sources)
        events = tel.tracer.trace_events()
        trace_path = two.trace(os.path.join(ROOT, "build",
                                            "phase10_trace.json"))
    finally:
        obs.disable()
    with open(trace_path) as f:
        doc = json.load(f)
    brk = phase_breakdown(events)
    tiled = sum(brk["phases"].values()) / brk["step_us"]
    steps = two.router.steps
    _require(len(done) == 2 * DEPLOY_REQUESTS and
             all(src.exhausted for src in sources.values()),
             f"two-tenant serve finished {len(done)}")
    _require(per["crossbar_mvm"] == 3 * steps and
             per["int8_matmul_fused"] == 3 * steps,
             f"two-tenant launches {per} in {steps} steps")
    diff = _served_diff(torch, two, done, dev)
    _require(diff <= 1e-5, f"two-tenant routed outputs differ from the "
                           f"direct stream by {diff:.3g}")
    apps_sum, fleet = _roll_up(two.stats())
    _require(apps_sum == fleet == {
        "requests": 2 * DEPLOY_REQUESTS,
        "items": 2 * DEPLOY_REQUESTS * DEPLOY_ITEMS, "rejected": 0,
        "lanes": 2 * DEPLOY_LANES * DEPLOY_CHIPS},
        f"two-tenant roll-up {apps_sum} vs {fleet}")
    _require(trace_ok(doc, len(done)) and brk["steps"] == steps and
             0.90 <= tiled <= 1.02,
             f"trace: {brk['steps']} steps, phases/steps {tiled:.4f}")
    lines["two_tenants"] = {
        "requests": len(done), "steps": steps, "launches": per,
        "served_max_abs_diff": diff, "roll_up": fleet,
        "step_phase_share": {k: v / brk["step_us"]
                             for k, v in sorted(brk["phases"].items())},
        "step_ms_mean": brk["step_us"] / brk["steps"] / 1e3,
        "phases_over_steps": tiled,
        "trace": os.path.relpath(trace_path, ROOT),
        "trace_events": len(doc["traceEvents"])}

    # (c) the tuned heterogeneous fabric
    tuned = tune(DeploymentSpec(apps=(
        AppSpec("deep", "deep", items_per_second=TUNE_SLO),
        AppSpec("ocr", "ocr", items_per_second=TUNE_SLO, weight_bits=12)),
        device=dev))
    picked = {a: (p.system, p.geometry)
              for a, p in tuned.assignment.items()}
    _require(picked == {"deep": ("memristor", "128x64"),
                        "ocr": ("digital", "128x64")} and
             tuned.n_chips == 2, f"tuned assignment {picked}")
    het = deploy(tuned.spec)
    rep = het.report()
    cost_rel = max(abs(rep.area_mm2 - tuned.area_mm2) / tuned.area_mm2,
                   abs(rep.power_mw - tuned.power_mw) / tuned.power_mw)
    _require(het.chip_systems == tuned.chip_systems and
             cost_rel <= REPORT_RTOL, f"tuned report rel {cost_rel:.3g}")
    xs, outs, per_batch = {}, {}, {}
    for i, name in enumerate(het.apps):
        d_in = APPS[name].nets(picked[name][0])[0][1][0]
        xs[name] = torch.rand((STREAM_B, d_in),
                              generator=torch.Generator().manual_seed(20 + i)
                              ).to(dev)
        outs[name], per_batch[name] = on_path(het.stream, name, xs[name])
    gen = torch.Generator().manual_seed(30)
    for name in het.apps:
        d_in = xs[name].shape[1]
        for _ in range(8):
            het.submit(name, torch.rand((DEPLOY_ITEMS, d_in),
                                        generator=gen).numpy())
    mixed, _ = on_path(het.run_until_drained)
    deep_chip, ocr_chip = het.chip("deep"), het.chip("ocr")
    _require(per_batch["deep"] == {"crossbar_mvm": 3, "int8_matmul_fused": 0,
                                   "int8_matmul_raw": 0} and
             per_batch["ocr"] == {"crossbar_mvm": 0, "int8_matmul_fused": 0,
                                  "int8_matmul_raw": 8},
             f"tuned launches a batch {per_batch}")
    flips, clear = _layerwise_check(torch, tcompile, tq, deep_chip,
                                    xs["deep"], "tuned deep")
    plain = deep_chip.stream(xs["deep"], use_kernel=False)
    e_deep = _rel(outs["deep"][clear], plain[clear])
    _require(e_deep <= TOL_F32, f"tuned deep vs einsum rel {e_deep:.3g}")
    _require(bool(torch.equal(outs["ocr"], ocr_chip.stream(
        xs["ocr"], use_kernel=False))), "tuned 12-bit ocr differs from the "
                                        "einsum path")
    plane_checks = 0
    for i, xp, wp in _layer_planes(torch, tcl, ocr_chip, xs["ocr"]):
        for a in range(xp.shape[0]):
            for b in range(wp.shape[0]):
                for rows in (STREAM_B, 4):
                    _require(torch.equal(
                        ops.int8_matmul(xp[a][:rows], wp[b]),
                        ref.int8_matmul_ref(xp[a][:rows], wp[b])),
                        f"raw int8 ocr layer {i} planes ({a}, {b}), "
                        f"{rows} rows, not exact")
                    plane_checks += 1
    diff = _served_diff(torch, het, mixed, dev)
    apps_sum, fleet = _roll_up(het.stats())
    _require(len(mixed) == 16 and diff <= 1e-5 and apps_sum == fleet,
             f"tuned mixed drain: {len(mixed)}, diff {diff:.3g}, "
             f"{apps_sum} vs {fleet}")
    lines["tuned"] = {
        "chip_systems": list(tuned.chip_systems), "assignment": picked,
        "area_mm2": tuned.area_mm2, "power_mw": tuned.power_mw,
        "report_rel": cost_rel, "launches_per_batch": per_batch,
        "deep_vs_einsum_rel": e_deep, "deep_threshold_flips_in_band": flips,
        "deep_rows_compared": int(clear.sum()),
        "ocr_equal_to_einsum_path": True,
        "ocr_planes": [list(lay.tiles.planes.shape) for lay in ocr_chip.plan],
        "raw_plane_checks_exact": plane_checks,
        "mixed_requests": len(mixed), "mixed_served_max_abs_diff": diff,
        "mixed_roll_up": fleet}

    # (d) the canary loop on a deployed drifting deep tenant: drift only,
    # as phase 5's loop — write noise re-rolls at every reprogram, so a
    # chip with it cannot return to its attach-time answers
    canary = torch.rand((CANARY_ROWS, DEEP[0]),
                        generator=torch.Generator().manual_seed(6)).numpy()
    n_req = VAR_LANES * DEPLOY_CHIPS
    frames = torch.rand((n_req * VAR_ITEMS, DEEP[0]),
                        generator=torch.Generator().manual_seed(13)).numpy()
    with tempfile.TemporaryDirectory() as tmp, deploy(AppSpec(
            "deep", spec, params=params,
            noise=var.NoiseModel(drift_rate=DRIFT_RATE, seed=0),
            lanes_per_chip=VAR_LANES), n_chips=DEPLOY_CHIPS,
            device=dev) as drifting:
        board = HeartbeatBoard(tmp)
        monitor = drifting.attach_monitor("deep", canary,
                                          every_steps=CANARY_STEPS)
        recal = drifting.attach_recalibration(
            "deep", policy=var.RecalPolicy(slo=CANARY_SLO), board=board)
        for i in range(n_req):
            drifting.submit("deep", frames[i * VAR_ITEMS:
                                           (i + 1) * VAR_ITEMS])
        c0 = chip_mod.compile_count()
        var_done, _ = on_path(drifting.run_until_drained)
        delta = chip_mod.compile_count() - c0
        events = recal.events
        journaled = len(board.events("recalibration"))
        accs = monitor.series()["accuracy"]
        var_steps = drifting.router.steps
    _require(len(var_done) == n_req and events and delta == 0 and
             min(accs) < CANARY_SLO and journaled == len(events) and
             all(e.accuracy_after >= CANARY_SLO and e.compile_delta == 0
                 for e in events),
             f"deployed canary loop: {[dataclasses.asdict(e) for e in events]}"
             f", compile delta {delta}")
    lines["canary_loop"] = {
        "noise": {"drift_rate": DRIFT_RATE, "seed": 0},
        "lanes": n_req, "steps": var_steps, "requests": len(var_done),
        "recals": [{"step": e.step, "items_streamed": e.items_streamed,
                    "before": e.accuracy_before, "after": e.accuracy_after}
                   for e in events],
        "journaled": journaled, "min_accuracy": min(accs),
        "compile_delta": delta}
    torch.cuda.synchronize()
    _line({"phase": "deploy", **lines, "launches": path,
           "seconds": time.perf_counter() - t_phase, "card": card})
    return two, het, xs, path


def phase_deploy_times(torch, chip_mod, two, het, xs, card):
    """The two-tenant router's steps/s beside one ``FleetRouter`` over
    the memristor tenant's fleet with the same 16 lanes serving the same
    64 requests (medians of three drains after a warm-up); then each
    tuned tenant's ms a batch (10 timings of 10 batches), device busy
    time, idle share and kernels a batch."""
    from repro_torch.deploy import MultiAppRouter
    from repro_torch.fleet import FleetRouter
    members = two.router.members
    frames = {app: _Frames(torch, i) for i, app in enumerate(members)}
    requests = [(app, frames[app].batch(step)) for step in
                range(DEPLOY_REQUESTS) for app in members]
    lanes = DEPLOY_LANES * DEPLOY_CHIPS
    engines = {
        "two_tenant_router": lambda: MultiAppRouter(
            members, lanes={app: lanes for app in members}),
        "one_app_fleet_router": lambda: FleetRouter(
            members["deep_memristor"],
            lanes_per_chip=DEPLOY_LANES * len(members))}
    rates = {k: [] for k in engines}
    steps = {}
    for _ in range(1 + SERVE_DRAINS):       # the first round warms up
        for k, make in engines.items():
            eng = make()
            for uid, (app, items) in enumerate(requests):
                eng.submit(chip_mod.ChipRequest(
                    uid=uid, items=items,
                    key=app if k == "two_tenant_router" else None))
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            rates[k].append(eng.steps / (time.perf_counter() - t0))
            steps[k] = eng.steps
    for k, r in rates.items():
        _line({"metric": "deploy_router_steps_per_s", "engine": k,
               "lanes": 2 * lanes, "requests": len(requests),
               "items": len(requests) * DEPLOY_ITEMS, "steps": steps[k],
               "drains": r[1:], "warm_up_drain": r[0],
               "steps_per_s": _quartiles(r[1:])[0], "card": card})
    for name, x in xs.items():
        member = het.router.members[name]
        ms = [_time_ms(torch, lambda: het.stream(name, x), iters=10)
              for _ in range(2 * STREAM_ROUNDS)]
        med, q1, q3 = _quartiles(ms)
        chip = het.chip(name)
        _line({"metric": "deploy_tuned_tenant_stream", "app": name,
               "system": chip.system,
               "geometry": f"{chip.geom.rows}x{chip.geom.cols}",
               "dims": list(chip.dims), "batch": STREAM_B,
               "ms_per_batch_median": med, "ms_per_batch_q1": q1,
               "ms_per_batch_q3": q3, "runs": len(ms),
               "items_per_s": STREAM_B / med * 1e3,
               **_device_busy(torch, member, x, True, med), "card": card})


# --------------------------------------------------------------------- #
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this script runs only "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch.chip as chip_mod
        import repro_torch.variability as var
        from repro_torch.chip import compile as tcompile
        from repro_torch.core import crossbar_layer as tcl
        from repro_torch.core import quantization as tq
        from repro_torch.kernels import build, ops, ref
    except ImportError as exc:
        print(f"chip_smoke: the repository's src/repro_torch is not beside "
              f"this script ({exc})", file=sys.stderr)
        return 2
    # the plain versions' products stay IEEE f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = smi
    try:
        t0 = time.perf_counter()
        seconds = build.build()
        _line({"phase": "build", "seconds": time.perf_counter() - t0,
               "per_kernel_s": seconds, "dir": str(build.BUILD_DIR)})
        phase_kernels(torch, ops, ref, dev)
        chips, launches = phase_main_path(torch, ops, tcompile, tq, tcl,
                                          chip_mod, dev, card)
        kernels = phase_times(torch, ops, ref, tcompile, tcl, chip_mod,
                              chips, launches, dev, card)
        drifting, x_var, var_launches = phase_variability(
            torch, ops, tcompile, tq, tcl, chip_mod, var, dev, card)
        phase_variability_times(torch, chip_mod, tcl, drifting, x_var, dev,
                                card)
        app_launches = phase_paper_apps(torch, ops, tcompile, tq, tcl,
                                        chip_mod, dev, card)
        wide, x_wide, wide_launches = phase_wide_digital(
            torch, ops, ref, tcl, chip_mod, dev, card)
        fleet_chips, x_fleet, fleet_launches = phase_fleet(
            torch, ops, tcompile, tcl, chip_mod, drifting, dev, card)
        kernels.append(phase_wide_digital_times(
            torch, ops, ref, tcl, wide, x_wide, launches, card))
        phase_fleet_times(torch, chip_mod, fleet_chips, x_fleet, card)
        rank_launches = phase_ranks(torch, chip_mod, None, card)
        two, het, x_tuned, deploy_launches = phase_deploy(
            torch, ops, ref, tcompile, tq, tcl, chip_mod, var, dev, card)
        phase_deploy_times(torch, chip_mod, two, het, x_tuned, card)
        # each kernel's launches: the main path's and the later phases'
        for row in kernels:
            for later in (var_launches, app_launches, wide_launches,
                          fleet_launches, rank_launches, deploy_launches):
                row["launches"] += later[row["name"]]
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    _line({"kernels": kernels})
    _line({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
