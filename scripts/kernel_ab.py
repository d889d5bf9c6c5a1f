#!/usr/bin/env python3
"""Compare the CUDA kernels of several checkouts of this repository on
one card, in one process.

    python3 scripts/kernel_ab.py [--rounds N] TREE [TREE ...]

Each TREE is the root of a checkout (the directory that holds its
``src/repro_torch``), for example this one (``.``) and a ``git archive``
of an older commit unpacked under ``build/``; its kernels must keep the
C entry points of ``kernels/build.py``, as every tree since the port
began does. The script builds each tree's kernel libraries with that
tree's own ``build.py`` (all at once), loads them all into this
process and swaps them under this checkout's wrappers: the Python side,
the process and the card are the same for every tree, only the kernels
differ. Trees are visited in order, then in reverse, and so on:

  * in each of N rounds (default 4) it times ``crossbar_mvm`` in
    partials mode (f32 x) at the deep app's three layer shapes and
    ``int8_matmul`` fused (uint8 codes) at its three layer shapes, each
    at B = 16,384 (a streamed batch) and at the serving batches 4 and
    1: the card's own time (calls queued behind a sleep, ``device_ms``)
    and the time at the host's launch pace (``host_paced_ms``); and,
    once a round, the PyTorch call that computes each kernel's function
    (under ``library``), the same two ways;
  * then, in 4·N rounds with nothing else between them, one drain of
    ``chip.serve(slots=4)`` (32 requests of 16 items) on each system
    and tree: engine steps/s.

It prints the card's name and power limit, one JSON line per round
and tree, and a last line with each number's median over the rounds
(the serving rates also with their quartiles), side by side. It needs
one CUDA card and imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402  (timing and operand helpers)

BATCHES = (cs.STREAM_B, 4, 1)
CB_LAYERS = ((7, 4, 128, 64), (2, 2, 128, 64), (1, 1, 128, 64))
I8_LAYERS = ((784, 200), (200, 100), (100, 10))
SERVE_ROUNDS_PER_ROUND = 4


def _build(tree: str) -> subprocess.Popen:
    """Build ``tree``'s kernels with its own build.py; the process
    prints the libraries' paths as JSON."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; build.build(); "
            "print(json.dumps({n: str(build.library_path(n)) "
            "for n in build.KERNELS}))")
    return subprocess.Popen([sys.executable, "-c", code,
                             os.path.join(tree, "src")],
                            stdout=subprocess.PIPE, text=True)


def _load(build, paths: dict) -> dict:
    """Every entry point of ``build._ENTRY`` that a tree's libraries
    hold (older trees lack the f32 DAC entry of ``int8_matmul``)."""
    entries = {}
    for name, (symbol, argtypes) in build._ENTRY.items():
        lib = ctypes.CDLL(paths[build.library_of(name)])
        if not hasattr(lib, symbol):
            continue
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _calls(torch, dev):
    """(kernel, layer, batch, kernel call, library call) for every timed
    launch, on operands made once from seed 0."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for B in BATCHES:
        for i, (R, C, r, c) in enumerate(CB_LAYERS):
            x, gp, gn, sc, _ = cs._cb_operands(torch, gen, dev, B, R, C, r,
                                               c)
            w = (gp - gn).permute(0, 2, 1, 3).reshape(R, r, C * c) * \
                sc.reshape(R, 1, C * c)
            calls.append((
                "crossbar_mvm", i, B,
                lambda x=x, gp=gp, gn=gn, sc=sc: ops.crossbar_mvm(
                    x, gp, gn, sc, partials=True),
                lambda x=x, w=w: torch.matmul(x.transpose(0, 1), w)))
        for i, (K, N) in enumerate(I8_LAYERS):
            xq = torch.randint(0, 256, (B, K), generator=gen, device=dev,
                               dtype=torch.uint8)
            wq = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                               dtype=torch.int8)
            s = torch.rand(N, generator=gen, device=dev) * 1e-2
            o = torch.randn(N, generator=gen, device=dev)
            calls.append((
                "int8_matmul_fused", i, B,
                lambda xq=xq, wq=wq, s=s, o=o: ops.int8_matmul(xq, wq, s, o),
                lambda xq=xq, wf=wq.float(), s=s, o=o: torch.addcmul(
                    o, xq.float() @ wf, s)))
    return calls


def _drain(torch, chip_mod, chip) -> float:
    """Engine steps/s of one drain of 32 requests of 16 items."""
    eng = chip.serve(slots=4)
    g = torch.Generator().manual_seed(4)
    for uid in range(32):
        eng.submit(chip_mod.ChipRequest(
            uid=uid, items=torch.rand((16, cs.DEEP[0]),
                                      generator=g).numpy()))
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    return eng.steps / (time.perf_counter() - t0)


def _two_ways(torch, fn) -> list:
    return [cs._device_ms(torch, fn), cs._time_ms(torch, fn)]


def _median(values):
    if isinstance(values[0], list):
        return [statistics.median(v) for v in zip(*values)]
    return statistics.median(values)


def main(argv) -> int:
    rounds = 4
    if len(argv) >= 2 and argv[0] == "--rounds":
        rounds, argv = int(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card is visible", file=sys.stderr)
        return 2
    import repro_torch.chip as chip_mod
    from repro_torch.core import crossbar_layer as tcl
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    procs = {tree: _build(tree) for tree in argv}
    paths, libs = {}, {}
    for tree, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"kernel_ab: the build of {tree} failed", file=sys.stderr)
            return 1
        paths[tree] = json.loads(out.strip().splitlines()[-1])
        libs[tree] = _load(build, paths[tree])
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": paths}), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    calls = _calls(torch, dev)
    spec = tcl.MLPSpec(cs.DEEP, activation="threshold",
                       out_activation="linear")
    chips = {}
    for system in ("memristor", "digital"):
        params = tcl.mlp_init(spec,
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
        chips[system] = chip_mod.compile_chip(spec, params=params,
                                              system=system, device=dev)
    build._entries.update(libs[argv[0]])
    for chip in chips.values():   # warm-up drains
        _drain(torch, chip_mod, chip)

    table = {}

    def keep(key, tree, value):
        table.setdefault(key, {}).setdefault(tree, []).append(value)

    def order(rnd):
        return argv if rnd % 2 == 0 else argv[::-1]

    for rnd in range(rounds):
        for kind, i, B, _, lib in calls:
            keep(f"{kind}/{i}/B{B}", "library", _two_ways(torch, lib))
        for tree in order(rnd):
            build._entries.update(libs[tree])
            line = {"round": rnd, "tree": tree, "kernels": {}, "card": smi}
            for kind, i, B, kernel, _ in calls:
                key = f"{kind}/{i}/B{B}"
                line["kernels"][key] = _two_ways(torch, kernel)
                keep(key, tree, line["kernels"][key])
            print(json.dumps(line), flush=True)
    serving = {}
    for rnd in range(SERVE_ROUNDS_PER_ROUND * rounds):
        for tree in order(rnd):
            build._entries.update(libs[tree])
            for system, chip in chips.items():
                serving.setdefault(system, {}).setdefault(tree, []).append(
                    _drain(torch, chip_mod, chip))
    print(json.dumps({"engine_steps_per_s": serving, "card": smi}),
          flush=True)

    print(json.dumps({
        "columns": ["device_ms", "host_paced_ms"], "rounds": rounds,
        "medians": {key: {tree: _median(v) for tree, v in by_tree.items()}
                    for key, by_tree in table.items()},
        "engine_steps_per_s_quartiles": {
            system: {tree: cs._quartiles(v) for tree, v in by_tree.items()}
            for system, by_tree in serving.items()},
        "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
