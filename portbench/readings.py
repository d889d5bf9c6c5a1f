"""The readings a configuration's correctness limit is set from.

    python3 portbench/readings.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --seconds 1

run on the card from the root of a checkout, like ``run.py``. In one
process: for each of ``--seeds`` seeds, one run of the cell with a
short window at the cell's own load (the program's readings); for each
of ``--control-seeds`` further seeds, the control (the reference in the
configuration's lower precision) at the cell's own size. One JSON line
a reading, then the largest program reading and the smallest control
reading of each number compared. The benchmark's own runs do not run
this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    seeds = [a.first_seed + 7919 * k
             for k in range(a.seeds + a.control_seeds)]
    prog, ctrl = {}, {}
    for seed in seeds[:a.seeds]:
        r = harness.run_cell(cell, seed, a.seconds, False)
        for name, c in r["check"].items():
            prog.setdefault(name, []).append(float(c["value"]))
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": r["correct"], "check": r["check"],
                          **r["info"]}), flush=True)
    for seed in seeds[a.seeds:]:
        v = harness.control_verdict(cell, seed)
        for name, c in v["check"].items():
            ctrl.setdefault(name, []).append(float(c["value"]))
        print(json.dumps({"side": "control", "seed": seed, **v}),
              flush=True)
    print(json.dumps({"workload": a.workload, "readings": {
        name: {"lower": max(vals), "upper": min(ctrl[name])
               if ctrl.get(name) else None}
        for name, vals in prog.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
