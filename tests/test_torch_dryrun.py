"""The dry run (``repro_torch.launch.dryrun``) on the CPU, in
subprocesses (its ``"fake"`` process group is process-global).

  * Every reduced architecture × input shape on a (2, 2) fake mesh is
    ``ok``, or skips with the reference's ``applicable`` reason; an ok
    cell's peak is at least the bytes of its parameters (and optimizer
    state) on the device, its useful-FLOP share is in (0, 1], and its
    ``model_flops`` is the reference's.
  * The FLOPs the dry run counts for a reduced qwen1.5-0.5B train step
    on a one-position mesh equal those ``FlopCounterMode`` counts on a
    real CPU run of the same step, exactly.
  * The committed ``experiments/dryrun/*.json`` cells (reduced qwen and
    moonshot, ``train_4k`` on 16×16) come out with the same
    ``model_flops`` and ``cost.bytes_per_device``, through the CLI.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro import configs as rconfigs

from repro_torch import configs as tconfigs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")

SWEEP = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import SHAPES, applicable, get_reduced
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_reduced(arch)
        for shape in SHAPES:
            ok, reason = applicable(cfg, shape)
            if not ok:
                out[f"{arch}/{shape.name}"] = {"status": "skip",
                                               "reason": reason}
                continue
            r = dryrun.lower_cell(cfg, shape, mesh, verbose=False)
            out[f"{arch}/{shape.name}"] = {
                k: r[k] for k in ("status", "model_flops", "memory",
                                  "useful_flops_frac", "roofline")}
    print(json.dumps(out))
""")

FLOPS = textwrap.dedent("""
    import json
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig, get_reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train import steps as steps_lib

    torch.set_num_threads(1)
    cfg = get_reduced("qwen1.5-0.5b")
    shape = ShapeConfig("t", 32, 4, "train")
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    counted = dryrun.lower_cell(cfg, shape, mesh, verbose=False)
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
    params = model_lib.init_params(cfg, 0, device="cpu")
    state = opt.init(params)
    step, _ = steps_lib.make_train_step(cfg, opt, global_batch=4)
    batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4, seed=0).batch(0)
    with FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    print(json.dumps({"dry": counted["cost"]["flops_per_device"],
                      "real": fc.get_total_flops(),
                      "state": counted["memory"]["state_bytes"],
                      "peak": counted["memory"]["peak_bytes_per_device"]}))
""")

GROUPS = [",".join(tconfigs.ARCH_IDS[i:i + 2])
          for i in range(0, len(tconfigs.ARCH_IDS), 2)]


def _last_json(res):
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sweep():
    """Every reduced cell on the (2, 2) fake mesh, five processes at a
    time (a process is one rank of its own fake group)."""
    procs = [subprocess.Popen([sys.executable, "-c", SWEEP, g], cwd=ROOT,
                              env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for g in GROUPS]
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=900)
        out.update(_last_json(subprocess.CompletedProcess(
            p.args, p.returncode, stdout, stderr)))
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_every_reduced_cell_runs_or_skips_with_the_reference_reason(
        arch, sweep):
    from repro.launch import roofline as rroof

    for shape in tconfigs.SHAPES:
        cell = sweep[f"{arch}/{shape.name}"]
        rcfg = rconfigs.get_reduced(arch)
        rshape = rconfigs.SHAPES_BY_NAME[shape.name]
        ok, reason = rconfigs.applicable(rcfg, rshape)
        if not ok:
            assert cell == {"status": "skip", "reason": reason}
            continue
        assert cell["status"] == "ok", cell
        mem = cell["memory"]
        assert mem["peak_bytes_per_device"] >= mem["state_bytes"] > 0
        assert 0.0 < cell["useful_flops_frac"] <= 1.0, cell
        assert cell["roofline"]["bound_s"] > 0.0
        assert cell["model_flops"] == rroof.model_flops(
            rcfg.replace(kv_repeat=1), rshape)


def test_counted_flops_equal_a_real_cpu_step():
    res = _last_json(subprocess.run(
        [sys.executable, "-c", FLOPS], cwd=ROOT, env=ENV,
        capture_output=True, text=True, timeout=600))
    assert res["dry"] == res["real"] > 0
    assert res["peak"] >= res["state"] > 0


def test_committed_reference_cells_are_reproduced(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b,moonshot-v1-16b-a3b", "--shape", "train_4k",
         "--mesh", "single", "--reduced", "--out", str(tmp_path)],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "failures=0" in res.stdout
    for arch in ("qwen1.5-0.5b", "moonshot-v1-16b-a3b"):
        name = f"{arch}__train_4k__single.json"
        got = json.loads((tmp_path / name).read_text())
        want = json.loads(open(os.path.join(
            ROOT, "experiments", "dryrun", name)).read())
        assert got["status"] == "ok" and got["mesh"] == "16x16"
        assert got["model_flops"] == want["model_flops"]
        assert got["cost"]["bytes_per_device"] == \
            want["cost"]["bytes_per_device"]
        assert got["counting_run"]["method"] == "full-run"
    qwen = json.loads((tmp_path / "qwen1.5-0.5b__train_4k__single.json")
                      .read_text())
    assert qwen["model_flops"] == 779_536_564_224
    assert qwen["cost"]["bytes_per_device"] == 92_296_720
