"""The roofline (``repro_torch.launch.roofline``) against the
reference's ``repro.launch.roofline``, on the CPU.

  * ``analytic_memory_bytes`` and ``model_flops`` equal the reference's
    at rel 1e-12 for every architecture, full and reduced, every input
    shape and a grid of (n_devices, dp, tp, grad-accum) and KV repeats;
    ``terms`` equals the reference's arithmetic with the reference's
    TPU constants put in place of the H100's, and the H100 constants
    are the spec sheet's.
  * The collective counter charges each of the five collectives as the
    reference's ``parse_collectives`` charges its HLO line at the same
    size and group: the port's op runs on a ``"fake"`` process group in
    a subprocess (the fake group is process-global), the reference
    reads a hand-written HLO line; the wire bytes are equal.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro import configs as rconfigs
from repro.launch import roofline as rroof

from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as troof

GRID = [(1, 1, 1, 1), (4, 2, 2, 1), (16, 4, 4, 2), (256, 16, 16, 1),
        (256, 256, 1, 8), (512, 32, 16, 4)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.fixture
def ref_counts_once(monkeypatch):
    """The reference counts parameters by an ``eval_shape`` of its
    init: one count a config, not one a call."""
    from repro.configs.base import ModelConfig

    monkeypatch.setattr(ModelConfig, "param_count", functools.lru_cache(
        maxsize=None)(ModelConfig.param_count))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_analytic_terms_match_reference(arch, ref_counts_once):
    for rcfg0, tcfg0 in ((rconfigs.get_config(arch),
                          tconfigs.get_config(arch)),
                         (rconfigs.get_reduced(arch),
                          tconfigs.get_reduced(arch))):
        for kv in (1, 2):
            rcfg = rcfg0.replace(kv_repeat=kv)
            tcfg = tcfg0.replace(kv_repeat=kv)
            for shape in tconfigs.SHAPES:
                rshape = rconfigs.SHAPES_BY_NAME[shape.name]
                assert _rel(troof.model_flops(tcfg, shape),
                            rroof.model_flops(rcfg, rshape)) <= 1e-12
                for n, dp, tp, acc in GRID:
                    got = troof.analytic_memory_bytes(
                        tcfg, shape, n_devices=n, dp=dp, tp=tp, accum=acc)
                    want = rroof.analytic_memory_bytes(
                        rcfg, rshape, n_devices=n, dp=dp, tp=tp, accum=acc)
                    assert _rel(got, want) <= 1e-12, (shape.name, n, dp)


@pytest.mark.parametrize("flops,nbytes,wire", [
    (1e12, 1e9, 1e8), (3e9, 5e10, 1e6), (1.0, 2.0, 3e12), (0.0, 0.0, 0.0)])
def test_terms_match_reference_arithmetic(flops, nbytes, wire, monkeypatch):
    monkeypatch.setattr(troof, "PEAK_FLOPS", rroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", rroof.HBM_BW)
    monkeypatch.setattr(troof, "LINK_BW", rroof.ICI_BW)
    got, want = troof.terms(flops, nbytes, wire), \
        rroof.terms(flops, nbytes, wire)
    assert got["dominant"] == want["dominant"]
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bound_s"):
        assert _rel(got[k], want[k]) <= 1e-12 or got[k] == want[k] == 0.0


def test_h100_constants_are_the_spec_sheet():
    assert troof.PEAK_FLOPS == 989.4e12
    assert troof.HBM_BW == 3.35e12
    assert troof.LINK_BW == 450e9
    assert troof.PEAK_TF32 == 494.7e12
    assert troof.PEAK_INT8 == 1979e12
    t = troof.terms(989.4e12, 3.35e12, 450e9)
    assert t["t_compute_s"] == t["t_memory_s"] == t["t_collective_s"] == 1.0


# the port's op on a fake group of 4 ranks (2 × 2 mesh: groups of 2
# along "model", 4 for the whole group), one JSON line of wire bytes
COUNTER = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.launch.roofline import CollectiveCounter

    mesh = fake_mesh((2, 2), ("data", "model"))
    pair = mesh["model"]
    out = {}
    ops = {
        "all-gather": lambda: fc.all_gather_tensor(
            torch.ones(4, 16), 0, pair),
        "reduce-scatter": lambda: fc.reduce_scatter_tensor(
            torch.ones(8, 16), "sum", 0, pair),
        "all-reduce": lambda: fc.all_reduce(torch.ones(8, 16), "sum",
                                            dist.group.WORLD),
        "all-to-all": lambda: fc.all_to_all_single(
            torch.ones(8, 16), None, None, pair),
        "collective-permute": lambda: dist.send(torch.ones(8, 16), dst=1),
    }
    for name, op in ops.items():
        with CollectiveCounter() as c:
            r = op()
            if hasattr(r, "wait"):
                r = r.wait()
            elif isinstance(r, torch.Tensor):
                r = fc.wait_tensor(r)
        out[name] = {"wire": c.stats.wire_bytes, "by_op": c.stats.by_op,
                     "counts": c.stats.counts}
    print(json.dumps(out))
""")

HLO = {
    "all-gather": "%ag = f32[8,16]{1,0} all-gather(f32[4,16]{1,0} %p), "
                  "replica_groups={{0,1}}, dimensions={0}",
    "reduce-scatter": "%rs = f32[4,16]{1,0} reduce-scatter(f32[8,16]{1,0} "
                      "%p), replica_groups={{0,1}}, dimensions={0}, "
                      "to_apply=%add",
    "all-reduce": "%ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p), "
                  "replica_groups={{0,1,2,3}}, to_apply=%add",
    "all-to-all": "%a2a = f32[8,16]{1,0} all-to-all(f32[8,16]{1,0} %p), "
                  "replica_groups={{0,1}}, dimensions={0}",
    "collective-permute": "%cp = f32[8,16]{1,0} collective-permute("
                          "f32[8,16]{1,0} %p), "
                          "source_target_pairs={{0,1},{1,2},{2,3}}",
}


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", COUNTER], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("op", list(HLO))
def test_collective_counter_matches_parse_collectives(op, counted):
    want = rroof.parse_collectives(HLO[op], n_devices=4)
    got = counted[op]
    assert want.counts == {op: 1}
    assert got["counts"] == {op: 1}
    assert got["wire"] == want.wire_bytes
    assert got["by_op"] == want.by_op
