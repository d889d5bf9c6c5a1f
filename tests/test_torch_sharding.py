"""The training substrate's parallelism (``repro_torch.sharding``,
``launch.mesh``, ``launch.rules``, ``launch.specs``, the models'
``*_specs``, ``train.steps`` under a mesh, the launcher's
``--model-parallel``) against the reference, on the CPU.

  * For each of the ten registry configs, full and reduced:
    ``param_specs`` and ``cache_specs`` equal the reference's as nested
    dicts of tuples, and every spec has one entry per dimension of the
    port's matching leaf (shapes from the ``meta`` device: nothing is
    allocated at the published widths).
  * ``make_rules``, ``kv_repeat_for`` and ``effective_dp`` equal the
    reference's for every config over the meshes (1,1), (2,1), (1,2),
    (2,2), (4,2), (16,16) and (2,16,16), the modes train, prefill and
    decode and global batches 8 and 256, on stand-in meshes on both
    sides (axis names and a shape).
  * ``launch.specs``: shapes equal ``jax.eval_shape``'s, the placements
    those of the rule table.
  * Without a mesh every helper of ``sharding.py`` returns its input
    object unchanged.
  * A sharded train step of the reduced qwen1.5-0.5B, moonshot (MoE),
    zamba2 (hybrid) and xlstm (ssm) (f32 compute, AdamW eps 1e-4) on 2
    gloo ranks (data=2) and on 4 (2 × 2, with TP) against one process's
    2 steps: the losses within rel 1e-5, and the
    parameters within rel 1e-5 of the tree's largest entry. Per leaf,
    the zero-initialised QKV biases (2·lr = 2e-3 at most after two
    steps) differ by up to 6.1e-8 on 4 ranks (3.1e-5 of their own
    largest entry): Adam divides their ~eps-sized gradients' reduction-
    order noise by ~eps (ROADMAP "Parity traps").
  * The launcher with ``--model-parallel 2`` under 4 ranks prints its
    mesh, trains, and writes checkpoints that restore (in one process
    it refuses: ``test_torch_train.py``). As a rank it takes the MoE,
    hybrid and ssm families on the CPU (their gates above hold: it gets
    as far as joining the group), and ranks on the card join the group
    ``launch.mesh.group_backend`` chooses (the staged backend on a
    shared card, NCCL with a card a rank).

The spawned ranks (a supervisor timeout of 240 s each) pay most of
their time in their first sharded step on torch 2.13, where DTensor
works out each operator's sharding once.
"""
import json
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import rules as rrules
from repro.launch import specs as rspecs
from repro.models import model as rmodel

from repro_torch import configs as tconfigs
from repro_torch import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import rules as trules
from repro_torch.launch import simdev
from repro_torch.launch import specs as tspecs
from repro_torch.models import model as tmodel
from repro_torch.optim.adamw import AdamW, constant_schedule
from repro_torch.pytree import flatten_with_path

torch.set_num_threads(1)

TIMEOUT = 240.0
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 1)),
          (("data", "model"), (1, 2)), (("data", "model"), (2, 2)),
          (("data", "model"), (4, 2)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


class RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=np.int8)


class PlacementMesh:
    """What ``sharding.placements`` reads of a mesh."""

    def __init__(self, names):
        self.mesh_dim_names = names
        self.ndim = len(names)


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _cfgs(arch):
    return [(rconfigs.get_config(arch), tconfigs.get_config(arch)),
            (rconfigs.get_reduced(arch), tconfigs.get_reduced(arch))]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_and_cache_specs_match_reference(arch):
    for rcfg, tcfg in _cfgs(arch):
        pspec = tmodel.param_specs(tcfg)
        cspec = tmodel.cache_specs(tcfg)
        assert _tuples(pspec) == _tuples(rmodel.param_specs(rcfg))
        assert _tuples(cspec) == _tuples(rmodel.cache_specs(rcfg))
        for specs, shapes in ((pspec, tspecs.param_shapes(tcfg)),
                              (cspec, tspecs.cache_shapes(tcfg, 2, 16))):
            flat = flatten_with_path(shapes)
            names = sharding._spec_leaves(specs)
            assert len(flat) == len(names)
            for (path, leaf), spec in zip(flat, names):
                assert leaf.device.type == "meta"
                assert leaf.dim() == len(spec), (arch, path, spec)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_rules_match_reference(arch):
    rcfg0, tcfg0 = rconfigs.get_config(arch), tconfigs.get_config(arch)
    for names, shape in MESHES:
        rm, tm = RefMesh(names, shape), tmesh.MeshShape(names, shape)
        assert tmesh.mesh_axis_sizes(tm) == dict(zip(names, shape))
        assert tmesh.dp_degree(tm) == rrules.mesh_lib.dp_degree(rm)
        assert tmesh.tp_degree(tm) == rrules.mesh_lib.tp_degree(rm)
        tp = tmesh.tp_degree(tm)
        kv = trules.kv_repeat_for(tcfg0, tp)
        assert kv == rrules.kv_repeat_for(rcfg0, tp)
        rcfg, tcfg = rcfg0.replace(kv_repeat=kv), tcfg0.replace(kv_repeat=kv)
        assert trules.effective_dp(tcfg, tm) == rrules.effective_dp(rcfg, rm)
        for mode in ("train", "prefill", "decode"):
            for gb in (8, 256):
                got = trules.make_rules(tcfg, tm, mode, global_batch=gb)
                want = rrules.make_rules(rcfg, rm, mode, global_batch=gb)
                assert got == want, (shape, mode, gb)


def test_placements_follow_the_rules():
    from torch.distributed.tensor import Replicate, Shard

    mesh = PlacementMesh(("pod", "data", "model"))
    rules = {"batch": ("pod", "data"), "embed": "data", "heads": "model",
             "vocab": None}
    with sharding.axis_rules(mesh, rules):
        assert sharding.current_mesh() is mesh
        assert sharding.spec_for(["batch", None, "heads", "nope"]) == \
            (("pod", "data"), None, "model", None)
        assert sharding.sharding_for(["batch", None, "heads"]) == \
            (Shard(0), Shard(0), Shard(2))
        assert sharding.sharding_for(["vocab", "embed"]) == \
            (Replicate(), Shard(1), Replicate())
        assert sharding.tree_shardings({"w": ("embed", "heads"),
                                        "b": (None,)}) == \
            {"w": (Replicate(), Shard(0), Shard(1)),
             "b": (Replicate(),) * 3}
    assert sharding.current_mesh() is None


def test_helpers_without_a_mesh_return_their_input():
    x = torch.arange(6.0).reshape(2, 3)
    tree = {"a": x, "b": [torch.ones(2)]}
    assert sharding.current_mesh() is None
    assert sharding.shard(x, "batch", None) is x
    assert sharding.tree_shard_like(tree, {"a": ("batch", None),
                                           "b": [(None,)]}) is tree
    assert sharding.sharding_for(["batch"]) is None
    assert sharding.spec_for(["batch", None]) == (None, None)
    with pytest.raises(ValueError):
        sharding.tree_shardings({"a": ("batch",)})
    with pytest.raises(ValueError):
        sharding.tree_distribute(tree, {"a": (), "b": [()]})
    # the model's annotations are no-ops too: the one-process forward is
    # unchanged (the existing parity tests hold it to the reference)
    cfg = tconfigs.get_reduced("qwen1.5-0.5b")
    p = tmodel.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    h, _, _ = tmodel.forward(cfg, p, {"tokens": tokens})
    assert type(h) is torch.Tensor


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "moonshot-v1-16b-a3b",
                                  "internvl2-26b"])
def test_specs_shapes_and_placements(arch):
    from jax.sharding import Mesh

    from repro.configs.base import ShapeConfig
    from repro.optim.adamw import AdamW as RAdamW
    from repro.optim.adamw import constant_schedule as rconst

    rcfg, tcfg = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    shape = ShapeConfig("t", 16, 4, "train")
    # shapes: the meta initialisers against jax.eval_shape
    for got, want in ((tspecs.param_shapes(tcfg), rspecs.param_shapes(rcfg)),
                      (tspecs.cache_shapes(tcfg, 4, 16),
                       rspecs.cache_shapes(rcfg, 4, 16))):
        g = flatten_with_path(got)
        w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
        for (_, a), (_, b) in zip(g, w):
            assert tuple(a.shape) == tuple(b.shape)
    opt = AdamW(lr=constant_schedule(1e-3))
    oshapes = tspecs.opt_shapes(tcfg, opt, tspecs.param_shapes(tcfg))
    rshapes = rspecs.opt_shapes(rcfg, RAdamW(lr=rconst(1e-3)),
                                rspecs.param_shapes(rcfg))
    assert [tuple(x.shape) for _, x in flatten_with_path(oshapes)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rshapes)]

    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    pmesh = PlacementMesh(("data", "model"))
    rules = trules.make_rules(tcfg, tmesh.MeshShape(("data", "model"),
                                                    (2, 2)),
                              "train", global_batch=4)
    with sharding.axis_rules(pmesh, rules):
        tb, tbs = tspecs.batch_specs(tcfg, shape, pmesh, with_labels=True)
        psh = tspecs.param_shardings(tcfg, pmesh)
        osh = tspecs.opt_shardings(psh, pmesh)
        (cs, ts, ps), (csh, tsh, psh_) = tspecs.decode_specs(tcfg, shape,
                                                             pmesh)
    from repro.sharding import axis_rules as raxis_rules
    with raxis_rules(jmesh, rules):
        rb, _ = rspecs.batch_specs(rcfg, shape, jmesh, with_labels=True)
        (rcs, rts, rps), _ = rspecs.decode_specs(rcfg, shape, jmesh)
    assert {k: tuple(v.shape) for k, v in tb.items()} == \
        {k: tuple(v.shape) for k, v in rb.items()}
    assert {k: v.dtype for k, v in tb.items()} == \
        {k: {"int32": torch.int32, "bfloat16": torch.bfloat16}[str(v.dtype)]
         for k, v in rb.items()}
    assert set(tbs) == set(tb)
    assert tuple(ts.shape) == tuple(rts.shape) and ps.dim() == 0
    assert [tuple(x.shape) for _, x in flatten_with_path(cs)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rcs)]
    assert osh.m is psh and osh.v is psh
    with sharding.axis_rules(pmesh, rules):
        assert psh == sharding.tree_shardings(tmodel.param_specs(tcfg))
        assert csh == sharding.tree_shardings(tmodel.cache_specs(tcfg))


# --------------------------------------------------------------------- #
# the sharded step on gloo ranks
# --------------------------------------------------------------------- #
STEP_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.rules import kv_repeat_for, make_rules
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, constant_schedule
    from repro_torch.pytree import flatten_with_path, leaves
    from repro_torch.sharding import axis_rules, tree_distribute
    from repro_torch.train import steps as steps_lib

    torch.set_num_threads(1)
    rank = mesh_lib.init_fleet_group(120)
    model_parallel, accum, arch = int(sys.argv[1]), int(sys.argv[2]), \
        sys.argv[3]
    cfg = get_reduced(arch).replace(compute_dtype="float32",
                                    grad_accum=accum)
    GB = 8
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=GB, seed=4)
    opt = AdamW(lr=constant_schedule(1e-3), eps=1e-4)
    p0 = model_lib.init_params(cfg, 0, device="cpu")

    one, _ = steps_lib.make_train_step(cfg, opt, global_batch=GB)
    p, s, ref = p0, opt.init(p0), []
    for i in range(2):
        p, s, m = one(p, s, pipe.batch(i))
        ref.append(float(m["loss"]))

    mesh = mesh_lib.make_debug_mesh(model=model_parallel, device="cpu")
    cfg = cfg.replace(kv_repeat=kv_repeat_for(cfg,
                                              mesh_lib.tp_degree(mesh)))
    rules = make_rules(cfg, mesh, "train", global_batch=GB)
    with axis_rules(mesh, rules):
        psh = specs_lib.param_shardings(cfg, mesh)
        params, state = tree_distribute(
            (p0, opt.init(p0)), (psh, specs_lib.opt_shardings(psh, mesh)))
        step, n_mb = steps_lib.make_train_step(
            cfg, opt, global_batch=GB, dp=mesh_lib.dp_degree(mesh))
        got = []
        for i in range(2):
            params, state, m = step(params, state, pipe.batch(i))
            got.append(float(m["loss"]))
        whole = [x.full_tensor() for x in leaves(params)]
        placements = {k: str(x.placements)
                      for k, x in flatten_with_path(params)}
    diff = max(float((a - b).abs().max())
               for a, b in zip(whole, leaves(p)))
    scale = max(float(b.abs().max()) for b in leaves(p))
    print(json.dumps({"rank": rank, "ref": ref, "got": got, "accum": n_mb,
                      "rel": diff / scale, "rules": {k: str(v) for k, v in
                                                     rules.items()},
                      "placements": placements}))
""")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b", "xlstm-350m"])
@pytest.mark.parametrize("ranks,model_parallel,accum",
                         [(2, 1, 2), (4, 2, 1)])
def test_sharded_train_step_matches_one_process(ranks, model_parallel,
                                                accum, arch):
    res = simdev.launch_local_fleet(
        [sys.executable, "-c", STEP_WORKER, str(model_parallel), str(accum),
         arch], ranks, timeout=TIMEOUT, extra_env={"OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    out = [simdev.last_json_line(r.stdout) for r in res]
    for o in out:
        assert o["accum"] == accum
        assert o["got"] == out[0]["got"]
        for a, b in zip(o["got"], o["ref"]):
            assert abs(a - b) / abs(b) <= 1e-5, (o["got"], o["ref"])
        assert o["rel"] <= 1e-5, o["rel"]
    # the rules shard what they say: FSDP (embed) on data, TP (heads,
    # ff, experts, SSM heads, the LSTMs' ff) on model, which has size 1
    # on the (2, 1) mesh
    pl = out[0]["placements"]
    want = {"qwen1.5-0.5b": {
                "['stack']['attn']['wq']": "(Shard(dim=1), Shard(dim=2))",
                "['stack']['mlp']['w2']": "(Shard(dim=2), Shard(dim=1))"},
            "moonshot-v1-16b-a3b": {
                "['stack']['mlp']['w1']": "(Shard(dim=2), Shard(dim=1))",
                "['stack']['mlp']['router']": "(Shard(dim=1), Replicate())"},
            "zamba2-1.2b": {
                "['stack']['groups']['mamba']['x_proj']":
                    "(Shard(dim=2), Shard(dim=3))",
                "['stack']['groups']['mamba']['A_log']":
                    "(Replicate(), Shard(dim=2))"},
            "xlstm-350m": {
                "['stack']['groups']['slstm']['w1']":
                    "(Shard(dim=1), Shard(dim=2))",
                "['stack']['groups']['mlstm']['wq']":
                    "(Shard(dim=2), Shard(dim=3))"}}[arch]
    for k, v in want.items():
        assert pl[k] == v, (k, pl[k])


def test_launcher_model_parallel_under_four_ranks(tmp_path):
    from repro_torch.train import checkpoint as ckpt_lib

    ckpt = tmp_path / "ckpt"
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--steps", "2",
            "--ckpt-every", "1", "--ckpt-dir", str(ckpt), "--log-every",
            "1", "--log", str(tmp_path / "log.jsonl"), "--model-parallel",
            "2"]
    res = simdev.launch_local_fleet(args, 4, timeout=TIMEOUT,
                                    extra_env={"OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
        assert "mesh: {'data': 2, 'model': 2} (dp=2, tp=2); " \
               "arch=qwen-smoke (reduced)" in r.stdout, r.stdout
    finals = [r.stdout.strip().splitlines()[-1] for r in res]
    assert len(set(finals)) == 1 and "steps 0→1" in finals[0]
    # rank 0 alone logged; the checkpoints are global arrays
    recs = [json.loads(line) for line in
            (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert ckpt_lib.published_steps(str(ckpt)) == [1, 2]
    cfg = tconfigs.get_reduced("qwen1.5-0.5b")
    like = tmodel.init_params(cfg, 0, device="cpu")
    opt = AdamW(lr=constant_schedule(1e-3))
    (params, state), manifest = ckpt_lib.restore(
        str(ckpt), 2, (like, opt.init(like)))
    assert manifest["step"] == 2 and int(state.step) == 2
    assert params["embed"]["table"].shape == like["embed"]["table"].shape


class _Joined(Exception):
    """Raised where a rank would join its group: the checks before it
    have passed."""


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b",
                                  "zamba2-1.2b", "xlstm-350m"])
def test_launcher_ranks_take_the_sharded_families(arch, monkeypatch):
    from repro_torch.launch import train as tlaunch

    def join(timeout_s, backend=None):
        raise _Joined(timeout_s, backend)

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(tmesh, "init_fleet_group", join)
    assert tconfigs.get_reduced(arch).family in tlaunch.SHARDED_FAMILIES
    with pytest.raises(_Joined):
        tlaunch.setup(tlaunch.parse_args(
            ["--arch", arch, "--reduced", "--device", "cpu"]))


@pytest.mark.parametrize("device,cards,backend", [
    (None, 1, "cpu:gloo,cuda:staged"), ("cuda", 1, "cpu:gloo,cuda:staged"),
    ("cuda:0", 1, "cpu:gloo,cuda:staged"), (None, 2, "cpu:gloo,cuda:nccl")])
def test_launcher_ranks_on_the_card_join_the_chosen_group(
        device, cards, backend, monkeypatch):
    """Ranks on the card reach the group join (no refusal): with the
    staged backend where two ranks share one card, NCCL where each has
    its own."""
    from repro_torch.launch import train as tlaunch

    def join(timeout_s, backend=None):
        raise _Joined(backend)

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tmesh, "init_fleet_group", join)
    argv = ["--arch", "qwen1.5-0.5b", "--reduced"]
    with pytest.raises(_Joined) as joined:
        tlaunch.setup(tlaunch.parse_args(
            argv + (["--device", device] if device else [])))
    assert joined.value.args == (backend,)
