"""The staged process group (``launch.mesh``'s ``"staged"`` backend) and
the sharded (FSDP × TP) serving and training steps over it, on gloo CPU
ranks (``OMP_NUM_THREADS=1``).

The group's device-specific part is its host copies: on CPU ranks
(``"cpu:staged"``) every collective copies its CPU tensors into host
buffers, runs gloo's op on them and copies the result back, so its
collectives, their completion and its byte count run here.

  * Each collective DTensor issues (the functional all-gather, also of
    8 MiB a rank, all-reduce, reduce-scatter, all-to-all and broadcast;
    DTensor's redistributions on a (2, 2) mesh between shards, partial sums and
    replicas; a barrier), through the staged group and through a plain
    gloo group of the same ranks on the same inputs, equal to the bit;
    each functional op's staged bytes are its inputs' and outputs'
    bytes, and the collective counter charges both groups alike. An op
    the group does not implement (``send``, the list ``all_gather``)
    raises, naming the op.
  * The reduced qwen1.5-0.5B (f32) on a (data 2, model 2) mesh of 4
    ranks over the staged group: a prefill of 4 × 16 tokens with the
    weights resident (the decode rules), 4 greedy decode steps into a
    cache of 32 with its sequence on ``model``, and 2 train steps (FSDP
    × TP, AdamW lr 1e-3 eps 1e-4), through ``chip_smoke``'s phase-17
    helpers: every step's logits, the tokens, the losses and the final
    parameters (over the tree) within rel 1e-5 of one process's, and
    of the reference's own sharded steps — ``jax.jit`` under its rule
    tables on 4 host devices, in a subprocess with
    ``--xla_force_host_platform_device_count=4`` over an Auto-axis
    ``jax.sharding.Mesh`` (never ``jax.make_mesh``: ROADMAP R3). The
    weights and batches go across as numpy.
  * ``group_backend``'s choice (gloo for CPU ranks, the staged backend
    for ranks sharing a card, NCCL for a card a rank), ``cuda_backend``
    of a backend string, and ``sharding.carry_rules`` on another thread
    (the autograd engine's, where a CUDA backward recomputes a block).
"""
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import simdev
from repro_torch.models import model as tmodel
from repro_torch.pytree import flatten_with_path

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240.0
ENV = {"OMP_NUM_THREADS": "1"}
PROMPTS, PROMPT_LEN, NEW, CACHE = 4, 16, 4, 32
GB, SEQ, STEPS = 8, 16, 2
TOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def built():
    """The staged backend, built once here before the ranks load it."""
    tmesh.build_staged_backend()


# --------------------------------------------------------------------- #
# the group's collectives against plain gloo's
# --------------------------------------------------------------------- #
COLLECTIVES = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.roofline import CollectiveCounter

    torch.set_num_threads(1)
    rank = mesh_lib.init_fleet_group(60, backend="cpu:staged")
    W = dist.get_world_size()
    groups = {"staged": dist.group.WORLD,
              "plain": dist.new_group(backend="gloo")}
    rows = [dist.new_group([0, 1], backend="gloo"),
            dist.new_group([2, 3], backend="gloo")]
    cols = [dist.new_group([0, 2], backend="gloo"),
            dist.new_group([1, 3], backend="gloo")]
    names = ("data", "model")
    meshes = {"staged": init_device_mesh("cpu", (2, 2),
                                         mesh_dim_names=names),
              "plain": DeviceMesh.from_group(
                  [cols[rank % 2], rows[rank // 2]], "cpu",
                  mesh=torch.arange(4).reshape(2, 2),
                  mesh_dim_names=names)}
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(7 + rank))
    # 8 MiB a rank: an all-gather of a weight's size
    big = torch.randn(2 ** 21 + 3,
                      generator=torch.Generator().manual_seed(9 + rank))
    nb = big.numel() * big.element_size()
    whole = torch.randn(8, 4, generator=torch.Generator().manual_seed(3))
    n = x.numel() * x.element_size()
    R, S0, S1 = Replicate(), Shard(0), Shard(1)

    def dt(mesh, t, where):
        return DTensor.from_local(t, mesh, where, run_check=False)

    def split(mesh):
        return dt(mesh, whole, [R, R]).redistribute(mesh, [S0, S1])

    def ops(g, mesh):
        return {
            "all_gather_into_tensor": (
                lambda: fc.all_gather_tensor(x, 0, g).wait(), n + W * n),
            "all_gather_into_tensor_8mib": (
                lambda: fc.all_gather_tensor(big, 0, g).wait(), nb + W * nb),
            "all_reduce": (lambda: fc.all_reduce(x, "sum", g).wait(), 2 * n),
            "reduce_scatter_tensor": (
                lambda: fc.reduce_scatter_tensor(x, "sum", 0, g).wait(),
                n + n // W),
            "all_to_all_single": (
                lambda: fc.all_to_all_single(x, None, None, g).wait(),
                2 * n),
            "broadcast": (lambda: fc.broadcast(x, 1, g).wait(), 2 * n),
            "all_reduce_max": (lambda: _inplace_max(g), 2 * n),
            "barrier": (lambda: _barrier(g), 0),
            "dtensor_shard_to_replicate": (
                lambda: split(mesh).redistribute(mesh, [R, R]).to_local(),
                None),
            "dtensor_partial_to_replicate": (
                lambda: dt(mesh, x, [Partial(), Partial()]).redistribute(
                    mesh, [R, R]).to_local(), None),
            "dtensor_partial_to_shard": (
                lambda: dt(mesh, x, [Partial(), Partial()]).redistribute(
                    mesh, [S0, S1]).to_local(), None),
            "dtensor_shard_to_shard": (
                lambda: split(mesh).redistribute(mesh, [S1, S0]).to_local(),
                None),
        }

    def _inplace_max(g):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
        return y

    def _barrier(g):
        dist.barrier(group=g)
        return torch.zeros(1)

    out = {"rank": rank, "ops": {}}
    got = {}
    for kind in ("staged", "plain"):
        for name, (fn, want) in ops(groups[kind], meshes[kind]).items():
            b0 = mesh_lib.staged_bytes()
            with CollectiveCounter() as c:
                res = fn()
            got[kind, name] = (res, mesh_lib.staged_bytes() - b0,
                               c.stats.counts, c.stats.wire_bytes, want)
    for name in ops(groups["staged"], meshes["staged"]):
        s, p = got["staged", name], got["plain", name]
        out["ops"][name] = {
            "equal": bool(torch.equal(s[0], p[0])), "staged_bytes": s[1],
            "plain_staged_bytes": p[1], "want_bytes": s[4],
            "counts": s[2], "plain_counts": p[2], "wire": s[3],
            "plain_wire": p[3]}
    out["unimplemented"] = {}
    for name, fn in (
            ("send", lambda: dist.send(x, (rank + 1) % W)),
            ("allgather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(W)], x))):
        try:
            fn()
            out["unimplemented"][name] = None
        except RuntimeError as exc:
            out["unimplemented"][name] = str(exc)
    print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
""")

OPS = ["all_gather_into_tensor", "all_gather_into_tensor_8mib",
       "all_reduce", "reduce_scatter_tensor",
       "all_to_all_single", "broadcast", "all_reduce_max", "barrier",
       "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
       "dtensor_partial_to_shard", "dtensor_shard_to_shard"]


@pytest.fixture(scope="module")
def collectives(built):
    res = simdev.launch_local_fleet([sys.executable, "-c", COLLECTIVES], 4,
                                    timeout=TIMEOUT, extra_env=ENV)
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    return [simdev.last_json_line(r.stdout) for r in res]


@pytest.mark.parametrize("op", OPS)
def test_staged_collective_equals_plain_gloo_to_the_bit(collectives, op):
    for out in collectives:
        row = out["ops"][op]
        assert row["equal"], (out["rank"], row)
        # the plain gloo group never touches the staged backend
        assert row["plain_staged_bytes"] == 0
        if row["want_bytes"] is not None:
            assert row["staged_bytes"] == row["want_bytes"], row
        else:
            assert row["staged_bytes"] > 0, row
        # the collective counter charges the staged group as plain gloo
        assert row["counts"] == row["plain_counts"], row
        assert row["wire"] == row["plain_wire"], row


@pytest.mark.parametrize("op", ["send", "allgather"])
def test_staged_group_raises_naming_an_op_it_lacks(collectives, op):
    for out in collectives:
        msg = out["unimplemented"][op]
        assert msg is not None and \
            f"Backend staged does not support {op}" in msg, msg


# --------------------------------------------------------------------- #
# sharded serving and training of the reduced qwen
# --------------------------------------------------------------------- #
REFERENCE = textwrap.dedent(f"""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_reduced
    from repro.launch import specs as specs_lib
    from repro.launch.rules import kv_repeat_for, make_rules
    from repro.models import model as model_lib
    from repro.optim.adamw import AdamW, constant_schedule
    from repro.sharding import axis_rules
    from repro.train import steps as steps_lib

    inp = dict(np.load(sys.argv[1]))
    cfg = get_reduced("qwen1.5-0.5b").replace(compute_dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    cfg = cfg.replace(kv_repeat=kv_repeat_for(cfg, 2))
    params = jax.tree_util.tree_map_with_path(
        lambda k, v: jnp.asarray(inp["p" + jax.tree_util.keystr(k)]),
        model_lib.init_params(cfg, jax.random.PRNGKey(0)))
    prompts = inp["prompts"]
    B, S = prompts.shape
    out = {{}}

    def rules(mode, batch):
        return make_rules(cfg, mesh, mode, global_batch=batch)

    with axis_rules(mesh, rules("decode", B)):
        served = jax.device_put(params,
                                specs_lib.param_shardings(cfg, mesh))
    with axis_rules(mesh, rules("prefill", B)):
        logits, cache = jax.jit(steps_lib.make_prefill_step(cfg))(
            served, {{"tokens": jnp.asarray(prompts)}})
    cache = {{k: np.pad(np.asarray(v), [(0, 0), (0, 0),
                                        (0, {CACHE} - v.shape[2]),
                                        (0, 0), (0, 0)])
              for k, v in cache.items()}}
    logits = np.asarray(logits)
    tokens = [logits[:, :cfg.vocab_size].argmax(-1)]
    out["logits0"] = logits
    with axis_rules(mesh, rules("decode", B)):
        cache = jax.device_put(cache, specs_lib.cache_shardings(cfg, mesh))
        step = jax.jit(steps_lib.make_decode_step(cfg))
        for i in range({NEW}):
            logits, cache = step(served, cache,
                                 jnp.asarray(tokens[-1][:, None], jnp.int32),
                                 jnp.int32(S + i))
            logits = np.asarray(logits)
            out[f"logits{{i + 1}}"] = logits
            tokens.append(logits[:, :cfg.vocab_size].argmax(-1))
    out["tokens"] = np.stack(tokens)

    opt = AdamW(lr=constant_schedule(1e-3), eps=1e-4)
    with axis_rules(mesh, rules("train", {GB})):
        psh = specs_lib.param_shardings(cfg, mesh)
        p = jax.device_put(params, psh)
        s = jax.device_put(opt.init(params),
                           specs_lib.opt_shardings(psh, mesh))
        step, _ = steps_lib.make_train_step(cfg, opt, global_batch={GB},
                                            dp=2)
        step = jax.jit(step)
        losses = []
        for i in range({STEPS}):
            p, s, m = step(p, s, {{"tokens": inp[f"tokens{{i}}"],
                                  "labels": inp[f"labels{{i}}"]}})
            losses.append(float(m["loss"]))
    out["losses"] = np.array(losses)
    for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
        out["p" + jax.tree_util.keystr(k)] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")

SHARDED = textwrap.dedent(f"""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, {ROOT!r})
    import chip_smoke as smoke
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.rules import kv_repeat_for
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, constant_schedule
    from repro_torch.pytree import flatten_with_path, leaves, unflatten_like

    torch.set_num_threads(1)
    rank = mesh_lib.init_fleet_group(120, backend="cpu:staged")
    inp = dict(np.load(sys.argv[1]))
    base = get_reduced("qwen1.5-0.5b").replace(compute_dtype="float32")
    like = model_lib.init_params(base, 0, device="meta")
    p0 = unflatten_like(like, [torch.from_numpy(inp["p" + k])
                               for k, _ in flatten_with_path(like)])
    prompts = torch.from_numpy(inp["prompts"])


    class Batches:
        def batch(self, i):
            return {{"tokens": inp[f"tokens{{i}}"],
                    "labels": inp[f"labels{{i}}"]}}


    opt = AdamW(lr=constant_schedule(1e-3), eps=1e-4)
    with torch.no_grad():
        one_logits, one_tokens, _ = smoke._shard_serve(
            torch, base, p0, prompts, {NEW}, {CACHE})
    one_p, _, one_rows, _ = smoke._shard_train(
        torch, base, p0, Batches(), {STEPS}, {GB}, opt=opt)

    mesh = mesh_lib.make_debug_mesh(model=2, device="cpu")
    cfg = base.replace(kv_repeat=kv_repeat_for(base,
                                               mesh_lib.tp_degree(mesh)))
    b0 = mesh_lib.staged_bytes()
    with torch.no_grad():
        logits, tokens, _ = smoke._shard_serve(
            torch, cfg, smoke._place(cfg, p0, mesh, "decode", {PROMPTS}),
            prompts, {NEW}, {CACHE}, mesh=mesh)
    serve_bytes = mesh_lib.staged_bytes() - b0
    p, _, rows, _ = smoke._shard_train(torch, cfg, p0, Batches(), {STEPS},
                                       {GB}, mesh=mesh, opt=opt)
    whole = [smoke._whole(x) for x in leaves(p)]
    big = max(float(b.abs().max()) for b in leaves(one_p))
    out = {{"rank": rank, "mesh": mesh_lib.mesh_axis_sizes(mesh),
           "logits_rel": [smoke._rel(a, b) for a, b in
                          zip(logits, one_logits)],
           "tokens": [t.tolist() for t in tokens],
           "one_tokens": [t.tolist() for t in one_tokens],
           "losses": [r["loss"] for r in rows],
           "one_losses": [r["loss"] for r in one_rows],
           "params_rel": max(float((a - b).abs().max()) for a, b in
                             zip(whole, leaves(one_p))) / big,
           "serve_staged_bytes": serve_bytes,
           "train_staged_bytes": [r["staged_bytes"] for r in rows]}}
    if rank == 0:
        arrays = {{f"logits{{i}}": x.numpy() for i, x in enumerate(logits)}}
        arrays["tokens"] = np.stack([t.numpy() for t in tokens])
        arrays["losses"] = np.array(out["losses"])
        for (k, _), x in zip(flatten_with_path(p), whole):
            arrays["p" + k] = x.detach().numpy()
        np.savez(sys.argv[2], **arrays)
    print(json.dumps(out), flush=True)
""")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, built):
    """The port's ranks and the reference's subprocess, side by side on
    the same numpy weights, prompts and batches."""
    d = tmp_path_factory.mktemp("staged_sharded")
    inp, ref, port = str(d / "in.npz"), str(d / "ref.npz"), \
        str(d / "port.npz")
    cfg = get_reduced("qwen1.5-0.5b").replace(compute_dtype="float32")
    arrays = {"p" + k: v.numpy() for k, v in flatten_with_path(
        tmodel.init_params(cfg, 0, device="cpu"))}
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=GB, seed=4)
    for i in range(STEPS):
        for k, v in pipe.batch(i).items():
            arrays[f"{k}{i}"] = np.asarray(v)
    arrays["prompts"] = np.asarray(
        TokenPipeline(vocab_size=cfg.vocab_size, seq_len=PROMPT_LEN,
                      global_batch=PROMPTS, seed=0).batch(0)["tokens"])
    np.savez(inp, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    jax_proc = subprocess.Popen([sys.executable, "-c", REFERENCE, inp, ref],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    try:
        res = simdev.launch_local_fleet(
            [sys.executable, "-c", SHARDED, inp, port], 4, timeout=TIMEOUT,
            extra_env=ENV)
        _, err = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    return ([simdev.last_json_line(r.stdout) for r in res],
            dict(np.load(port)), dict(np.load(ref)))


def test_sharded_serving_matches_one_process(sharded):
    ranks, _, _ = sharded
    for o in ranks:
        assert o["mesh"] == {"data": 2, "model": 2}
        assert len(o["logits_rel"]) == NEW + 1
        assert max(o["logits_rel"]) <= TOL, o["logits_rel"]
        assert o["tokens"] == o["one_tokens"]
        # the resident weights' products and the cache's sequence split
        # crossed the ranks through the staged group
        assert o["serve_staged_bytes"] > 0


def test_sharded_train_steps_match_one_process(sharded):
    ranks, _, _ = sharded
    for o in ranks:
        assert o["losses"] == ranks[0]["losses"]
        for a, b in zip(o["losses"], o["one_losses"]):
            assert abs(a - b) / abs(b) <= TOL, (o["losses"],
                                                  o["one_losses"])
        assert o["params_rel"] <= TOL, o["params_rel"]
        assert all(b > 0 for b in o["train_staged_bytes"])


@pytest.mark.parametrize("what", ["prefill", "decode", "train"])
def test_sharded_steps_match_the_references_own(sharded, what):
    _, port, ref = sharded
    if what == "prefill":
        assert _rel(port["logits0"], ref["logits0"]) <= TOL
    elif what == "decode":
        np.testing.assert_array_equal(port["tokens"], ref["tokens"])
        for i in range(1, NEW + 1):
            assert _rel(port[f"logits{i}"], ref[f"logits{i}"]) <= TOL, i
    else:
        assert _rel(port["losses"], ref["losses"]) <= TOL
        keys = sorted(k for k in ref if k.startswith("p"))
        assert keys == sorted(k for k in port if k.startswith("p"))
        big = max(float(np.abs(ref[k]).max()) for k in keys)
        diff = max(float(np.abs(port[k] - ref[k]).max()) for k in keys)
        assert diff / big <= TOL, diff / big


# --------------------------------------------------------------------- #
# the backend choice and the rule table on another thread
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("device,cards,env,want", [
    ("cpu", 1, {"WORLD_SIZE": "4"}, "gloo"),
    (None, 1, {"WORLD_SIZE": "4"}, "cpu:gloo,cuda:staged"),
    ("cuda:0", 2, {"WORLD_SIZE": "4"}, "cpu:gloo,cuda:staged"),
    (None, 4, {"WORLD_SIZE": "4"}, "cpu:gloo,cuda:nccl"),
    (None, 2, {"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "2"},
     "cpu:gloo,cuda:nccl"),
])
def test_group_backend_chooses_by_cards_and_local_ranks(
        device, cards, env, want, monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tmesh.group_backend(device) == want


@pytest.mark.parametrize("backend,want", [
    ("gloo", "gloo"), ("nccl", "nccl"), ("cpu:gloo,cuda:staged", "staged"),
    ("cpu:gloo,cuda:nccl", "nccl"), ("cpu:staged", "cpu:staged")])
def test_cuda_backend_reads_the_backend_string(backend, want, monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    assert tmesh.cuda_backend() == want


def test_carry_rules_installs_the_table_on_another_thread():
    mesh = tmesh.MeshShape(("data", "model"), (2, 2))
    seen = {}

    def look(tag):
        seen[tag] = (sharding.current_mesh(), sharding.spec_for(["batch"]))

    with sharding.axis_rules(mesh, {"batch": "data"}):
        carried = sharding.carry_rules(lambda: look("carried"))
        bare = threading.Thread(target=look, args=("bare",))
        bare.start()
        bare.join()
    t = threading.Thread(target=carried)
    t.start()
    t.join()
    assert seen["bare"] == (None, (None,))
    assert seen["carried"] == (mesh, ("data",))
    # without a mesh it is the function itself
    fn = lambda: None  # noqa: E731
    assert sharding.carry_rules(fn) is fn


def test_a_bf16_decode_state_moves_under_a_tiny_weight_change():
    """Why phase 17 holds a bf16-state decode at 1e-3, not 1e-5: the
    reduced xlstm keeps its mLSTM ``C`` in bf16 in the cache, and one
    process's own greedy decode moves by more than 1e-5 of its largest
    logit when every weight moves by a relative 1e-7 (a reduction
    order's size), though its prefill does not; the reduced qwen's f32
    cache does not. Both stay within 1e-3."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.pytree import tree_map

    moved = {}
    for arch in ("xlstm-350m", "qwen1.5-0.5b"):
        cfg = smoke._shard_config(arch, True)
        p0 = tmodel.init_params(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        p1 = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=gen)), p0)
        prompts = torch.as_tensor(TokenPipeline(
            vocab_size=cfg.vocab_size, seq_len=PROMPT_LEN,
            global_batch=PROMPTS, seed=4).batch(0)["tokens"])
        with torch.no_grad():
            a, _, info = smoke._shard_serve(torch, cfg, p0, prompts, NEW,
                                             CACHE)
            b, _, _ = smoke._shard_serve(torch, cfg, p1, prompts, NEW,
                                         CACHE)
        rel = [smoke._rel(x, y) for x, y in zip(b, a)]
        moved[arch] = (info["bf16_state"], rel)
        assert max(rel) <= smoke.PAR_BF16_TOL and rel[0] <= TOL, (arch, rel)
    assert moved["xlstm-350m"][0] and not moved["qwen1.5-0.5b"][0]
    assert max(moved["xlstm-350m"][1][1:]) > TOL, moved
    assert max(moved["qwen1.5-0.5b"][1]) <= TOL, moved
