"""The GPipe pipeline (``repro_torch.launch.pipeline``) against the
reference's own ``repro.launch.pipeline.pipeline_apply``, forward and
backward, on gloo CPU ranks (``OMP_NUM_THREADS=1``).

  * The reference runs in a subprocess on 4 host devices
    (``--xla_force_host_platform_device_count=4``) over an Auto-axis
    ``jax.sharding.Mesh`` of ``("pod",)``: its own test builds its mesh
    with ``jax.make_mesh``, whose Explicit axes fail on this JAX (ROADMAP
    R3), and in the pytest worker another file may already have started
    JAX with one device. Its arrays come back as numpy.
  * The reference test's case, S 4, B 8, D 16, M 4, a ``tanh(h @ W[s])``
    stage, ``W`` and ``x`` drawn by numpy from a seed: the port's
    forward on 4 ranks (a ``pod`` mesh of 4 stages) and its gradients of
    ``sum(out²)`` with respect to each stage's ``W[s]`` and to ``x``
    within 1e-5 (max abs, the reference test's bound) of the reference's
    forward and ``jax.grad``; with one microbatch too, and with only
    ``x`` requiring a gradient. Every rank returns the same output and
    the same d x as stage 0; the collective counter sees M sends
    rightwards and M leftwards at each boundary and the two broadcasts
    (the outputs, d x). A call under ``no_grad``, or one where nothing
    requires a gradient, returns an output without a graph. The same
    ranks run a one-stage pipeline (a (pod 1, data 4) mesh), forward and
    backward, against plain autograd.
  * The reduced qwen stack (4 layers, f32) pipelined as 2 and as 4
    stages: every rank holds the embedding and the final norm
    replicated and its blocks, and computes ``loss_fn``'s loss of the
    replicated output (``chip_smoke._pipe_loss``, phase 16(c)'s own
    step). Its loss and every gradient within rel 1e-5 of the
    reference's ``jax.grad`` of ``repro.models.model.loss_fn`` on the
    same numpy weights; one AdamW step (eps 1e-4, clipped by the global
    norm across the ranks) within rel 1e-5 of one process's port step.
  * ``bubble_fraction`` equals the reference's over a grid; a batch that
    does not split into the microbatches raises.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.launch.pipeline import bubble_fraction as rbubble
from repro.models import model as jmodel
from repro_torch.configs import get_reduced
from repro_torch.launch import pipeline as tpipe
from repro_torch.launch import simdev
from repro_torch.models import model as tmodel
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.pytree import flatten_with_path
from repro_torch.train import steps as tsteps

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B, D, M = 4, 8, 16, 4
SEED = 7
TOL = 1e-5
ENV = {"OMP_NUM_THREADS": "1"}
QWEN = dict(num_layers=4, compute_dtype="float32")
QWEN_B, QWEN_S, QWEN_M = 8, 16, 4
LR, EPS = 3e-4, 1e-4


def _arrays():
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, x


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


REFERENCE = textwrap.dedent(f"""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.launch.pipeline import pipeline_apply

    S, B, D = {S}, {B}, {D}
    rng = np.random.default_rng({SEED})
    w = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:S]), ("pod",))

    def stage_fn(p, h):
        return jnp.tanh(h @ p)

    out = {{}}
    for m in ({M}, 1):
        f = lambda w, x, m=m: pipeline_apply(stage_fn, w, x, mesh=mesh,
                                             axis="pod", microbatches=m)
        out[f"out{{m}}"] = np.asarray(f(w, x))
        gw, gx = jax.grad(lambda w, x: jnp.sum(f(w, x) ** 2),
                          argnums=(0, 1))(w, x)
        out[f"gw{{m}}"], out[f"gx{{m}}"] = np.asarray(gw), np.asarray(gx)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's forward and ``jax.grad`` on 4 host devices."""
    path = str(tmp_path_factory.mktemp("pipe_ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", REFERENCE, path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


WORKER = textwrap.dedent(f"""
    import json
    import numpy as np
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.pipeline import pipeline_apply, stage_index
    from repro_torch.launch.roofline import CollectiveCounter

    torch.set_num_threads(1)
    rank = mesh_lib.init_fleet_group(120)
    S, B, D, M = {S}, {B}, {D}, {M}
    rng = np.random.default_rng({SEED})
    w = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)

    def stage_fn(p, h):
        return torch.tanh(h @ p)

    mesh = mesh_lib.make_mesh((S,), ("pod",), "cpu")
    s = stage_index("pod", mesh=mesh)
    r = {{"rank": rank, "stage": s}}

    def run(m, w_grad, x_grad, on=mesh, ws=w[s]):
        wt = torch.from_numpy(ws).requires_grad_(w_grad)
        xt = torch.from_numpy(x).requires_grad_(x_grad)
        with CollectiveCounter() as c:
            out = pipeline_apply(stage_fn, wt, xt, mesh=on, axis="pod",
                                 microbatches=m)
            if out.grad_fn is not None:
                (out ** 2).sum().backward()
        grad = lambda t: None if t.grad is None else t.grad.tolist()
        return {{"out": out.tolist(), "graph": out.grad_fn is not None,
                 "gw": grad(wt), "gx": grad(xt), "by_op": c.stats.by_op,
                 "counts": c.stats.counts}}

    r["forward"] = run(M, False, False)
    r["both"] = run(M, True, True)
    r["one_mb"] = run(1, True, True)
    r["x_only"] = run(M, False, True)
    with torch.no_grad():
        r["no_grad"] = run(M, True, True)
    # one stage: the (pod 1, data 4) mesh's pod axis
    one = mesh_lib.make_mesh((1, S), ("pod", "data"), "cpu")
    r["alone"] = run(2, True, True, on=one, ws=w[0])
    print(json.dumps(r))
""")


@pytest.fixture(scope="module")
def ranks():
    """The port on 4 gloo CPU ranks: each case's output, gradients and
    collectives, one dict a rank, in stage order."""
    res = simdev.launch_local_fleet([sys.executable, "-c", WORKER], S,
                                    timeout=240.0, extra_env=ENV)
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    out = sorted((simdev.last_json_line(r.stdout) for r in res),
                 key=lambda o: o["stage"])
    assert [o["stage"] for o in out] == list(range(S))
    return out


def test_pipeline_matches_sequential_on_four_ranks(ranks, reference):
    w, x = _arrays()
    seq = x
    for s in range(S):
        seq = np.tanh(seq @ w[s])
    for o in ranks:
        got = np.asarray(o["forward"]["out"], dtype=np.float32)
        assert got.shape == (B, D)
        assert _max_abs(got, reference[f"out{M}"]) < TOL
        assert _max_abs(got, seq) < TOL
        assert o["forward"]["out"] == ranks[0]["forward"]["out"]
        # one hop a microbatch and a boundary, then the broadcast of
        # the (M, B/M, D) outputs from the last stage
        mb_bytes = B // M * D * 4
        sends = M if o["stage"] < S - 1 else 0
        counts, by_op = o["forward"]["counts"], o["forward"]["by_op"]
        assert counts.get("collective-permute", 0) == sends
        assert by_op.get("collective-permute", 0.0) == sends * mb_bytes
        assert counts["broadcast"] == 1
        assert by_op["broadcast"] == B * D * 4 * (S - 1) / S


def test_pipeline_gradients_match_the_reference(ranks, reference):
    """d W[s] on each stage and d x on every rank, against ``jax.grad``
    through the reference's own pipeline."""
    for o in ranks:
        both = o["both"]
        assert both["graph"]
        assert _max_abs(both["out"], reference[f"out{M}"]) < TOL
        assert _max_abs(both["gw"], reference[f"gw{M}"][o["stage"]]) < TOL
        assert _max_abs(both["gx"], reference[f"gx{M}"]) < TOL


def test_backward_sends_one_hop_a_microbatch_leftwards(ranks):
    """Every rank's d x is stage 0's; stage s sends M microbatches right
    (s < S−1) and M left (s > 0), and two broadcasts go out: the outputs
    from the last stage, d x from stage 0."""
    mb_bytes = B // M * D * 4
    for o in ranks:
        both, s = o["both"], o["stage"]
        assert both["gx"] == ranks[0]["both"]["gx"]
        sends = M * ((s < S - 1) + (s > 0))
        assert both["counts"].get("collective-permute", 0) == sends
        assert both["by_op"].get("collective-permute", 0.0) == \
            sends * mb_bytes
        assert both["counts"]["broadcast"] == 2
        assert both["by_op"]["broadcast"] == 2 * B * D * 4 * (S - 1) / S


def test_one_microbatch_gradients_match_the_reference(ranks, reference):
    for o in ranks:
        one = o["one_mb"]
        assert _max_abs(one["out"], reference["out1"]) < TOL
        assert _max_abs(one["gw"], reference["gw1"][o["stage"]]) < TOL
        assert _max_abs(one["gx"], reference["gx1"]) < TOL


def test_only_x_requiring_a_gradient(ranks, reference):
    """No stage parameter requires a gradient: the stages still pass d h
    leftwards, and every rank gets the reference's d x."""
    for o in ranks:
        xo = o["x_only"]
        assert xo["graph"] and xo["gw"] is None
        assert _max_abs(xo["gx"], reference[f"gx{M}"]) < TOL
        assert xo["counts"]["broadcast"] == 2


def test_a_call_without_gradients_keeps_no_graph(ranks):
    """Under ``no_grad``, and where nothing requires a gradient, the
    output has no ``grad_fn`` (the schedule kept no stash) and the
    collectives are the forward's alone."""
    for o in ranks:
        for case in ("no_grad", "forward"):
            c = o[case]
            assert not c["graph"] and c["gw"] is None and c["gx"] is None
            assert c["counts"]["broadcast"] == 1
        assert o["no_grad"]["out"] == o["forward"]["out"]


def test_a_one_stage_pipeline_differentiates_as_plain_autograd(ranks):
    w, x = _arrays()
    wt = torch.from_numpy(w[0]).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = torch.tanh(xt @ wt)
    (out ** 2).sum().backward()
    for o in ranks:
        alone = o["alone"]
        assert _max_abs(alone["out"], out.detach()) < 1e-6
        assert _max_abs(alone["gw"], wt.grad) < 1e-6
        assert _max_abs(alone["gx"], xt.grad) < 1e-6
        assert alone["counts"] == {}


# ------------- the reduced qwen stack, pipelined and trained ------------- #
QWEN_WORKER = textwrap.dedent(f"""
    import json
    import os
    import sys
    import numpy as np
    import torch

    sys.path.insert(0, {ROOT!r})
    import chip_smoke as cs
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.pipeline import stage_index
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.pytree import flatten_with_path, unflatten_like

    torch.set_num_threads(1)
    rank = mesh_lib.init_fleet_group(120)
    n = int(os.environ["WORLD_SIZE"])
    d = sys.argv[1]
    cfg = get_reduced("qwen1.5-0.5b").replace(**{QWEN!r})
    data = np.load(os.path.join(d, "in.npz"))
    mesh = mesh_lib.make_mesh((n,), ("pod",), "cpu")
    s = stage_index("pod", mesh=mesh)
    per = cfg.num_layers // n
    layers = list(range(s * per, (s + 1) * per))
    # what this rank holds, in the model's structure: the replicated
    # leaves whole, the stack's leaves at its layers
    like = model_lib.init_params(cfg.replace(num_layers=per), 0,
                                 device="meta")
    arrays = []
    for path, _ in flatten_with_path(like):
        a = data[cs._leaf_file(path)[:-4]]
        arrays.append(a[layers[0]:layers[-1] + 1]
                      if path.startswith("['stack']") else a)
    held = model_lib.params_from_numpy(cfg, unflatten_like(like, arrays),
                                       device="cpu")
    batch = {{k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}}
    opt = AdamW(lr=cosine_schedule({LR}, 1, 1), eps={EPS})
    loss, grads, new, _, _ = cs._pipe_step(
        torch, cfg, opt, held, opt.init(held), batch, layers, mesh,
        {QWEN_M}, {{}}, lambda: None)
    out = {{"loss": np.float32(float(loss))}}
    for tag, t in (("grad", grads), ("new", new)):
        for path, leaf in flatten_with_path(t):
            out[tag + cs._leaf_file(path)[:-4]] = leaf.detach().numpy()
    np.savez(os.path.join(d, f"stage{{s}}.npz"), **out)
    print(json.dumps({{"rank": rank, "stage": s, "layers": layers}}))
""")


def _qwen():
    jcfg = jget_reduced("qwen1.5-0.5b").replace(**QWEN)
    tcfg = get_reduced("qwen1.5-0.5b").replace(**QWEN)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, tcfg.vocab_size,
                          (QWEN_B, QWEN_S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return jcfg, tcfg, jax.tree.map(np.asarray, jp), batch


@pytest.fixture(scope="module")
def qwen_reference():
    """The reference's loss and ``jax.grad`` of ``loss_fn`` on its own
    seeded weights (as numpy, keyed ``stack.attn.wq``), and one
    process's port step on the same weights."""
    jcfg, tcfg, jp, batch = _qwen()
    loss, jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, batch)[0])(jp)
    flat = lambda tree: {path.strip("[]'").replace("']['", "."):
                         np.asarray(v) for path, v in flatten_with_path(tree)}
    tp = tmodel.params_from_numpy(tcfg, jp, device="cpu")
    opt = AdamW(lr=cosine_schedule(LR, 1, 1), eps=EPS)
    _, tg = tsteps.value_and_grad(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    new, _, _ = opt.update(tg, opt.init(tp), tp)
    return {"params": flat(jp), "batch": batch, "loss": float(loss),
            "grads": flat(jg),
            "new": flat(new)}


@pytest.fixture(scope="module", params=[2, 4])
def qwen_ranks(request, qwen_reference, tmp_path_factory):
    """The reduced qwen pipelined over ``request.param`` gloo CPU ranks:
    each stage's loss, gradients and AdamW step (numpy, keyed as the
    reference's)."""
    n = request.param
    d = str(tmp_path_factory.mktemp(f"qwen_pipe{n}"))
    ref = qwen_reference
    np.savez(os.path.join(d, "in.npz"), **ref["params"], **ref["batch"])
    res = simdev.launch_local_fleet([sys.executable, "-c", QWEN_WORKER, d],
                                    n, timeout=240.0, extra_env=ENV)
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    info = sorted((simdev.last_json_line(r.stdout) for r in res),
                  key=lambda o: o["stage"])
    for o in info:
        o.update(np.load(os.path.join(d, f"stage{o['stage']}.npz")))
    return n, info


def _stage_slice(key, want, layers):
    return want[layers[0]:layers[-1] + 1] if key.startswith("stack.") \
        else want


def test_qwen_pipelined_loss_and_gradients_match_the_reference(
        qwen_ranks, qwen_reference):
    """Each stage's block gradients (the reference's at its layers), and
    every rank's loss, embedding and final-norm gradients, within rel
    1e-5 of ``jax.grad(loss_fn)``."""
    n, info = qwen_ranks
    want = qwen_reference["grads"]
    assert len(info) == n
    for o in info:
        assert abs(float(o["loss"]) - qwen_reference["loss"]) <= \
            TOL * abs(qwen_reference["loss"])
        keys = [k[4:] for k in o if k.startswith("grad")]
        assert set(keys) == set(want)
        for k in keys:
            assert _rel(o["grad" + k], _stage_slice(
                k, want[k], o["layers"])) <= TOL, (o["stage"], k)


def test_qwen_pipelined_adamw_step_matches_one_process(qwen_ranks,
                                                       qwen_reference):
    """One AdamW step on what each rank holds (eps 1e-4, the global norm
    clipped across the ranks) within rel 1e-5 of one process's step of
    the whole model."""
    _, info = qwen_ranks
    want = qwen_reference["new"]
    for o in info:
        keys = [k[3:] for k in o if k.startswith("new")]
        assert set(keys) == set(want)
        for k in keys:
            assert _rel(o["new" + k], _stage_slice(
                k, want[k], o["layers"])) <= TOL, (o["stage"], k)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("microbatches", [1, 2, 4, 12])
def test_bubble_fraction_matches_reference(n_stages, microbatches):
    assert tpipe.bubble_fraction(n_stages, microbatches) == \
        rbubble(n_stages, microbatches)


def test_uneven_microbatches_raise():
    x = torch.zeros((6, 4))
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_apply(lambda p, h: h, torch.zeros(()), x, mesh=None,
                             microbatches=4)
