"""The port's training substrate against the reference, on the CPU:
``models.layers.cross_entropy``, ``models.model.loss_fn`` and the
stack's remat, ``optim.adamw``, ``train.steps``, ``train.checkpoint``,
``train.train_loop`` and ``launch.train``.

Weights and batches are handed across as numpy (the reference's
``init_params`` on a ``jax.random`` key, its pipeline's batches).
Tolerances, relative to the reference's largest magnitude:

  * ``cross_entropy``: 1e-6;
  * ``loss_fn`` at ``reduced()`` with f32 compute: loss 1e-5, every
    gradient leaf 1e-4; with bf16 compute, loss 2e-3 and gradients
    5e-2 (bf16 keeps 8 bits: the two packages round their bf16
    intermediates at different points; measured 3.1e-4 and 1.8e-2);
  * ``remat`` "full", "dots" and "none": equal gradients, bit for bit
    (the recompute repeats the same arithmetic);
  * one AdamW update: 1e-6; the schedules: 1e-6;
  * ``make_train_step`` with ``accum=2``, 2 steps, f32: 1e-5;
  * checkpoints: the arrays restored equal, both ways;
  * the train loop's resume: rel 1e-6 (the reference's own bound in
    ``tests/test_train_substrate.py``), here also equal to the bit.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import TokenPipeline as JPipe
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train import steps as jsteps

from repro_torch.configs import get_reduced
from repro_torch.data import TokenPipeline
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.pytree import flatten_with_path, leaves
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import steps as tsteps
from repro_torch.train.train_loop import (StragglerWatchdog,
                                          TrainLoopConfig, run)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-0.5b"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _keyed(tree):
    """{keystr: numpy} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _cfgs(**kw):
    return jget_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


def _params(jcfg, tcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tmodel.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _batch(step=0, seed=1, B=4, S=16, vocab=512):
    b = JPipe(vocab_size=vocab, seq_len=S, global_batch=B,
              seed=seed).batch(step)
    return b, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# ---------------- cross_entropy and the loss --------------------------- #
@pytest.mark.parametrize("vocab,padded", [(500, 512), (512, 512)])
def test_cross_entropy_masks_the_pad_and_negative_labels(vocab, padded):
    rng = np.random.default_rng(vocab)
    logits = (rng.standard_normal((3, 7, padded)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 5] = -1
    jl, ja = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   vocab)
    tl, ta = tlayers.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), vocab)
    assert _rel(tl, jl) <= 1e-6 and _rel(ta, ja) <= 1e-6
    # every label masked: the reference's max(valid, 1) denominator
    none = np.full_like(labels, -1)
    jl0, _ = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(none),
                                   vocab)
    tl0, ta0 = tlayers.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(none), vocab)
    assert float(tl0) == float(jl0) == 0.0 and float(ta0) == 0.0


@pytest.mark.parametrize("compute,loss_tol,grad_tol",
                         [("float32", 1e-5, 1e-4), ("bfloat16", 2e-3, 5e-2)])
def test_loss_fn_and_its_gradients_match_reference(compute, loss_tol,
                                                   grad_tol):
    jcfg, tcfg = _cfgs(compute_dtype=compute)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch()
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    tm, tg = tsteps.value_and_grad(tcfg, tp, tb)
    assert _rel(tm["loss"], jl) <= loss_tol
    assert set(tm) == set(jm) == {"loss", "accuracy", "total_loss"}
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    want = _keyed(jg)
    got = dict(flatten_with_path(tg))
    assert set(got) == set(want)
    for k, g in got.items():
        assert _rel(g.numpy(), want[k]) <= grad_tol, k


def test_remat_policies_give_the_same_gradients():
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    _, tp = _params(jcfg, tcfg)
    _, tb = _batch(seed=3)
    grads = {r: tsteps.value_and_grad(tcfg.replace(remat=r), tp, tb)[1]
             for r in ("full", "dots", "none")}
    for r in ("dots", "none"):
        for a, b in zip(leaves(grads["full"]), leaves(grads[r])):
            assert torch.equal(a, b), r
    with pytest.raises(ValueError, match="remat"):
        tsteps.value_and_grad(tcfg.replace(remat="bogus"), tp, tb)


# ---------------- AdamW ------------------------------------------------ #
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32),
            "stack": {"wq": rng.standard_normal((2, 4, 3)).astype(
                np.float32)}}


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0), (100.0, 0.5)])
def test_adamw_updates_match_reference(clip, wd):
    """Three updates with the same gradients: the clip (1.0 binds, 100
    does not, 0 is off) and the decay mask (none on the 1-D leaf)."""
    params, = (_tree(0),)
    kw = dict(clip_norm=clip, weight_decay=wd)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-2, 2, 10), **kw)
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-2, 2, 10), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
              {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = _tree(10 + i)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tg = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                  {kk: torch.from_numpy(vv) for kk, vv in v.items()})
              for k, v in g.items()}
        tp, ts, tm = topt.update(tg, ts, tp)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    want = _keyed((jp, js))
    for k, v in flatten_with_path((tp, ts)):
        assert _rel(v.numpy(), want[k]) <= 1e-6, k
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32


def test_schedules_match_reference():
    jc, tc = jadamw.cosine_schedule(3e-4, 5, 50), \
        tadamw.cosine_schedule(3e-4, 5, 50)
    for s in (0, 1, 4, 5, 6, 27, 50, 80):
        assert _rel(tc(torch.tensor(s, dtype=torch.int32)),
                    jc(jnp.asarray(s, jnp.int32))) <= 1e-6
    assert float(tadamw.constant_schedule(0.125)(torch.tensor(3))) == \
        float(jadamw.constant_schedule(0.125)(jnp.asarray(3)))
    g = _tree(4)
    tg = {"w": torch.from_numpy(g["w"]), "b": torch.from_numpy(g["b"]),
          "stack": {"wq": torch.from_numpy(g["stack"]["wq"])}}
    assert _rel(tadamw.global_norm(tg),
                jadamw.global_norm(jax.tree.map(jnp.asarray, g))) <= 1e-6


# ---------------- the train step -------------------------------------- #
@pytest.mark.parametrize("grad_accum,B,dp", [(2, 8, 1), (4, 6, 1),
                                             (3, 8, 2), (1, 4, 1)])
def test_effective_accum_matches_reference(grad_accum, B, dp):
    jcfg, tcfg = _cfgs(grad_accum=grad_accum)
    assert tsteps.effective_accum(tcfg, B, dp) == \
        jsteps.effective_accum(jcfg, B, dp)


def test_train_step_with_accumulation_matches_reference():
    """``make_train_step`` with ``accum=2`` on the reference's batches:
    params, optimizer state and metrics after 2 steps at rel ≤ 1e-5.

    AdamW runs with eps 1e-4. At the default 1e-8 an entry's first
    update is g / (|g| + 1e-8): an f32 rounding difference in a
    near-zero gradient becomes a full ±lr step (``bk``'s exact gradient
    is zero — softmax ignores a shift of all of a query's scores — and
    it measured rel 2.3e-4, ``w2`` 1.6e-4). At eps 1e-4 the update is
    continuous in the gradient, so the comparison sees the microbatch
    accumulation, not the sign of rounding noise; AdamW itself is held
    at the default eps to 1e-6 above."""
    jcfg, tcfg = _cfgs(compute_dtype="float32", grad_accum=2)
    jp, tp = _params(jcfg, tcfg, seed=2)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 1, 4), eps=1e-4)
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-3, 1, 4), eps=1e-4)
    jstep, jaccum = jsteps.make_train_step(jcfg, jopt, global_batch=8)
    tstep, taccum = tsteps.make_train_step(tcfg, topt, global_batch=8)
    assert jaccum == taccum == 2
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(2):
        jb, tb = _batch(step=step, seed=5, B=8)
        jp, js, jm = jax.jit(jstep)(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        for k in jm:
            assert _rel(tm[k], jm[k]) <= 1e-5, k
    want = _keyed((jp, js))
    for k, v in flatten_with_path((tp, ts)):
        assert _rel(v.numpy(), want[k]) <= 1e-5, k


def test_eval_prefill_and_decode_steps_wrap_the_model():
    tcfg = get_reduced(ARCH).replace(compute_dtype="float32")
    tp = tmodel.init_params(tcfg, 0, device="cpu")
    _, tb = _batch(seed=2)
    m = tsteps.make_eval_step(tcfg)(tp, tb)
    _, want = tmodel.loss_fn(tcfg, tp, tb)
    assert float(m["loss"]) == float(want["loss"])
    logits, cache = tsteps.make_prefill_step(tcfg)(tp, {"tokens":
                                                        tb["tokens"]})
    ref_logits, _ = tmodel.prefill(tcfg, tp, {"tokens": tb["tokens"]})
    assert torch.equal(logits, ref_logits)
    nxt = torch.argmax(logits, -1)[:, None]
    out, _ = tsteps.make_decode_step(tcfg)(tp, cache, nxt,
                                           torch.tensor(16))
    assert out.shape == logits.shape and bool(torch.isfinite(out).all())


# ---------------- checkpoints ----------------------------------------- #
def _opt_tree(tcfg, tp):
    return tadamw.AdamW(lr=tadamw.constant_schedule(1e-3)).init(tp)


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=4)
    jopt = jadamw.AdamW(lr=jadamw.constant_schedule(1e-3))
    js = jopt.init(jp)
    _, js = jp, js._replace(step=jnp.asarray(7, jnp.int32))
    path = jckpt.save(str(tmp_path), 7, (jp, js),
                      pipeline_state={"seed": 3, "step": 7})
    like = (tmodel.init_params(tcfg, 9, device="cpu"), _opt_tree(tcfg, tp))
    assert tckpt.latest_step(str(tmp_path)) == 7
    (rp, rs), manifest = tckpt.restore(str(tmp_path), 7, like)
    assert manifest["pipeline"] == {"seed": 3, "step": 7}
    want = _keyed((jp, js))
    got = dict(flatten_with_path((rp, rs)))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    assert "[1].step" in got and "[0]['embed']['table']" in got
    assert "[1].m['stack']['attn']['wq']" in got
    assert os.path.basename(path) == "step_00000007"


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=5)
    ts = _opt_tree(tcfg, tp)._replace(step=torch.tensor(3,
                                                        dtype=torch.int32))
    tckpt.save(str(tmp_path), 3, (tp, ts), pipeline_state={"seed": 1,
                                                            "step": 3})
    jopt = jadamw.AdamW(lr=jadamw.constant_schedule(1e-3))
    like = (jmodel.init_params(jcfg, jax.random.PRNGKey(8)), jopt.init(jp))
    (rp, rs), manifest = jckpt.restore(str(tmp_path), 3, like)
    assert manifest["step"] == 3
    want = dict(flatten_with_path((tp, ts)))
    got = _keyed((rp, rs))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k].numpy())
        assert v.dtype == want[k].numpy().dtype
    # the manifests agree field for field with the reference's own save
    jckpt.save(str(tmp_path / "ref"), 3, (rp, rs),
               pipeline_state={"seed": 1, "step": 3})
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "ref" / "step_00000003" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine == theirs


def test_checkpoint_is_atomic_detects_corruption_and_keeps_the_latest(
        tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    d = str(tmp_path)
    # a crashed writer's staging directory is never a published step,
    # and the next save collects it
    os.makedirs(os.path.join(d, "step_00000009.tmp-12345"))
    assert tckpt.published_steps(d) == [] and tckpt.latest_step(d) is None
    path = tckpt.save(d, 42, tree, pipeline_state={"seed": 1, "step": 42})
    assert sorted(os.listdir(d)) == ["step_00000042"]
    assert os.path.exists(os.path.join(path, "manifest.json"))
    back, manifest = tckpt.restore(d, 42, {"a": torch.zeros(2, 3),
                                           "b": {"c": torch.zeros(4)}})
    assert torch.equal(back["a"], tree["a"]) and \
        back["b"]["c"].dtype == torch.int32
    # a second save of a published step leaves it as it was
    tckpt.save(d, 42, {"a": torch.zeros(2, 3),
                       "b": {"c": torch.zeros(4, dtype=torch.int32)}})
    assert torch.equal(tckpt.restore(d, 42, tree)[0]["a"], tree["a"])
    # corruption: the reference's test, and a shape lie
    npz = os.path.join(path, "arrays.npz")
    arr = dict(np.load(npz))
    arr["['a']"] = arr["['a']"] + 1.0
    np.savez(npz, **arr)
    with pytest.raises(ValueError, match="checksum"):
        tckpt.restore(d, 42, tree)
    arr["['a']"] = arr["['a']"].reshape(3, 2)
    np.savez(npz, **arr)
    with pytest.raises(ValueError, match="corrupt"):
        tckpt.restore(d, 42, tree)
    # keep: the last two survive
    for s in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path / "gc"), s, {"a": torch.zeros(())}, keep=2)
    assert tckpt.published_steps(str(tmp_path / "gc")) == [4, 5]


# ---------------- the train loop -------------------------------------- #
def _tiny_model():
    """The reference test's 2-layer token model, in torch."""
    V, D = 64, 16

    def init(seed):
        g = torch.Generator().manual_seed(seed)
        return {"emb": torch.randn((V, D), generator=g) * 0.02,
                "out": torch.randn((D, V), generator=g) * 0.02}

    def loss_fn(p, batch):
        h = p["emb"][batch["tokens"].long()]
        logits = h @ p["out"]
        lab = torch.nn.functional.one_hot(batch["labels"].long(), V)
        loss = -torch.mean(torch.sum(torch.log_softmax(logits, -1) * lab,
                                     -1))
        return loss, {"loss": loss}
    return init, loss_fn


def _make_step(loss_fn, opt):
    def step(params, opt_state, batch):
        live = {k: v.detach().requires_grad_(True)
                for k, v in params.items()}
        loss, m = loss_fn(live, batch)
        g = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        p, s, om = opt.update(g, opt_state, params)
        return p, s, {**{k: v.detach() for k, v in m.items()}, **om}
    return step


def test_train_loop_resume_bit_exact(tmp_path):
    """Interrupted training + resume == uninterrupted training (the
    reference's test: rel ≤ 1e-6; here equal to the bit)."""
    init, loss_fn = _tiny_model()
    opt = tadamw.AdamW(lr=tadamw.constant_schedule(1e-2), weight_decay=0.0)
    pipe = TokenPipeline(vocab_size=64, seq_len=16, global_batch=4, seed=9)
    step = _make_step(loss_fn, opt)
    p0 = init(0)
    outA = run(TrainLoopConfig(total_steps=20, ckpt_dir=str(tmp_path / "A"),
                               ckpt_every=0),
               train_step=step, params=p0, opt_state=opt.init(p0),
               pipeline=pipe)
    p1 = init(0)
    s1 = opt.init(p1)
    run(TrainLoopConfig(total_steps=10, ckpt_dir=str(tmp_path / "B"),
                        ckpt_every=5),
        train_step=step, params=p1, opt_state=s1, pipeline=pipe)
    outB = run(TrainLoopConfig(total_steps=20, ckpt_dir=str(tmp_path / "B"),
                               ckpt_every=10),
               train_step=step, params=init(7), opt_state=s1, pipeline=pipe)
    assert outB["resumed_from"] == 10
    for a, b in zip(leaves(outA["params"]), leaves(outB["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="seed"):
        run(TrainLoopConfig(total_steps=21, ckpt_dir=str(tmp_path / "B")),
            train_step=step, params=init(0), opt_state=s1,
            pipeline=TokenPipeline(vocab_size=64, seq_len=16,
                                   global_batch=4, seed=10))


def test_straggler_watchdog_flags_outliers():
    w = StragglerWatchdog(factor=3.0, window=16)
    for _ in range(10):
        assert not w.observe(0.1)
    assert w.observe(1.0)        # 10x the median
    assert w.flagged == 1
    assert not w.observe(0.11)


def test_train_loop_emits_metrics_log(tmp_path):
    init, loss_fn = _tiny_model()
    opt = tadamw.AdamW(lr=tadamw.constant_schedule(1e-2), weight_decay=0.0)
    pipe = TokenPipeline(vocab_size=64, seq_len=16, global_batch=4)
    log = tmp_path / "metrics.jsonl"
    cfg = TrainLoopConfig(total_steps=12, ckpt_dir=str(tmp_path / "c"),
                          ckpt_every=0, log_every=4)
    out = run(cfg, train_step=_make_step(loss_fn, opt), params=init(0),
              opt_state=opt.init(init(0)), pipeline=pipe,
              log_path=str(log))
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(recs) >= 3 and all("loss" in r for r in recs)
    assert [r["step"] for r in recs] == [0, 4, 8, 11] == \
        [r["step"] for r in out["metrics"]]


# ---------------- the CLI --------------------------------------------- #
def test_train_cli_on_the_cpu_then_resume(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu
    --steps 4``: the loss logged at steps 0 and 3, a checkpoint at
    steps 2 and 4; a second run to 6 resumes from 4 and logs its last
    step."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
            "--reduced", "--device", "cpu", "--global-batch", "4",
            "--seq-len", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "ck"), "--log",
            str(tmp_path / "log.jsonl")]
    out = subprocess.run(base + ["--steps", "4"], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "steps 0→3" in out.stdout and "qwen-smoke (reduced)" in out.stdout
    assert tckpt.published_steps(str(tmp_path / "ck")) == [2, 4]
    out = subprocess.run(base + ["--steps", "6"], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed_from=4" in out.stdout
    recs = [json.loads(line) for line in
            (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 3, 5]     # log_every 10
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_train_cli_refuses_model_parallel():
    from repro_torch.launch import train as tlaunch
    # one process is no mesh: it names the ranks --model-parallel needs
    with pytest.raises(ValueError, match="mesh of at least 2 ranks"):
        tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--model-parallel", "2"])
