"""The port's ex-situ training path (``repro_torch.core.quantization``,
``core.crossbar_layer.mlp_apply``, ``optim.qat``) against the
reference, on the CPU.

Inputs are made with numpy from a seed and handed across; the
reference's initial weights (``mlp_init`` on a ``jax.random`` key) are
handed to the port's ``train_mlp(params=)``. Tolerances:

  * quantization and the float/qat forward: rel ≤ 1e-6 (max |diff| /
    max |reference|), integer codes exact;
  * the trainer's loss gradient: rel ≤ 1e-5 against ``jax.grad``;
  * trained parameters (float 20 steps, qat 5 steps): rel ≤ 1e-5, on
    sigmoid nets. Threshold nets are held to one step's gradient only:
    XLA's f32 ``tanh`` is a clamped rational approximation (exactly ±1
    for |x| ≥ 7.9), so the straight-through surrogate's backward
    differs from PyTorch's in the tails, and the hard threshold turns
    such differences into flipped units a few steps on;
  * deployed accuracy through ``compile_chip``: equal to the
    reference's on the same weights and data, both systems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chip import compile_chip as jcompile_chip
from repro.core import crossbar_layer as jcl
from repro.core import quantization as jqz
from repro.optim import qat as jqat

from repro_torch.chip import compile_chip
from repro_torch.core import crossbar_layer as tcl
from repro_torch.core import quantization as tqz
from repro_torch.optim import qat as tqat
from repro_torch.variability import NoiseModel

torch.set_num_threads(1)

DIMS = (64, 32, 16, 10)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(seed, n=300, d=64, classes=10):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, d)).astype(np.float32), \
        rng.integers(0, classes, n)


def _ref_init(dims, activation, seed=0):
    spec = jcl.MLPSpec(tuple(dims), activation=activation,
                       out_activation="linear")
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in jcl.mlp_init(jax.random.PRNGKey(seed), spec)]


# ---------------- quantization ---------------------------------------- #
@pytest.mark.parametrize("bits", [2, 4, 8, 12])
@pytest.mark.parametrize("per_column", [False, True])
def test_fake_quant_and_its_gradient_match_reference(bits, per_column):
    w = np.random.default_rng(bits).standard_normal((24, 12)).astype(
        np.float32)
    g_out = np.random.default_rng(99).standard_normal((24, 12)).astype(
        np.float32)
    ref = jqz.fake_quant(jnp.asarray(w), bits, per_column)
    wt = _t(w).requires_grad_(True)
    got = tqz.fake_quant(wt, bits, per_column)
    assert _rel(got.detach().numpy(), ref) <= 1e-6
    # the codes themselves are exact
    s = np.asarray(jqz.weight_scale(jnp.asarray(w), bits, per_column))
    np.testing.assert_array_equal(
        np.round(got.detach().numpy() / s), np.round(np.asarray(ref) / s))
    jg = jax.grad(lambda v: jnp.sum(jqz.fake_quant(v, bits, per_column)
                                    * g_out))(jnp.asarray(w))
    (got * _t(g_out)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("bits,lo,hi", [(8, -1.0, 1.0), (4, -1.0, 1.0),
                                        (6, 0.0, 1.0)])
def test_fake_quant_act_and_its_gradient_match_reference(bits, lo, hi):
    x = np.random.default_rng(bits).uniform(-1.5, 1.5, (50, 7)).astype(
        np.float32)
    ref = jqz.fake_quant_act(jnp.asarray(x), bits, lo, hi)
    xt = _t(x).requires_grad_(True)
    got = tqz.fake_quant_act(xt, bits, lo, hi)
    assert _rel(got.detach().numpy(), ref) <= 1e-6
    jg = jax.grad(lambda v: jnp.sum(jqz.fake_quant_act(v, bits, lo, hi)
                                    ** 2))(jnp.asarray(x))
    (got ** 2).sum().backward()
    assert _rel(xt.grad.numpy(), jg) <= 1e-6


@pytest.mark.parametrize("bits", [4, 8, 10])
def test_quantize_activations_dac_and_dequantize_match_reference(bits):
    x = np.random.default_rng(bits).uniform(-0.2, 1.2, (40, 9)).astype(
        np.float32)
    jc, jlo, jstep = jqz.quantize_activations(jnp.asarray(x), bits)
    tc, tlo, tstep = tqz.quantize_activations(_t(x), bits)
    assert str(tc.dtype).split(".")[-1] == str(jc.dtype)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tlo, tstep) == (jlo, jstep)
    assert _rel(tqz.dac(tc, tlo, tstep).numpy(),
                jqz.dac(jc, jlo, jstep)) <= 1e-6
    w = np.random.default_rng(5).standard_normal((16, 8)).astype(np.float32)
    jq, js = jqz.quantize_weights(jnp.asarray(w), bits, per_column=True)
    tq, ts = tqz.quantize_weights(_t(w), bits, per_column=True)
    assert _rel(tqz.dequantize(tq, ts).numpy(), jqz.dequantize(jq, js)) \
        <= 1e-6


@pytest.mark.parametrize("bits,lo,hi", [(8, -8.0, 8.0), (6, -4.0, 4.0)])
def test_sigmoid_lut_and_apply_lut_match_reference(bits, lo, hi):
    jl = jqz.sigmoid_lut(bits, lo, hi)
    tl = tqz.sigmoid_lut(bits, lo, hi)
    assert tl.dtype == torch.int32 and tl.shape == (2 ** bits,)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    acc = np.random.default_rng(1).uniform(-10, 10, (33, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tqz.apply_lut(_t(acc), tl, lo, hi).numpy(),
        np.asarray(jqz.apply_lut(jnp.asarray(acc), jl, lo, hi)))


# ---------------- mlp_apply ------------------------------------------- #
def _clear_rows(params, x, bits):
    """Rows of ``x`` on which no hidden threshold unit of the
    reference's qat forward lies within 1e-5·max|pre| of zero. With
    ±1 inputs and fake-quantized weights a unit's exact sum can be 0,
    and the sign the f32 sum then takes depends on the summation
    order: those rows are excluded, as chip_smoke's band rule does."""
    h = jnp.asarray(x)
    clear = np.ones(x.shape[0], bool)
    for p in params[:-1]:
        pre = h @ jqz.fake_quant(jnp.asarray(p["w"]), bits, True) + p["b"]
        near = np.abs(np.asarray(pre)) <= 1e-5 * float(jnp.abs(pre).max())
        clear &= ~near.any(axis=1)
        h = jqz.fake_quant_act(jqz.threshold_ste(pre), bits)
    return clear


@pytest.mark.parametrize("activation", ["sigmoid", "threshold", "tanh"])
@pytest.mark.parametrize("mode,bits", [("float", 8), ("qat", 8),
                                       ("qat", 4)])
def test_mlp_apply_training_modes_match_reference(activation, mode, bits):
    """rel ≤ 1e-6; a threshold net in qat mode on the rows clear of the
    near-zero band (at least half of them)."""
    params = _ref_init(DIMS, activation, seed=3)
    x, _ = _data(4, n=64)
    spec_j = jcl.MLPSpec(DIMS, activation=activation)
    spec_t = tcl.MLPSpec(DIMS, activation=activation)
    ref = jcl.mlp_apply([{k: jnp.asarray(v) for k, v in p.items()}
                         for p in params], jnp.asarray(x), spec_j,
                        weight_bits=bits, act_bits=bits, mode=mode)
    got = tcl.mlp_apply(tcl.params_from_numpy(params, device="cpu"), _t(x),
                        spec_t, weight_bits=bits, act_bits=bits, mode=mode)
    rows = np.ones(x.shape[0], bool)
    if activation == "threshold" and mode == "qat":
        rows = _clear_rows(params, x, bits)
        assert rows.sum() >= x.shape[0] // 2
    assert _rel(got.numpy()[rows], np.asarray(ref)[rows]) <= 1e-6


@pytest.mark.parametrize("mode", ["crossbar", "digital"])
def test_mlp_apply_deployed_modes_program_once_and_match_reference(
        mode, monkeypatch):
    """The memo programs each layer once across calls (the reference's
    ``test_mlp_apply_programs_exactly_once``), ``clear_program_cache``
    drops it, and the deployed output equals the reference's einsum
    path at rel ≤ 1e-5 (tanh: no threshold flips)."""
    dims = (32, 16, 4)
    params = _ref_init(dims, "tanh", seed=14)
    spec_j = jcl.MLPSpec(dims, activation="tanh")
    spec_t = tcl.MLPSpec(dims, activation="tanh")
    tparams = tcl.params_from_numpy(params, device="cpu")
    calls = {"n": 0}
    name = "program_layer" if mode == "crossbar" else "program_digital"
    real = getattr(tcl, name)

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tcl, name, counting)
    tcl.clear_program_cache()
    x = np.random.default_rng(20).uniform(-1, 1, (8, 32)).astype(np.float32)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    with pytest.warns(DeprecationWarning):
        for _ in range(3):
            got = tcl.mlp_apply(tparams, _t(x), spec_t, mode=mode)
    assert calls["n"] == len(params)
    tcl.clear_program_cache()
    with pytest.warns(DeprecationWarning):
        tcl.mlp_apply(tparams, _t(x), spec_t, mode=mode)
    assert calls["n"] == 2 * len(params)
    with pytest.warns(DeprecationWarning):
        ref = jcl.mlp_apply(jp, jnp.asarray(x), spec_j, mode=mode)
    assert _rel(got.numpy(), ref) <= 1e-5
    prog = tcl.program_mlp(tparams, spec_t, mode=mode)
    assert torch.equal(tcl.mlp_apply(tparams, _t(x), spec_t, mode=mode,
                                     programmed=prog),
                       tcl.programmed_mlp_apply(prog, _t(x),
                                                use_kernel=True))


@pytest.mark.parametrize("which", ["crossbar", "digital"])
def test_one_shot_linears_warn_and_match_reference(which):
    w = np.random.default_rng(7).standard_normal((40, 20)).astype(
        np.float32) * 0.2
    x = np.random.default_rng(8).uniform(-1, 1, (6, 40)).astype(np.float32)
    jfn = jcl.crossbar_linear if which == "crossbar" else jcl.digital_linear
    tfn = tcl.crossbar_linear if which == "crossbar" else tcl.digital_linear
    with pytest.warns(DeprecationWarning):
        ref = jfn(jnp.asarray(x), jnp.asarray(w), activation="sigmoid")
    with pytest.warns(DeprecationWarning):
        got = tfn(_t(x), _t(w), activation="sigmoid", use_kernel=True)
    assert _rel(got.numpy(), ref) <= 1e-5


# ---------------- the trainer ----------------------------------------- #
def _ref_loss(params, xb, yb, spec, weight_bits, act_bits, mode):
    """The reference trainer's loss (the closure inside train_mlp)."""
    logits = jcl.mlp_apply(params, xb, spec, weight_bits=weight_bits,
                           act_bits=act_bits, mode=mode)
    onehot = jax.nn.one_hot(yb, spec.dims[-1])
    return jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * -onehot, axis=-1))


@pytest.mark.parametrize("activation", ["sigmoid", "threshold"])
@pytest.mark.parametrize("mode", ["float", "qat"])
def test_train_mlp_loss_gradient_matches_jax_grad(activation, mode):
    params = _ref_init(DIMS, activation, seed=1)
    x, y = _data(2, n=128)
    if activation == "threshold" and mode == "qat":
        rows = _clear_rows(params, x, 8)          # no exact-zero ties
        assert rows.sum() >= 64
        x, y = x[rows], y[rows]
    spec_j = jcl.MLPSpec(DIMS, activation=activation)
    spec_t = tcl.MLPSpec(DIMS, activation=activation)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    jloss, jg = jax.value_and_grad(_ref_loss)(jp, jnp.asarray(x),
                                              jnp.asarray(y), spec_j, 8, 8,
                                              mode)
    tp = tcl.params_from_numpy(params, device="cpu")
    leaves = [p[k].requires_grad_(True) for p in tp for k in ("w", "b")]
    tloss = tqat.mlp_loss(tp, _t(x), _t(y), spec_t, 8, 8, mode)
    grads = torch.autograd.grad(tloss, leaves)
    assert abs(float(tloss.detach()) - float(jloss)) <= \
        1e-6 * abs(float(jloss))
    for g, (i, k) in zip(grads, [(i, k) for i in range(3)
                                 for k in ("w", "b")]):
        assert _rel(g.numpy(), jg[i][k]) <= 1e-5, (i, k)


@pytest.mark.parametrize("weight_bits,steps", [(32, 20), (8, 5), (4, 5)])
def test_train_mlp_matches_reference_from_its_weights(weight_bits, steps,
                                                      capsys):
    """Sigmoid nets from the reference's initial weights: float after
    20 steps, qat after 5, at rel ≤ 1e-5; for qat the fake-quant codes
    of the trained weights are counted (and printed) where they
    differ."""
    x, y = _data(0)
    kw = dict(activation="sigmoid", weight_bits=weight_bits,
              act_bits=weight_bits, steps=steps)
    ref = jqat.train_mlp(x, y, DIMS, seed=0, **kw)
    got = tqat.train_mlp(x, y, DIMS, params=_ref_init(DIMS, "sigmoid"),
                         device="cpu", **kw)
    differing = 0
    for gp, rp in zip(got["params"], ref["params"]):
        for k in ("w", "b"):
            assert _rel(gp[k].numpy(), rp[k]) <= 1e-5, k
        if weight_bits < 32:
            s = np.asarray(jqz.weight_scale(rp["w"], weight_bits, True))
            differing += int((np.round(gp["w"].numpy() / s) !=
                              np.round(np.asarray(rp["w"]) / s)).sum())
    print(f"fake-quant codes that differ: {differing}")
    assert got["spec"] == tcl.MLPSpec(DIMS, activation="sigmoid")


def test_train_mlp_sigma0_is_byte_identical_and_noise_hardens():
    """``noise=None`` and ``NoiseModel()`` train the same bytes as no
    model; ``program_sigma=0.3`` trains another net (the reference's
    ``test_qat_trainer_sigma0_equivalence``)."""
    x, y = _data(6, n=96, d=16, classes=4)
    kw = dict(activation="threshold", weight_bits=8, act_bits=8, steps=25,
              seed=0, device="cpu")
    clean = tqat.train_mlp(x, y, (16, 12, 4), **kw)
    for other in (tqat.train_mlp(x, y, (16, 12, 4), noise=None, **kw),
                  tqat.train_mlp(x, y, (16, 12, 4), noise=NoiseModel(),
                                 **kw)):
        for pa, pb in zip(clean["params"], other["params"]):
            for k in ("w", "b"):
                assert pa[k].numpy().tobytes() == pb[k].numpy().tobytes()
    hard = tqat.train_mlp(x, y, (16, 12, 4),
                          noise=NoiseModel(program_sigma=0.3), **kw)
    assert not torch.equal(hard["params"][0]["w"], clean["params"][0]["w"])
    again = tqat.train_mlp(x, y, (16, 12, 4),
                           noise=NoiseModel(program_sigma=0.3), **kw)
    assert torch.equal(hard["params"][0]["w"], again["params"][0]["w"])


@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_accuracy_on_a_compiled_chip_matches_reference(system):
    """``accuracy(chip=)`` through the port's ``compile_chip`` equals
    the reference's on the same weights and data; so do the float and
    qat modes."""
    dims = (64, 32, 10)
    params = _ref_init(dims, "threshold", seed=2)
    x, y = _data(9, n=200)
    jspec = jcl.MLPSpec(dims)
    tspec = tcl.MLPSpec(dims)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    tp = tcl.params_from_numpy(params, device="cpu")
    jchip = jcompile_chip(jspec, params=jp, system=system)
    tchip = compile_chip(tspec, params=tp, system=system, device="cpu")
    n = x.shape[0]

    def hits(acc):       # the f32 means round differently: count hits
        return round(acc * n)

    ref = jqat.accuracy(jp, jspec, x, y, mode=system, chip=jchip)
    got = tqat.accuracy(tp, tspec, x, y, mode=system, chip=tchip)
    assert hits(got) == hits(ref) and 0.0 <= got <= 1.0
    for mode in ("float", "qat"):
        assert hits(tqat.accuracy(tp, tspec, x, y, mode=mode)) == \
            hits(jqat.accuracy(jp, jspec, x, y, mode=mode))


def test_qat_params_quantizes_only_matrices_and_passes_gradients():
    """The reference's two qat_params tests, and qat_loss_fn."""
    p = {"w": torch.linspace(-1, 1, 64).reshape(8, 8),
         "b": torch.linspace(-1, 1, 8)}
    qp = tqat.qat_params(p, bits=4)
    assert not torch.allclose(qp["w"], p["w"])
    assert torch.equal(qp["b"], p["b"])
    jqp = jqat.qat_params({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                          bits=4)
    np.testing.assert_array_equal(qp["w"].numpy(), np.asarray(jqp["w"]))
    w = torch.ones((4, 4), requires_grad=True)
    (tqat.qat_params({"w": w})["w"] ** 2).sum().backward()
    assert float(w.grad.abs().sum()) > 0
    loss = tqat.qat_loss_fn(lambda q, s: (q["w"] * s).sum(), bits=4)
    assert float(loss(p, 2.0)) == pytest.approx(
        float(2.0 * qp["w"].sum()))
