"""The port's programming and evaluate paths against the reference.

The reference's weights (and, where the evaluate path alone is under
test, its programmed state) are carried across as numpy; both packages
then program and stream the same layers on the CPU. Bounds: programmed
f32 state and f32 outputs rel ≤ 1e-6 (max |diff| / max |ref|); integer
codes exact; bf16 outputs rel ≤ 1e-2 (one bf16 rounding of the
output, 2⁻⁸ ≈ 4e-3, on values the two frameworks sum in different
orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jcb
from repro.core import crossbar_layer as jcl
from repro.core import quantization as jq
from repro.core.device import DEFAULT_DEVICE as JDEVICE
from repro.core.neural_core import CoreGeometry as JGeom

from repro_torch import runtime
from repro_torch.core import crossbar as tcb
from repro_torch.core import crossbar_layer as tcl
from repro_torch.core import quantization as tq
from repro_torch.core.device import DEFAULT_DEVICE as TDEVICE
from repro_torch.core.neural_core import CoreGeometry as TGeom
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.variability import NoiseModel as TNoise

torch.set_num_threads(1)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _weights(seed, d_in, d_out):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d_in, d_out)) /
            np.sqrt(d_in)).astype(np.float32)


def _carry_crossbar(p):
    return tcl.crossbar_params_from_numpy(
        np.asarray(p.gp), np.asarray(p.gn), np.asarray(p.scale),
        d_in=p.d_in, d_out=p.d_out, geom_rows=p.geom_rows,
        geom_cols=p.geom_cols, device="cpu")


def _carry_digital(p):
    return tcl.digital_params_from_numpy(
        np.asarray(p.wq), np.asarray(p.scale), np.asarray(p.offset),
        step=p.step, bits=p.bits, d_in=p.d_in, d_out=p.d_out,
        device="cpu")


# --------------------------- device & crossbar ------------------------ #
def test_device_encoding_matches_reference():
    w = np.linspace(-1.2, 1.2, 1001).astype(np.float32)
    jgp, jgn = JDEVICE.pair_from_weight(jnp.asarray(w))
    tgp, tgn = TDEVICE.pair_from_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tgp.numpy(), np.asarray(jgp))
    np.testing.assert_array_equal(tgn.numpy(), np.asarray(jgn))
    np.testing.assert_array_equal(
        TDEVICE.quantize_g(tgp).numpy(),
        np.asarray(JDEVICE.quantize_g(jgp)))


@pytest.mark.parametrize("rows,cols,r_seg", [(128, 64, 2.5), (32, 16, 10.0)])
def test_wire_attenuation_matches_reference(rows, cols, r_seg):
    ref = jcb.wire_attenuation(rows, cols, JDEVICE.g_on, r_seg)
    out = tcb.wire_attenuation(rows, cols, TDEVICE.g_on, r_seg)
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("bits,per_column", [(8, True), (8, False),
                                             (4, True), (12, True)])
def test_quantize_weights_codes_exact(bits, per_column):
    w = _weights(1, 200, 100)
    jqw, js = jq.quantize_weights(jnp.asarray(w), bits, per_column)
    tqw, ts = tq.quantize_weights(torch.from_numpy(w), bits, per_column)
    assert str(tqw.dtype).endswith(str(jqw.dtype))
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    assert _rel(ts, js) <= 1e-6


def test_activations_match_reference():
    x = np.linspace(-3, 3, 97).astype(np.float32)
    x[48] = 0.0
    for kind in ("threshold", "sigmoid", "tanh", "relu", "linear"):
        out = tq.make_activation(kind)(torch.from_numpy(x))
        ref = jq.make_activation(kind)(jnp.asarray(x))
        assert _rel(out, ref) <= 1e-6, kind
    np.testing.assert_array_equal(tq.threshold(torch.from_numpy(x)).numpy(),
                                  np.asarray(jq.threshold(jnp.asarray(x))))


# ------------------------------ programming --------------------------- #
@pytest.mark.parametrize("d_in,d_out,geom", [(784, 200, (128, 64)),
                                             (100, 10, (32, 16)),
                                             (300, 130, (256, 128))])
@pytest.mark.parametrize("r_seg", [0.0, 2.5])
def test_program_layer_matches_reference(d_in, d_out, geom, r_seg):
    w = _weights(2, d_in, d_out)
    ref = jcl.program_layer(jnp.asarray(w), geom=JGeom(*geom), r_seg=r_seg)
    out = tcl.program_layer(torch.from_numpy(w), geom=TGeom(*geom),
                            r_seg=r_seg)
    assert out.gp.shape == ref.gp.shape
    assert (out.d_in, out.d_out, out.geom_rows, out.geom_cols) == \
        (ref.d_in, ref.d_out, ref.geom_rows, ref.geom_cols)
    for name in ("gp", "gn", "scale"):
        assert _rel(getattr(out, name), getattr(ref, name)) <= 1e-6, name


@pytest.mark.parametrize("bits", [8, 4, 12])
def test_program_digital_matches_reference(bits):
    w = _weights(3, 784, 200)
    ref = jcl.program_digital(jnp.asarray(w), bits=bits)
    out = tcl.program_digital(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(out.wq.numpy(), np.asarray(ref.wq))
    assert (out.step, out.bits) == (ref.step, ref.bits)
    assert _rel(out.scale, ref.scale) <= 1e-6
    assert _rel(out.offset, ref.offset) <= 1e-6


# ------------------------------- evaluate ----------------------------- #
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("activation", ["linear", "sigmoid", "relu"])
def test_crossbar_apply_matches_reference(use_kernel, activation):
    w = _weights(4, 300, 130)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3, 11, 300)).astype(np.float32)
    b = (rng.standard_normal(130) * 0.1).astype(np.float32)
    jp = jcl.program_layer(jnp.asarray(w), r_seg=2.5)
    ref = jcl.crossbar_apply(jp, jnp.asarray(x), bias=jnp.asarray(b),
                             activation=activation)
    out = tcl.crossbar_apply(_carry_crossbar(jp), torch.from_numpy(x),
                             bias=torch.from_numpy(b),
                             activation=activation, use_kernel=use_kernel)
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("use_kernel", [False, True])
def test_crossbar_apply_bf16_input(use_kernel):
    w = _weights(6, 256, 64)
    x = np.random.default_rng(7).uniform(-1, 1, (32, 256)).astype(
        np.float32)
    jp = jcl.program_layer(jnp.asarray(w))
    ref = jcl.crossbar_apply(jp, jnp.asarray(x).astype(jnp.bfloat16))
    out = tcl.crossbar_apply(_carry_crossbar(jp),
                             torch.from_numpy(x).to(torch.bfloat16),
                             use_kernel=use_kernel)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float(), np.asarray(ref.astype(jnp.float32))) <= 1e-2


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("activation", ["linear", "sigmoid", "tanh"])
def test_digital_apply_matches_reference(use_kernel, activation):
    w = _weights(8, 784, 200)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (64, 784)).astype(np.float32)
    b = (rng.standard_normal(200) * 0.1).astype(np.float32)
    jp = jcl.program_digital(jnp.asarray(w))
    ref = jcl.digital_apply(jp, jnp.asarray(x), bias=jnp.asarray(b),
                            activation=activation)
    out = tcl.digital_apply(_carry_digital(jp), torch.from_numpy(x),
                            bias=torch.from_numpy(b),
                            activation=activation, use_kernel=use_kernel)
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("activation", ["linear", "threshold", "sigmoid"])
@pytest.mark.parametrize("bits", [8, 4])
def test_digital_apply_kernel_path_keeps_its_cpu_output(activation, bits):
    """The kernel path hands the f32 inputs and the DAC's constants to
    the fused int8 MAC; on the CPU that gives, to the bit, what the
    path gave when it quantised first: the codes cast to uint8 through
    the fused epilogue with offset + bias."""
    w = _weights(12, 200, 100)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(-1.3, 1.3, (3, 21, 200)).astype(
        np.float32))
    b = torch.from_numpy((rng.standard_normal(100) * 0.1).astype(
        np.float32))
    p = tcl.program_digital(torch.from_numpy(w), bits=bits)
    codes = tcl.quantize_inputs(p, x.reshape(-1, 200)).to(torch.uint8)
    want = tref.int8_matmul_fused_ref(codes, p.wq, p.scale, p.offset + b,
                                      activation=activation)
    got = tcl.digital_apply(p, x, bias=b, activation=activation,
                            use_kernel=True)
    assert got.shape == (3, 21, 100)
    assert torch.equal(got.reshape(-1, 100), want)


def test_digital_wide_codes_einsum_path_and_kernel_refusal():
    """At 12 bits the einsum path matches the reference's; the int8 MAC
    kernel's wrapper refuses the wide codes instead of wrapping them
    into uint8 (R4): only the byte-plane route takes them."""
    w = _weights(10, 100, 10)
    x = np.random.default_rng(11).uniform(-1, 1, (16, 100)).astype(
        np.float32)
    jp = jcl.program_digital(jnp.asarray(w), bits=12)
    tp = _carry_digital(jp)
    assert tp.wq.dtype == torch.int32
    ref = jcl.digital_apply(jp, jnp.asarray(x))
    assert _rel(tcl.digital_apply(tp, torch.from_numpy(x)), ref) <= 1e-6
    xq = tcl.quantize_inputs(tp, torch.from_numpy(x)).to(torch.int32)
    assert int(xq.max()) > 255
    with pytest.raises(ValueError, match="uint8/int8"):
        kops.int8_matmul(xq, tp.wq, tp.scale, tp.offset)
    with pytest.raises(ValueError, match="uint8/int8"):
        kops.int8_matmul(xq, tp.wq)


@pytest.mark.parametrize("bits", [9, 12, 16])
def test_digital_wide_codes_plane_route_equals_einsum_path(bits):
    """Above 8 bits the kernel path runs the int8 MAC once per pair of
    byte planes and combines them exactly: the output equals the einsum
    path to the bit, and the planes (programmed, or built from carried
    codes) rebuild the codes exactly."""
    w = _weights(13, 300, 40)
    x = np.random.default_rng(14).uniform(-1.2, 1.2, (33, 300)).astype(
        np.float32)
    b = (np.random.default_rng(15).standard_normal(40) * 0.1).astype(
        np.float32)
    tp = tcl.program_digital(torch.from_numpy(w), bits=bits)
    carried = _carry_digital(jcl.program_digital(jnp.asarray(w),
                                                 bits=bits))
    assert torch.equal(carried.planes, tp.planes)
    assert tp.planes.dtype == torch.int8
    weights = 256 ** torch.arange(tp.planes.shape[0])
    assert torch.equal((tp.planes.long() * weights[:, None, None]).sum(0),
                       tp.wq.long())
    for act in ("linear", "sigmoid", "threshold"):
        kw = dict(bias=torch.from_numpy(b), activation=act)
        assert torch.equal(
            tcl.digital_apply(tp, torch.from_numpy(x), use_kernel=True, **kw),
            tcl.digital_apply(tp, torch.from_numpy(x), **kw))
    assert tcl.program_digital(torch.from_numpy(w), bits=8).planes is None


def test_digital_wide_codes_accumulate_exactly_where_int32_wraps():
    """R5: at 16 bits and K = 64, all-maximal codes accumulate to
    65535 · 32767 · 64 ≈ 1.4e11 > 2³¹. The reference's int32
    accumulator wraps; both of the port's paths hold the exact sum."""
    k = 64
    w = np.ones((k, 3), np.float32) * np.asarray([1.0, -1.0, 0.5],
                                                 np.float32)
    x = np.ones((2, k), np.float32)
    jp = jcl.program_digital(jnp.asarray(w), bits=16)
    tp = tcl.program_digital(torch.from_numpy(w), bits=16)
    xq = tcl.quantize_inputs(tp, torch.from_numpy(x)).long()
    exact = xq @ tp.wq.long()
    assert int(exact.abs().max()) > 2 ** 31 - 1
    xp = tcl.unsigned_byte_planes(xq, 2)
    assert torch.equal(kops.int8_matmul_planes(xp, tp.planes), exact)
    want = exact.to(torch.float32) * tp.scale[None, :] + tp.offset[None, :]
    for use_kernel in (False, True):
        assert torch.equal(tcl.digital_apply(tp, torch.from_numpy(x),
                                             use_kernel=use_kernel), want)
    # the reference's einsum path sums in int32 and wraps
    ref = np.asarray(jcl.digital_apply(jp, jnp.asarray(x)))
    assert _rel(ref, want.numpy()) > 1e-3


@pytest.mark.parametrize("bits", [1, 17, 32])
def test_program_digital_refuses_widths_it_cannot_keep_exact(bits):
    with pytest.raises(ValueError, match="bits must be in"):
        tcl.program_digital(torch.from_numpy(_weights(16, 8, 4)), bits=bits)


def test_programmed_state_carried_across_is_what_the_port_programs():
    """program_layer on carried weights == the reference's programmed
    state carried across (the two routes into the evaluate path)."""
    w = _weights(12, 200, 100)
    params = tcl.params_from_numpy([{"w": w, "b": np.zeros(100)}],
                                   device="cpu")
    own = tcl.program_layer(params[0]["w"])
    carried = _carry_crossbar(jcl.program_layer(jnp.asarray(w)))
    for name in ("gp", "gn", "scale"):
        assert _rel(getattr(own, name), getattr(carried, name)) <= 1e-6


# ------------------------------ entry points -------------------------- #
def test_mlp_init_draws_scaled_normal_on_the_given_device():
    spec = tcl.MLPSpec((784, 200, 100, 10))
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    again = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert [tuple(p["w"].shape) for p in params] == \
        [(784, 200), (200, 100), (100, 10)]
    for p, q in zip(params, again):
        assert p["w"].device.type == "cpu"
        assert torch.equal(p["w"], q["w"])
        assert not p["b"].any()
    w = params[0]["w"]
    assert abs(float(w.mean())) < 0.01
    assert abs(float(w.std()) * np.sqrt(784) - 1.0) < 0.02


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tcl.MLPSpec((8, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.mlp_init(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.params_from_numpy([{"w": np.zeros((8, 4)), "b": np.zeros(4)}])
    with pytest.raises(ValueError, match="cuda or cpu"):
        runtime.resolve_device("meta")
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_program_refuses_noise_until_the_variability_slice():
    """The variability slice is in: ``program_layer``/``program_mlp``
    take a NoiseModel; an ideal one programs the same tiles as none,
    and a noisy one perturbs them."""
    w = torch.from_numpy(_weights(3, 40, 12))
    ideal = tcl.program_layer(w, geom=TGeom(16, 8))
    same = tcl.program_layer(w, geom=TGeom(16, 8), noise=TNoise())
    for f in ("gp", "gn", "scale"):
        assert torch.equal(getattr(same, f), getattr(ideal, f))
    noisy = tcl.program_layer(w, geom=TGeom(16, 8),
                              noise=TNoise(program_sigma=0.2))
    assert not torch.equal(noisy.gp, ideal.gp)
    spec = tcl.MLPSpec((40, 12))
    params = [{"w": w, "b": torch.zeros(12)}]
    prog = tcl.program_mlp(params, spec, geom=TGeom(16, 8),
                           noise=TNoise(program_sigma=0.2))
    assert torch.equal(prog.layers[0].gp, noisy.gp)
    dig = tcl.program_mlp(params, spec, mode="digital",
                          noise=TNoise(program_sigma=0.2))
    assert torch.equal(dig.layers[0].wq, tcl.program_digital(w).wq)


def test_programmed_containers_are_frozen():
    p = tcl.program_digital(torch.ones((8, 4)))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.bits = 4


def test_reference_weights_carry_across_exactly():
    spec_j = jcl.MLPSpec((784, 200, 100, 10))
    jparams = jcl.mlp_init(jax.random.PRNGKey(0), spec_j)
    tparams = tcl.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
        device="cpu")
    for jp, tp in zip(jparams, tparams):
        np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
        assert tp["w"].dtype == torch.float32
