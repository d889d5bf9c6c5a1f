"""The port's kernels: plain PyTorch versions against the reference's
oracles (``repro.kernels.ref``) on the CPU, and the hand-written CUDA
kernels against their plain versions on the card (``gpu`` marker).

Inputs are drawn with numpy from fixed seeds and handed to both
packages. The reference's Pallas kernels are not called: on this JAX
they cannot build their compiler params, so the oracles they are held
to in ``tests/test_kernels.py`` are the yardstick here too.

Bounds: f32 results rel ≤ 1e-6 (max |diff| / max |ref|) — the two
frameworks sum in different orders; int32 results exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref

from repro_torch.kernels import build, ops
from repro_torch.kernels import crossbar_mvm as cb_wrapper
from repro_torch.kernels import int8_matmul as i8_wrapper
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

ACTS = ["linear", "threshold", "sigmoid", "relu", "tanh"]
SWEEP = [(1, 1, 1, 128, 64), (8, 1, 1, 128, 128), (200, 3, 2, 128, 64),
         (128, 2, 3, 64, 32), (5, 4, 1, 32, 16)]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _cb_operands(seed, B, R, C, rows, cols):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, R, rows)).astype(np.float32)
    gp = rng.uniform(8e-9, 8e-6, (R, C, rows, cols)).astype(np.float32)
    gn = rng.uniform(8e-9, 8e-6, (R, C, rows, cols)).astype(np.float32)
    sc = (rng.uniform(0.2, 3.0, (R, C, cols)) /
          np.sum(gp + gn, axis=2)).astype(np.float32)
    bias = (rng.standard_normal(C * cols) * 0.1).astype(np.float32)
    return x, gp, gn, sc, bias


def _i8_operands(seed, B, K, N, signed=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (B, K), dtype=np.int8) if signed else \
        rng.integers(0, 256, (B, K), dtype=np.uint8)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    offset = rng.standard_normal(N).astype(np.float32)
    return x, w, scale, offset


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------- crossbar MVM (K1) -------------------------- #
@pytest.mark.parametrize("B,R,C,rows,cols", SWEEP)
def test_crossbar_plain_matches_reference(B, R, C, rows, cols):
    ops_ = _cb_operands(0, B, R, C, rows, cols)
    out = ops.crossbar_mvm(*_t(*ops_[:4]))
    ref = jref.crossbar_mvm_ref(*_j(*ops_[:4]))
    assert out.shape == (B, C * cols)
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("activation", ACTS)
def test_crossbar_plain_fused_epilogue(activation):
    ops_ = _cb_operands(7, 48, 2, 2, 64, 32)
    out = ops.crossbar_mvm(*_t(*ops_), activation=activation)
    ref = jref.crossbar_mvm_ref(*_j(*ops_), activation=activation)
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("B", [1, 37, 200])
def test_crossbar_plain_ragged_batch(B):
    ops_ = _cb_operands(8, B, 2, 1, 128, 64)
    out = ops.crossbar_mvm(*_t(*ops_), activation="sigmoid")
    ref = jref.crossbar_mvm_ref(*_j(*ops_), activation="sigmoid")
    assert out.shape == (B, 64)
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("B,R,C,rows,cols", SWEEP)
def test_crossbar_plain_partials_are_per_chunk_calls(B, R, C, rows, cols):
    """Partials mode == the reference's one oracle call per row chunk
    (how ``repro.chip`` keeps the partials apart)."""
    x, gp, gn, sc, _ = _cb_operands(3, B, R, C, rows, cols)
    out = ops.crossbar_mvm(*_t(x, gp, gn, sc), partials=True)
    assert out.shape == (B, R, C * cols)
    for r in range(R):
        ref = jref.crossbar_mvm_ref(*_j(x[:, r:r + 1], gp[r:r + 1],
                                        gn[r:r + 1], sc[r:r + 1]))
        assert _rel(out[:, r], ref) <= 1e-6


def test_crossbar_plain_bf16_input():
    """bf16 x: the plain version upcasts x and keeps the combined tile
    in f32, as the reference's oracle does, so it holds the f32 bound."""
    x, gp, gn, sc, bias = _cb_operands(5, 64, 2, 2, 128, 64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(xb.float().numpy(),
                                  np.asarray(xj.astype(jnp.float32)))
    out = ops.crossbar_mvm(xb, *_t(gp, gn, sc, bias))
    ref = jref.crossbar_mvm_ref(xj, *_j(gp, gn, sc, bias))
    assert out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-6


# The card's crossbar kernel multiplies f32 operands as 3×TF32: each
# operand v splits into big = tf32(v) and small = tf32(v − big) (round to
# nearest, ties away from zero, to a 10-bit mantissa), and the product
# is a_small·b_big + a_big·b_small + a_big·b_big. These emulate that
# arithmetic in plain PyTorch (products and sums in float64, so only the
# split's error is measured) and hold it to the kernel's unchanged bound
# against the IEEE f32 plain version: rel ≤ 1e-5.
def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split(v: torch.Tensor):
    big = _tf32_rna(v)
    return big, _tf32_rna(v - big)


def _partials_3xtf32(x, gp, gn, scale):
    xb, xs = _tf32_split(x)
    wb, ws = _tf32_split(gp - gn)
    num = sum(torch.einsum("brk,rckn->brcn", a.double(), w.double())
              for a, w in ((xs, wb), (xb, ws), (xb, wb)))
    num = num.to(torch.float32) * scale[None]
    return num.reshape(x.shape[0], x.shape[1], -1)


def test_tf32_split_rounds_to_nearest_ties_away():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -12],
                     dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32_rna(v).numpy(),
        np.array([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                  1.0 + 2.0 ** -10, 1.0], np.float32))
    big, small = _tf32_split(torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32)))
    assert bool((big.view(torch.int32) & 0x1FFF == 0).all())
    assert bool((small.view(torch.int32) & 0x1FFF == 0).all())


@pytest.mark.parametrize("B,R,C,rows,cols",
                         SWEEP + [(37, 2, 5, 32, 16), (4, 7, 4, 128, 64)])
def test_crossbar_3xtf32_split_within_kernel_bound(B, R, C, rows, cols):
    x, gp, gn, sc, _ = _t(*_cb_operands(21, B, R, C, rows, cols))
    plain = tref.crossbar_mvm_partials_ref(x, gp, gn, sc)
    assert _rel(_partials_3xtf32(x, gp, gn, sc), plain) <= 1e-5


def test_crossbar_3xtf32_split_on_the_deep_app_layer0():
    """The deep app's layer-0 crossbar operands, as the memristor chip's
    stream hands them to the kernel, at B = 256."""
    from repro_torch.chip import compile_chip
    from repro_torch.core import crossbar_layer as tcl
    spec = tcl.MLPSpec((784, 200, 100, 10), activation="threshold",
                       out_activation="linear")
    params = tcl.mlp_init(spec, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    chip = compile_chip(spec, params=params, system="memristor",
                        device="cpu")
    p = chip.plan[0].tiles
    x = torch.from_numpy(np.random.default_rng(22).uniform(
        0, 1, (256, 784)).astype(np.float32))
    xt = tcl.tile_inputs(p, x)
    assert tuple(xt.shape) == (256, 7, 128)
    plain = tref.crossbar_mvm_partials_ref(xt, p.gp, p.gn, p.scale)
    assert _rel(_partials_3xtf32(xt, p.gp, p.gn, p.scale), plain) <= 1e-5


# ---------------------- int8 MAC array (K2, K3) ----------------------- #
@pytest.mark.parametrize("B,K,N", [(1, 256, 128), (37, 300, 130),
                                   (128, 784, 200), (200, 100, 10)])
@pytest.mark.parametrize("signed", [False, True])
def test_int8_plain_raw_is_exact(B, K, N, signed):
    x, w, _, _ = _i8_operands(1, B, K, N, signed)
    out = ops.int8_matmul(*_t(x, w))
    ref = jref.int8_matmul_ref(*_j(x, w))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("activation", ACTS)
def test_int8_plain_fused_epilogue(activation):
    x, w, scale, offset = _i8_operands(2, 96, 784, 200)
    out = ops.int8_matmul(*_t(x, w, scale, offset), activation=activation)
    ref = jref.int8_matmul_fused_ref(*_j(x, w, scale, offset),
                                     activation=activation)
    assert _rel(out, ref) <= 1e-6


def test_int8_plain_refuses_wide_codes():
    """Codes above 8 bits are not wrapped into uint8 (reference fault
    R4): the port raises, on the CPU as on the card."""
    x = torch.full((2, 4), 4095, dtype=torch.int32)
    w = torch.ones((4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="uint8/int8"):
        ops.int8_matmul(x, w, torch.ones(3))


DAC = (-1.0, 2.0 / 255.0, 8)   # the deep app's 8-bit DAC: (lo, step, bits)


def _dac_inputs(seed, B, K):
    """(B, K) f32 analog inputs for ``DAC``: uniform over a little more
    than its range; a quarter of them exact half-code ties of
    (x − lo) / step in f32; a fiftieth ±inf or far out of range."""
    lo, step, _ = DAC
    near = np.float32((np.arange(256) + 0.5) * step + lo)
    cand = (near.view(np.int32)[:, None] + np.arange(-8, 9)).astype(
        np.int32).view(np.float32).ravel()
    y = (cand - np.float32(lo)) / np.float32(step)
    ties = cand[y - np.floor(y) == 0.5]
    assert ties.size >= 100
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo - 0.25, 0.25 - lo, B * K).astype(np.float32)
    pick = rng.random(B * K)
    x = np.where(pick < 0.25, rng.choice(ties, B * K), x)
    special = np.array([np.inf, -np.inf, 3.0, -3.0, 1e30], np.float32)
    x = np.where(pick > 0.98, rng.choice(special, B * K), x)
    return x.reshape(B, K)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("K,N", [(9, 4), (100, 10), (200, 100), (784, 200)])
def test_int8_plain_dac_equals_codes_then_fused(activation, K, N):
    """f32 inputs with the DAC's constants give, on the CPU, the codes
    of ``quantize_inputs`` cast to uint8 through the fused epilogue, to
    the bit."""
    from repro_torch.core import crossbar_layer as tcl
    x = torch.from_numpy(_dac_inputs(3, 67, K))
    _, w, scale, offset = _t(*_i8_operands(3, 1, K, N))
    p = tcl.DigitalParams(w, scale, offset, DAC[1], DAC[2], K, N)
    codes = tcl.quantize_inputs(p, x).to(torch.uint8)
    want = tref.int8_matmul_fused_ref(codes, w, scale, offset,
                                      activation=activation)
    got = ops.int8_matmul(x, w, scale, offset, activation=activation,
                          dac=tcl.dac_of(p))
    assert torch.equal(got, want)


def test_int8_dac_refusals():
    """The DAC runs in the fused mode only, on f32 inputs, at 8 bits and
    below: on the CPU as in the kernel's wrapper."""
    x = torch.from_numpy(_dac_inputs(4, 2, 16))
    _, w, scale, offset = _t(*_i8_operands(4, 1, 16, 3))
    with pytest.raises(ValueError, match="needs scale"):
        ops.int8_matmul(x, w, dac=DAC)
    with pytest.raises(ValueError, match="float32"):
        ops.int8_matmul(x.to(torch.uint8), w, scale, dac=DAC)
    with pytest.raises(ValueError, match="1..8 bits"):
        ops.int8_matmul(x, w, scale, dac=(-1.0, 2.0 / 4095, 12))
    with pytest.raises(ValueError, match="CUDA tensor"):
        i8_wrapper.int8_matmul(x, w, scale, offset, dac=DAC)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_dac_constants_are_exact_in_f32(bits):
    """shift = −lo; at the DAC's steps 2/(2^bits − 1) the reciprocal
    (2^bits − 1)/2 is exact in f32 (1/f32(step) is not), so the kernel's
    product is the one PyTorch's CUDA div by the Python scalar takes."""
    step = 2.0 / (2 ** bits - 1)
    shift, inv, top = i8_wrapper.dac_constants((-1.0, step, bits))
    assert (shift, inv, top) == (1.0, (2 ** bits - 1) / 2, 2 ** bits - 1)
    assert float(np.float32(1.0) / np.float32(step)) != inv or bits == 1


# ------------------------- dispatch and wrappers ---------------------- #
def test_dispatch_refuses_other_devices():
    x = torch.empty((2, 1, 32), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ops.crossbar_mvm(x, x, x, x)


def test_kernel_wrappers_take_only_cuda_tensors():
    """The wrappers never run a plain version: a CPU tensor is refused
    before anything is built or launched, and nothing is counted."""
    ops.reset_launch_counts()
    x, gp, gn, sc, bias = _t(*_cb_operands(0, 4, 1, 1, 32, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cb_wrapper.crossbar_mvm(x, gp, gn, sc, bias)
    xi, w, s, o = _t(*_i8_operands(0, 4, 32, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        i8_wrapper.int8_matmul(xi, w, s, o)
    assert set(ops.launch_counts().values()) == {0}


def test_plain_versions_are_not_counted():
    """Nor does the DAC mode add a counter: the three keys stay."""
    ops.reset_launch_counts()
    ops.crossbar_mvm(*_t(*_cb_operands(0, 4, 1, 1, 32, 16)[:4]))
    ops.int8_matmul(*_t(*_i8_operands(0, 4, 32, 16)[:2]))
    _, w, scale, offset = _t(*_i8_operands(0, 1, 32, 16))
    ops.int8_matmul(torch.from_numpy(_dac_inputs(0, 4, 32)), w, scale,
                    offset, dac=DAC)
    assert ops.launch_counts() == {"crossbar_mvm": 0,
                                   "int8_matmul_fused": 0,
                                   "int8_matmul_raw": 0}


def test_library_name_is_keyed_by_source_and_flags():
    paths = {name: build.library_path(name) for name in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-")
    assert build.library_path("crossbar_mvm") == paths["crossbar_mvm"]


def test_activation_codes_cover_the_plain_table():
    assert set(build.ACTIVATION_CODES) == set(tref.ACTIVATIONS)
    with pytest.raises(ValueError, match="unsupported"):
        build.activation_code("gelu")
