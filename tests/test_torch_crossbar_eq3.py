"""The port's Eq. 3 crossbar model (``repro_torch.core.crossbar``:
``eq3_dot_product``, ``effective_weights``, ``crossbar_forward``) and
``YAKOPCIC_PARAMS`` against the reference's ``repro.core.crossbar``, on
the CPU, and the properties of ``tests/test_core_crossbar.py`` held in
the port.

Inputs come from ``np.random.default_rng`` and are handed to both
packages. Bounds: parity rel ≤ 1e-6 (max |diff| / max |ref|: the same
f32 arithmetic summed in another order, ~3e-7 measured), on single
tiles and on (T, M, N) stacks of tiles, without and with wire
resistance; the properties at the reference test's own bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jcb
from repro.core import device as jdevice

from repro_torch.core import crossbar as tcb
from repro_torch.core import device as tdevice

torch.set_num_threads(1)

G_LO, G_HI = 8e-9, 8e-6


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _pairs(seed, shape):
    rng = np.random.default_rng(seed)
    gp = rng.uniform(G_LO, G_HI, shape).astype(np.float32)
    gn = rng.uniform(G_LO, G_HI, shape).astype(np.float32)
    return gp, gn


def _x(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _w(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) *
            0.2).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_yakopcic_params_equal_the_reference():
    assert tdevice.YAKOPCIC_PARAMS == jdevice.YAKOPCIC_PARAMS


# ------------------------------------------------------------------- #
# parity with the reference
# ------------------------------------------------------------------- #
SHAPES = [(None, 16, 128, 64), (None, 7, 256, 128), (3, 16, 128, 64),
          (2, 5, 32, 16)]   # (tiles or None, batch, rows, cols)


@pytest.mark.parametrize("r_seg", [0.0, 2.5], ids=["ideal", "wire_r"])
@pytest.mark.parametrize("tiles,B,M,N", SHAPES)
def test_eq3_and_effective_weights_match_reference(tiles, B, M, N, r_seg):
    lead = () if tiles is None else (tiles,)
    gp, gn = _pairs(M + N, lead + (M, N))
    x = _x(B, lead + (B, M))
    dp = tcb.eq3_dot_product(*_t(x, gp, gn), r_seg=r_seg).numpy()
    w_eff = tcb.effective_weights(*_t(gp, gn), r_seg=r_seg).numpy()
    assert dp.shape == lead + (B, N) and w_eff.shape == lead + (M, N)
    for i in range(tiles or 1):
        pick = (lambda a: a[i]) if tiles else (lambda a: a)
        want = jcb.eq3_dot_product(jnp.asarray(pick(x)),
                                   jnp.asarray(pick(gp)),
                                   jnp.asarray(pick(gn)), r_seg)
        assert _rel(pick(dp), want) <= 1e-6
        want = jcb.effective_weights(jnp.asarray(pick(gp)),
                                     jnp.asarray(pick(gn)), r_seg)
        assert _rel(pick(w_eff), want) <= 1e-6


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("compensate", [True, False])
@pytest.mark.parametrize("r_seg", [0.0, 2.5], ids=["ideal", "wire_r"])
@pytest.mark.parametrize("tiles", [None, 3])
def test_crossbar_forward_matches_reference(tiles, r_seg, compensate,
                                            quantize):
    lead = () if tiles is None else (tiles,)
    w = _w(5, lead + (128, 64))
    x = _x(6, lead + (16, 128))
    out = tcb.crossbar_forward(*_t(x, w), r_seg=r_seg, quantize=quantize,
                               compensate_gain=compensate).numpy()
    assert out.shape == lead + (16, 64)
    for i in range(tiles or 1):
        pick = (lambda a: a[i]) if tiles else (lambda a: a)
        want = jcb.crossbar_forward(jnp.asarray(pick(x)),
                                    jnp.asarray(pick(w)), r_seg=r_seg,
                                    quantize=quantize,
                                    compensate_gain=compensate)
        assert _rel(pick(out), want) <= 1e-6


def test_one_input_vector_matches_reference():
    """A 1-D x (M,) is one input vector, on a tile and on a stack."""
    gp, gn = _pairs(1, (3, 128, 64))
    x = _x(2, (128,))
    w = _w(3, (128, 64))
    out = tcb.eq3_dot_product(*_t(x, gp, gn)).numpy()
    assert out.shape == (3, 64)
    for i in range(3):
        assert _rel(out[i], jcb.eq3_dot_product(
            jnp.asarray(x), jnp.asarray(gp[i]), jnp.asarray(gn[i]))) <= 1e-6
    out = tcb.crossbar_forward(*_t(x, w)).numpy()
    assert out.shape == (64,)
    assert _rel(out, jcb.crossbar_forward(jnp.asarray(x),
                                          jnp.asarray(w))) <= 1e-6


# ------------------------------------------------------------------- #
# the reference test's properties, in the port
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("lead", [(), (4,)], ids=["tile", "stack"])
def test_eq3_is_normalized_divider(lead):
    """|DP| can never exceed max|x|: it is a resistive divider."""
    gp, gn = _pairs(0, lead + (128, 64))
    x = _x(1, lead + (32, 128))
    dp = tcb.eq3_dot_product(*_t(x, gp, gn))
    assert float(dp.abs().max()) <= float(np.abs(x).max()) + 1e-6


def test_eq3_linear_in_x():
    gp, gn = _pairs(1, (128, 64))
    x = torch.from_numpy(_x(2, (4, 128)))
    g = _t(gp, gn)
    np.testing.assert_allclose(tcb.eq3_dot_product(2.0 * x, *g).numpy(),
                               2.0 * tcb.eq3_dot_product(x, *g).numpy(),
                               rtol=1e-5)


def test_crossbar_forward_matches_matmul_unquantized():
    x, w = _t(_x(2, (16, 128)), _w(3, (128, 64)))
    out = tcb.crossbar_forward(x, w, quantize=False)
    np.testing.assert_allclose(out.numpy(), (x @ w).numpy(), rtol=1e-4,
                               atol=1e-5)


def test_crossbar_forward_8bit_error_budget():
    x, w = _t(_x(3, (64, 128)), _w(4, (128, 64)))
    out = tcb.crossbar_forward(x, w, quantize=True)
    ref = x @ w
    rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
    assert rel < 0.05  # ~7-bit device pairs → well under 5% on a tile


def test_threshold_is_gain_invariant():
    """The paper's pairing of Eq. 3 with a threshold activation: the
    output's sign does not depend on the column divider gain."""
    x, w = _t(_x(4, (32, 128)), _w(5, (128, 64)))
    dp_raw = tcb.crossbar_forward(x, w, quantize=False,
                                  compensate_gain=False)
    dp_deg = tcb.crossbar_forward(x, w, quantize=False,
                                  compensate_gain=True)
    assert torch.equal(torch.sign(dp_raw), torch.sign(dp_deg))


def test_wire_attenuation_monotone():
    a = tcb.wire_attenuation(128, 64, 8e-6, 2.5).numpy()
    assert a.max() <= 1.0
    # devices far from the row inputs and the sense see more wire
    assert a[0, -1] == a.max()
    assert a[-1, 0] == a.min()


@pytest.mark.parametrize("rows,cols", [(2, 1), (3, 32), (17, 5), (64, 1),
                                       (64, 32), (40, 23)])
def test_effective_weights_columns_sum_property(rows, cols):
    """Each effective-weight column has Σ_i |w_eff| ≤ 1: the numerator
    is at most the denominator element by element."""
    gp, gn = _pairs(rows * 1000 + cols, (rows, cols))
    w_eff = tcb.effective_weights(*_t(gp, gn)).numpy()
    assert (np.abs(w_eff).sum(axis=0) <= 1.0 + 1e-6).all()
