"""The port on the card: each hand-written CUDA kernel against its plain
PyTorch version at the deep app's shapes (the int8 kernel's own DAC on
f32 inputs against PyTorch's quantise-and-cast chain, to the bit), and
the deep-app stream through the kernels. Every test here carries the ``gpu`` marker and
skips (decided in a fixture) where no card is visible.

It also streams a noisy, drifting deep-app chip and the paper's object
and ocr nets (24 and 20 row chunks; digital rows of 3072 and 2500
bytes) through the kernels, layer by layer against the einsum path; a
digital chip at 12 and 16 bits through the raw int8 kernel's byte
planes, equal to the einsum path to the bit; and the deep app as a
fleet of 1–4 logical chips against the chip (rel ≤ 1e-6), a fleet of
two ranks sharing the card (and one of them killed mid-serve); the raw
int8 kernel at the tuned 12-bit ocr tenant's plane shapes, a deployed
two-tenant drain and the tuned heterogeneous deployment.

This file imports no JAX (the machine with the card has none), so it
runs there on its own:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Bounds: crossbar f32 rel ≤ 1e-5 (the kernel sums in another order than
the plain version's matmul); crossbar with bf16 x rel ≤ 1e-2 (the
kernel rounds the combined tile to bf16 as the TPU kernel does, the
plain version keeps it f32); fused int8 rel ≤ 1e-6; raw int8 exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.chip import compile as tcompile
from repro_torch.chip import compile_chip
from repro_torch.fleet import shard_chip
from repro_torch.core import crossbar_layer as tcl
from repro_torch.core import quantization as tq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.variability import NoiseModel

torch.set_num_threads(1)

SWEEP = [(1, 1, 1, 128, 64), (8, 1, 1, 128, 128), (200, 3, 2, 128, 64),
         (128, 2, 3, 64, 32), (5, 4, 1, 32, 16)]
DEEP = (784, 200, 100, 10)
BAND = 1e-5          # near-zero band for threshold units, × max|pre|


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


def _t(*arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    # the plain versions' matmuls must stay IEEE f32 (PyTorch's default)
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


@pytest.fixture
def staged(cuda):
    """The card with the staged backend built (ranks sharing the card
    join a group that uses it), once, before any rank starts."""
    from repro_torch.launch import mesh as tmesh
    tmesh.build_staged_backend()
    return cuda


# the deep app's launch shapes: memristor (B, R, C, rows, cols) per layer
DEEP_CB = [(4096, 7, 4, 128, 64), (4096, 2, 2, 128, 64),
           (4096, 1, 1, 128, 64)]
DEEP_I8 = [(4096, 784, 200), (4096, 200, 100), (4096, 100, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEEP_CB + SWEEP)
@pytest.mark.parametrize("partials", [False, True])
def test_gpu_crossbar_kernel_matches_plain(cuda, shape, partials):
    x, gp, gn, sc, bias = _t(*_cb_operands(11, *shape), device=cuda)
    bias = None if partials else bias
    act = "linear" if partials else "tanh"
    out = ops.crossbar_mvm(x, gp, gn, sc, bias, activation=act,
                           partials=partials)
    plain = (tref.crossbar_mvm_partials_ref(x, gp, gn, sc) if partials
             else tref.crossbar_mvm_ref(x, gp, gn, sc, bias,
                                        activation=act))
    torch.cuda.synchronize()
    assert _rel(out.cpu(), plain.cpu()) <= 1e-5   # another sum order


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEEP_CB)
def test_gpu_crossbar_kernel_bf16(cuda, shape):
    """The kernel rounds the combined tile to bf16 (as the TPU kernel
    does); the plain version keeps it f32: rel ≤ 1e-2."""
    x, gp, gn, sc, bias = _t(*_cb_operands(12, *shape), device=cuda)
    out = ops.crossbar_mvm(x.to(torch.bfloat16), gp, gn, sc, bias)
    plain = tref.crossbar_mvm_ref(x.to(torch.bfloat16), gp, gn, sc, bias)
    assert _rel(out.cpu(), plain.cpu()) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,N", DEEP_I8)
def test_gpu_int8_kernels_match_plain(cuda, B, K, N):
    x, w, scale, offset = _t(*_i8_operands(13, B, K, N), device=cuda)
    assert torch.equal(ops.int8_matmul(x, w), tref.int8_matmul_ref(x, w))
    out = ops.int8_matmul(x, w, scale, offset, activation="sigmoid")
    plain = tref.int8_matmul_fused_ref(x, w, scale, offset,
                                       activation="sigmoid")
    assert _rel(out.cpu(), plain.cpu()) <= 1e-6


# edge shapes of the tensor-core kernels: serving batches (1, 4) and a
# ragged one (37), 32-row crossbars, 16-column tiles several of which
# share one 64-column block tile, and a ragged batch large enough that
# partials mode walks all its row chunks in one block (smaller ones
# give each chunk its own block)
EDGE_CB = [(1, 1, 1, 128, 64), (4, 2, 2, 128, 64), (37, 2, 5, 32, 16),
           (4, 3, 2, 32, 16), (37, 7, 4, 128, 64), (16383, 3, 3, 128, 32)]
ACTS = ["linear", "threshold", "sigmoid", "relu", "tanh"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EDGE_CB)
@pytest.mark.parametrize("activation", ACTS)
def test_gpu_crossbar_kernel_reduce_edges(cuda, shape, activation):
    """Reduce mode with every fused activation; threshold units may take
    the other rail only in the near-zero band."""
    x, gp, gn, sc, bias = _t(*_cb_operands(14, *shape), device=cuda)
    out = ops.crossbar_mvm(x, gp, gn, sc, bias, activation=activation)
    plain = tref.crossbar_mvm_ref(x, gp, gn, sc, bias, activation=activation)
    if activation == "threshold":
        pre = tref.crossbar_mvm_ref(x, gp, gn, sc, bias)
        near = pre.abs() <= BAND * pre.abs().max()
        assert not bool(((out != plain) & ~near).any())
    else:
        assert _rel(out.cpu(), plain.cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EDGE_CB)
def test_gpu_crossbar_kernel_partials_edges(cuda, shape):
    x, gp, gn, sc, _ = _t(*_cb_operands(15, *shape), device=cuda)
    out = ops.crossbar_mvm(x, gp, gn, sc, partials=True)
    plain = tref.crossbar_mvm_partials_ref(x, gp, gn, sc)
    assert _rel(out.cpu(), plain.cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EDGE_CB + DEEP_CB)
@pytest.mark.parametrize("partials", [False, True])
def test_gpu_crossbar_kernel_bf16_edges(cuda, shape, partials):
    """bf16 x in both modes: the kernel rounds the combined tile to bf16,
    the plain version keeps it f32 (rel ≤ 1e-2)."""
    x, gp, gn, sc, bias = _t(*_cb_operands(16, *shape), device=cuda)
    xb = x.to(torch.bfloat16)
    if partials:
        out = ops.crossbar_mvm(xb, gp, gn, sc, partials=True)
        plain = tref.crossbar_mvm_partials_ref(xb, gp, gn, sc)
    else:
        out = ops.crossbar_mvm(xb, gp, gn, sc, bias, activation="sigmoid")
        plain = tref.crossbar_mvm_ref(xb, gp, gn, sc, bias,
                                      activation="sigmoid")
    assert _rel(out.cpu(), plain.cpu()) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 37])
@pytest.mark.parametrize("K,N", [(784, 200), (200, 100), (100, 10),
                                 (37, 5)])
@pytest.mark.parametrize("signed", [False, True])
def test_gpu_int8_kernels_edges(cuda, B, K, N, signed):
    """Rows of 200, 100 and 37 bytes are not 16-byte aligned (narrower
    copies), and 784 = 12.25 steps of 64 leaves a ragged last step."""
    x, w, scale, offset = _t(*_i8_operands(17, B, K, N, signed),
                             device=cuda)
    assert torch.equal(ops.int8_matmul(x, w), tref.int8_matmul_ref(x, w))
    out = ops.int8_matmul(x, w, scale, offset, activation="tanh")
    plain = tref.int8_matmul_fused_ref(x, w, scale, offset,
                                       activation="tanh")
    assert _rel(out.cpu(), plain.cpu()) <= 1e-6


DAC = (-1.0, 2.0 / 255.0, 8)   # the deep app's 8-bit DAC: (lo, step, bits)
DAC_SPECIAL = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1.0, -1.0,
                        3.0, -3.0, 1e30], np.float32)


def _dac_inputs(seed, B, K):
    """(B, K) f32 analog inputs for ``DAC``: uniform over a little more
    than its range; a quarter of them exact half-code ties of x + (−lo)
    in f32 then ÷ f32(step), × f32(1/step) or × 1/f32(step); a fiftieth
    ±inf, NaN, ±0, the range's ends or far past them."""
    lo, step, _ = DAC
    near = np.float32((np.arange(256) + 0.5) * step + lo)
    cand = (near.view(np.int32)[:, None] + np.arange(-8, 9)).astype(
        np.int32).view(np.float32).ravel()
    u = cand + np.float32(-lo)
    ties = np.concatenate([
        cand[y - np.floor(y) == 0.5]
        for y in (u / np.float32(step), u * np.float32(1.0 / step),
                  u * (np.float32(1.0) / np.float32(step)))])
    assert ties.size >= 100
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo - 0.25, 0.25 - lo, B * K).astype(np.float32)
    pick = rng.random(B * K)
    x = np.where(pick < 0.25, rng.choice(ties, B * K), x)
    x = np.where(pick > 0.98, rng.choice(DAC_SPECIAL, B * K), x)
    return x.reshape(B, K)


def _dac_against_the_chain(x, w, scale, offset):
    """The kernel's own DAC on f32 ``x`` against the chain it replaces on
    the card (PyTorch's CUDA ops quantise, the uint8 cast, the kernel
    on codes): the same bits."""
    codes = tref.dac_codes(x, *DAC).to(torch.uint8)
    for act in ("linear", "threshold"):
        want = ops.int8_matmul(codes, w, scale, offset, activation=act)
        got = ops.int8_matmul(x, w, scale, offset, activation=act, dac=DAC)
        assert torch.equal(got, want), act


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 127, 128, 129, 16384, 65536])
@pytest.mark.parametrize("K,N", [(784, 200), (200, 100), (100, 10), (9, 4)])
def test_gpu_int8_dac_kernel_equals_the_torch_chain(cuda, B, K, N):
    """Ties, values out of range, ±inf and NaN; 16-byte copies where K
    % 4 == 0, one input a copy for the 9-input apps; 64- and 256-column
    tiles; ragged K (784 = 12.25 steps) and B edges."""
    x = torch.from_numpy(_dac_inputs(18, B, K)).to(cuda)
    _, w, scale, offset = _t(*_i8_operands(18, 1, K, N), device=cuda)
    _dac_against_the_chain(x, w, scale, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [129, 4096])
@pytest.mark.parametrize("K,N", [(784, 200), (100, 10)])
def test_gpu_int8_dac_kernel_unaligned_view(cuda, B, K, N):
    """An x 4 bytes past a 16-byte boundary (a view into a larger
    buffer) takes one input a copy."""
    flat = torch.from_numpy(_dac_inputs(19, 1, B * K + 1)).to(cuda)
    x = flat.reshape(-1)[1:].view(B, K)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    _, w, scale, offset = _t(*_i8_operands(19, 1, K, N), device=cuda)
    _dac_against_the_chain(x, w, scale, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4097, 65536])
def test_gpu_sram_stream_forms_the_dac_codes_in_the_kernel(cuda, batch):
    """A compiled deep-app SRAM chip streams f32 inputs into one fused
    launch a layer, with the same outputs as the chain each layer ran
    before the kernel formed the codes: quantise, the uint8 cast, the
    kernel on codes."""
    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    chip = compile_chip(tspec, params=params, system="digital", device=cuda)
    x = torch.from_numpy(_dac_inputs(20, batch, DEEP[0])).to(cuda)
    ops.reset_launch_counts()
    out = chip.stream(x)
    assert ops.launch_counts() == {"crossbar_mvm": 0, "int8_matmul_fused": 3,
                                   "int8_matmul_raw": 0}
    h = x
    for layer in chip.plan:
        p = layer.tiles
        codes = tcl.quantize_inputs(p, h).to(torch.uint8)
        h = ops.int8_matmul(codes, p.wq, p.scale, p.offset + layer.bias,
                            activation=layer.activation)
    assert torch.equal(out, h)


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_gpu_deep_app_stream_goes_through_the_kernels(cuda, system):
    """On the card the stream launches one kernel per layer, and each
    layer's kernel pre-activation agrees with the einsum path's on the
    same input (threshold units may differ only in the near-zero
    band)."""
    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    chip = compile_chip(tspec, params=params, system=system, device=cuda)
    x = torch.rand((512, 784), generator=torch.Generator().manual_seed(1),
                   device="cpu").to(cuda)
    ops.reset_launch_counts()
    out = chip.stream(x)
    key = "crossbar_mvm" if system == "memristor" else "int8_matmul_fused"
    assert ops.launch_counts()[key] == 3
    assert out.shape == (512, 10) and bool(torch.isfinite(out).all())
    h = x
    for layer in chip.plan:
        lin = dataclasses.replace(layer, activation="linear")
        pre_k = tcompile._apply_stream_layer(lin, h, True)
        pre_p = tcompile._apply_stream_layer(lin, h, False)
        assert _rel(pre_k.cpu(), pre_p.cpu()) <= 1e-5
        act = tq.make_activation(layer.activation)
        if layer.activation == "threshold":
            differ = act(pre_k) != act(pre_p)
            near = pre_p.abs() <= BAND * pre_p.abs().max()
            assert not bool((differ & ~near).any())
        h = act(pre_p)


def _layers_match(plan, x, age=None):
    """Each layer's kernel pre-activation against the einsum path's on
    the same input; threshold units may differ only in the band."""
    h = x
    for layer in plan:
        lin = dataclasses.replace(layer, activation="linear")
        pre_k = tcompile._apply_stream_layer(lin, h, True, age)
        pre_p = tcompile._apply_stream_layer(lin, h, False, age)
        assert _rel(pre_k.cpu(), pre_p.cpu()) <= 1e-5
        act = tq.make_activation(layer.activation)
        if layer.activation == "threshold":
            differ = act(pre_k) != act(pre_p)
            near = pre_p.abs() <= BAND * pre_p.abs().max()
            assert not bool((differ & ~near).any())
        h = act(pre_p)


@pytest.mark.gpu
def test_gpu_drifting_deep_app_stream_goes_through_the_kernel(cuda):
    """A noisy, drifting deep-app chip: three crossbar launches a call
    at every age, the clock advancing by the batch, and each layer's
    decayed tiles through the kernel matching the einsum path."""
    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    noise = NoiseModel(program_sigma=0.1, stuck_on_frac=0.01,
                       stuck_off_frac=0.01, ir_drop_r_seg=1.0,
                       drift_rate=1e-6, seed=0)
    chip = compile_chip(tspec, params=params, noise=noise, device=cuda)
    assert all(layer.drift is not None and
               layer.drift.device.type == cuda.type for layer in chip.plan)
    x = torch.rand((4096, 784), generator=torch.Generator().manual_seed(1),
                   device="cpu").to(cuda)
    outs = []
    for _ in range(3):
        age = chip.items_streamed
        ops.reset_launch_counts()
        outs.append(chip.stream(x))
        assert ops.launch_counts()["crossbar_mvm"] == 3
        assert chip.items_streamed == age + 4096
        _layers_match(chip.plan, x, torch.full((), float(age),
                                               device=cuda))
    assert not torch.equal(outs[0], outs[2])
    assert all(bool(torch.isfinite(o).all()) for o in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(3072, 100, 10), (2500, 60, 26)])
@pytest.mark.parametrize("system", ["memristor", "digital"])
@pytest.mark.parametrize("batch", [37, 16384])
def test_gpu_object_and_ocr_nets_through_the_kernels(cuda, dims, system,
                                                     batch):
    """The object (24 row chunks at 128×64; 3072-byte digital rows) and
    ocr (20 row chunks, one 60-column tile; 2500-byte rows) nets."""
    tspec = tcl.MLPSpec(dims)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(2),
                          device=cuda)
    chip = compile_chip(tspec, params=params, system=system, device=cuda)
    x = torch.rand((batch, dims[0]),
                   generator=torch.Generator().manual_seed(3),
                   device="cpu").to(cuda)
    ops.reset_launch_counts()
    out = chip.stream(x)
    key = "crossbar_mvm" if system == "memristor" else "int8_matmul_fused"
    assert ops.launch_counts()[key] == 2
    assert out.shape == (batch, dims[-1]) and bool(torch.isfinite(out).all())
    _layers_match(chip.plan, x)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [12, 16])
def test_gpu_wide_digital_stream_through_raw_kernel_planes(cuda, bits):
    """Codes wider than 8 bits: one raw int8 launch per pair of byte
    planes a layer (2 × 2 at 12 bits, 2 × 3 at 16), no fused launch, and
    the stream equal to the einsum path to the bit."""
    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    chip = compile_chip(tspec, params=params, system="digital",
                        weight_bits=bits, device=cuda)
    x = torch.rand((4097, 784), generator=torch.Generator().manual_seed(1),
                   device="cpu").to(cuda)
    ops.reset_launch_counts()
    out = chip.stream(x)
    pairs = 2 * chip.plan[0].tiles.planes.shape[0]
    assert ops.launch_counts() == {"crossbar_mvm": 0, "int8_matmul_fused": 0,
                                   "int8_matmul_raw": 3 * pairs}
    assert torch.equal(out, chip.stream(x, use_kernel=False))


@pytest.mark.gpu
def test_gpu_int8_matmul_planes_is_exact(cuda):
    """The plane route's int64 product equals the exact integer product
    of 12-bit codes (computed on the CPU in int64)."""
    rng = np.random.default_rng(5)
    xq = rng.integers(0, 4096, (300, 784))
    wq = rng.integers(-2047, 2048, (784, 200))
    xp = tcl.unsigned_byte_planes(torch.from_numpy(xq), 2).to(cuda)
    wp = tcl.signed_byte_planes(torch.from_numpy(wq), 2).to(cuda)
    got = ops.int8_matmul_planes(xp, wp)
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), torch.from_numpy(xq @ wq))


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["memristor", "digital"])
@pytest.mark.parametrize("n_chips", [1, 2, 3, 4])
def test_gpu_fleet_stream_matches_chip(cuda, system, n_chips):
    """The fleet's batch goes through one stream call: three
    kernel launches a batch, as the chip's, within rel 1e-6 of it."""
    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    chip = compile_chip(tspec, params=params, system=system, device=cuda)
    fleet = shard_chip(chip, n_chips)
    key = "crossbar_mvm" if system == "memristor" else "int8_matmul_fused"
    for batch in (16384, 4097):
        x = torch.rand((batch, 784),
                       generator=torch.Generator().manual_seed(batch),
                       device="cpu").to(cuda)
        ops.reset_launch_counts()
        got = fleet.stream(x)
        assert ops.launch_counts()[key] == 3
        assert got.shape == (batch, 10)
        assert _rel(got.cpu(), chip.stream(x).cpu()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_gpu_stream_local_goes_through_the_kernels(cuda, system):
    """A one-process fleet's ``stream_local`` on the card: the whole
    stream, three kernel launches a call, equal to ``stream_host`` to
    the bit."""
    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    chip = compile_chip(tspec, params=params, system=system, device=cuda)
    fleet = shard_chip(chip, 2)
    key = "crossbar_mvm" if system == "memristor" else "int8_matmul_fused"
    x = torch.rand((8192, 784),
                   generator=torch.Generator().manual_seed(3)).numpy()
    ops.reset_launch_counts()
    got = fleet.stream_local(x)
    assert ops.launch_counts()[key] == 3
    np.testing.assert_array_equal(got, fleet.stream_host(x))


@pytest.mark.gpu
def test_gpu_two_rank_fleet_on_the_card(cuda):
    """Two ranks (fresh interpreters, one gloo group) share the card:
    each rank's ``stream_local`` is the chip's to the bit with three
    launches a call, and the lockstep roll-up holds."""
    from repro_torch.fleet import __main__ as fmain
    summary = fmain.run_distributed_selftest(2, 2, rows=8192, requests=6,
                                             verbose=False, timeout=300.0)
    assert summary["pass"], summary
    for w in summary["workers"].values():
        assert w["device"] == "cuda:0"
        for system in fmain.SYSTEMS:
            per_call = w[system]["launches_per_call"]
            assert per_call[fmain.KERNEL[system]] == 3
            assert w[system]["equal_chip"]


@pytest.mark.gpu
@pytest.mark.parametrize("lockstep,kill_rank", [(False, 0), (True, 1)])
def test_gpu_chaos_on_the_card(cuda, lockstep, kill_rank):
    """Kill a rank mid-serve on the card: the survivor absorbs its feed
    through the crossbar kernel with exact accounting."""
    from repro_torch.fleet import __main__ as fmain
    summary = fmain.run_chaos_selftest(2, kill_rank=kill_rank,
                                       lockstep=lockstep, verbose=False,
                                       timeout=300.0)
    assert summary["pass"], summary
    (survivor,) = summary["workers"].values()
    assert survivor["launches"]["crossbar_mvm"] > 0
    assert survivor["compile_delta"] == 0


# -------------------- deploy and tune on the card --------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("B", [16384, 4])
@pytest.mark.parametrize("K,N", [(2500, 60), (60, 26)])
def test_gpu_raw_int8_kernel_at_the_ocr_plane_shapes(cuda, B, K, N):
    """The raw int8 kernel at the tuned 12-bit ocr tenant's plane
    shapes (2500 → 60 → 26: N not a multiple of a tile), exact."""
    x, w, _, _ = _i8_operands(7, B, K, N)
    xt, wt = _t(x, w, device=cuda)
    assert torch.equal(ops.int8_matmul(xt, wt),
                       tref.int8_matmul_ref(xt, wt))
    rng = np.random.default_rng(8)
    xq = rng.integers(0, 4096, (B, K))
    wq = rng.integers(-2047, 2048, (K, N))
    got = ops.int8_matmul_planes(
        tcl.unsigned_byte_planes(torch.from_numpy(xq), 2).to(cuda),
        tcl.signed_byte_planes(torch.from_numpy(wq), 2).to(cuda))
    assert torch.equal(got.cpu(), torch.from_numpy(xq @ wq))


@pytest.mark.gpu
def test_gpu_two_tenant_deployment_drains_through_the_kernels(cuda):
    """A memristor and a digital deep-app tenant on 2 logical chips: each
    engine step launches the crossbar kernel 3 times and the fused int8
    kernel 3 times, routed outputs match the direct stream, and the
    per-app rows roll up exactly."""
    from repro_torch.deploy import AppSpec, deploy
    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    d = deploy([AppSpec("m", tspec, params=params, lanes_per_chip=4),
                AppSpec("d", tspec, params=params, system="digital",
                        lanes_per_chip=4)], n_chips=2)
    rng = np.random.default_rng(1)
    for i in range(8):
        for app in ("m", "d"):
            d.submit(app, rng.uniform(0, 1, (16, 784)).astype(np.float32))
    ops.reset_launch_counts()
    done = d.run_until_drained()
    steps = d.router.steps
    assert ops.launch_counts() == {"crossbar_mvm": 3 * steps,
                                   "int8_matmul_fused": 3 * steps,
                                   "int8_matmul_raw": 0}
    for st in done:
        want = d.stream(st.request.key,
                        torch.from_numpy(st.request.items).to(cuda))
        assert np.abs(st.result - want.cpu().numpy()).max() <= 1e-5
    stats = d.stats()
    for f in ("requests", "items", "rejected", "lanes"):
        assert getattr(stats.fleet, f) == sum(getattr(s, f) for s in
                                              stats.apps.values())
    assert stats.fleet.requests == 16 and stats.fleet.items == 256


@pytest.mark.gpu
def test_gpu_tuned_heterogeneous_deployment(cuda):
    """The tuner's fabric for deep and 12-bit ocr deployed on the card:
    each tenant streams as its own single-system chip to the bit,
    ocr through eight raw int8 launches a batch."""
    from repro_torch.configs.paper_apps import APPS
    from repro_torch.core.neural_core import CoreGeometry
    from repro_torch.deploy import AppSpec, DeploymentSpec, deploy
    from repro_torch.tune import tune
    tuned = tune(DeploymentSpec(apps=(
        AppSpec("deep", "deep", items_per_second=1e5),
        AppSpec("ocr", "ocr", items_per_second=1e5, weight_bits=12))))
    d = deploy(tuned.spec)
    assert d.chip_systems == ("digital", "memristor")
    for i, app in enumerate(tuned.spec.apps):
        pt = tuned.assignment[app.name]
        dims = APPS[app.name].nets(pt.system)[0][1]
        spec = tcl.MLPSpec(dims)
        params = tcl.mlp_init(
            spec, generator=torch.Generator().manual_seed(app.seed),
            device=cuda)
        chip = compile_chip(spec, params=params, system=pt.system,
                            geom=CoreGeometry(*pt.geom),
                            weight_bits=app.weight_bits, device=cuda)
        x = torch.rand((4097, dims[0]),
                       generator=torch.Generator().manual_seed(i)).to(cuda)
        ops.reset_launch_counts()
        got = d.stream(app.name, x)
        counts = ops.launch_counts()
        assert torch.equal(got, chip.stream(x))
        if pt.system == "digital":
            assert counts["int8_matmul_raw"] == 8
            assert torch.equal(got, chip.stream(x, use_kernel=False))
        else:
            assert counts["crossbar_mvm"] == 3


# the LM's block linears at the qwen1.5-0.5B width, exact encoding
LM_LINEAR_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [(128, 64), (256, 128)])
@pytest.mark.parametrize("d_in,d_out", LM_LINEAR_SHAPES)
@pytest.mark.parametrize("M", [4, 32])
def test_gpu_crossbar_kernel_at_the_lm_shapes(cuda, geom, d_in, d_out, M):
    """K1 in partials mode on a full-width qwen linear programmed as
    ``compile_lm`` programs it (``quantize=False``), at a decode step's
    4 rows and a prefill's 32, on both systems' geometries (a 128-column
    tile spans two of the kernel's 64-column block tiles)."""
    from repro_torch.core.neural_core import CoreGeometry
    gen = torch.Generator().manual_seed(d_in + d_out + M)
    w = (torch.randn((d_in, d_out), generator=gen) / d_in ** 0.5).to(cuda)
    p = tcl.program_layer(w, geom=CoreGeometry(*geom), quantize=False)
    x = (torch.rand((M, d_in), generator=gen) * 2 - 1).to(cuda)
    xt = tcl.tile_inputs(p, x)
    out = ops.crossbar_mvm(xt, p.gp, p.gn, p.scale, partials=True)
    plain = tref.crossbar_mvm_partials_ref(xt, p.gp, p.gn, p.scale)
    assert out.shape == (M, d_in // geom[0], d_out)
    assert _rel(out.cpu(), plain.cpu()) <= 1e-5   # another sum order
    # the partials sum to x @ w (the exact encoding recovers w)
    assert _rel(out.sum(1).cpu(), (x.double() @ w.double()).cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_gpu_full_width_compile_lm_prefill_matches_dense(cuda, system):
    """The full-width qwen1.5-0.5B: ``compile_lm``'s prefill, every block
    linear through K1 (7 × 24 launches), against the dense forward on
    the card (IEEE f32): logits and cache within rel ≤ 1e-5."""
    from repro_torch.configs import qwen1p5_0p5b
    from repro_torch.lm import TransformerParams, compile_lm
    from repro_torch.models import model as model_lib
    cfg = qwen1p5_0p5b.CONFIG.replace(compute_dtype="float32",
                                      decode_per_slot=True)
    params = model_lib.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(5)).to(cuda)
    want, want_cache = model_lib.prefill(cfg, params, {"tokens": toks})
    clm = compile_lm(TransformerParams(cfg, params), system=system,
                     device=cuda)
    ops.reset_launch_counts()
    got, cache = clm.prefill(toks)
    assert ops.launch_counts() == {"crossbar_mvm": 7 * 24,
                                   "int8_matmul_fused": 0,
                                   "int8_matmul_raw": 0}
    assert _rel(got.cpu(), want.cpu()) <= 1e-5
    for k in want_cache:
        assert _rel(cache[k].cpu(), want_cache[k].cpu()) <= 1e-5


# ---------------- ex-situ training on the card ------------------------ #
@pytest.mark.gpu
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_gpu_trained_net_deployed_equals_the_plain_path(cuda, system):
    """A deep app QAT-trained on the card (8-bit, threshold, 100 steps)
    and compiled: its test-set predictions through the kernels equal
    the einsum path's outside the near-zero band, and its deployed
    accuracy is within 3 points of the QAT forward."""
    from repro_torch.data import mnist_like
    from repro_torch.optim import qat
    xtr, ytr = mnist_like(seed=0, n=1024)
    xte, yte = mnist_like(seed=1, n=512)
    t = qat.train_mlp(xtr, ytr, DEEP, activation="threshold",
                      weight_bits=8, act_bits=8, steps=100, device=cuda)
    assert t["params"][0]["w"].device.type == "cuda"
    chip = compile_chip(t["spec"], params=t["params"], system=system,
                        device=cuda)
    x, y = xte.to(cuda), yte.to(cuda)
    ops.reset_launch_counts()
    got = chip.stream(x)
    key = "crossbar_mvm" if system == "memristor" else "int8_matmul_fused"
    assert ops.launch_counts()[key] == 3
    plain = chip.stream(x, use_kernel=False)
    h = x
    clear = torch.ones(x.shape[0], dtype=torch.bool, device=cuda)
    for layer in chip.plan[:-1]:
        lin = dataclasses.replace(layer, activation="linear")
        pre = tcompile._apply_stream_layer(lin, h, False)
        clear &= ~(pre.abs() <= BAND * pre.abs().max()).any(dim=1)
        h = tq.make_activation(layer.activation)(pre)
    assert int(clear.sum()) >= 256
    assert torch.equal(got.argmax(-1)[clear], plain.argmax(-1)[clear])
    acc_qat = qat.accuracy(t["params"], t["spec"], x, y, mode="qat")
    acc = qat.accuracy(t["params"], t["spec"], x, y, mode=system,
                       chip=chip)
    assert abs(acc - acc_qat) <= 0.03 and acc > 0.5


def _reduced_cfg(compute):
    from repro_torch.configs import get_reduced
    return get_reduced("qwen1.5-0.5b").replace(compute_dtype=compute)


@pytest.mark.gpu
@pytest.mark.parametrize("compute,loss_tol,grad_tol",
                         [("float32", 1e-5, 1e-4), ("bfloat16", 2e-3, 5e-2)])
def test_gpu_reduced_train_step_equals_the_cpu(cuda, compute, loss_tol,
                                               grad_tol):
    """The reduced qwen's loss and gradients on the card against the
    CPU on the same weights and batch (f32 compute: loss rel ≤ 1e-5,
    gradients ≤ 1e-4, the card's matmuls sum in another order; bf16
    compute at 2e-3 and 5e-2, as the CPU parity with the reference),
    and one accumulated train step (AdamW at eps 1e-4, see
    ``tests/test_torch_train.py``) at rel ≤ 1e-4."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.pytree import flatten_with_path, tree_map
    from repro_torch.train import steps
    cfg = _reduced_cfg(compute).replace(grad_accum=2)
    cpu_params = model_lib.init_params(cfg, 0, device="cpu")
    card_params = tree_map(lambda p: p.to(cuda), cpu_params)
    batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=8, seed=2).batch(0)
    m_cpu, g_cpu = steps.value_and_grad(cfg, cpu_params, batch)
    m_card, g_card = steps.value_and_grad(
        cfg, card_params, {k: v.to(cuda) for k, v in batch.items()})
    assert _rel(m_card["loss"].cpu(), m_cpu["loss"]) <= loss_tol
    want = dict(flatten_with_path(g_cpu))
    for k, g in flatten_with_path(g_card):
        assert g.device.type == "cuda"
        assert _rel(g.cpu(), want[k]) <= grad_tol, k
    if compute != "float32":
        return
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 1, 4), eps=1e-4)
    step, accum = steps.make_train_step(cfg, opt, global_batch=8)
    assert accum == 2
    p_cpu, s_cpu, _ = step(cpu_params, opt.init(cpu_params), batch)
    p_card, s_card, _ = step(card_params, opt.init(card_params), batch)
    want = dict(flatten_with_path((p_cpu, s_cpu)))
    for k, v in flatten_with_path((p_card, s_card)):
        assert _rel(v.cpu(), want[k]) <= 1e-4, k


@pytest.mark.gpu
def test_gpu_resume_on_the_card_holds(cuda, tmp_path):
    """The reduced qwen trained 6 steps on the card through the
    launcher, and the same job stopped after its step-3 checkpoint and
    resumed: equal at rel ≤ 1e-6 (the reference's bound), the
    checkpoint written from the card."""
    from repro_torch.launch import train as launch_train
    from repro_torch.pytree import leaves
    from repro_torch.train import train_loop
    args = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "6",
            "--global-batch", "4", "--seq-len", "32", "--ckpt-every", "3"]
    straight = launch_train.main(args + ["--ckpt-dir",
                                         str(tmp_path / "a")])
    leg = launch_train.setup(launch_train.parse_args(
        args + ["--ckpt-dir", str(tmp_path / "b")]))
    assert leg["device"].type == "cuda"
    train_loop.run(dataclasses.replace(leg["loop"], total_steps=3),
                   train_step=leg["train_step"], params=leg["params"],
                   opt_state=leg["opt_state"], pipeline=leg["pipeline"])
    resumed = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed["resumed_from"] == 3
    for a, b in zip(leaves((straight["params"], straight["opt_state"])),
                    leaves((resumed["params"], resumed["opt_state"]))):
        assert a.device.type == b.device.type == "cuda"
        assert _rel(b.cpu(), a.cpu()) <= 1e-6


# ---------------- the Eq. 3 model and the other families --------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("r_seg", [0.0, 2.5], ids=["ideal", "wire_r"])
@pytest.mark.parametrize("rows,cols", [(128, 64), (256, 128)])
def test_gpu_eq3_equals_the_cpu(cuda, rows, cols, r_seg):
    """``eq3_dot_product``, ``effective_weights`` and
    ``crossbar_forward`` on CUDA tensors against the CPU's, rel ≤ 1e-6
    (IEEE f32 summed in another order), on one tile and a stack of 3."""
    from repro_torch.core import crossbar as tcb
    rng = np.random.default_rng(rows + cols)
    x = rng.uniform(-1, 1, (3, 512, rows)).astype(np.float32)
    w = (rng.standard_normal((3, rows, cols)) * 0.2).astype(np.float32)
    for xs, ws in ((x[0], w[0]), (x, w)):
        xc, wc = torch.from_numpy(xs), torch.from_numpy(ws)
        gp, gn, _ = tcb.pairs_from_weights(wc)
        for fn in (lambda x, w, gp, gn: tcb.eq3_dot_product(x, gp, gn, r_seg),
                   lambda x, w, gp, gn: tcb.effective_weights(gp, gn, r_seg),
                   lambda x, w, gp, gn: tcb.crossbar_forward(x, w,
                                                             r_seg=r_seg)):
            want = fn(xc, wc, gp, gn)
            got = fn(*(t.to(cuda) for t in (xc, wc, gp, gn)))
            assert got.device.type == "cuda"
            assert _rel(got.cpu(), want) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(128, 64), (256, 128)])
def test_gpu_k1_with_the_column_gain_equals_eq3(cuda, rows, cols):
    """K1 on one tile's programmed pairs (R = 1, scale = 1/column_gain)
    is Eq. 3 (rel ≤ 1e-5: 3×TF32), and with the threshold epilogue and a
    positive per-column gain it gives Eq. 3's signs outside the band."""
    from repro_torch.core import crossbar as tcb
    rng = np.random.default_rng(cols)
    x = torch.from_numpy(rng.uniform(-1, 1, (4096, rows)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((rows, cols)) * 0.2).astype(
        np.float32)).to(cuda)
    gp, gn, _ = tcb.pairs_from_weights(w)
    gain = tcb.column_gain(gp, gn)
    dp = tcb.eq3_dot_product(x, gp, gn)
    ops.reset_launch_counts()
    k1 = ops.crossbar_mvm(x[:, None, :], gp[None, None].contiguous(),
                          gn[None, None].contiguous(),
                          (1.0 / gain)[None, None].contiguous())
    assert ops.launch_counts()["crossbar_mvm"] == 1
    assert _rel(k1.cpu(), dp.cpu()) <= 1e-5
    pos = torch.from_numpy(rng.uniform(0.2, 3.0, cols).astype(
        np.float32)).to(cuda)
    signs = ops.crossbar_mvm(x[:, None, :], gp[None, None].contiguous(),
                             gn[None, None].contiguous(),
                             (pos / gain)[None, None].contiguous(),
                             activation="threshold")
    clear = dp.abs() > BAND * dp.abs().max()
    assert torch.equal(signs[clear], tq.threshold(dp)[clear])


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["drops", "drop_free"])
def test_gpu_moe_tokens_equals_the_cpu(cuda, cf):
    """The reduced moonshot's ``_moe_tokens`` on 96 tokens: the same
    expert ids and kept slots on the card as on the CPU, aux_loss and
    drop_frac rel ≤ 1e-6, y rel ≤ 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as ttf
    cfg = get_reduced("moonshot-v1-16b-a3b").replace(capacity_factor=cf)
    p = ttf.layer_slice(model_lib.init_params(cfg, 0, device="cpu")
                        ["stack"]["mlp"], 0)
    pc = {k: (v.to(cuda) if torch.is_tensor(v) else
              {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (96, cfg.d_model)).astype(np.float32))
    C = tmoe.capacity(96, cfg)
    _, _, ids = tmoe.route(p, cfg, x)
    _, _, ids_c = tmoe.route(pc, cfg, x.to(cuda))
    assert torch.equal(ids_c.cpu(), ids)
    slot, valid = tmoe.dispatch(ids, cfg.num_experts, C)
    slot_c, valid_c = tmoe.dispatch(ids_c, cfg.num_experts, C)
    assert torch.equal(valid_c.cpu(), valid)
    assert torch.equal(torch.where(valid_c, slot_c, -1).cpu(),
                       torch.where(valid, slot, -1))
    y, aux = tmoe._moe_tokens(p, cfg, x)
    y_c, aux_c = tmoe._moe_tokens(pc, cfg, x.to(cuda))
    assert _rel(y_c.cpu(), y) <= 1e-5
    for k in aux:
        assert _rel(aux_c[k].cpu(), aux[k]) <= 1e-6, k
    assert (float(aux["drop_frac"]) > 0) == (cf == 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_gpu_reduced_gemma2_compile_lm_matches_dense(cuda, system):
    """The reduced gemma2 (windows of 16 under a 24-token prompt,
    softcaps, post-norms, GeGLU) through ``compile_lm``: every linear
    through K1 (7 × 4 launches a forward), prefill and a per-slot decode
    within rel ≤ 1e-5 of the dense forward on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.lm import TransformerParams, compile_lm
    from repro_torch.models import model as model_lib
    cfg = get_reduced("gemma2-9b").replace(compute_dtype="float32",
                                           decode_per_slot=True)
    params = model_lib.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(6)).to(cuda)
    want, wcache = model_lib.prefill(cfg, params, {"tokens": toks})
    clm = compile_lm(TransformerParams(cfg, params), system=system,
                     device=cuda)
    ops.reset_launch_counts()
    got, cache = clm.prefill(toks)
    assert ops.launch_counts()["crossbar_mvm"] == 7 * 4
    assert _rel(got.cpu(), want.cpu()) <= 1e-5
    grow = lambda c: {k: torch.nn.functional.pad(  # noqa: E731
        v, [0, 0, 0, 0, 0, 4]) for k, v in c.items()}
    step = toks[:, :1]
    pos = torch.tensor([24, 20], dtype=torch.int32, device=cuda)
    want_d, _ = model_lib.decode_step(cfg, params, grow(wcache), step, pos)
    got_d, _ = clm.decode(grow(cache), step, pos)
    assert _rel(got_d.cpu(), want_d.cpu()) <= 1e-5


# ---------------- the state-space families (zamba2, xlstm) ------------- #
def _state_reduced(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as model_lib
    cfg = get_reduced(arch).replace(compute_dtype="float32")
    return cfg, model_lib.init_params(cfg, 0, device="cpu")


def _scan_operands(scan, L, dev):
    """Layer 0's scan inputs of the reduced arch, from its projections of
    a seeded hidden state (on the CPU), moved to ``dev``."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models import transformer as ttf
    cfg, params = _state_reduced("zamba2-1.2b" if scan == "ssd"
                                 else "xlstm-350m")
    g0 = ttf.layer_slice(params["stack"]["groups"], 0)
    x = torch.from_numpy(np.random.default_rng(L).standard_normal(
        (2, L, cfg.d_model)).astype(np.float32))
    if scan == "ssd":
        ops_ = ssm.ssd_inputs(ttf.layer_slice(g0["mamba"], 0), cfg, x)[4:]
    else:
        ops_ = xlstm.mlstm_inputs(ttf.layer_slice(g0["mlstm"], 0), cfg,
                                  x)[3:8]
    return [t.to(dev) for t in ops_]


@pytest.mark.gpu
@pytest.mark.parametrize("scan", ["ssd", "mlstm"])
@pytest.mark.parametrize("L,chunk", [(32, 256), (512, 128)])
def test_gpu_chunked_scans_match_their_recurrence(cuda, scan, L, chunk):
    """``ssd_chunked`` and ``mlstm_cell_chunked`` on the card, one chunk
    and four, against their own per-token recurrence on the card:
    outputs and final state rel ≤ 1e-5 (the CPU test's bound; IEEE f32
    summed in another order)."""
    from repro_torch.models import ssm, xlstm
    card = _scan_operands(scan, L, cuda)
    if scan == "ssd":
        (y, s), (y_rec, s_rec) = (ssm.ssd_chunked(*card, chunk),
                                  ssm.ssd_recurrence(*card))
        states = [(s, s_rec)]
    else:
        (y, st), (y_rec, st_rec) = (
            xlstm.mlstm_cell_chunked(*card, None, chunk),
            xlstm.mlstm_recurrence(*card))
        states = list(zip(xlstm.restabilise(st, st_rec[2]), st_rec[:2]))
    assert y.device.type == cuda.type
    assert _rel(y.cpu(), y_rec.cpu()) <= 1e-5
    for got, want in states:
        assert _rel(got.cpu(), want.cpu()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_gpu_state_space_engine_serves_each_requests_greedy(cuda, arch):
    """The reduced arch on the card: ``Engine(slots=2)`` serving 3
    prompts × 6 tokens gives each request the tokens of its own B = 1
    greedy decode, and the prefill logits equal the CPU's (rel ≤ 1e-5)."""
    from repro_torch.models import model as model_lib
    from repro_torch.pytree import tree_map
    from repro_torch.serving import Engine, Request
    cfg, cpu_params = _state_reduced(arch)
    params = tree_map(lambda p: p.to(cuda), cpu_params)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist()
               for n in (5, 9, 12)]
    eng = Engine(cfg, params, slots=2, cache_len=32)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    eng.run_until_drained()
    got = {st.request.uid: st.generated for st in eng.finished}
    for uid, p in enumerate(prompts):
        logits, cache = model_lib.prefill(cfg, params, {"tokens": [p]})
        want, _ = model_lib.prefill(cfg, cpu_params, {"tokens": [p]})
        assert _rel(logits.cpu(), want) <= 1e-5
        if "attn" in cache:
            cache["attn"] = {k: torch.nn.functional.pad(
                v, [0, 0, 0, 0, 0, 32 - v.shape[2]])
                for k, v in cache["attn"].items()}
        toks = [int(logits.argmax(-1))]
        while len(toks) < 6:
            logits, cache = model_lib.decode_step(
                cfg, params, cache, torch.tensor([[toks[-1]]], device=cuda),
                torch.tensor(len(p) + len(toks) - 1))
            toks.append(int(logits.argmax(-1)))
        assert got[uid] == toks, uid


# ------------- the training substrate's reductions on the card ------------- #
PARALLEL_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import AdamW, constant_schedule
from repro_torch.optim.grad_compression import compressed_psum
from repro_torch.pytree import leaves
from repro_torch.train import steps as steps_lib

torch.backends.cuda.matmul.allow_tf32 = False
rank = mesh_lib.init_fleet_group(120)
dev = mesh_lib.rank_device()
torch.cuda.set_device(dev)
world = dist.get_world_size()
out = {"rank": rank, "device": str(dev)}

# compressed_psum on CUDA tensors, different gradients on each rank
mesh = mesh_lib.make_mesh((world,), ("data",))
gen = torch.Generator(device=dev).manual_seed(rank)
grads = {"w": torch.randn((300, 40), generator=gen, device=dev) * (1 + rank),
         "b": torch.randn((17,), generator=gen, device=dev) * 1e-3}
err = {k: torch.zeros_like(v) for k, v in grads.items()}
scale = torch.stack([grads[k].abs().max() / 127.0 for k in sorted(grads)])
dist.all_reduce(scale, op=dist.ReduceOp.MAX)
plain = {k: v.clone() for k, v in grads.items()}
for v in plain.values():
    dist.all_reduce(v)
mean, _ = compressed_psum(mesh, ("data",), grads, err)
out["psum_miss_over_half_scale"] = max(
    float((mean[k] - plain[k] / world).abs().max()) / float(s / 2)
    for k, s in zip(sorted(grads), scale))
out["psum_mean_sum"] = sum(float(v.double().sum()) for v in mean.values())

# the data-parallel step against one process, on the card
cfg = get_reduced("qwen1.5-0.5b").replace(compute_dtype="float32",
                                          grad_accum=2)
pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
                     seed=0)
opt = AdamW(lr=constant_schedule(1e-3), eps=1e-4)
runs = {}
for name in ("one", "dp"):
    params = model_lib.init_params(cfg, 0, device=dev)
    state = opt.init(params)
    make = steps_lib.make_train_step if name == "one" else \\
        steps_lib.make_dp_train_step
    step, _ = make(cfg, opt, global_batch=8)
    losses = []
    for i in range(2):
        params, state, m = step(params, state, pipe.batch(i))
        losses.append(float(m["loss"]))
    runs[name] = (losses, params)
(l1, p1), (l2, p2) = runs["one"], runs["dp"]
out["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
out["params_rel"] = max(float((a - b).abs().max()) for a, b in
                        zip(leaves(p2), leaves(p1))) / \\
    max(float(b.abs().max()) for b in leaves(p1))
print(json.dumps(out))
"""


def _parallel_ranks():
    import sys

    from repro_torch.launch import simdev
    res = simdev.launch_local_fleet([sys.executable, "-c", PARALLEL_WORKER],
                                    2, timeout=300.0)
    for r in res:
        assert r.returncode == 0, r.stderr_tail
    return [simdev.last_json_line(r.stdout) for r in res]


@pytest.mark.gpu
def test_gpu_compressed_psum_and_dp_step_on_cuda_ranks(cuda):
    """Two ranks share the card in one gloo group, every tensor on it:
    ``compressed_psum`` of different gradients lands within scale/2 of
    the plain ``all_reduce`` mean, the same on both ranks; the
    data-parallel step (``make_dp_train_step``, 2 microbatches) of the
    reduced qwen in f32 equals one process's 2 steps (losses and the
    parameter tree within rel 1e-5)."""
    out = _parallel_ranks()
    assert {o["device"] for o in out} == {"cuda:0"}
    assert out[0]["psum_mean_sum"] == out[1]["psum_mean_sum"]
    for o in out:
        assert o["psum_miss_over_half_scale"] <= 1 + 1e-5
        assert o["loss_rel"] <= 1e-5 and o["params_rel"] <= 1e-5, o


GLOO_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch.launch import mesh as mesh_lib

rank = mesh_lib.init_fleet_group(60, backend=sys.argv[1])
dev = mesh_lib.rank_device()
torch.cuda.set_device(dev)
out = {"rank": rank}
x = torch.full((4,), 1.5 + rank, device=dev)
dist.all_reduce(x)
out["all_reduce"] = x.tolist()
g = torch.empty(8, dtype=torch.int8, device=dev)
dist.all_gather_into_tensor(g, torch.full((4,), 100 - rank,
                                          dtype=torch.int8, device=dev))
out["all_gather_into_tensor_int8"] = g.tolist()
r = torch.empty(2, device=dev)
dist.reduce_scatter_tensor(r, torch.arange(4.0, device=dev))
out["reduce_scatter_tensor"] = r.tolist()
try:
    dist.all_reduce(torch.ones(4, dtype=torch.int16, device=dev))
    out["all_reduce_int16"] = "accepted"
except RuntimeError as exc:
    out["all_reduce_int16"] = str(exc)
print(json.dumps(out), flush=True)
if sys.argv[2:] == ["dtensor"]:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = mesh_lib.make_mesh((2,), ("data",))
    w = distribute_tensor(torch.ones(8, 4, device=dev), mesh, [Shard(0)],
                          src_data_rank=None)
    print(json.dumps({"full": w.redistribute(mesh, [Replicate()])
                      .to_local().sum().item()}), flush=True)
"""


def _gloo_ranks(backend, *args):
    import sys

    from repro_torch.launch import simdev
    return simdev.launch_local_fleet(
        [sys.executable, "-c", GLOO_WORKER, backend, *args], 2,
        timeout=120.0)


@pytest.mark.gpu
def test_gpu_gloo_collectives_on_cuda_tensors(cuda):
    """What the port's reductions rest on: gloo takes the card's tensors
    in ``all_reduce``, ``all_gather_into_tensor`` (int8: the compressed
    wire) and ``reduce_scatter_tensor``, and refuses int16 (ROADMAP
    R16: the reference's wire)."""
    import json
    res = _gloo_ranks("gloo")
    for r in res:
        assert r.returncode == 0, r.stderr_tail
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["all_reduce"] == [4.0] * 4
        assert out["all_gather_into_tensor_int8"] == [100] * 4 + [99] * 4
        assert out["reduce_scatter_tensor"] == [[0.0, 2.0], [4.0, 6.0]][
            out["rank"]]
        assert "Invalid scalar type" in out["all_reduce_int16"]


@pytest.mark.gpu
def test_gpu_dtensor_over_gloo_dies_on_cuda_tensors(cuda):
    """Why ranks sharing the card join the staged group, not plain
    gloo: DTensor's first redistribution over gloo on the card's
    tensors — a functional all-gather — kills both ranks (SIGSEGV on
    torch 2.11). When this fails, gloo itself could serve DTensor on
    the card (``launch/mesh.py`` decision 1)."""
    res = _gloo_ranks("gloo", "dtensor")
    assert all(r.returncode != 0 for r in res), [r.stdout for r in res]
    assert all('"full"' not in r.stdout for r in res)


@pytest.mark.gpu
def test_gpu_dtensor_over_the_staged_group_on_cuda_tensors(staged):
    """The twin of the test above over the group ranks sharing the card
    join (``"cpu:gloo,cuda:staged"``): the same redistribution returns
    the whole tensor on both ranks, and the plain collectives give
    gloo's results."""
    import json
    res = _gloo_ranks("cpu:gloo,cuda:staged", "dtensor")
    for r in res:
        assert r.returncode == 0, r.stderr_tail
        lines = r.stdout.strip().splitlines()
        out = json.loads(lines[-2])
        assert out["all_reduce"] == [4.0] * 4
        assert out["all_gather_into_tensor_int8"] == [100] * 4 + [99] * 4
        assert "Invalid scalar type" in out["all_reduce_int16"]
        assert json.loads(lines[-1]) == {"full": 32.0}


SHARDED_WORKER = """
import json
import torch
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.rules import kv_repeat_for, make_rules
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import AdamW, constant_schedule
from repro_torch.pytree import leaves
from repro_torch.sharding import axis_rules, tree_distribute
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import elastic
from repro_torch.train import steps as steps_lib
import sys, tempfile

torch.backends.cuda.matmul.allow_tf32 = False
rank = mesh_lib.init_fleet_group(120, backend=mesh_lib.group_backend())
dev = mesh_lib.rank_device()
torch.cuda.set_device(dev)
base = get_reduced("qwen1.5-0.5b").replace(compute_dtype="float32")
pipe = TokenPipeline(vocab_size=base.vocab_size, seq_len=16, global_batch=8,
                     seed=4)
opt = AdamW(lr=constant_schedule(1e-3), eps=1e-4)
p0 = model_lib.init_params(base, 0, device=dev)
one, _ = steps_lib.make_train_step(base, opt, global_batch=8)
p, s, ref = p0, opt.init(p0), []
for i in range(2):
    p, s, m = one(p, s, pipe.batch(i))
    ref.append(float(m["loss"]))

mesh = mesh_lib.make_debug_mesh(model=2)
cfg = base.replace(kv_repeat=kv_repeat_for(base, mesh_lib.tp_degree(mesh)))
rules = make_rules(cfg, mesh, "train", global_batch=8)
with axis_rules(mesh, rules):
    psh = specs_lib.param_shardings(cfg, mesh)
    params, state = tree_distribute(
        (p0, opt.init(p0)), (psh, specs_lib.opt_shardings(psh, mesh)))
    step, _ = steps_lib.make_train_step(cfg, opt, global_batch=8,
                                        dp=mesh_lib.dp_degree(mesh))
    got = []
    for i in range(2):
        params, state, m = step(params, state, pipe.batch(i))
        got.append(float(m["loss"]))
    whole = [x.full_tensor() for x in leaves(params)]
    # the checkpoint of the card's DTensors, resumed on a (2, 1) mesh
    d = sys.argv[1]
    ckpt_lib.save(d, 2, (params, state))
    rp, rs, rmesh, at = elastic.remesh(d, None, cfg, mesh=elastic.best_mesh_for(
        2, 1), global_batch=8)
    back = max(float((x.full_tensor() - w).abs().max())
               for x, w in zip(leaves(rp), whole))
diff = max(float((a - b).abs().max()) for a, b in zip(whole, leaves(p)))
big = max(float(b.abs().max()) for b in leaves(p))
print(json.dumps({"rank": rank, "ref": ref, "got": got, "rel": diff / big,
                  "mesh": mesh_lib.mesh_axis_sizes(mesh),
                  "remesh": mesh_lib.mesh_axis_sizes(rmesh), "at": at,
                  "restored_max_abs": back,
                  "staged_bytes": mesh_lib.staged_bytes(),
                  "wq": str(params["stack"]["attn"]["wq"].placements)}))
"""


@pytest.mark.gpu
def test_gpu_sharded_train_step_on_two_ranks_sharing_the_card(staged,
                                                              tmp_path):
    """The reduced qwen's sharded (TP) train step on a (1, 2) mesh of two
    ranks sharing the card, over the staged group: its 2 losses and
    final parameters within rel 1e-5 of one process's on the card; the
    checkpoint of its DTensors restores onto a (2, 1) mesh
    (``elastic.remesh``) to the bit."""
    import json
    import sys

    from repro_torch.launch import simdev
    res = simdev.launch_local_fleet(
        [sys.executable, "-c", SHARDED_WORKER, str(tmp_path)], 2,
        timeout=300.0)
    for r in res:
        assert r.returncode == 0, r.stderr_tail
    for o in [json.loads(r.stdout.strip().splitlines()[-1]) for r in res]:
        assert o["mesh"] == {"data": 1, "model": 2}
        assert o["remesh"] == {"data": 2, "model": 1} and o["at"] == 2
        for a, b in zip(o["got"], o["ref"]):
            assert abs(a - b) / abs(b) <= 1e-5, (o["got"], o["ref"])
        assert o["rel"] <= 1e-5 and o["restored_max_abs"] == 0.0, o
        assert o["staged_bytes"] > 0 and "Shard" in o["wq"]


PIPE_WORKER = """
import json
import numpy as np
import torch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.pipeline import pipeline_apply, stage_index

rank = mesh_lib.init_fleet_group(60)
dev = mesh_lib.rank_device()
torch.cuda.set_device(dev)
rng = np.random.default_rng(7)
w = torch.from_numpy((rng.standard_normal((2, 16, 16)) / 4.0)
                     .astype(np.float32)).to(dev)
x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(dev)
mesh = mesh_lib.make_mesh((2,), ("pod",), "cpu")
s = stage_index("pod", mesh=mesh)
stats = {}
out = pipeline_apply(lambda p, h: torch.tanh(h @ p), w[s], x, mesh=mesh,
                     microbatches=4, stats=stats)
want = torch.tanh(torch.tanh(x @ w[0]) @ w[1])
print(json.dumps({"rank": rank, "device": str(out.device),
                  "err": float((out - want).abs().max()),
                  "staged_bytes": stats["staged_bytes"]}), flush=True)
"""


@pytest.mark.gpu
def test_gpu_pipeline_on_two_ranks_sharing_the_card(cuda):
    """``pipeline_apply`` with two stages on two ranks sharing the card
    (one gloo group): the activations are the card's tensors, staged
    through pinned host buffers (gloo's point-to-point takes CPU
    tensors), and every rank returns the sequential result."""
    import json
    import sys

    from repro_torch.launch import simdev
    res = simdev.launch_local_fleet([sys.executable, "-c", PIPE_WORKER], 2,
                                    timeout=120.0)
    outs = []
    for r in res:
        assert r.returncode == 0, r.stderr_tail
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for o in outs:
        assert o["device"] == "cuda:0" and o["err"] < 1e-6, o
    # stage 0: 4 microbatches of 2 × 16 f32 to the host, the broadcast
    # (4, 2, 16) outputs back; stage 1: 4 microbatches in, the outputs
    # to the host for the broadcast
    mb = 2 * 16 * 4
    assert [o["staged_bytes"] for o in outs] == [8 * mb, 8 * mb]


PIPE_GRAD_WORKER = """
import json
import numpy as np
import torch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.pipeline import pipeline_apply, stage_index

torch.backends.cuda.matmul.allow_tf32 = False
rank = mesh_lib.init_fleet_group(60)
dev = mesh_lib.rank_device()
torch.cuda.set_device(dev)
rng = np.random.default_rng(7)
w = torch.from_numpy((rng.standard_normal((2, 16, 16)) / 4.0)
                     .astype(np.float32)).to(dev)
x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(dev)
mesh = mesh_lib.make_mesh((2,), ("pod",), "cpu")
s = stage_index("pod", mesh=mesh)
stats = {}
ws = w[s].clone().requires_grad_()
xs = x.clone().requires_grad_()
out = pipeline_apply(lambda p, h: torch.tanh(h @ p), ws, xs, mesh=mesh,
                     microbatches=4, stats=stats)
(out ** 2).sum().backward()
# one process's autograd of the sequential stages on the card
wr = w.clone().requires_grad_()
xr = x.clone().requires_grad_()
(torch.tanh(torch.tanh(xr @ wr[0]) @ wr[1]) ** 2).sum().backward()
print(json.dumps({"rank": rank, "stage": s, "device": str(out.device),
                  "dw": float((ws.grad - wr.grad[s]).abs().max()),
                  "dx": float((xs.grad - xr.grad).abs().max()),
                  "staged_bytes": stats["staged_bytes"]}), flush=True)
"""


@pytest.mark.gpu
def test_gpu_pipeline_backward_on_two_ranks_sharing_the_card(cuda):
    """``pipeline_apply`` differentiated with two stages on two ranks
    sharing the card, the reference test's stage (``tanh(h @ W[s])``, B
    8, D 16, 4 microbatches): each stage's d W and every rank's d x
    within 1e-6 of one process's CUDA autograd; the staged bytes count
    both directions and the d x broadcast."""
    import json
    import sys

    from repro_torch.launch import simdev
    res = simdev.launch_local_fleet([sys.executable, "-c", PIPE_GRAD_WORKER],
                                    2, timeout=120.0)
    outs = []
    for r in res:
        assert r.returncode == 0, r.stderr_tail
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for o in outs:
        assert o["device"] == "cuda:0", o
        assert o["dw"] < 1e-6 and o["dx"] < 1e-6, o
    # each rank: the forward's 8 microbatches (its sends or receives, and
    # the outputs' broadcast), then 4 d h microbatches leftwards (stage 1
    # to the host, stage 0 from it) and the (4, 2, 16) d x broadcast
    mb = 2 * 16 * 4
    assert [o["staged_bytes"] for o in sorted(outs, key=lambda o:
                                              o["stage"])] == \
        [16 * mb, 16 * mb]


DRYRUN_WORKER = """
import json
import torch
from repro_torch.configs import ShapeConfig, get_reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train import steps as steps_lib

cfg = get_reduced("qwen1.5-0.5b").replace(d_model=512, d_ff=1024,
                                          num_heads=8, num_kv_heads=8,
                                          head_dim=64)
B, S = 8, 512
pred = dryrun.lower_cell(cfg, ShapeConfig("t", S, B, "train"), None,
                         verbose=False)["memory"]["peak_bytes_per_device"]
dev = torch.device("cuda", 0)
opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
step, _ = steps_lib.make_train_step(cfg, opt, global_batch=B)
batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=0).batch(0)

def args():
    p = model_lib.init_params(cfg, 0, device=dev)
    return p, opt.init(p), batch

step(*args())
torch.cuda.synchronize()
torch.cuda.empty_cache()
before = torch.cuda.memory_allocated(dev)
a = args()
torch.cuda.reset_peak_memory_stats(dev)
out = step(*a)
torch.cuda.synchronize()
print(json.dumps({"predicted": pred,
                  "measured": torch.cuda.max_memory_allocated(dev) - before}))
"""


@pytest.mark.gpu
def test_gpu_dryrun_peak_of_a_reduced_step_matches_the_card(cuda):
    """The dry run's peak of a qwen train step at reduced depth (3
    layers, d 512, 8 × 512 tokens) on one position (no mesh) against
    ``max_memory_allocated`` of the same step on the card, after a
    warm-up step: within 10 % (phase 16(a)'s bound)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", DRYRUN_WORKER], cwd=root,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(root, "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert abs(out["predicted"] - out["measured"]) <= 0.10 * out["measured"], \
        out


# the card sleeps while the host queues a burst: ~0.2 s at the H100's clock
BURST_SLEEP_CYCLES = 400_000_000


@pytest.mark.gpu
def test_gpu_stream_spans_resolve_after_one_synchronise(cuda, monkeypatch):
    """With telemetry on, a burst of deep-app stream calls dispatched
    ahead (queued behind a sleep, so the card runs them back to back)
    calls no synchronise; after one final synchronise every span has a
    device time, and the combiner's spans read within 15 % of the
    profiler's sum of the kernels the combiner's operations launched
    (host operations placed inside the spans through the tracer's clock
    anchor)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    tspec = tcl.MLPSpec(DEEP)
    params = tcl.mlp_init(tspec, generator=torch.Generator().manual_seed(0),
                          device=cuda)
    chip = compile_chip(tspec, params=params, system="memristor",
                        device=cuda)
    x = torch.rand((65536, 784), generator=torch.Generator().manual_seed(1),
                   device="cpu").to(cuda)
    want = chip.stream(x)
    torch.cuda.synchronize()
    calls = 8
    tel = obs.configure()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync = torch.cuda.synchronize
            with monkeypatch.context() as m:
                def refuse(*args, **kw):
                    raise AssertionError("a stream call synchronised")
                m.setattr(torch.cuda, "synchronize", refuse)
                torch.cuda._sleep(BURST_SLEEP_CYCLES)
                mark = torch.cuda.Event()
                mark.record()
                outs = [chip.stream(x) for _ in range(calls)]
                starved = mark.query()
            sync()
        left = tel.tracer.resolve_device_times()
        events = tel.tracer.trace_events()
        tracer = tel.tracer
    finally:
        obs.disable()
    assert not starved, "the card woke before the burst was queued"
    assert all(torch.equal(y, want) for y in outs)
    assert left == 0
    names = [e["name"] for e in events]
    assert names.count("chip.stream") == calls
    assert names.count("chip.tile") == 3 * calls
    assert names.count("chip.combine") == 2 * calls
    assert "chip.handover" not in names        # the batch is resident
    assert all(e["args"].get("device_ms", 0) > 0 for e in events), events

    combine = [(tracer.unix_ns(e["ts"]), tracer.unix_ns(e["ts"] + e["dur"]))
               for e in events if e["name"] == "chip.combine"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    kernel_us, ops_inside = 0.0, []
    for fe in prof.events():
        mid = t0 + 500 * (fe.time_range.start + fe.time_range.end)
        if fe.kernels and any(a <= mid <= b for a, b in combine):
            kernel_us += sum(k.duration for k in fe.kernels)
            ops_inside.append(fe.name)
    span_ms = sum(e["args"]["device_ms"] for e in events
                  if e["name"] == "chip.combine")
    assert kernel_us > 0, "no profiled operation inside a combiner span"
    assert abs(span_ms - kernel_us / 1e3) <= 0.15 * kernel_us / 1e3, \
        (span_ms, kernel_us / 1e3, sorted(set(ops_inside)))
