"""The port on the card: each hand-written CUDA kernel against its plain
PyTorch version at the deep app's shapes, and the deep-app stream
through the kernels. Every test here carries the ``gpu`` marker and
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
