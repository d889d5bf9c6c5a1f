"""Every weighted net of the paper's five apps, streamed through the
port's chip and the reference's on both systems, on the CPU.

Each net of ``APPS[app].nets(system)`` becomes an ``MLPSpec`` of its
dims with threshold hidden layers and a linear output; the reference's
``mlp_init`` weights are carried across as numpy. The port streams
through its kernel path (the kernels' plain versions on CPU tensors)
and its einsum path. Bounds, as in ``test_torch_chip.py``: every
layer's pre-activation rel ≤ 1e-5 (max |diff| / max |ref|) on the
reference's own inputs; final outputs rel ≤ 1e-5 against the
reference's stream on the rows whose hidden units all sit outside the
near-zero band (|pre| > 1e-5·max|pre|, R6 in ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chip import compile as jcompile
from repro.core import crossbar_layer as jcl
from repro.core import quantization as jq

from repro_torch.chip import compile as tcompile
from repro_torch.chip import compile_chip
from repro_torch.configs.paper_apps import APPS
from repro_torch.core import crossbar_layer as tcl
from repro_torch.kernels import ops

torch.set_num_threads(1)

BAND = 1e-5
B = 37


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _weighted_nets(app_id, system):
    """The app's distinct net dims on ``system``, in order."""
    seen = []
    for _, dims in APPS[app_id].nets(system):
        if tuple(dims) not in seen:
            seen.append(tuple(dims))
    return seen


def _pair(dims, system, seed):
    jspec = jcl.MLPSpec(dims, activation="threshold",
                        out_activation="linear")
    jparams = jcl.mlp_init(jax.random.PRNGKey(seed), jspec)
    jc = jcompile.compile_chip(jspec, params=jparams, system=system)
    tparams = tcl.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
        device="cpu")
    tc = compile_chip(tcl.MLPSpec(dims, activation="threshold",
                                  out_activation="linear"),
                      params=tparams, system=system, device="cpu")
    return jc, tc


@pytest.mark.parametrize("app_id", sorted(APPS))
@pytest.mark.parametrize("system", ["memristor", "digital"])
def test_paper_app_nets_stream_like_the_reference(app_id, system):
    nets = _weighted_nets(app_id, system)
    assert nets
    for k, dims in enumerate(nets):
        jc, tc = _pair(dims, system, seed=k)
        assert [tl.levels for tl in tc.plan] == [jl.levels for jl in jc.plan]
        x = np.random.default_rng(k).uniform(0, 1, (B, dims[0])).astype(
            np.float32)
        # layer by layer on the reference's own (eager) activations
        h = x
        keep = np.ones(B, bool)
        for i, (jl, tl) in enumerate(zip(jc.plan, tc.plan)):
            pre = np.asarray(jcompile._apply_stream_layer(
                dataclasses.replace(jl, activation="linear"),
                jnp.asarray(h), False))
            for use_kernel in (True, False):
                out = tcompile._apply_stream_layer(
                    dataclasses.replace(tl, activation="linear"),
                    torch.from_numpy(h), use_kernel)
                assert _rel(out, pre) <= 1e-5, (dims, i, use_kernel)
            if i < len(jc.plan) - 1:
                keep &= ~np.any(np.abs(pre) <= BAND * np.max(np.abs(pre)),
                                axis=1)
            h = np.array(jq.make_activation(jl.activation)(
                jnp.asarray(pre)))
        assert keep.sum() >= 0.8 * B, (dims, int(keep.sum()))
        ops.reset_launch_counts()
        got = tc.stream(torch.from_numpy(x)).numpy()
        assert sum(ops.launch_counts().values()) == 0    # CPU: plain
        want = np.asarray(jc.stream(jnp.asarray(x)))
        assert got.shape == (B, dims[-1])
        assert _rel(got[keep], want[keep]) <= 1e-5, dims
        plain = tc.stream(torch.from_numpy(x), use_kernel=False).numpy()
        assert _rel(plain[keep], want[keep]) <= 1e-5, dims


def test_new_launch_shapes_of_the_paper_apps():
    """The paper apps put the kernels at shapes the deep app does not:
    object 24 row chunks and ocr 20 (one column tile of 60), the motion
    nets narrower than a tile, and digital rows of 3072, 2500 and 9
    bytes."""
    grids = {}
    for app_id in APPS:
        for dims in _weighted_nets(app_id, "memristor"):
            spec = tcl.MLPSpec(dims)
            params = tcl.mlp_init(spec,
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu")
            chip = compile_chip(spec, params=params, device="cpu")
            grids[dims] = [tuple(lay.tiles.gp.shape[:2])
                           for lay in chip.plan]
    assert grids[(3072, 100, 10)] == [(24, 2), (1, 1)]
    assert grids[(2500, 60, 26)] == [(20, 1), (1, 1)]
    assert grids[(2, 1)] == [(1, 1)] and grids[(64, 10)] == [(1, 1)]
    widths = {dims[0] for app_id in APPS
              for dims in _weighted_nets(app_id, "digital")}
    assert {3072, 2500, 9, 2} <= widths
