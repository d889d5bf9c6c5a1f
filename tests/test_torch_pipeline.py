"""The GPipe pipeline (``repro_torch.launch.pipeline``) against the
reference's test case, on gloo CPU ranks.

  * ``pipeline_apply`` on 4 ranks (a ``pod`` mesh of 4 stages), the
    case of ``tests/test_pipeline.py``: S 4, B 8, D 16, M 4, a
    ``tanh(h @ W[s])`` stage, ``W`` and ``x`` drawn by numpy from a
    seed. Held to the same sequential loop computed in JAX on the same
    arrays, to the reference test's bound (max abs < 1e-5); every rank
    returns the same array. The reference's own run of its script
    fails on this JAX (ROADMAP R3), so no reference run of it is used.
    The same ranks run a one-stage pipeline (a (pod 1, data 4) mesh)
    and count the p2p bytes with ``roofline.CollectiveCounter``.
  * ``bubble_fraction`` equals the reference's over a grid.
  * A batch that does not split into the microbatches raises, and so
    does a stage parameter that requires a gradient (forward only).
"""
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.pipeline import bubble_fraction as rbubble
from repro_torch.launch import pipeline as tpipe
from repro_torch.launch import simdev

torch.set_num_threads(1)

S, B, D, M = 4, 8, 16, 4
SEED = 7


def _arrays():
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, x


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
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))

    def stage_fn(p, h):
        return torch.tanh(h @ p)

    mesh = mesh_lib.make_mesh((S,), ("pod",), "cpu")
    s = stage_index("pod", mesh=mesh)
    with CollectiveCounter() as c:
        out = pipeline_apply(stage_fn, torch.from_numpy(w[s]), x,
                             mesh=mesh, axis="pod", microbatches=M)
    # one stage: the (pod 1, data 4) mesh's pod axis
    one = mesh_lib.make_mesh((1, S), ("pod", "data"), "cpu")
    alone = pipeline_apply(stage_fn, torch.from_numpy(w[0]), x, mesh=one,
                           axis="pod", microbatches=2)
    print(json.dumps({{"rank": rank, "stage": s, "out": out.tolist(),
                      "alone": alone.tolist(), "by_op": c.stats.by_op,
                      "counts": c.stats.counts}}))
""")


def test_pipeline_matches_sequential_on_four_ranks():
    w, x = _arrays()
    ref = jnp.asarray(x)
    for s in range(S):
        ref = jnp.tanh(ref @ jnp.asarray(w[s]))
    ref = np.asarray(ref)
    res = simdev.launch_local_fleet([sys.executable, "-c", WORKER], S,
                                    timeout=240.0,
                                    extra_env={"OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    out = [simdev.last_json_line(r.stdout) for r in res]
    assert sorted(o["stage"] for o in out) == list(range(S))
    for o in out:
        got = np.asarray(o["out"], dtype=np.float32)
        assert got.shape == (B, D)
        assert float(np.max(np.abs(got - ref))) < 1e-5
        assert o["out"] == out[0]["out"]
        one = np.asarray(o["alone"], dtype=np.float32)
        want = np.tanh(x @ w[0])
        assert float(np.max(np.abs(one - want))) < 1e-6
        # one hop a microbatch and a boundary, then the broadcast of
        # the (M, B/M, D) outputs from the last stage
        mb_bytes = B // M * D * 4
        sends = M if o["stage"] < S - 1 else 0
        assert o["counts"].get("collective-permute", 0) == sends
        assert o["by_op"].get("collective-permute", 0.0) == sends * mb_bytes
        assert o["counts"]["broadcast"] == 1
        assert o["by_op"]["broadcast"] == B * D * 4 * (S - 1) / S


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


def test_a_parameter_with_a_gradient_raises():
    w = torch.zeros((4, 4), requires_grad=True)
    with pytest.raises(NotImplementedError, match="9i"):
        tpipe.pipeline_apply(lambda p, h: h @ p, {"w": w},
                             torch.zeros((4, 4)), mesh=None, microbatches=2)
