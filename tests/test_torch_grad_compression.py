"""``repro_torch.optim.grad_compression`` against ``repro.optim.
grad_compression`` on the CPU.

  * ``quantize_leaf`` / ``dequantize_leaf`` / ``compress_decompress`` /
    ``init_error`` on seeded numpy inputs: the int8 codes equal, the
    scales, dequantised values and errors at rel ≤ 1e-7 (both round
    half to even; the arithmetic is the same f32 operations).
  * Error feedback over 50 steps on the reference test's draws: the
    port's running sum equal to the reference's (rel ≤ 1e-6), and
    within the reference test's bound of the true sum.
  * ``compressed_psum`` over gloo ranks spawned on the CPU (a
    supervisor timeout of 120 s each): on one rank equal to the
    reference's on a one-device mesh; on two ranks with equal
    gradients equal to it too; with unequal gradients within
    ``scale_shared / 2`` (plus f32 rounding) of the plain mean, where
    the reference's formula — each rank's own scale, the sum of codes
    dequantised with the largest — misses it by more than that (R15,
    pinned on the two gradients that show it); and five steps of error
    feedback whose summed means track the summed plain means within
    one step's bound.
"""
import json
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_auto_mesh
from repro.optim import grad_compression as R

from repro_torch.launch import simdev
from repro_torch.optim import grad_compression as T

torch.set_num_threads(1)

TIMEOUT = 120.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,scale", [((256,), 1.0), ((3, 5, 7), 1e-3),
                                         ((64, 33), 40.0), ((1,), 0.0)])
def test_quantize_leaf_matches_reference(bits, shape, scale):
    g = (np.random.default_rng(sum(shape) + bits).standard_normal(shape)
         * scale).astype(np.float32)
    rc, rs = R.quantize_leaf(jnp.asarray(g), bits)
    tc, ts = T.quantize_leaf(_t(g), bits)
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    assert _rel(ts.numpy(), np.asarray(rs)) <= 1e-7
    back = T.dequantize_leaf(tc, ts)
    assert _rel(back.numpy(), np.asarray(R.dequantize_leaf(rc, rs))) \
        <= 1e-7


def test_codes_round_half_to_even():
    # t / scale lands on .5 exactly: both packages round to the even code
    g = np.array([127.0, 2.5, -2.5, 3.5, -0.5, 0.5], np.float32)
    rc, _ = R.quantize_leaf(jnp.asarray(g))
    tc, _ = T.quantize_leaf(_t(g))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(tc.numpy(), [127, 2, -2, 4, 0, 0])


def test_compress_decompress_and_init_error_match_reference():
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((16, 8)).astype(np.float32),
             "b": {"c": (rng.standard_normal(40) * 1e-3).astype(np.float32)}}
    error = {"a": (rng.standard_normal((16, 8)) * 1e-2).astype(np.float32),
             "b": {"c": (rng.standard_normal(40) * 1e-5).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, grads)
    je = jax.tree.map(jnp.asarray, error)
    tt = {"a": _t(grads["a"]), "b": {"c": _t(grads["b"]["c"])}}
    te = {"a": _t(error["a"]), "b": {"c": _t(error["b"]["c"])}}
    rd, rn = R.compress_decompress(jt, je)
    td, tn = T.compress_decompress(tt, te)
    for path in (("a",), ("b", "c")):
        want_d, want_n, got_d, got_n = rd, rn, td, tn
        for k in path:
            want_d, want_n = want_d[k], want_n[k]
            got_d, got_n = got_d[k], got_n[k]
        assert _rel(got_d.numpy(), np.asarray(want_d)) <= 1e-7
        assert _rel(got_n.numpy(), np.asarray(want_n)) <= 1e-7
    zero = T.init_error(tt)
    assert zero["a"].shape == (16, 8) and zero["b"]["c"].shape == (40,)
    assert all(float(z.abs().max()) == 0.0 and z.dtype == torch.float32
               for z in (zero["a"], zero["b"]["c"]))


def test_error_feedback_tracks_reference_and_true_sum():
    """The reference test's 50 steps, on one seeded draw stream fed to
    both packages: Σ D(Q(g_t + e_t)) equal to the reference's and
    within its bound (0.1) of Σ g_t."""
    rng = np.random.default_rng(1)
    g_true = np.zeros(64, np.float64)
    r_sum, r_err = jnp.zeros(64), jnp.zeros(64)
    t_sum, t_err = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        g = (rng.standard_normal(64) + 0.05).astype(np.float32)
        g_true += g
        rd, r_err = R.compress_decompress(jnp.asarray(g), r_err)
        r_sum = r_sum + rd
        (td,), (t_err,) = T.compress_decompress([_t(g)], [t_err])
        t_sum = t_sum + td
    assert _rel(t_sum.numpy(), np.asarray(r_sum)) <= 1e-6
    assert float(np.linalg.norm(t_sum.numpy() - g_true)) < 0.1


# --------------------------------------------------------------------- #
# compressed_psum over gloo ranks
# --------------------------------------------------------------------- #
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.grad_compression import compressed_psum

    torch.set_num_threads(1)
    rank = mesh_lib.init_fleet_group(60)
    mesh = mesh_lib.make_mesh((dist.get_world_size(),), ("data",),
                              device="cpu")
    with open(sys.argv[1]) as f:
        cases = json.load(f)
    out = {}
    for name, case in cases.items():
        steps = case["steps"]          # [step][rank] -> {leaf: list}
        err = {k: torch.zeros(len(v)) for k, v in steps[0][rank].items()}
        rows = []
        for per_rank in steps:
            g = {k: torch.tensor(v, dtype=torch.float32)
                 for k, v in per_rank[rank].items()}
            plain = {k: v.clone() for k, v in g.items()}
            t = {k: g[k] + err[k] for k in g}
            for v in plain.values():
                dist.all_reduce(v)
            scale = torch.stack([v.abs().max().clamp(min=1e-12) / 127.0
                                 for v in t.values()])
            dist.all_reduce(scale, op=dist.ReduceOp.MAX)
            mean, err = compressed_psum(mesh, ("data",), g, err)
            rows.append({
                "mean": {k: v.tolist() for k, v in mean.items()},
                "error": {k: v.tolist() for k, v in err.items()},
                "plain": {k: (v / dist.get_world_size()).tolist()
                          for k, v in plain.items()},
                "scale": dict(zip(t, scale.tolist()))})
        out[name] = rows
    print(json.dumps({"rank": rank, "cases": out}))
""")


def _spawn(cases, n, tmp_path):
    path = tmp_path / f"cases_{n}.json"
    path.write_text(json.dumps(cases))
    res = simdev.launch_local_fleet(
        [sys.executable, "-c", WORKER, str(path)], n, timeout=TIMEOUT,
        extra_env={"OMP_NUM_THREADS": "1"})
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    return [simdev.last_json_line(r.stdout)["cases"] for r in res]


def _ref_psum_one_device(grads, error):
    """The reference's ``compressed_psum`` on a one-device mesh."""
    mesh = make_auto_mesh((1,), ("data",))
    mean, new_e = R.compressed_psum(
        mesh, ("data",), {k: jnp.asarray(v, jnp.float32)
                          for k, v in grads.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in error.items()})
    return ({k: np.asarray(v) for k, v in mean.items()},
            {k: np.asarray(v) for k, v in new_e.items()})


def _reference_formula(per_rank):
    """The reference's multi-rank arithmetic: each rank's codes with its
    own scale, summed, dequantised with the largest scale, / ranks."""
    codes, scales = zip(*[R.quantize_leaf(jnp.asarray(g, jnp.float32))
                          for g in per_rank])
    total = sum(np.asarray(c, np.int32) for c in codes)
    return total.astype(np.float32) * float(max(map(float, scales))) / \
        len(per_rank)


R15_GRADS = [[1.0, 0.5, -0.3], [0.01, 0.004, -0.002]]


def _draws(seed, n_ranks, n_steps, shapes, spread):
    rng = np.random.default_rng(seed)
    return [[{k: (rng.standard_normal(s) * spread[r] + 0.02).astype(
        np.float32).tolist() for k, s in shapes.items()}
        for r in range(n_ranks)] for _ in range(n_steps)]


def test_compressed_psum_one_rank_equals_reference(tmp_path):
    steps = _draws(5, 1, 3, {"w": 96, "b": 7}, [1.0])
    (got,) = _spawn({"one": {"steps": steps}}, 1, tmp_path)
    err = {k: np.zeros(len(v), np.float32) for k, v in steps[0][0].items()}
    for step, row in zip(steps, got["one"]):
        want_mean, err = _ref_psum_one_device(step[0], err)
        for k in want_mean:
            assert _rel(row["mean"][k], want_mean[k]) <= 1e-7
            assert _rel(row["error"][k], err[k]) <= 1e-7


def test_compressed_psum_two_ranks(tmp_path):
    shapes = {"w": 128, "b": 9}
    equal_step = _draws(6, 1, 1, shapes, [1.0])[0][0]
    cases = {
        "equal": {"steps": [[equal_step, equal_step]]},
        "unequal": {"steps": _draws(7, 2, 1, shapes, [1.0, 1e-3])},
        "r15": {"steps": [[{"g": R15_GRADS[0]}, {"g": R15_GRADS[1]}]]},
        "feedback": {"steps": _draws(8, 2, 5, shapes, [1.0, 0.3])},
    }
    ranks = _spawn(cases, 2, tmp_path)
    # every rank holds the same mean
    for name in cases:
        for a, b in zip(ranks[0][name], ranks[1][name]):
            assert a["mean"] == b["mean"], name
    res = ranks[0]

    # equal gradients: the reference's result (every scale is shared)
    (row,) = res["equal"]
    want, want_e = _ref_psum_one_device(
        equal_step, {k: np.zeros(len(v), np.float32)
                     for k, v in equal_step.items()})
    for k in want:
        assert _rel(row["mean"][k], want[k]) <= 1e-7
        assert _rel(row["error"][k], want_e[k]) <= 1e-7

    # unequal gradients: within scale_shared / 2 of the plain mean
    for name in ("unequal", "r15"):
        (row,) = res[name]
        for k in row["mean"]:
            bound = row["scale"][k] / 2 * (1 + 1e-6) + 1e-7
            miss = np.max(np.abs(np.subtract(row["mean"][k],
                                             row["plain"][k])))
            assert miss <= bound, (name, k, miss, bound)

    # R15: the reference's formula is biased on these gradients
    (row,) = res["r15"]
    ref_mean = _reference_formula(R15_GRADS)
    np.testing.assert_allclose(ref_mean, [1.0, 0.453, -0.248], atol=2e-3)
    plain = np.mean(np.asarray(R15_GRADS, np.float32), axis=0)
    assert np.max(np.abs(ref_mean - plain)) > row["scale"]["g"] / 2
    (urow,) = res["unequal"]
    for k in shapes:
        ref_unequal = _reference_formula(
            [r[k] for r in cases["unequal"]["steps"][0]])
        assert np.max(np.abs(ref_unequal - np.asarray(urow["plain"][k]))) \
            > urow["scale"][k] / 2

    # error feedback: Σ compressed tracks Σ plain within one step's bound
    rows = res["feedback"]
    for k in rows[0]["mean"]:
        drift = np.abs(np.sum([r["mean"][k] for r in rows], axis=0) -
                       np.sum([r["plain"][k] for r in rows], axis=0))
        bound = max(r["scale"][k] for r in rows) / 2 * (1 + 1e-5) + 1e-6
        assert np.max(drift) <= bound, (k, np.max(drift), bound)
