"""The port's state-space families against the reference on the CPU: the
causal conv stem (``repro_torch.models.layers``), the Mamba2 SSD scan
(``models.ssm``), the mLSTM and sLSTM cells (``models.xlstm``), their
prefill caches, the serving engine's lane surgery on nested caches
(``serving.kvcache``), the ``Engine`` on both families, ``compile_lm``'s
refusal and checkpoints of a hybrid model both ways.

Everything runs at the reduced zamba2 and xlstm widths in f32, with the
reference's weights handed across (``params_from_numpy``) and inputs
from ``np.random.default_rng``. Scan inputs come from the port's own
projections of layer 0 (``ssd_inputs``, ``mlstm_inputs``) and are fed,
as numpy, to both packages' scans. Bounds, max |diff| / max |ref|:

  * the causal conv and its one-step update: rel ≤ 1e-6;
  * ``ssd_chunked``, ``mlstm_cell_chunked`` and the sLSTM scan against
    the reference: rel ≤ 1e-5 (the same f32 arithmetic summed in
    another order);
  * the chunked scans against their own per-token recurrence (ROADMAP
    R14: the reference's docstring promises that check; no reference
    test makes it): rel ≤ 1e-5;
  * a prefill cache's leaves: the reference's dtype exactly, f32 leaves
    rel ≤ 1e-5, bf16 leaves (the mLSTM's ``C``) rel ≤ 1e-2 (a value
    near a rounding boundary may round to the neighbouring bf16);
  * tokens, lanes and checkpoints: exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import lm as jlm
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt

import repro_torch.configs as tconfigs
from repro_torch.lm import TransformerParams, compile_lm
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as txlstm
from repro_torch.optim import adamw as tadamw
from repro_torch.pytree import flatten_with_path
from repro_torch.serving import Engine, Request, kvcache
from repro_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

HYBRID, SSM = "zamba2-1.2b", "xlstm-350m"
SCAN_CASES = [(32, 256), (512, 128)]   # (L, chunk): one chunk, four


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _keyed(tree):
    """{keystr: numpy} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jcfg, jax params, tcfg, port params) at the reduced width in f32."""
    jcfg = jconfigs.get_reduced(arch).replace(compute_dtype="float32")
    tcfg = tconfigs.get_reduced(arch).replace(compute_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmodel.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _hidden(cfg, L, seed, B=2):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, L, cfg.d_model)).astype(np.float32))


def _ssd_operands(L, seed=0):
    """Layer 0's scan inputs (xs, dts, A, Bm, Cm) as numpy, from the
    port's projections of a random hidden state."""
    _, _, tcfg, tp = _setup(HYBRID)
    p = ttf.layer_slice(ttf.layer_slice(tp["stack"]["groups"], 0)["mamba"],
                        0)
    _, _, _, _, *ops = tssm.ssd_inputs(p, tcfg, _hidden(tcfg, L, seed))
    return [t.numpy() for t in ops]


def _mlstm_operands(L, seed=0):
    """Layer 0's cell inputs (q, k, v, log_i, log_f) as numpy."""
    _, _, tcfg, tp = _setup(SSM)
    p = ttf.layer_slice(ttf.layer_slice(tp["stack"]["groups"], 0)["mlstm"],
                        0)
    out = txlstm.mlstm_inputs(p, tcfg, _hidden(tcfg, L, seed))
    return [t.numpy() for t in out[3:8]]


# ------------------------------------------------------------------- #
# the causal conv stem
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("bias", [True, False])
def test_causal_conv_and_its_update_match_reference(bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32) if bias else None
    tb = None if b is None else torch.from_numpy(b)
    jb = None if b is None else jnp.asarray(b)
    got = tlayers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), tb)
    want = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jb)
    assert _rel(got.numpy(), _np(want)) <= 1e-6
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    ts, ty = tlayers.conv_update(torch.from_numpy(state),
                                 torch.from_numpy(x[:, 0]),
                                 torch.from_numpy(w), tb)
    js, jy = jlayers.conv_update(jnp.asarray(state), jnp.asarray(x[:, 0]),
                                 jnp.asarray(w), jb)
    assert np.array_equal(ts.numpy(), _np(js))
    assert _rel(ty.numpy(), _np(jy)) <= 1e-6
    # stepping the update over the sequence from a zero state is the conv
    s = torch.zeros((2, 3, 24))
    outs = []
    for t in range(x.shape[1]):
        s, y = tlayers.conv_update(s, torch.from_numpy(x[:, t]),
                                   torch.from_numpy(w), tb)
        outs.append(y)
    assert _rel(torch.stack(outs, 1).numpy(), got.numpy()) <= 1e-6


# ------------------------------------------------------------------- #
# the chunked scans: against the reference and their own recurrence
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("L,chunk", SCAN_CASES)
def test_ssd_chunked_matches_reference(L, chunk):
    ops = _ssd_operands(L)
    y, s = tssm.ssd_chunked(*map(torch.from_numpy, ops), chunk)
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, ops), chunk)
    assert y.shape == (2, L) + ops[0].shape[2:] and y.dtype == torch.float32
    assert _rel(y.numpy(), _np(jy)) <= 1e-5
    assert _rel(s.numpy(), _np(js)) <= 1e-5


@pytest.mark.parametrize("L,chunk", SCAN_CASES)
def test_ssd_chunked_matches_its_recurrence(L, chunk):
    ops = list(map(torch.from_numpy, _ssd_operands(L, seed=2)))
    y, s = tssm.ssd_chunked(*ops, chunk)
    y_rec, s_rec = tssm.ssd_recurrence(*ops)
    assert _rel(y.numpy(), y_rec.numpy()) <= 1e-5
    assert _rel(s.numpy(), s_rec.numpy()) <= 1e-5


@pytest.mark.parametrize("L,chunk", SCAN_CASES)
def test_mlstm_cell_chunked_matches_reference(L, chunk):
    ops = _mlstm_operands(L)
    h, state = txlstm.mlstm_cell_chunked(*map(torch.from_numpy, ops), None,
                                         chunk)
    jh, jstate = jxlstm.mlstm_cell_chunked(*map(jnp.asarray, ops), None,
                                           chunk)
    assert _rel(h.numpy(), _np(jh)) <= 1e-5
    for got, want in zip(state, jstate):
        assert _rel(got.numpy(), _np(want)) <= 1e-5


@pytest.mark.parametrize("L,chunk", SCAN_CASES)
def test_mlstm_cell_chunked_matches_its_recurrence(L, chunk):
    ops = list(map(torch.from_numpy, _mlstm_operands(L, seed=3)))
    h, state = txlstm.mlstm_cell_chunked(*ops, None, chunk)
    h_rec, state_rec = txlstm.mlstm_recurrence(*ops)
    assert _rel(h.numpy(), h_rec.numpy()) <= 1e-5
    # C and n are stored scaled by exp(-m), and the two forms may take
    # another stabiliser m: compare them at the recurrence's
    C, n = txlstm.restabilise(state, state_rec[2])
    assert _rel(C.numpy(), state_rec[0].numpy()) <= 1e-5
    assert _rel(n.numpy(), state_rec[1].numpy()) <= 1e-5


def test_mlstm_cell_chunked_carries_a_state_as_the_reference():
    """A second segment continuing from the first's state."""
    ops = _mlstm_operands(64, seed=4)
    first, second = ([o[:, :32] for o in ops], [o[:, 32:] for o in ops])
    _, st = txlstm.mlstm_cell_chunked(*map(torch.from_numpy, first), None,
                                      16)
    _, jst = jxlstm.mlstm_cell_chunked(*map(jnp.asarray, first), None, 16)
    h, _ = txlstm.mlstm_cell_chunked(*map(torch.from_numpy, second), st, 16)
    jh, _ = jxlstm.mlstm_cell_chunked(*map(jnp.asarray, second), jst, 16)
    assert _rel(h.numpy(), _np(jh)) <= 1e-5


def test_slstm_scan_matches_reference():
    jcfg, jp, tcfg, tp = _setup(SSM)
    jl = jax.tree.map(lambda a: a[0], jp["stack"]["groups"]["slstm"])
    tl = ttf.layer_slice(tp["stack"]["groups"], 0)["slstm"]
    d = tcfg.d_model
    gx = np.random.default_rng(5).standard_normal((2, 24, 4 * d)).astype(
        np.float32)
    z = np.zeros((2, d), np.float32)
    carry = (z, z, z, np.full((2, d), txlstm.NEG, np.float32))
    hs, last = txlstm.slstm_scan(tl, tcfg, torch.from_numpy(gx),
                                 tuple(map(torch.from_numpy, carry)))
    jc, jhs = tuple(map(jnp.asarray, carry)), []
    for t in range(gx.shape[1]):
        jc = jxlstm._slstm_step(jl, jcfg, jc, jnp.asarray(gx[:, t]))
        jhs.append(jc[0])
    assert _rel(hs.numpy(), _np(jnp.stack(jhs, 1))) <= 1e-5
    for got, want in zip(last, jc):
        assert _rel(got.numpy(), _np(want)) <= 1e-5


@pytest.mark.parametrize("scan", ["ssd", "mlstm"])
def test_chunked_scans_refuse_lengths_the_reference_cannot_reshape(scan):
    """L = 513 at chunk 256 is 2 chunks of 256, which do not tile 513: the
    reference's reshape fails there (R13); the port raises, naming it."""
    L = 513
    with pytest.raises(ValueError, match="R13"):
        if scan == "ssd":
            tssm.ssd_chunked(*map(torch.from_numpy, _ssd_operands(L)), 256)
        else:
            txlstm.mlstm_cell_chunked(*map(torch.from_numpy,
                                           _mlstm_operands(L)), None, 256)
    for ok in (512, 1024, 1040):
        assert tssm.chunk_geometry(ok, 256)[0] * \
            tssm.chunk_geometry(ok, 256)[1] == ok


# ------------------------------------------------------------------- #
# prefill caches
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_prefill_cache_matches_reference(arch):
    jcfg, jp, tcfg, tp = _setup(arch)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 20),
                                             dtype=np.int32)
    _, cache = tmodel.prefill(tcfg, tp, {"tokens": toks})
    _, jcache = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    want = _keyed(jcache)
    got = dict(flatten_with_path(cache))
    assert set(got) == set(want)
    for k, v in got.items():
        w = want[k]
        assert str(v.dtype).split(".")[-1] == str(w.dtype), k
        assert tuple(v.shape) == w.shape, k
        tol = 1e-2 if v.dtype == torch.bfloat16 else 1e-5
        assert _rel(v.float().numpy(), w.astype(np.float32)) <= tol, k
    if arch == SSM:
        assert got["['mlstm']['C']"].dtype == torch.bfloat16
    # and the cache an Engine starts from has the reference's layout
    empty = dict(flatten_with_path(tmodel.init_cache(tcfg, 3, 16,
                                                     device="cpu")))
    jempty = _keyed(jmodel.init_cache(jcfg, 3, 16))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in empty.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jempty.items()}


# ------------------------------------------------------------------- #
# lane surgery on a nested cache
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_write_and_clear_slot_touch_one_lane_of_a_nested_cache(arch):
    _, _, tcfg, tp = _setup(arch)
    axes = tmodel.cache_axes(tcfg)
    cache = tmodel.init_cache(tcfg, 3, 16, device="cpu")
    for _, leaf in flatten_with_path(cache):
        leaf.fill_(5.0)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (1, 9),
                                             dtype=np.int32)
    _, one = tmodel.prefill(tcfg, tp, {"tokens": toks})
    out = kvcache.write_slot(cache, one, 1, axes)
    assert out is cache

    def lanes(tree, ax, path=""):
        for name, leaf in tree.items():
            a = ax[name] if isinstance(ax, dict) else ax
            if isinstance(leaf, dict):
                yield from lanes(leaf, a, f"{path}{name}.")
            else:
                yield path + name, leaf, a

    src = dict((n, (lf, a)) for n, lf, a in lanes(one, axes))
    for name, leaf, (lane, ring) in lanes(cache, axes):
        for b in (0, 2):
            assert bool((leaf.select(lane, b).float() == 5.0).all()), name
        got, want = leaf.select(lane, 1), src[name][0].select(lane, 0)
        if ring is not None:
            S = want.shape[ring - 1]
            assert bool((got.narrow(ring - 1, S, got.shape[ring - 1] - S)
                         .float() == 5.0).all()), name
            got = got.narrow(ring - 1, 0, S)
        assert torch.equal(got, want.to(got.dtype)), name
    kvcache.clear_slot(cache, 1, axes)
    for name, leaf, (lane, _) in lanes(cache, axes):
        assert bool((leaf.select(lane, 1) == 0).all()), name
        assert bool((leaf.select(lane, 0).float() == 5.0).all()), name
    # a leaf of the wrong shape is refused
    bad = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="one lane"):
        kvcache.write_slot(cache, bad, 0, axes)


# ------------------------------------------------------------------- #
# the Engine serves each request its own greedy tokens
# ------------------------------------------------------------------- #
def _reference_greedy(jcfg, jp, prompt, new, T=32):
    """The reference's per-request greedy decode: a B = 1 prefill, its
    attention rings grown to ``T`` slots, then ``decode_step``s."""
    step = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    logits, cache = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(
        [prompt], jnp.int32)})

    if "attn" in cache:        # the hybrid's shared-attention ring
        cache = dict(cache, attn=jax.tree.map(
            lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, T - x.shape[2])] +
                              [(0, 0)] * (x.ndim - 3)), cache["attn"]))
    toks = [int(jnp.argmax(logits[0]))]
    pos = len(prompt)
    while len(toks) < new:
        logits, cache = step(jp, cache, jnp.asarray([[toks[-1]]], jnp.int32),
                             jnp.int32(pos))
        toks.append(int(jnp.argmax(logits[0])))
        pos += 1
    return toks


@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_engine_tokens_equal_each_requests_own_greedy_decode(arch):
    """3 prompts × 6 tokens on 2 lanes (a lane is reused): every
    request's tokens are those of its own greedy decode in the
    reference (where the reference's own Engine differs: R12)."""
    jcfg, jp, tcfg, tp = _setup(arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,)).tolist()
               for n in (5, 9, 12)]
    eng = Engine(tcfg, tp, slots=2, cache_len=32)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    eng.run_until_drained()
    got = {st.request.uid: st.generated for st in eng.finished}
    want = {uid: _reference_greedy(jcfg, jp, p, 6)
            for uid, p in enumerate(prompts)}
    assert got == want


# ------------------------------------------------------------------- #
# compile_lm and checkpoints
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_compile_lm_refuses_the_state_space_families(arch):
    jcfg, jp, tcfg, tp = _setup(arch)
    with pytest.raises(NotImplementedError, match="dense"):
        jlm.compile_lm(jlm.TransformerParams(jcfg, jp))
    with pytest.raises(NotImplementedError, match="dense"):
        compile_lm(TransformerParams(tcfg, tp), device="cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        compile_lm(tcfg, device="cpu")


def test_hybrid_checkpoint_written_by_the_port_restores_in_the_reference(
        tmp_path):
    jcfg, jp, tcfg, tp = _setup(HYBRID)
    ts = tadamw.AdamW(lr=tadamw.constant_schedule(1e-3)).init(tp)._replace(
        step=torch.tensor(2, dtype=torch.int32))
    tckpt.save(str(tmp_path), 2, (tp, ts), pipeline_state={"seed": 0,
                                                            "step": 2})
    like = (jmodel.init_params(jcfg, jax.random.PRNGKey(9)),
            jadamw.AdamW(lr=jadamw.constant_schedule(1e-3)).init(jp))
    (rp, rs), manifest = jckpt.restore(str(tmp_path), 2, like)
    assert manifest["step"] == 2
    want = dict(flatten_with_path((tp, ts)))
    got = _keyed((rp, rs))
    assert set(got) == set(want)
    assert "[0]['stack']['groups']['mamba']['A_log']" in got
    assert "[0]['stack']['shared']['attn']['wq']" in got
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k].numpy())


def test_hybrid_checkpoint_written_by_the_reference_restores_in_the_port(
        tmp_path):
    jcfg, jp, tcfg, tp = _setup(HYBRID)
    js = jadamw.AdamW(lr=jadamw.constant_schedule(1e-3)).init(jp)._replace(
        step=jnp.asarray(5, jnp.int32))
    jckpt.save(str(tmp_path), 5, (jp, js), pipeline_state={"seed": 1,
                                                            "step": 5})
    like = (tmodel.init_params(tcfg, 3, device="cpu"),
            tadamw.AdamW(lr=tadamw.constant_schedule(1e-3)).init(tp))
    (rp, rs), manifest = tckpt.restore(str(tmp_path), 5, like)
    assert manifest["pipeline"] == {"seed": 1, "step": 5}
    want = _keyed((jp, js))
    got = dict(flatten_with_path((rp, rs)))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k])
