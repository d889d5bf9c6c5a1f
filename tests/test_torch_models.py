"""The port's dense transformer (``repro_torch.models``, ``configs`` and
``serving.kvcache``) against the reference's ``repro.models``, on the CPU.

The reference's parameter tree is handed across as numpy
(``params_from_numpy``: the same keys and layouts); token ids come from
``np.random.default_rng``. Bounds:

  * f32 compute: prefill and decode logits and caches within rel ≤ 1e-6
    (max |diff| / max |ref|) — the same arithmetic in the same dtypes,
    summed in another order (about 2e-7 measured);
  * the int8 KV cache: its codes come from ``round(x / scale)``, so an
    ulp of difference in x can move a value sitting on a rounding
    boundary by one code. Codes may differ by at most one, on at most
    one in a thousand entries; the scales, the prefill logits and a
    decode from the reference's own cache keep rel ≤ 1e-6 wherever the
    new codes agree, and one code step (1/127 of a row's largest value)
    bounds the rest;
  * bf16 compute: rel ≤ 3e-2 on logits and caches — each bf16 rounding
    is worth up to 2^-8 = 3.9e-3 relative, and the two packages round
    the same values at the same places but from f32 partial sums taken
    in another order, so a rounding can land one bf16 step apart; three
    layers and the head compound a few such steps (5e-3 measured);
  * slot surgery, ring positions and parameter counts: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import qwen1p5_0p5b as jqwen
from repro.models import attention as jattn
from repro.models import model as jmodel

import repro_torch.configs as tconfigs
from repro_torch.configs import qwen1p5_0p5b as tqwen
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.serving import kvcache

torch.set_num_threads(1)

VARIANTS = {
    "qwen": {},
    # gemma-style knobs: gelu, both softcaps, alternating sliding
    # windows shorter than the prompt, post-norms, embed scale, an
    # untied head
    "gelu_softcap_window": dict(act="gelu", attn_softcap=30.0,
                                final_softcap=20.0, sliding_window=4,
                                local_global=True, post_block_norm=True,
                                scale_embed=True, tie_embeddings=False),
    # grouped-query attention with replicated KV heads
    "gqa_kv_repeat": dict(num_kv_heads=2, kv_repeat=2),
}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy()


def _pair(dtype="float32", **kw):
    jcfg = jqwen.reduced().replace(compute_dtype=dtype, **kw)
    tcfg = tqwen.reduced().replace(compute_dtype=dtype, **kw)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmodel.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape)


def _cache_rel(tc, jc):
    assert set(tc) == set(jc)
    return max(_rel(_t(tc[k]), _np(jc[k])) for k in jc)


# ------------------------------------------------------------------- #
# configs
# ------------------------------------------------------------------- #
def test_qwen_config_equals_the_reference():
    for t, j in ((tqwen.CONFIG, jqwen.CONFIG),
                 (tqwen.reduced(), jqwen.reduced()),
                 (tqwen.reduced_serving(), jqwen.reduced_serving())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.padded_vocab, t.q_per_kv) == (j.padded_vocab, j.q_per_kv)
    assert tqwen.CONFIG.padded_vocab == 152_064
    assert tconfigs.get_config("qwen1.5-0.5b") == tqwen.CONFIG
    assert tconfigs.get_reduced("qwen1.5-0.5b") == tqwen.reduced()
    assert [s.name for s in tconfigs.SHAPES] == \
        [s.name for s in jconfigs.SHAPES]
    for shape in tconfigs.SHAPES:
        js = jconfigs.SHAPES_BY_NAME[shape.name]
        assert tconfigs.applicable(tqwen.CONFIG, shape) == \
            jconfigs.applicable(jqwen.CONFIG, js)


def test_registry_names_the_queue_item_for_unported_archs():
    """Every architecture of the reference is ported: the registry
    refuses only ids it does not know, and ``get_stack`` only families
    it does not know."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("zamba3-9b")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_reduced("no-such-arch")
    with pytest.raises(ValueError, match="unknown family"):
        ttf.get_stack(tqwen.reduced().replace(family="rwkv"))


@pytest.mark.parametrize("cfg_kw", [{}, {"tie_embeddings": False},
                                    {"post_block_norm": True,
                                     "qkv_bias": False},
                                    {"num_kv_heads": 2}])
def test_param_count_equals_the_reference(cfg_kw):
    for j, t in ((jqwen.CONFIG, tqwen.CONFIG),
                 (jqwen.reduced(), tqwen.reduced())):
        jc, tc = j.replace(**cfg_kw), t.replace(**cfg_kw)
        assert tc.param_count() == jc.param_count()
        assert tmodel.count_nonembedding_params(tc) == \
            jmodel.count_nonembedding_params(jc)
    assert tqwen.CONFIG.param_count() == 464_118_784


def test_init_layout_and_determinism():
    jcfg, jp, tcfg, _ = _pair()
    a = tmodel.init_params(tcfg, 0, device="cpu")
    b = tmodel.init_params(tcfg, 0, device="cpu")
    c = tmodel.init_params(tcfg, 1, device="cpu")
    ja = jax.tree.leaves(jp)
    ta = jax.tree.leaves(jax.tree.map(np.asarray, a,
                                      is_leaf=torch.is_tensor))
    assert [np.shape(x) for x in ta] == [np.shape(x) for x in ja]
    flat = torch.utils._pytree.tree_leaves
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["stack"]["attn"]["wq"],
                           c["stack"]["attn"]["wq"])
    # truncated at ±2 σ: σ = 1 for the table, 1/sqrt(fan_in) for weights
    assert float(a["embed"]["table"].abs().max()) <= 2.0
    assert float(a["stack"]["mlp"]["w2"].abs().max()) <= \
        2.0 / np.sqrt(tcfg.d_ff) + 1e-7
    assert float(a["stack"]["attn"]["wq"].std()) == pytest.approx(
        0.88 / np.sqrt(tcfg.d_model), rel=0.1)


# ------------------------------------------------------------------- #
# prefill / decode against the reference
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("per_slot", [True, False],
                         ids=["per_slot", "lockstep"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(variant, per_slot):
    """Prefill, then three decode steps from the prefill cache (a ring of
    S = 9 slots): per-slot lanes at different positions, or lockstep.
    Positions 9.. wrap the ring, overwriting the oldest slots."""
    jcfg, jp, tcfg, tp = _pair(decode_per_slot=per_slot,
                               **VARIANTS[variant])
    toks = _tokens(1, (2, 9))
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tcfg, tp, {"tokens": toks})
    assert tl.dtype == torch.float32 and tl.shape == (2, 512)
    assert _rel(_t(tl), _np(jl)) <= 1e-6
    assert _cache_rel(tc, jc) <= 1e-6
    t_in = {k: v.clone() for k, v in tc.items()}
    for i in range(3):
        step = _tokens(10 + i, (2, 1))
        pos = np.asarray([9 + i, 11 + i] if per_slot else 9 + i, np.int32)
        jl, jc = jmodel.decode_step(jcfg, jp, jc, jnp.asarray(step),
                                    jnp.asarray(pos))
        tl, tc_new = tmodel.decode_step(tcfg, tp, tc, step, pos)
        assert _rel(_t(tl), _np(jl)) <= 1e-6
        assert _cache_rel(tc_new, jc) <= 1e-6
        if i == 0:
            # the functional contract: the input cache is untouched
            assert all(torch.equal(tc[k], t_in[k]) for k in tc)
        tc = tc_new


def test_int8_kv_cache_matches_reference():
    jcfg, jp, tcfg, tp = _pair(decode_per_slot=True, kv_cache_dtype="int8")
    toks = _tokens(2, (2, 9))
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tcfg, tp, {"tokens": toks})
    assert _rel(_t(tl), _np(jl)) <= 1e-6
    assert tc["k"].dtype == torch.int8 and tc["ks"].dtype == torch.float32

    def codes_close(t, j):
        d = np.abs(t.numpy().astype(np.int32) -
                   np.asarray(j).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        return bool((d == 0).all())

    for k in ("k", "v"):
        codes_close(tc[k], jc[k])
        assert _rel(_t(tc[k + "s"]), _np(jc[k + "s"])) <= 1e-6
    # a decode from the reference's own cache: the same stored codes
    handed = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    step, pos = _tokens(3, (2, 1)), np.asarray([9, 12], np.int32)
    jl2, jc2 = jmodel.decode_step(jcfg, jp, jc, jnp.asarray(step),
                                  jnp.asarray(pos))
    tl2, tc2 = tmodel.decode_step(tcfg, tp, handed, step, pos)
    same = all([codes_close(tc2[k], jc2[k]) for k in ("k", "v")])
    assert _rel(_t(tl2), _np(jl2)) <= (1e-6 if same else 1.0 / 127)


@pytest.mark.parametrize("kv_cache_dtype", ["bfloat16", "int8"])
def test_bf16_compute_path_matches_reference(kv_cache_dtype):
    """The dense model's default bf16 compute (``CONFIG`` computes in
    bf16), a bf16 or int8 decode cache written through ``write_slot``."""
    jcfg, jp, tcfg, tp = _pair("bfloat16", decode_per_slot=True,
                               kv_cache_dtype=kv_cache_dtype)
    toks = _tokens(4, (1, 7))
    jl, jc1 = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc1 = tmodel.prefill(tcfg, tp, {"tokens": toks})
    assert _rel(_t(tl), _np(jl)) <= 3e-2
    if kv_cache_dtype == "bfloat16":
        assert tc1["k"].dtype == torch.bfloat16
        assert _cache_rel(tc1, jc1) <= 3e-2
    from repro.serving import kvcache as jkv
    jcache = jkv.write_slot(jmodel.init_cache(jcfg, 2, 16), jc1,
                            jnp.int32(1))
    tcache = kvcache.write_slot(
        tmodel.init_cache(tcfg, 2, 16, device="cpu"), tc1, 1)
    assert tcache["k"].dtype == (torch.bfloat16 if kv_cache_dtype ==
                                 "bfloat16" else torch.int8)
    step, pos = np.asarray([[5], [6]]), np.asarray([3, 7], np.int32)
    jl2, _ = jmodel.decode_step(jcfg, jp, jcache, jnp.asarray(step),
                                jnp.asarray(pos))
    tl2, _ = tmodel.decode_step(tcfg, tp, tcache, step, pos)
    assert _rel(_t(tl2), _np(jl2)) <= 3e-2


def test_decode_reads_a_bf16_cache_beside_f32_queries():
    """The serving shape: f32 compute, the bf16 cache ``init_cache``
    defaults to, filled by ``write_slot`` (round to nearest even)."""
    jcfg, jp, tcfg, tp = _pair(decode_per_slot=True)
    toks = _tokens(5, (1, 6))
    _, jc1 = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _, tc1 = tmodel.prefill(tcfg, tp, {"tokens": toks})
    from repro.serving import kvcache as jkv
    jcache = jkv.write_slot(jmodel.init_cache(jcfg, 3, 16), jc1,
                            jnp.int32(2))
    tcache = kvcache.write_slot(
        tmodel.init_cache(tcfg, 3, 16, device="cpu"), tc1, 2)
    assert tcache["k"].dtype == torch.bfloat16
    # the stored bf16 values agree up to one bf16 step of a rounding
    # that an ulp of f32 moved
    assert _cache_rel(tcache, jcache) <= 2 ** -7
    step, pos = np.asarray([[5], [6], [7]]), np.asarray([0, 0, 6], np.int32)
    jl, jc = jmodel.decode_step(jcfg, jp, jcache, jnp.asarray(step),
                                jnp.asarray(pos))
    handed = {k: torch.tensor(_np(v)).to(torch.bfloat16)
              for k, v in jcache.items()}
    tl, tc = tmodel.decode_step(tcfg, tp, handed, step, pos)
    assert _rel(_t(tl), _np(jl)) <= 1e-6
    assert _cache_rel(tc, jc) <= 2 ** -7


def test_prompt_longer_than_the_ring():
    """A direct ``attn_apply`` prefill with a Python-int window shorter
    than the prompt keeps the last T positions, each at slot p % T;
    decodes continue on that ring."""
    jcfg = jqwen.reduced().replace(compute_dtype="float32",
                                   sliding_window=4, decode_per_slot=True)
    tcfg = tqwen.reduced().replace(compute_dtype="float32",
                                   sliding_window=4, decode_per_slot=True)
    jp = jattn.attn_init(jax.random.PRNGKey(1), jcfg)
    jp = {k: v + 0.1 * (i + 1) if k.startswith("b") else v
          for i, (k, v) in enumerate(jp.items())}
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(6).normal(size=(2, 7, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    jo, jc = jattn.attn_apply(jp, jcfg, jnp.asarray(x),
                              positions=jnp.asarray(pos), mode="prefill",
                              window=4)
    to, tc = tattn.attn_apply(tp, tcfg, torch.from_numpy(x),
                              positions=torch.from_numpy(pos.copy()),
                              mode="prefill", window=4)
    assert tc["k"].shape[1] == 4
    assert _rel(to.numpy(), _np(jo)) <= 1e-6
    assert _cache_rel(tc, jc) <= 1e-6
    for step in range(2):
        xs = np.random.default_rng(7 + step).normal(
            size=(2, 1, 64)).astype(np.float32)
        p = np.asarray([[7 + step], [9 + step]], np.int32)
        jo, jc = jattn.attn_apply(jp, jcfg, jnp.asarray(xs),
                                  positions=jnp.asarray(p), mode="decode",
                                  cache=jc, window=4)
        to, tc = tattn.attn_apply(tp, tcfg, torch.from_numpy(xs),
                                  positions=torch.from_numpy(p),
                                  mode="decode", cache=tc, window=4)
        assert _rel(to.numpy(), _np(jo)) <= 1e-6
        assert _cache_rel(tc, jc) <= 1e-6


def test_chunked_attention_equals_one_block():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 2, 4)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)[None, :]
    whole = tattn.attend(q, k, v, pos, pos, scale=0.5)
    chunked = tattn.attend(q, k, v, pos, pos, scale=0.5, q_chunk=4)
    assert _rel(chunked.numpy(), whole.numpy()) <= 1e-6
    jw = jattn.attend(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                      jnp.asarray(v.numpy()), jnp.asarray(pos.numpy()),
                      jnp.asarray(pos.numpy()), scale=0.5, q_chunk=4)
    assert _rel(chunked.numpy(), _np(jw)) <= 1e-6


# ------------------------------------------------------------------- #
# ring positions, ring store and slot surgery
# ------------------------------------------------------------------- #
def test_ring_positions_and_store_match_reference():
    T = 8
    for p in (3, 10, 17):
        got = tattn._ring_positions(torch.tensor(p, dtype=torch.int32), T)
        assert got.tolist() == \
            [int(v) for v in jattn._ring_positions(jnp.int32(p), T)]
    lanes = torch.tensor([3, 10], dtype=torch.int32)
    assert tattn._ring_positions(lanes, T).tolist() == [
        [0, 1, 2, 3, -4, -3, -2, -1], [8, 9, 10, 3, 4, 5, 6, 7]]
    k = np.arange(6, dtype=np.float32).reshape(1, 6, 1, 1)
    for cache_len in (4, 6, 9):
        assert np.array_equal(
            tattn._store_prefill(cache_len, torch.from_numpy(k)).numpy(),
            np.asarray(jattn._store_prefill(cache_len, jnp.asarray(k))))
    s = k[..., 0]
    assert np.array_equal(tattn._store_prefill(4, torch.from_numpy(s)).numpy(),
                          np.asarray(jattn._store_prefill_scale(
                              4, jnp.asarray(s))))


def _cache_tree(L=2, B=3, T=8, KH=2, dh=4, dtype=torch.bfloat16):
    """leaf[l, b] is filled with 10*l + b so lane provenance survives."""
    def leaf(shape):
        a = torch.zeros(shape, dtype=torch.float32)
        for l in range(L):
            for b in range(B):
                a[l, b] = 10 * l + b
        return a.to(dtype)

    return {"k": leaf((L, B, T, KH, dh)), "v": leaf((L, B, T, KH, dh)),
            "ks": leaf((L, B, T, KH))}


def test_write_slot_copies_one_lane_casts_and_pads():
    cache = _cache_tree()
    S = 5
    src = {k: torch.full((v.shape[0], 1, S) + tuple(v.shape[3:]), 7.0)
           for k, v in cache.items()}
    out = kvcache.write_slot(cache, src, 1)
    assert out is cache
    for name, leaf in out.items():
        assert leaf.dtype == torch.bfloat16           # cast, not promoted
        got = leaf.float()
        assert bool((got[:, 1, :S] == 7.0).all()), name
        for l in range(got.shape[0]):
            assert bool((got[l, 1, S:] == 10 * l + 1).all()), name
            for b in (0, 2):
                assert bool((got[l, b] == 10 * l + b).all()), name
    with pytest.raises(ValueError, match="one lane"):
        kvcache.write_slot(cache, {k: torch.zeros(
            (v.shape[0], 1, 9) + tuple(v.shape[3:])) for k, v in
            cache.items()}, 0)


def test_clear_slot_and_chain_match_reference():
    from repro.serving import kvcache as jkv

    out = kvcache.clear_slot(_cache_tree(), 2)
    for leaf in out.values():
        got = leaf.float()
        assert bool((got[:, 2] == 0.0).all())
        for l in range(got.shape[0]):
            for b in (0, 1):
                assert bool((got[l, b] == 10 * l + b).all())
    # the admit/retire chain, against the reference's
    cache = _cache_tree()
    jcache = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
              for k, v in cache.items()}
    S = cache["k"].shape[2]
    for slot in range(3):
        src = {k: torch.full((v.shape[0], 1, S) + tuple(v.shape[3:]),
                             float(slot) + 1.3) for k, v in cache.items()}
        cache = kvcache.write_slot(cache, src, slot)
        jcache = jkv.write_slot(jcache, {k: jnp.asarray(v.numpy())
                                         for k, v in src.items()},
                                jnp.int32(slot))
    cache = kvcache.clear_slot(cache, 1)
    jcache = jkv.clear_slot(jcache, jnp.int32(1))
    for k in cache:
        assert np.array_equal(cache[k].float().numpy(), _np(jcache[k]))
