"""The port's other architectures (``repro_torch.configs`` deepseek,
granite, gemma2, internvl2, musicgen, moonshot, dbrx, and the hybrid
zamba2 and ssm xlstm), the MoE stack
(``repro_torch.models.moe``), the frontend stubs and a gemma2
``compile_lm``, against the reference on the CPU.

Each arch runs at its ``reduced()`` width with ``compute_dtype=
"float32"`` on both sides. The reference's parameter tree is handed
across as numpy (``params_from_numpy``); tokens, labels and stand-in
embeddings come from ``np.random.default_rng`` (the port's stubs draw
from a ``torch.Generator``, which cannot replay ``jax.random``).
Bounds, max |diff| / max |ref|:

  * configs, parameter counts, expert ids and kept slots: exact;
  * hidden states and losses rel ≤ 1e-5, each gradient leaf rel ≤ 1e-4
    (the same arithmetic summed in another order: ~1e-6 measured);
  * the router's ``aux_loss`` and ``drop_frac`` rel ≤ 1e-6, the MoE
    output rel ≤ 1e-5;
  * prefill/decode consistency: the reference test's bound, rel < 0.02
    (~1e-6 measured in f32);
  * the gemma2 ``compile_lm``: mapped against dense rel ≤ 1e-5, and
    against the reference's ``compile_lm`` rel ≤ 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import lm as jlm
from repro.models import model as jmodel
from repro.models import moe as jmoe

import repro_torch.configs as tconfigs
from repro_torch.lm import LM_LINEARS, TransformerParams, compile_lm
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import stubs
from repro_torch.models import transformer as ttf
from repro_torch.pytree import flatten_with_path

torch.set_num_threads(1)

ARCHS = ["deepseek-7b", "granite-3-8b", "gemma2-9b", "internvl2-26b",
         "musicgen-large", "moonshot-v1-16b-a3b", "dbrx-132b", "zamba2-1.2b",
         "xlstm-350m"]
STACKS = {"dense": ttf.DenseStack, "vlm": ttf.DenseStack,
          "audio": ttf.DenseStack, "moe": ttf.MoEStack,
          "hybrid": ttf.HybridStack, "ssm": ttf.XLSTMStack}
MOE_ARCHS = ["moonshot-v1-16b-a3b", "dbrx-132b"]
B, S = 2, 32


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jcfg, jax params, tcfg, port params, numpy batch) at the
    reduced width in f32, one init an arch for the whole module."""
    jcfg = jconfigs.get_reduced(arch).replace(compute_dtype="float32")
    tcfg = tconfigs.get_reduced(arch).replace(compute_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmodel.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if jcfg.frontend != "none":
        batch["embeds"] = (rng.standard_normal((B, S, jcfg.d_model)) *
                           0.02).astype(np.float32)
    return jcfg, jp, tcfg, tp, batch


def grow_rings(cfg, cache, extra: int):
    """The cache with each attention ring (``cache_axes``' ring axis)
    grown by ``extra`` zero slots; recurrent states pass through, as
    the reference test's ``_grow_ring`` passes them."""
    def grow(c, axes):
        if isinstance(c, dict):
            return {k: grow(v, axes[k] if isinstance(axes, dict) else axes)
                    for k, v in c.items()}
        ring = axes[1]
        if ring is None:
            return c
        return torch.nn.functional.pad(
            c, [0, 0] * (c.dim() - 1 - ring) + [0, extra])
    return grow(cache, tmodel.cache_axes(cfg))


def _train_batch(cfg, batch, lib):
    """The modality's train batch: embeds for a stub frontend, else
    tokens; ``lib`` turns numpy into the package's arrays."""
    key = "embeds" if cfg.frontend != "none" else "tokens"
    return {key: lib(batch[key]), "labels": lib(batch["labels"])}


# ------------------------------------------------------------------- #
# configs and the registry
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch):
    for t, j in ((tconfigs.get_config(arch), jconfigs.get_config(arch)),
                 (tconfigs.get_reduced(arch), jconfigs.get_reduced(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.padded_vocab, t.q_per_kv) == (j.padded_vocab, j.q_per_kv)
    cfg = tconfigs.get_config(arch)
    assert cfg.name == arch and cfg.padded_vocab % 512 == 0
    assert ttf.get_stack(cfg) is STACKS[cfg.family]


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch):
    for t, j in ((tconfigs.get_config(arch), jconfigs.get_config(arch)),
                 (tconfigs.get_reduced(arch), jconfigs.get_reduced(arch))):
        for active in (False, True):
            assert tmodel.count_params(t, active) == \
                jmodel.count_params(j, active)
            assert tmodel.count_nonembedding_params(t, active) == \
                jmodel.count_nonembedding_params(j, active)
    # and the count is that of the leaves init_params makes
    _, _, tcfg, tp, _ = _setup(arch)
    assert sum(v.numel() for _, v in flatten_with_path(tp)) == \
        tmodel.count_params(tcfg)


# ------------------------------------------------------------------- #
# forward, loss and gradients against the reference
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    jcfg, jp, tcfg, tp, batch = _setup(arch)
    jb = _train_batch(jcfg, batch, jnp.asarray)
    tb = _train_batch(tcfg, batch, torch.from_numpy)
    jh, _, jaux = jmodel.forward(jcfg, jp, jb, mode="train")
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)

    live = jax.tree.map(lambda x: x.clone().requires_grad_(True), tp,
                        is_leaf=torch.is_tensor)
    th, _, taux = tmodel.forward(tcfg, live, tb, mode="train")
    assert th.shape == (B, S, tcfg.d_model)
    assert _rel(th.detach().numpy(), _np(jh)) <= 1e-5
    tloss, tmet = tmodel.loss_fn(tcfg, live, tb)
    tloss.backward()
    assert _rel(tloss.detach().numpy(), _np(jloss)) <= 1e-5
    assert set(tmet) == set(jmet)
    if tcfg.family == "moe":
        assert set(taux) == {"aux_loss", "drop_frac"}
        for k in ("moe_aux", "moe_drop"):
            assert _rel(tmet[k].detach().numpy(), _np(jmet[k])) <= 1e-6, k
        assert float(tmet["moe_aux"].detach()) > 0
    else:
        assert taux == {}
    want = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    want = {jax.tree_util.keystr(k): v for k, v in want.items()}
    gnorm = 0.0
    for path, leaf in flatten_with_path(live):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        assert _rel(g.numpy(), _np(want[path])) <= 1e-4, path
        gnorm += float(g.double().square().sum())
    assert np.isfinite(gnorm) and gnorm > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """A decode after an (S-1)-token prefill (the ring grown by one
    slot, as the reference test does) reproduces the S-token prefill's
    last logits; the prefill equals the reference's. The stub-frontend
    archs keep their embedding table and decode from tokens here (the
    reference's test skips them)."""
    jcfg, jp, tcfg, tp, batch = _setup(arch)
    toks = batch["tokens"]
    full, _ = tmodel.prefill(tcfg, tp, {"tokens": toks})
    jfull, _ = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert _rel(full.numpy(), _np(jfull)) <= 1e-5
    _, cache = tmodel.prefill(tcfg, tp, {"tokens": toks[:, :S - 1]})
    dec, _ = tmodel.decode_step(tcfg, tp, grow_rings(tcfg, cache, 1),
                                toks[:, S - 1:],
                                np.int32(S - 1))
    assert torch.isfinite(dec).all()
    assert _rel(dec.numpy(), full.numpy()) < 0.02


# ------------------------------------------------------------------- #
# the MoE layer: routing, dispatch, drops and the grouped path
# ------------------------------------------------------------------- #
def _reference_routing(jp, cfg, xt):
    """The reference ``_moe_tokens``'s routing and dispatch steps, run in
    jax (the reference computes them inside ``_moe_tokens`` and returns
    only y and aux): expert ids (T, K) and the (E, C) slot ids with
    their validity."""
    E, K = cfg.num_experts, cfg.top_k
    C = jmoe.capacity(xt.shape[0], cfg)
    logits = jnp.einsum("td,de->te", xt, jp["router"],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = jax.lax.top_k(probs, K)
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ar = jnp.arange(E, dtype=sorted_e.dtype)
    starts = jnp.searchsorted(sorted_e, ar, side="left")
    counts = jnp.searchsorted(sorted_e, ar, side="right") - starts
    slot = starts[:, None] + jnp.arange(C, dtype=jnp.int32)[None, :]
    valid = jnp.arange(C, dtype=jnp.int32)[None, :] < counts[:, None]
    flat_slot = jnp.take(order, jnp.where(valid, slot, 0).reshape(-1))
    return (np.asarray(ids), np.asarray(flat_slot).reshape(E, C),
            np.asarray(valid), np.asarray(probs))


def _moe_inputs(arch, T, cf):
    jcfg, jp, tcfg, tp, _ = _setup(arch)
    jcfg = jcfg.replace(capacity_factor=cf)
    tcfg = tcfg.replace(capacity_factor=cf)
    jl = jax.tree.map(lambda a: a[0], jp["stack"]["mlp"])
    tl = ttf.layer_slice(tp["stack"]["mlp"], 0)
    x = np.random.default_rng(T).standard_normal(
        (T, jcfg.d_model)).astype(np.float32)
    return jcfg, jl, tcfg, tl, x


def _min_gap(probs, K):
    top = np.sort(probs, axis=-1)[..., ::-1]
    return float(np.min(top[..., K - 1] - top[..., K]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["drops", "drop_free"])
def test_moe_tokens_matches_reference(arch, cf):
    """``_moe_tokens`` on 96 tokens of one layer: at capacity factor 1
    overflow assignments are dropped (in token order), at 8 none is.
    The same expert ids and kept (token, choice) slots, aux_loss and
    drop_frac at rel ≤ 1e-6, y at rel ≤ 1e-5."""
    jcfg, jl, tcfg, tl, x = _moe_inputs(arch, 96, cf)
    ids, flat_slot, valid, probs = _reference_routing(jl, jcfg,
                                                      jnp.asarray(x))
    gap = _min_gap(probs, jcfg.top_k)
    print(f"{arch} cf {cf}: smallest k-th/(k+1)-th router gap {gap:.3g}")
    assert gap > 1e-6        # top-k is decided, not a tie
    xt = torch.from_numpy(x)
    _, _, t_ids = tmoe.route(tl, tcfg, xt)
    t_slot, t_valid = tmoe.dispatch(t_ids, tcfg.num_experts,
                                    tmoe.capacity(96, tcfg))
    assert np.array_equal(t_ids.numpy(), ids)
    assert np.array_equal(t_valid.numpy(), valid)
    assert np.array_equal(np.where(valid, t_slot.numpy(), -1),
                          np.where(valid, flat_slot, -1))
    jy, jaux = jmoe._moe_tokens(jl, jcfg, jnp.asarray(x), constrain=False)
    ty, taux = tmoe._moe_tokens(tl, tcfg, xt)
    assert _rel(ty.numpy(), _np(jy)) <= 1e-5
    for k in ("aux_loss", "drop_frac"):
        assert _rel(taux[k].numpy(), _np(jaux[k])) <= 1e-6, k
    dropped = float(taux["drop_frac"])
    assert (dropped > 0) if cf == 1.0 else dropped == 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grouped_path_matches_reference(arch):
    """``moe_apply`` with ``moe_groups = 2`` (GShard's G axis, taken
    because 2 × 48 tokens divide by 2) at a capacity factor that drops,
    shared experts included; and the same tokens with 3 groups, which
    do not divide 2 × 47 tokens, fall back to one group."""
    jcfg, jl, tcfg, tl, x = _moe_inputs(arch, 96, 1.0)
    for groups, shape in ((2, (2, 48)), (3, (2, 47))):
        jc = jcfg.replace(moe_groups=groups)
        tc = tcfg.replace(moe_groups=groups)
        xs = x[:shape[0] * shape[1]].reshape(*shape, -1)
        jy, jaux = jmoe.moe_apply(jl, jc, jnp.asarray(xs))
        ty, taux = tmoe.moe_apply(tl, tc, torch.from_numpy(xs))
        assert _rel(ty.numpy(), _np(jy)) <= 1e-5
        for k in ("aux_loss", "drop_frac"):
            assert _rel(taux[k].numpy(), _np(jaux[k])) <= 1e-6, (groups, k)
        if groups == 2:
            assert float(taux["drop_frac"]) > 0
            xg = torch.from_numpy(xs.reshape(2, 48, -1))
            _, _, g_ids = tmoe.route(tl, tc, xg)
            for g in range(2):
                ids, _, _, probs = _reference_routing(jl, jc,
                                                      jnp.asarray(xs[g]))
                gap = _min_gap(probs, jc.top_k)
                print(f"{arch} group {g}: smallest router gap {gap:.3g}")
                assert gap > 1e-6
                assert np.array_equal(g_ids[g].numpy(), ids)


def test_moe_capacity_rounds_as_the_reference():
    cfg = tconfigs.get_config("moonshot-v1-16b-a3b")
    jcfg = jconfigs.get_config("moonshot-v1-16b-a3b")
    for tokens in (1, 4, 48, 100, 4096, 4097, 65536):
        for cf in (1.0, 1.25, 2.5, 64 / 6):
            assert tmoe.capacity(tokens, cfg.replace(capacity_factor=cf)) \
                == jmoe.capacity(tokens, jcfg.replace(capacity_factor=cf))


def test_moe_top_k_keeps_the_lower_index_on_ties():
    """Tied router probabilities: the lower expert index comes first, as
    ``jax.lax.top_k`` returns it."""
    cfg = tconfigs.get_reduced("dbrx-132b")
    p = {"router": torch.zeros((cfg.d_model, cfg.num_experts))}
    _, gates, ids = tmoe.route(p, cfg, torch.ones((3, cfg.d_model)))
    assert ids.tolist() == [[0, 1]] * 3
    assert torch.equal(gates, torch.full((3, 2), 0.5))


def test_moe_stack_init_layout_and_aux_sums_over_layers():
    arch = "moonshot-v1-16b-a3b"
    jcfg, jp, tcfg, tp, batch = _setup(arch)
    a = tmodel.init_params(tcfg, 0, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in flatten_with_path(a)}
    assert shapes == {k: tuple(v.shape) for k, v in flatten_with_path(tp)}
    assert shapes["['stack']['mlp']['w1']"] == (3, 8, 64, 32)
    assert shapes["['stack']['mlp']['shared']['w2']"] == (3, 32, 64)
    # summed over the layers: the stack's aux is the sum of each
    # layer's own
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 16, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(16, dtype=torch.int32)[None, :]
    _, _, aux = ttf.MoEStack.apply(tp["stack"], tcfg, h, positions=pos,
                                   mode="prefill")
    want, hl = 0.0, h
    for layer in range(tcfg.num_layers):
        hl, _, a_l = ttf._block_apply(
            ttf.layer_slice(tp["stack"], layer), tcfg, hl, positions=pos,
            mode="prefill", cache=None, window=torch.tensor(0),
            use_moe=True)
        want += float(a_l["aux_loss"])
    assert float(aux["aux_loss"]) == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------------- #
# frontend stubs
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-large",
                                  "deepseek-7b"])
def test_make_batch_modality_and_determinism(arch):
    cfg = tconfigs.get_reduced(arch)
    b = stubs.make_batch(cfg, 0, 2, 8, device="cpu")
    again = stubs.make_batch(cfg, 0, 2, 8, device="cpu")
    other = stubs.make_batch(cfg, 1, 2, 8, train=False, device="cpu")
    if cfg.frontend != "none":
        assert set(b) == {"embeds", "labels"}
        assert b["embeds"].shape == (2, 8, cfg.d_model)
        assert b["embeds"].dtype == torch.bfloat16
        assert 0.01 < float(b["embeds"].float().std()) < 0.04
        key = "embeds"
    else:
        assert set(b) == {"tokens", "labels"}
        assert b["tokens"].dtype == torch.int32
        assert 0 <= int(b["tokens"].min()) and \
            int(b["tokens"].max()) < cfg.vocab_size
        key = "tokens"
    assert set(other) == {key}
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b[key], other[key])
    assert b["labels"].dtype == torch.int32 and \
        int(b["labels"].max()) < cfg.vocab_size
    # a stub batch trains the model
    loss, _ = tmodel.loss_fn(cfg, tmodel.init_params(cfg, 0, device="cpu"),
                             b)
    assert torch.isfinite(loss)


# ------------------------------------------------------------------- #
# gemma2 through compile_lm: windows, softcaps, post-norms, GeGLU
# ------------------------------------------------------------------- #
def test_gemma2_compile_lm_matches_dense_and_the_reference():
    """The reduced gemma2 (local/global layers with a 16-token window,
    softcaps 50/30, post-block norms, GeGLU, an untied head) with a
    24-token prompt, longer than the window, so the local layers mask:
    the mapped prefill and a per-slot decode against the port's dense
    forward and the reference's ``compile_lm``, rel ≤ 1e-5."""
    jcfg, jp, tcfg, tp, _ = _setup("gemma2-9b")
    assert tcfg.local_global and tcfg.sliding_window == 16 and \
        tcfg.attn_softcap and tcfg.final_softcap and not tcfg.tie_embeddings
    clm = compile_lm(TransformerParams(tcfg, tp), device="cpu")
    assert len(clm.plans) == 4 and set(clm.plans[0]) == set(LM_LINEARS)
    toks = np.random.default_rng(4).integers(0, 512, (2, 24),
                                             dtype=np.int32)
    step = np.asarray([[3], [7]], np.int32)
    pos = np.asarray([24, 20], np.int32)
    dcfg = tcfg.replace(decode_per_slot=True)
    want, wcache = tmodel.prefill(dcfg, tp, {"tokens": toks})
    got, cache = clm.prefill(toks)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5
    for k in wcache:
        assert _rel(cache[k].numpy(), wcache[k].numpy()) <= 1e-5
    grow = lambda c: {k: torch.nn.functional.pad(  # noqa: E731
        v, [0, 0, 0, 0, 0, 4]) for k, v in c.items()}
    want_d, _ = tmodel.decode_step(dcfg, tp, grow(wcache), step, pos)
    got_d, _ = clm.decode(grow(cache), step, pos)
    assert _rel(got_d.numpy(), want_d.numpy()) <= 1e-5
    # the window masks: a full-attention twin of the config differs
    full, _ = tmodel.prefill(dcfg.replace(local_global=False,
                                          sliding_window=0), tp,
                             {"tokens": toks})
    assert _rel(full.numpy(), want.numpy()) > 1e-3

    jclm = jlm.compile_lm(jlm.TransformerParams(jcfg, jp))
    jl, jc = jclm.prefill(jnp.asarray(toks))
    assert _rel(got.numpy(), _np(jl)) <= 1e-5
    jc = jax.tree.map(lambda v: jnp.pad(v, [(0, 0)] * 2 + [(0, 4)] +
                                        [(0, 0)] * (v.ndim - 3)), jc)
    jd, _ = jclm.decode(jc, jnp.asarray(step), jnp.asarray(pos))
    assert _rel(got_d.numpy(), _np(jd)) <= 1e-5


# ------------------------------------------------------------------- #
# the trainer on a frontend batch
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-large"])
def test_train_step_on_frontend_embeds_matches_reference(arch):
    """``train.steps.value_and_grad`` on a batch of stand-in embeddings:
    the token table, which the loss does not reach, gets the zero
    gradient ``jax.grad`` gives it (the step raised before), and every
    other leaf the reference's gradient."""
    from repro_torch.pytree import leaves
    from repro_torch.train import steps
    jcfg, jp, tcfg, tp, batch = _setup(arch)
    jb = _train_batch(jcfg, batch, jnp.asarray)
    jg = jax.grad(lambda p: jmodel.loss_fn(jcfg, p, jb)[0])(jp)
    metrics, g = steps.value_and_grad(tcfg, tp, _train_batch(
        tcfg, batch, torch.from_numpy))
    assert torch.equal(g["embed"]["table"],
                       torch.zeros_like(tp["embed"]["table"]))
    for got, want in zip(leaves(g), jax.tree.leaves(jg)):
        assert _rel(got.numpy(), _np(want)) <= 1e-4
    assert torch.isfinite(metrics["loss"])
