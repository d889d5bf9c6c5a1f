"""Moonlight-16B-A3B's blocks in the port (latent attention, sigmoid-
routed held experts, the leading dense layer) against the plain
reference ``repro_torch.models.reference_moonlight``, on the CPU at
``moonlight_16b_a3b.reduced()`` (3 layers: 1 dense, 2 MoE; 16 experts
of which rank 0's 8 are held, top-2; widths of 64).

Bounds: the mapped model (``compile_lm`` → ``LMMember``: prefill, then
decode through the latent cache) within rel 1e-5 of the reference's
full forward (about 1e-6 measured: f32 sums in another order, the
absorbed products, the combiner); the absorbed attention within 1e-5 of
the expanded one; the expert shares add up to the uncut layer within
1e-5. The weights are the reference's seeded draws, carried into the
port's tree by ``params_from_layers``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import moonlight_16b_a3b as moon
from repro_torch.lm import LMMember, TransformerParams, compile_lm
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import reference_moonlight as ref
from repro_torch.serving import kvcache

torch.set_num_threads(1)

# the reduced config's published-style dict (the reference's input)
HF = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
      "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
      "kv_lora_rank": 64, "q_lora_rank": None, "intermediate_size": 64,
      "moe_intermediate_size": 64, "n_routed_experts": 8,
      "router_experts": 16, "expert_rank": 0, "n_shared_experts": 2,
      "num_experts_per_tok": 2, "vocab_size": 512, "num_hidden_layers": 3,
      "first_k_dense_replace": 1, "rms_norm_eps": 1e-5,
      "rope_theta": 50000, "routed_scaling_factor": 2.446,
      "scoring_func": "sigmoid", "norm_topk_prob": True, "n_group": 1,
      "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
      "tie_word_embeddings": False,
      "weights": {"embed_std": 1.0, "gate_bias_std": 0.05}}
REL = 1e-5


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def weights():
    cfg = moon.from_hf(HF, name="moonlight-smoke")
    params = ref.make_params(HF, torch.Generator().manual_seed(11), "cpu")
    return cfg, params, tmodel.params_from_layers(cfg, params, device="cpu")


def test_from_hf_reads_the_reduced_config():
    assert moon.from_hf(HF, name="moonlight-smoke") == moon.reduced()
    assert tmodel.count_params(moon.CONFIG) == 15_960_110_208
    # the benchmark's cut: 568.5 M parameters on the card
    cut = moon.CONFIG.replace(num_layers=5, held_experts=8,
                              vocab_size=20_480)
    assert tmodel.count_params(cut) == 568_484_608


def _state(prompt):
    req = types.SimpleNamespace(uid=0, prompt=tuple(prompt))
    return types.SimpleNamespace(request=req, outputs=[])


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
def test_mapped_prefill_then_decode_matches_the_reference(weights,
                                                         use_kernel):
    """Prefill through ``LMMember.on_admit``, then greedy decode steps
    over two lanes at their own positions, against the reference's full
    forward over each lane's prompt and fed tokens."""
    cfg, params, tree = weights
    clm = compile_lm(TransformerParams(cfg, tree), geometry=(32, 16),
                     device="cpu")
    member = LMMember(clm, lanes=2, cache_len=48,
                      cache_dtype=torch.float32)
    assert member.cache["ckv"].dtype == torch.float32
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).tolist() for n in (30, 17)]
    seqs = [list(p) for p in prompts]
    for lane, p in enumerate(prompts):
        member.on_admit(lane, _state(p))
    rows = []
    for _ in range(6):
        pos = member._pos.copy()
        fed = member.stream_host(np.zeros((2, 1), np.float32),
                                 use_kernel=use_kernel)
        for lane in range(2):
            seqs[lane].append(int(fed[lane, 0]))
        rows.append((pos, member.logits.clone()))
    for lane in range(2):
        want, _, _ = ref.forward(HF, params, torch.tensor(seqs[lane]),
                              [int(p[lane]) for p, _ in rows])
        for i, (_, logits) in enumerate(rows):
            assert _rel(logits[lane], want[i]) <= REL
    # the last prompt position's logits chose the first fed token
    want, _, _ = ref.forward(HF, params, torch.tensor(prompts[1]))
    assert int(torch.argmax(want[-1])) == seqs[1][17]


def test_absorbed_mla_equals_expanded_and_caches_the_latent(weights):
    cfg, params, tree = weights
    lay = params["layers"][1]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 20, 64)).astype(np.float32))
    k = ref._dims(HF)
    expanded = ref._attention(lay, x[0], k, 50000.0, 1e-5, "exact")
    p_l, moe = tmodel.tf.LatentMoEStack.layer(tree["stack"], cfg, 1)
    pos = torch.arange(20, dtype=torch.int32)[None]
    absorbed, cache = tattn.mla_apply(p_l["attn"], cfg, x, positions=pos,
                                      mode="prefill")
    assert _rel(absorbed[0], expanded) <= REL
    assert moe and tuple(cache["ckv"].shape) == (1, 20, 64 + 8)
    # decode: the last position through a cache of the first 19
    ring = torch.zeros((1, 32, 72))
    ring[:, :19] = cache["ckv"][:, :19]
    one, same = tattn.mla_apply(p_l["attn"], cfg, x[:, 19:], positions=pos[
        :, 19:], mode="decode", cache={"ckv": ring}, kv_len=20)
    assert same["ckv"] is ring
    assert torch.allclose(ring[0, 19], cache["ckv"][0, 19], atol=1e-6)
    assert _rel(one[0, 0], expanded[19]) <= REL
    # published widths: 512 + 64 values a position a layer
    full = tmodel.init_cache(moon.CONFIG, 2, 8, device="meta")["ckv"]
    assert tuple(full.shape) == (27, 2, 8, 576)


def test_sigmoid_bias_routing_hand_worked():
    """Scores σ(logit); the top 2 of score + bias, the lower index first
    on a tie; weights the chosen scores (without the bias) over their
    sum, times the scaling; the gap is the 2nd choice value less the
    3rd."""
    cfg = moon.reduced().replace(num_experts=4, top_k=2, routed_scaling=2.0)
    logits = torch.tensor([[2.0, 0.0, 0.0, -3.0],
                           [1.0, 1.0, 1.0, 1.0]])
    bias = torch.tensor([0.0, 0.2, 0.2, 0.0])
    w, ids, gap = tmoe.route_sigmoid(logits, bias, cfg)
    s = torch.sigmoid(logits)
    # row 0: choice values .8808, .7, .7, .0474: experts 1 and 2 tie for
    # the 2nd place, the lower index is chosen, the gap is 0
    assert ids[0].tolist() == [0, 1] and float(gap[0]) == 0.0
    assert torch.allclose(w[0], 2.0 * s[0, :2] / s[0, :2].sum())
    # row 1: all scores .7311; a bias of .3 picks 0 and 1 (the lower
    # first) over expert 3 by .3, and the weights stay equal
    w, ids, gap = tmoe.route_sigmoid(logits[1:], torch.tensor(
        [0.3, 0.3, -0.5, 0.0]), cfg)
    assert ids.tolist() == [[0, 1]]
    assert torch.allclose(w[0], torch.tensor([1.0, 1.0]))
    assert float(gap[0]) == pytest.approx(0.3, abs=1e-6)
    # unequal scores: the weights are the scores' shares
    w2, ids2, _ = tmoe.route_sigmoid(torch.tensor([[2.0, 0.5, 0.0, 0.0]]),
                                     torch.zeros(4), cfg)
    a, b = torch.sigmoid(torch.tensor(2.0)), torch.sigmoid(torch.tensor(.5))
    assert ids2.tolist() == [[0, 1]]
    assert torch.allclose(w2[0], 2.0 * torch.stack([a, b]) / (a + b))
    # the reference selects the same
    m = {"gate": torch.eye(4), "gate_bias": torch.tensor([0.0, .2, .2, 0.0]),
         "shared": {"w1": torch.zeros(4, 1), "w3": torch.zeros(4, 1),
                    "w2": torch.zeros(1, 4)},
         "w1": torch.zeros(0, 4, 1), "w3": torch.zeros(0, 4, 1),
         "w2": torch.zeros(0, 1, 4)}
    k = dict(ref._dims(dict(HF, num_experts_per_tok=2, n_routed_experts=0,
                            router_experts=4)))
    _, rgap, rids = ref._moe(m, logits, k, 2.0, "exact")
    # row 1 under this bias: .9311 twice (experts 1, 2), then .7311
    assert rgap.tolist() == pytest.approx([0.0, 0.2], abs=1e-6)
    _, ids, gap = tmoe.route_sigmoid(logits, m["gate_bias"], cfg)
    assert ids[1].tolist() == [1, 2] and torch.equal(gap, rgap)
    assert torch.equal(rids, ids)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_expert_shares_add_up_to_the_uncut_layer(side):
    """Two EP ranks of 8 experts each: their parts, the shared experts
    counted once, are the uncut reference layer over all 16."""
    hf_all = dict(HF, n_routed_experts=16)
    params = ref.make_params(hf_all, torch.Generator().manual_seed(4), "cpu")
    m = params["layers"][1]["moe"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (40, 64)).astype(np.float32))
    k_all = ref._dims(hf_all)
    whole, _, _ = ref._moe(m, x, k_all, 2.446, "exact")
    sh = m["shared"]
    shared = ref._glu(x, sh["w1"], sh["w3"], sh["w2"], "exact")

    def share(rank):
        part = {**m, "w1": m["w1"][8 * rank:8 * rank + 8],
                "w3": m["w3"][8 * rank:8 * rank + 8],
                "w2": m["w2"][8 * rank:8 * rank + 8]}
        if side == "reference":
            k = ref._dims(dict(HF, expert_rank=rank))
            return ref._moe(part, x, k, 2.446, "exact")[0]
        cfg = moon.reduced().replace(expert_rank=rank)
        p = {"router": part["gate"], "router_bias": part["gate_bias"],
             "w1": part["w1"], "w3": part["w3"], "w2": part["w2"],
             "shared": sh}
        return tmoe.held_moe_apply(p, cfg, x[None])[0]

    total = share(0) + share(1) - shared
    assert _rel(total, whole) <= REL
    assert _rel(share(0), whole) > 1e-2          # each share is a part


def test_latent_cache_lanes_are_written_and_cleared(weights):
    cfg, _, tree = weights
    clm = compile_lm(TransformerParams(cfg, tree), device="cpu")
    assert clm.init_cache(2, 8)["ckv"].dtype == torch.bfloat16
    member = LMMember(clm, lanes=3, cache_len=16)
    assert member.cache["ckv"].dtype == torch.bfloat16     # the default
    member = LMMember(clm, lanes=3, cache_len=16, cache_dtype=torch.float32)
    member.on_admit(1, _state(range(5, 12)))
    ckv = member.cache["ckv"]
    _, one = clm.prefill([list(range(5, 12))])
    assert torch.equal(ckv[:, 1, :7], one["ckv"][:, 0])
    assert not ckv[:, 1, 7:].any() and not ckv[:, (0, 2)].any()
    kvcache.clear_slot(member.cache, 1)
    assert not member.cache["ckv"].any()


def test_compile_lm_maps_every_static_product(weights):
    """Both block kinds' products are grids; the heads' W_kbᵀ and W_vb
    are one grouped grid each."""
    cfg, _, tree = weights
    clm = compile_lm(TransformerParams(cfg, tree), geometry=(32, 16),
                     device="cpu")
    dense, moe = clm.plans[0], clm.plans[1]
    assert set(dense) == {"wq_a", "wkb", "wvb", "wo", "w13", "w2"}
    assert set(moe) == {"wq_a", "wkb", "wvb", "wo", "router", "shared_w13",
                        "shared_w2"} | {f"w{j}.{e}" for j in (13, 2)
                                        for e in range(8)}
    assert dense["wkb"].groups == dense["wvb"].groups == 4
    assert dense["wvb"].tiles.gp.shape[0] == 4 * 2      # 64 rows: 2 chunks
    assert dataclasses.replace(clm.cfg, name="x").decode_per_slot
