"""Moonlight-16B-A3B (moonshotai, ``model_type: deepseek_v3``): latent
attention and sigmoid-routed fine-grained experts.

Published values [hf:moonshotai/Moonlight-16B-A3B config.json]: 27
layers, the first dense (FFN 11,264), the rest MoE; hidden 2,048, 16
heads; MLA with q_lora_rank null (q_proj 2,048 → 16 × 192), kv_lora_rank
512, qk nope 128 + rope 64, v 128; 64 routed experts of width 1,408, 6
a token, 2 shared (one GLU of width 2,816); sigmoid scores with the
noaux_tc correction bias, one group, normalised top-6 weights times
2.446; vocabulary 163,840, untied head, 8,192 positions, RoPE θ 50,000
(no scaling), RMS eps 1e-5, SiLU.

Not in the architecture registry (``configs.ARCH_IDS`` mirrors the
reference package's list). ``moonshot_v1_16b_a3b`` is the reference
package's GQA/softmax stand-in under the older name, not this
architecture. :func:`from_hf` reads a Hugging Face-style config (the
benchmark's configuration file) whose ``n_routed_experts`` is the
experts held here.
"""
from repro_torch.configs.base import LatentMoEConfig, ModelConfig

CONFIG = LatentMoEConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,
    d_ff=1408,
    vocab_size=163_840,
    rope_theta=50_000.0,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    router="sigmoid_bias",
    routed_scaling=2.446,
    first_k_dense=1,
    dense_d_ff=11_264,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    norm_eps=1e-5,
    act="silu",
    tie_embeddings=False,
    param_dtype="float32",
    compute_dtype="float32",
)


def reduced() -> ModelConfig:
    """3 layers (1 dense, 2 MoE), 16 experts of which rank 0's 8 are
    held, top-2, widths of 64 (CPU tests)."""
    return CONFIG.replace(
        name="moonlight-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,
        d_ff=64,
        dense_d_ff=64,
        vocab_size=512,
        num_experts=16,
        held_experts=8,
        top_k=2,
        num_shared_experts=2,
        kv_lora_rank=64,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    )


def from_hf(hf: dict, *, name: str = "moonlight") -> ModelConfig:
    """A ``deepseek_v3`` config dict → :class:`ModelConfig`. Its
    ``n_routed_experts`` counts the experts held here, those of rank
    ``expert_rank`` (default 0); ``router_experts`` (default: the same)
    is the router's width."""
    if hf.get("q_lora_rank") is not None:
        raise NotImplementedError("MLA with a q_lora_rank: q is projected "
                                  "whole here")
    if (hf.get("n_group", 1), hf.get("topk_group", 1)) != (1, 1):
        raise NotImplementedError("grouped expert selection")
    if hf.get("scoring_func") != "sigmoid" or not hf.get("norm_topk_prob"):
        raise NotImplementedError("the router scores by sigmoid with "
                                  "normalised top-k weights")
    if hf.get("moe_layer_freq", 1) != 1:
        raise NotImplementedError("MoE in every layer after the dense "
                                  "ones")
    held = int(hf["n_routed_experts"])
    nope, rope = int(hf["qk_nope_head_dim"]), int(hf["qk_rope_head_dim"])
    return CONFIG.replace(
        name=name,
        num_layers=int(hf["num_hidden_layers"]),
        d_model=int(hf["hidden_size"]),
        num_heads=int(hf["num_attention_heads"]),
        num_kv_heads=int(hf["num_key_value_heads"]),
        head_dim=nope + rope,
        d_ff=int(hf["moe_intermediate_size"]),
        dense_d_ff=int(hf["intermediate_size"]),
        vocab_size=int(hf["vocab_size"]),
        rope_theta=float(hf["rope_theta"]),
        num_experts=int(hf.get("router_experts", held)),
        held_experts=held,
        expert_rank=int(hf.get("expert_rank", 0)),
        top_k=int(hf["num_experts_per_tok"]),
        num_shared_experts=int(hf["n_shared_experts"]),
        routed_scaling=float(hf["routed_scaling_factor"]),
        first_k_dense=int(hf["first_k_dense_replace"]),
        kv_lora_rank=int(hf["kv_lora_rank"]),
        qk_nope_head_dim=nope,
        qk_rope_head_dim=rope,
        v_head_dim=int(hf["v_head_dim"]),
        norm_eps=float(hf["rms_norm_eps"]),
        act=hf["hidden_act"],
        tie_embeddings=bool(hf["tie_word_embeddings"]),
    )
