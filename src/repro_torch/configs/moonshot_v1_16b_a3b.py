"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — fine-grained MoE.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64 experts
top-6 [hf:moonshotai/Moonlight-16B-A3B; hf]. d_ff is the per-expert
width (fine-grained experts, DeepSeekMoE lineage).

Port of ``repro.configs.moonshot_v1_16b_a3b``: the same published
geometry and the same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    grad_accum=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="moonshot-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=32,
        vocab_size=512,
        num_experts=8,
        top_k=2,
        num_shared_experts=1,
        capacity_factor=8.0,  # drop-free at smoke-test sizes
        grad_accum=1,
    )
