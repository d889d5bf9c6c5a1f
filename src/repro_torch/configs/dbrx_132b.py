"""dbrx-132b — 16-expert top-4 MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified]. Largest assigned model — the
FSDP + EP + grad-accum stress test.

Port of ``repro.configs.dbrx_132b``: the same published geometry and the
same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    num_experts=16,
    top_k=4,
    grad_accum=16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="dbrx-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        num_experts=4,
        top_k=2,
        capacity_factor=8.0,  # drop-free at smoke-test sizes
        grad_accum=1,
    )
