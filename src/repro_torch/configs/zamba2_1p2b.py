"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. One shared transformer block (attn + MLP, weights
shared across applications) applied after every 2 Mamba2 blocks —
Zamba-style parameter sharing (DESIGN.md §8.4).

Port of ``repro.configs.zamba2_1p2b``: the same published geometry and the
same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    conv_width=4,
    shared_attn_every=2,
    # long-context mode: shared attn uses a sliding window (sub-quadratic)
    sliding_window=4096,
    grad_accum=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_headdim=32,
        sliding_window=32,
        grad_accum=1,
    )
