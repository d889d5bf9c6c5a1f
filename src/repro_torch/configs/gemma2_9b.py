"""gemma2-9b — local/global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000
[arXiv:2408.00118; hf]. Layers alternate (local sliding-window 4096,
global full attention); attention-logit softcap 50, final-logit softcap
30, GeGLU MLP, pre+post block norms, head_dim 256.

Port of ``repro.configs.gemma2_9b``: the same published geometry and the
same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    vocab_size=256_000,
    act="gelu",
    scale_embed=True,
    local_global=True,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=(3584 // 16) ** -0.5,  # query_pre_attn_scalar = d_model/H
    post_block_norm=True,
    grad_accum=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sliding_window=16,
        grad_accum=1,
    )
