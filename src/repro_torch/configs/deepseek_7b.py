"""deepseek-7b — llama-architecture dense transformer.

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400
[arXiv:2401.02954; hf].

Port of ``repro.configs.deepseek_7b``: the same published geometry and
the same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11_008,
    vocab_size=102_400,
    grad_accum=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        grad_accum=1,
    )
