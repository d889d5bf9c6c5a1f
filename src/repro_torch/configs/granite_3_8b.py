"""granite-3-8b — dense GQA transformer.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base; hf].

Port of ``repro.configs.granite_3_8b``: the same published geometry and
the same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab_size=49_155,
    grad_accum=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        grad_accum=1,
    )
