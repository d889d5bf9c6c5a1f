"""musicgen-large — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284;
hf]. The EnCodec frontend is a stub — ``models.stubs`` supplies
stand-in frame embeddings; the decode path emits one codebook's
token per step (vocab 2048).

Port of ``repro.configs.musicgen_large``: the same published geometry
and the same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    act="gelu",
    frontend="audio",
    grad_accum=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="musicgen-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        grad_accum=1,
    )
