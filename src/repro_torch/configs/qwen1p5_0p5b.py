"""qwen1.5-0.5b — dense transformer with QKV bias.

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936
[hf:Qwen/Qwen1.5-0.5B; hf]. Port of ``repro.configs.qwen1p5_0p5b``:
the same published geometry and the same two width-scaled configs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    grad_accum=2,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        grad_accum=1,
    )


def reduced_serving() -> ModelConfig:
    """The width-scaled config as an LM fabric tenant
    (``repro_torch.lm.compile_lm`` / ``AppSpec(network=...)``): float32
    host glue so the mapped tile-grid path matches the dense forward at
    rel ≤ 1e-6 (compile_lm would force it anyway; naming it here keeps
    the dense Engine oracle in tests on the identical config)."""
    return reduced().replace(name="qwen-lm-tenant",
                             compute_dtype="float32")
