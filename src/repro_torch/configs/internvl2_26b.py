"""internvl2-26b — InternViT + InternLM2 VLM.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821;
hf]. Per the assignment, only the transformer BACKBONE (InternLM2-20B
geometry) is modeled; the InternViT frontend is a stub — ``models.stubs``
supplies stand-in patch embeddings (B, S, d_model).

Port of ``repro.configs.internvl2_26b``: the same published geometry and
the same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_553,
    frontend="vision",
    grad_accum=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-smoke",
        num_layers=3,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=384,
        grad_accum=1,
    )
