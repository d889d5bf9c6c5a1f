"""xlstm-350m — sLSTM + mLSTM block stack.

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517;
unverified]. xLSTM[7:1]-style: one sLSTM block per 8 blocks, remainder
mLSTM. d_ff=0 per the pool spec — blocks carry only their internal
up/down projections (mLSTM proj factor 2, sLSTM gated FFN factor 4/3).

Port of ``repro.configs.xlstm_350m``: the same published geometry and the
same ``reduced()`` config, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    slstm_period=8,
    mlstm_proj_factor=2.0,
    slstm_ff_factor=4.0 / 3.0,
    num_lstm_heads=4,
    conv_width=4,
    grad_accum=2,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke",
        num_layers=4,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        head_dim=32,
        vocab_size=256,
        slstm_period=2,
        num_lstm_heads=2,
        grad_accum=1,
    )
