"""xlstm-1.3b [ssm] — 48L d_model=2048 4H, sLSTM + mLSTM blocks (7:1),
no separate FFN (d_ff=0), vocab=50304. [arXiv:2405.04517; unverified]

Attention-free: eligible for the long_500k decode cell (O(1)/token state).
"""

from repro_torch.core.config import FFNKind, ModelConfig, XLSTMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        ffn=FFNKind.NONE,
        xlstm=XLSTMConfig(slstm_every=8),
        block_pattern=("mlstm",) * 7 + ("slstm",),
        family="ssm",
        sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        ffn=FFNKind.NONE,
        xlstm=XLSTMConfig(slstm_every=2),
        block_pattern=("mlstm", "slstm"),
        family="ssm",
        sub_quadratic=True,
    )
