"""musicgen-medium [audio] — 48L d_model=1536 24H d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub providing precomputed frame
embeddings via input_specs(); 24 heads -> seq_tp attention strategy.
"""

from repro_torch.core.config import Frontend, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        rope_theta=1e4,
        frontend=Frontend.AUDIO_STUB.value,
        family="audio",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        rope_theta=1e4,
        frontend=Frontend.AUDIO_STUB.value,
        family="audio",
    )
