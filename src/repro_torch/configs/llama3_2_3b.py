"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256, small llama3. [hf:meta-llama/Llama-3.2-1B family; unverified]

24 heads do not divide the model axis (16) — seq_tp attention strategy.
"""

from repro_torch.core.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=5e5,
        max_position=131072,
        tie_embeddings=True,
        family="dense",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke",
        num_layers=2,
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=512,
        rope_theta=5e5,
        tie_embeddings=True,
        family="dense",
    )
