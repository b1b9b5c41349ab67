"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 (padded to 151680 for TP divisibility; logged), InternViT
frontend stubbed as precomputed patch embeddings. [arXiv:2404.16821; hf]
"""

from repro_torch.core.config import Frontend, ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        rope_theta=1e6,
        max_position=32768,
        frontend=Frontend.VISION_STUB.value,
        stub_patches=256,
        family="vlm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        rope_theta=1e6,
        frontend=Frontend.VISION_STUB.value,
        stub_patches=8,   # reduced stub for CPU smoke shapes
        family="vlm",
    )
