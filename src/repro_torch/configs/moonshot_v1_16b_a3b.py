"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H d_ff(expert)=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from repro_torch.core.config import FFNKind, ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        ffn=FFNKind.MOE,
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408),
        rope_theta=5e6,
        family="moe",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        ffn=FFNKind.MOE,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=96),
        family="moe",
    )
