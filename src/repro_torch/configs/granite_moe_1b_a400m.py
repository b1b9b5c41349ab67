"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8)
d_ff(expert)=512, MoE 32 experts top-8, vocab=49155 (padded for TP).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Tiny experts: the MoE dispatch decision node tends to pick the *gather*
(hash-join/broadcast) strategy here — the broadcast side is cheap.
"""

from repro_torch.core.config import FFNKind, ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        ffn=FFNKind.MOE,
        moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
        rope_theta=1e4,
        family="moe",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        ffn=FFNKind.MOE,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
        family="moe",
    )
