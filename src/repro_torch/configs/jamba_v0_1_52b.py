"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba+attention 1:7 interleave, MoE 16 experts top-2 on every
second layer. [arXiv:2403.19887; hf]

Hybrid: eligible for long_500k (Mamba states are O(1)/token; the 1:7
attention layers decode linearly against a mesh-sharded KV cache).
Note: the published Jamba uses no explicit positional encoding; we keep RoPE
on the attention layers (recorded deviation, does not change shapes/FLOPs).
"""

from repro_torch.core.config import FFNKind, ModelConfig, MoEConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        ffn=FFNKind.MOE,
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336,
                      every_k_layers=2),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        block_pattern=("mamba", "mamba", "mamba", "attention",
                       "mamba", "mamba", "mamba", "mamba"),
        rope_theta=1e6,
        family="hybrid",
        sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        ffn=FFNKind.MOE,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                      every_k_layers=2),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
        block_pattern=("mamba", "attention"),
        rope_theta=1e6,
        family="hybrid",
        sub_quadratic=True,
    )
