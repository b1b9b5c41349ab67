"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]

20 heads do not divide the model axis (16) — the attention-strategy decision
node selects seq_tp (sequence-sharded residual + KV broadcast).
"""

from repro_torch.core.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=5e6,
        max_position=32768,
        family="dense",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=160,
        vocab_size=512,
        qkv_bias=True,
        rope_theta=5e6,
        family="dense",
    )
