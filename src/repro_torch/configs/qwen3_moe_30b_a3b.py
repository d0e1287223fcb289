"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, GQA kv=4.

48L d_model=2048 32H (kv=4) d_ff=768/expert vocab=151936  [hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ModelConfig, register

QWEN3_MOE = register(
    ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=768,
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        moe_d_ff=768,
        act="swiglu",
        notes="EP: 128 experts / 16 model shards = 8 experts per device",
    )
)
