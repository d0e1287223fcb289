"""granite-moe-3b-a800m [moe]: 40 experts, top-8.

32L d_model=1536 24H (kv=8) d_ff=512/expert vocab=49155  [hf:ibm-granite]
"""
from repro_torch.configs.base import ModelConfig, register

GRANITE_MOE = register(
    ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        num_experts=40,
        experts_per_token=8,
        moe_d_ff=512,
        act="swiglu",
        tie_embeddings=True,
        notes="40 experts not divisible by 16: GSPMD pads expert axis shards",
    )
)
