"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared (weight-tied) attention block.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64  [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, register

ZAMBA2_1_2B = register(
    ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,  # mamba2 layers
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        attn_every=6,  # shared attention block applied after every 6 ssm layers
        act="swiglu",
        notes="runs long_500k (hybrid); shared attn block weight-tied across applications",
    )
)
