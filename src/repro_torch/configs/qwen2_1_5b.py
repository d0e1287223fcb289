"""qwen2-1.5b [dense]: GQA kv=2, QKV bias.

28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936  [arXiv:2407.10671]
"""
from repro_torch.configs.base import ModelConfig, register

QWEN2_1_5B = register(
    ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        act="swiglu",
        tie_embeddings=True,
    )
)
