"""qwen1.5-32b [dense]: MHA with QKV bias.

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064  [hf:Qwen/Qwen1.5]
"""
from repro_torch.configs.base import ModelConfig, register

QWEN15_32B = register(
    ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        act="swiglu",
        notes="40 heads not divisible by TP=16: ffn/vocab TP exact, heads unevenly sharded by GSPMD",
    )
)
