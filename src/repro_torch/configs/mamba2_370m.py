"""mamba2-370m [ssm]: pure SSD (state-space duality), attention-free.

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, register

MAMBA2_370M = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        tie_embeddings=True,
        notes="attention-free; runs long_500k; decode state is O(1) in sequence length",
    )
)
