"""granite-34b [dense]: llama-arch code model, MQA (kv=1).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152  [arXiv:2405.04324]
"""
from repro_torch.configs.base import ModelConfig, register

GRANITE_34B = register(
    ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        act="gelu",  # granite-34b-code uses gpt_bigcode-style MLP
        notes="MQA: kv cache replicated over model axis, batch over data",
    )
)
