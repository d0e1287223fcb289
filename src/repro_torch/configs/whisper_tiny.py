"""whisper-tiny [audio]: enc-dec, conv frontend stubbed as frame embeddings.

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, register

WHISPER_TINY = register(
    ModelConfig(
        name="whisper-tiny",
        family="encdec",
        num_layers=4,  # decoder layers
        encoder_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        act="gelu",
        norm="layernorm",
        use_rope=False,  # whisper uses learned/sinusoidal positions
        qkv_bias=True,
        is_encdec=True,
        encoder_seq=1500,  # 30 s of audio -> 1500 frames (stub frontend)
        notes="enc-dec; conv frontend is a stub (precomputed frame embeddings)",
    )
)
