"""llava-next-mistral-7b [vlm]: mistral-7b backbone, anyres patch tiling stubbed.

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000  [hf:llava-hf/llava-v1.6]
"""
from repro_torch.configs.base import ModelConfig, register

LLAVA_NEXT = register(
    ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        act="swiglu",
        num_patches=576,  # stub anyres frontend: precomputed patch embeddings
        notes="backbone only; modality frontend is a stub (input_specs provides patch embeddings)",
    )
)
