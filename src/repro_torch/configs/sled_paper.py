"""The paper's own model pairs: LLaMA-style 1B/3B drafts, 11B/70B targets.

The port's copy of ``repro.configs.sled_paper``, field for field. They are
llama-3.2/3.1-shaped configs (RoPE theta 500000, no QKV bias; the targets
untie their head); notes start with "paper-" so ``all_cells`` leaves them
out of the dry-run grid.
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA_1B_DRAFT = register(
    ModelConfig(
        name="llama-1b-draft",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        tie_embeddings=True,
        rope_theta=500_000.0,
        notes="paper-draft: RPi/Jetson draft model (llama-3.2-1B shape)",
    )
)

LLAMA_3B_DRAFT = register(
    ModelConfig(
        name="llama-3b-draft",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        tie_embeddings=True,
        rope_theta=500_000.0,
        notes="paper-draft: llama-3.2-3B shape",
    )
)

LLAMA_11B_TARGET = register(
    ModelConfig(
        name="llama-11b-target",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        notes="paper-target: 11B verifier on the edge server",
    )
)

LLAMA_70B_TARGET = register(
    ModelConfig(
        name="llama-70b-target",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500_000.0,
        notes="paper-target: 70B verifier (llama-3.1-70B shape)",
    )
)
