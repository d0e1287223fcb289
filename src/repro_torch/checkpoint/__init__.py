"""Checkpoints in the JAX package's format (``checkpoint.py``): a step
directory of ``manifest.json`` and ``arrays.npz``, bf16 stored as uint16
bits, so the two packages read each other's checkpoints."""

from repro_torch.checkpoint.checkpoint import all_steps, latest_step, restore, save

__all__ = ["all_steps", "latest_step", "restore", "save"]
