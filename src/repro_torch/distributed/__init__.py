"""Collectives over a mesh of torch.distributed ranks (see collectives.py)."""
