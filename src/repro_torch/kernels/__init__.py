"""Hopper kernels for the port (CUDA C++ in ``csrc/``), their launch
wrappers, the plain PyTorch versions beside them, and the public ops."""
