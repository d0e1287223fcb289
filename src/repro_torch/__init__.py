"""repro_torch: the SLED serving stack ported to PyTorch and CUDA (H100).

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``configs/``, ``models/``, ``kernels/``, ``core/``, ``api/``,
``telemetry/``, ``cli``) and imports nothing of it. Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU
(``runtime.resolve_device``). Importing the package imports no ``torch``,
so ``python -m repro_torch.cli --help`` stays instant.
"""
