"""Launch wrapper for the Hopper Mamba2 SSD chunked-scan kernel.

``ssd_scan`` launches ``csrc/ssd_scan.cu`` on PyTorch's current stream: the
C.B^T kernel into a scratch it allocates with ``torch.empty``, then the scan
kernel. It takes CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to
the plain version ``kernels/ref.py::ssd_scan_ref``. It adds one to
``LAUNCHES["ssd_scan"]`` per call (both kernels) and nowhere else.

x, B and C may be strided views (the model hands over slices of its conv
output) as long as their innermost dimension is contiguous; the kernel
reads them through their batch and step strides without a copy, in 16-byte
vectors. The kernel takes P in slices of ``SLICE`` columns and N in
16-column steps, so P and N must be multiples of 16 (and N at most 256).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = {"ssd_scan": 0}
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
SLICE = 16            # P columns per scan block (kSlice in the source)
MAX_N = 256           # largest state dim the kernel takes (kMaxN)

_ARGTYPES = (
    [ctypes.c_void_p] * 9       # x, dt, A, Bm, Cm, h0, cb (scratch), y, h_out
    + [ctypes.c_int] * 6        # B, S, H, P, N, chunk
    + [ctypes.c_longlong] * 6   # x (batch, step), Bm (batch, step), Cm (batch, step) strides
    + [ctypes.c_void_p]         # stream
)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library():
    lib = build.load("ssd_scan")
    if lib.ssd_scan_bf16.argtypes is None:
        lib.ssd_scan_bf16.argtypes = _ARGTYPES
        lib.ssd_scan_bf16.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 2  # Q, N
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(x, dt, A, Bm, Cm, h0) -> None:
    tensors = (x, dt, A, Bm, Cm, h0)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA SSD scan kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, dt, A, B, C and h0 must be on one device")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError("x must have head_dim contiguous and heads adjacent")
    for name, t in (("B", Bm), ("C", Cm)):
        if tuple(t.shape) != (B, S, N) or t.stride(2) != 1:
            raise ValueError(f"{name} must be ({B}, {S}, {N}) with the state dim contiguous")
    if P % SLICE or N % 16 or N > MAX_N:
        raise ValueError(f"the kernel takes P in slices of {SLICE} and N in steps of 16 up to "
                         f"{MAX_N}: got P {P}, N {N}")
    # the kernel reads x, B and C in 16-byte vectors of 8 bf16
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned with batch and step strides "
                             "that are multiples of 8 elements")
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) or tuple(h0.shape) != (B, H, P, N):
        raise ValueError("dt, A or h0 does not match x and B")


def ssd_scan(
    x: torch.Tensor,    # (B, S, H, P) bf16
    dt: torch.Tensor,   # (B, S, H) f32, post-softplus
    A: torch.Tensor,    # (H,) f32, negative
    Bm: torch.Tensor,   # (B, S, N) bf16
    Cm: torch.Tensor,   # (B, S, N) bf16
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) f32; None: zeros
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan on the card: (y (B, S, H, P) bf16, state (B, H, P, N) f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if h0 is None:
        h0 = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    _check(x, dt, A, Bm, Cm, h0)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    lib = _library()
    Q = min(chunk, S)
    smem = lib.ssd_scan_smem_bytes(Q, N)
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk {Q}, P {P}, N {N} need {smem} B of shared "
                         f"memory per block, more than the card's {SMEM_LIMIT}")
    y = torch.empty((B, S, H, P), dtype=torch.bfloat16, device=x.device)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    q16 = -(-Q // 16) * 16
    cb = torch.empty((B, -(-S // Q), q16, q16), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_bf16(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            h0.data_ptr(), cb.data_ptr(), y.data_ptr(), h_out.data_ptr(), B, S, H, P, N, chunk,
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    LAUNCHES["ssd_scan"] += 1
    return y, h_out
