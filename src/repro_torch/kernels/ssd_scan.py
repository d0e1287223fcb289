"""Launch wrappers for the Hopper Mamba2 SSD chunked-scan kernels.

``ssd_scan`` launches ``csrc/ssd_scan.cu`` on PyTorch's current stream: the
C.B^T kernel into a scratch it allocates with ``torch.empty``, then the scan
kernel; with ``return_states`` the scan also writes each chunk's start
state (training keeps it for the backward; a serve's y and state keep their
bits without it). ``ssd_scan_bwd`` launches the backward's kernels on the
forward's chunk states: the reverse pass (with more than one chunk), the
chunk pass (with one chunk it also writes dh0) and the reduction of the
heads' f32 partials of dB and dC. Both take CUDA tensors only;
``kernels/ops.py`` routes CPU tensors to the plain versions in
``kernels/ref.py``. Each adds
one to its count, ``LAUNCHES["ssd_scan"]`` or ``LAUNCHES["ssd_scan_bwd"]``,
per call (all its kernels) and nowhere else.

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

LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
SLICE = 16            # P columns per scan block (kSlice in the source)
MAX_N = 256           # largest state dim the kernel takes (kMaxN)

_ARGTYPES = (
    [ctypes.c_void_p] * 10      # x, dt, A, Bm, Cm, h0, cb (scratch), y, h_out, states (or null)
    + [ctypes.c_int] * 6        # B, S, H, P, N, chunk
    + [ctypes.c_longlong] * 6   # x (batch, step), Bm (batch, step), Cm (batch, step) strides
    + [ctypes.c_void_p]         # stream
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 18      # x, dt, A, Bm, Cm, dy, states, dh_out (or null); scratch
                                # dh_end, dBp, dCp, dAp; dx, ddt, dA, dB, dC, dh0
    + [ctypes.c_int] * 6        # B, S, H, P, N, chunk
    + [ctypes.c_longlong] * 6   # x, Bm, Cm strides as the forward's
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
        lib.ssd_scan_bwd_bf16.argtypes = _BWD_ARGTYPES
        lib.ssd_scan_bwd_bf16.restype = ctypes.c_int
        lib.ssd_scan_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3  # Q, N, P
        lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(x, dt, A, Bm, Cm, h0=None) -> None:
    tensors = (x, dt, A, Bm, Cm) + ((h0,) if h0 is not None else ())
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
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
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
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or (h0 is not None and tuple(h0.shape) != (B, H, P, N))):
        raise ValueError("dt, A or h0 does not match x and B")


def _smem_check(what: str, smem: int, Q: int, P: int, N: int) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: chunk {Q}, P {P}, N {N} need {smem} B of shared memory per "
                         f"block, more than the card's {SMEM_LIMIT}")


def _strides(x, Bm, Cm):
    return (x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))


def ssd_scan(
    x: torch.Tensor,    # (B, S, H, P) bf16
    dt: torch.Tensor,   # (B, S, H) f32, post-softplus
    A: torch.Tensor,    # (H,) f32, negative
    Bm: torch.Tensor,   # (B, S, N) bf16
    Cm: torch.Tensor,   # (B, S, N) bf16
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) f32; None: zeros
    *,
    chunk: int,
    return_states: bool = False,
):
    """Chunked SSD scan on the card: (y (B, S, H, P) bf16, state (B, H, P, N)
    f32), and with ``return_states`` each chunk's start state (B, n_chunks,
    H, P, N) f32, which ``ssd_scan_bwd`` takes."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if h0 is None:
        h0 = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    _check(x, dt, A, Bm, Cm, h0)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    lib = _library()
    Q = min(chunk, S)
    _smem_check("ssd_scan", lib.ssd_scan_smem_bytes(Q, N), Q, P, N)
    y = torch.empty((B, S, H, P), dtype=torch.bfloat16, device=x.device)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    q16 = -(-Q // 16) * 16
    nc = -(-S // Q)
    cb = torch.empty((B, nc, q16, q16), dtype=torch.float32, device=x.device)
    states = (torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
              if return_states else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_bf16(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            h0.data_ptr(), cb.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            states.data_ptr() if states is not None else None, B, S, H, P, N, chunk,
            *_strides(x, Bm, Cm), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    LAUNCHES["ssd_scan"] += 1
    return (y, h_out, states) if return_states else (y, h_out)


def ssd_scan_bwd(
    x: torch.Tensor,       # (B, S, H, P) bf16, as the forward took it
    dt: torch.Tensor,      # (B, S, H) f32
    A: torch.Tensor,       # (H,) f32
    Bm: torch.Tensor,      # (B, S, N) bf16
    Cm: torch.Tensor,      # (B, S, N) bf16
    states: torch.Tensor,  # (B, n_chunks, H, P, N) f32, the forward's chunk start states
    dy: torch.Tensor,      # (B, S, H, P) bf16, the cotangent of y
    dh_out: Optional[torch.Tensor] = None,  # (B, H, P, N) f32, of the final state; None: zeros
    *,
    chunk: int,
) -> Tuple[torch.Tensor, ...]:
    """The scan's gradient on the card: (dx (B, S, H, P) bf16, ddt (B, S, H)
    f32, dA (H,) f32, dB, dC (B, S, N) bf16, dh0 (B, H, P, N) f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _check(x, dt, A, Bm, Cm)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    Q = min(chunk, S)
    nc = -(-S // Q)
    if (states.dtype != torch.float32 or not states.is_contiguous()
            or tuple(states.shape) != (B, nc, H, P, N)):
        raise ValueError(f"states must be a contiguous float32 ({B}, {nc}, {H}, {P}, {N}) "
                         "tensor (ssd_scan(return_states=True))")
    if dy.dtype != torch.bfloat16 or not dy.is_contiguous() or dy.shape != x.shape:
        raise ValueError(f"dy must be a contiguous bfloat16 {tuple(x.shape)} tensor")
    if dh_out is not None and (dh_out.dtype != torch.float32 or not dh_out.is_contiguous()
                               or tuple(dh_out.shape) != (B, H, P, N)):
        raise ValueError(f"dh_out must be a contiguous float32 ({B}, {H}, {P}, {N}) tensor")
    if any(t.device != x.device for t in (states, dy) + ((dh_out,) if dh_out is not None else ())):
        raise ValueError("states, dy and dh_out must be on x's device")
    lib = _library()
    _smem_check("ssd_scan_bwd", lib.ssd_scan_bwd_smem_bytes(Q, N, P), Q, P, N)
    _smem_check("ssd_scan_bwd", lib.ssd_scan_smem_bytes(Q, N), Q, P, N)
    dev, f32 = x.device, torch.float32
    dh_end = torch.empty((B, nc - 1, H, P, N), dtype=f32, device=dev)  # the last chunk's is dh_out
    dBp = torch.empty((B, H, S, N), dtype=f32, device=dev)
    dCp = torch.empty((B, H, S, N), dtype=f32, device=dev)
    dAp = torch.empty((B, nc, H), dtype=f32, device=dev)
    dx = torch.empty((B, S, H, P), dtype=torch.bfloat16, device=dev)
    ddt = torch.empty((B, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((B, S, N), dtype=torch.bfloat16, device=dev)
    dC = torch.empty((B, S, N), dtype=torch.bfloat16, device=dev)
    dh0 = torch.empty((B, H, P, N), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_bwd_bf16(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), states.data_ptr(), dh_out.data_ptr() if dh_out is not None else None,
            dh_end.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            dAp.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dh0.data_ptr(), B, S, H, P, N, chunk, *_strides(x, Bm, Cm), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {rc}")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC, dh0
