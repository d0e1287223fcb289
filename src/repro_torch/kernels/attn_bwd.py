"""Launch wrappers for the Hopper attention-backward kernels.

``attention_bwd`` runs the three kernels of ``csrc/attn_bwd.cu`` on
PyTorch's current stream: ``delta`` (Delta = rowsum(dO * O) of each query
row, f32), ``dkdv`` (dK and dV of each 64-position KV block, summed over
the G query heads of its KV head) and ``dq``. They are the gradient of the
forward kernel's dense entry over fresh K/V
(``verify_attn.verify_attention_packed`` with no layer), causal-offset or
non-causal, and take each row's log-sum-exp from that forward
(``return_lse=True``), which computes it in its merge: no kernel here
computes it again. ``kernels/ops.py``'s ``attention`` calls them from its
backward. Each wrapper adds one to ``LAUNCHES[<its kernel>]`` per launch
and nowhere else.

``dq`` and ``dkdv`` run every product on the tensor cores and round dS to
bf16 for its two products (``ref.attention_bwd_split_ref`` restates their
decomposition). ``dkdv`` runs one block per (64-position block, query
head, batch entry), as ``dkdv_plan`` says from the shape alone: with G > 1
each block writes f32 partials to a workspace the call allocates, and the
last block of each (position block, KV head, entry) sums them in head
order. It finds out that it is last from a ticket counter, which it
returns to 0: the counters are the one thing kept between calls, a zeroed
int32 buffer per device (calls on two streams at once would share it).

The wrappers take CUDA tensors only; the plain versions are
``kernels/ref.py``'s ``attention_bwd_delta_ref``, ``attention_bwd_dkdv_ref``
and ``attention_bwd_dq_ref`` (``attention_bwd_ref`` runs all three, with
``attention_lse_ref`` for the LSE). LSE and Delta are (B, Hq, Sq) f32.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = {"attn_bwd_delta": 0, "attn_bwd_dkdv": 0, "attn_bwd_dq": 0}
HEAD_DIMS = (16, 64, 96, 128)
POSITIONS = 64  # KV positions of one dkdv block

_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_ARGTYPES = {
    # out, dout, delta, B, Sq, Hq, D, stream
    "attn_bwd_delta": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    # q, k, v, dout, kv_valid, lse, delta, dk, dv, work, tickets
    "attn_bwd_dkdv": [ctypes.c_void_p] * 11 + _TAIL,
    "attn_bwd_dq": [ctypes.c_void_p] * 8 + _TAIL,     # q, k, v, dout, kv_valid, lse, delta, dq
}
_TICKETS: Dict[torch.device, torch.Tensor] = {}


class DkdvPlan(NamedTuple):
    """How ``attn_bwd_dkdv`` cuts the work of one batch entry."""
    position_blocks: int          # ceil(Skv / 64): the grid's x
    query_heads: int              # one block per query head: the grid's y
    work_shape: Tuple[int, ...]   # f32 partials (Hkv, blocks, G, dK|dV, 64, D); () when G = 1
    tickets: int                  # counters, one per (KV head, block); 0 when G = 1


def dkdv_plan(Sq: int, Skv: int, Hq: int, Hkv: int, D: int) -> DkdvPlan:
    """The split of ``dkdv`` for one batch entry, and so its sum order: a
    function of the shape that takes no batch size, so an entry's gradient
    is the same bits alone and in any batch."""
    blocks = -(-Skv // POSITIONS)
    G = Hq // Hkv
    if G == 1:
        return DkdvPlan(blocks, Hq, (), 0)
    return DkdvPlan(blocks, Hq, (Hkv, blocks, G, 2, POSITIONS, D), Hkv * blocks)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """``n`` zeroed int32 counters on ``device``: the kernel returns each one
    it takes to 0, so one buffer serves every call. A buffer first needed
    inside a CUDA graph's capture is that call's own (its zeroing is
    captured with it)."""
    have = _TICKETS.get(device)
    if have is None or have.numel() < n:
        fresh = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        if torch.cuda.is_current_stream_capturing():
            return fresh
        _TICKETS[device] = have = fresh
    return have


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _function(symbol: str):
    fn = getattr(build.load("attn_bwd"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _check_device(tensors) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA attention-backward kernels take CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the attention-backward tensors must be on one device")


def _check_rows(rows) -> None:
    for t in rows:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k, v, out and dout must be contiguous 16-byte aligned bfloat16")


def _check(q, k, v, kv_valid, rows) -> Tuple[int, ...]:
    """(B, Sq, Hq, Hkv, D, Skv) of a call, after checking what the kernels take."""
    _check_device([q, k, v, kv_valid, *rows])
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the CUDA kernel (one of {HEAD_DIMS})")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"k and v must be ({B}, Skv, Hkv, {D}) with Hkv dividing {Hq}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    _check_rows((q, k, v, *rows))
    for t in rows:
        if t.shape != q.shape:
            raise ValueError(f"out and dout must have q's shape {tuple(q.shape)}")
    if kv_valid.dtype != torch.int32 or kv_valid.shape != (B,) or not kv_valid.is_contiguous():
        raise ValueError(f"kv_valid must be a contiguous ({B},) int32 tensor")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"empty attention {tuple(q.shape)} over {Skv} positions")
    return B, Sq, Hq, Hkv, D, Skv


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _function(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _tail(q, dims, causal) -> tuple:
    """dkdv's and dq's shape arguments, then the forward's scale, which these
    kernels differentiate, and the mask."""
    return (*dims, 1.0 / math.sqrt(q.shape[-1]), int(causal))


def delta(out, dout) -> torch.Tensor:
    """Delta = sum_d dO * O of each query row and head, (B, Hq, Sq) f32."""
    _check_device([out, dout])
    _check_rows((out, dout))
    if out.dim() != 4 or dout.shape != out.shape:
        raise ValueError(f"out and dout must be one (B, Sq, Hq, D) shape, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    B, Sq, Hq, D = out.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the CUDA kernel (one of {HEAD_DIMS})")
    if B * Sq * Hq == 0:
        raise ValueError(f"empty attention output {tuple(out.shape)}")
    res = torch.empty((B, Hq, Sq), dtype=torch.float32, device=out.device)
    _launch("attn_bwd_delta", out.device, out.data_ptr(), dout.data_ptr(), res.data_ptr(),
            B, Sq, Hq, D)
    return res


def _check_stats(q, *stats) -> None:
    B, Sq, Hq, _ = q.shape
    for t in stats:
        if (t.dtype != torch.float32 or t.shape != (B, Hq, Sq) or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"lse and delta must be contiguous ({B}, {Hq}, {Sq}) float32 "
                             "tensors on q's device")


def dkdv(q, k, v, dout, kv_valid, lse, delta, *, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each shaped and typed as k."""
    dims = _check(q, k, v, kv_valid, (dout,))
    _check_stats(q, lse, delta)
    B, Sq, Hq, Hkv, D, Skv = dims
    plan = dkdv_plan(Sq, Skv, Hq, Hkv, D)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    work = tickets = None
    if plan.work_shape:
        work = torch.empty((B, *plan.work_shape), dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, B * plan.tickets)
    _launch("attn_bwd_dkdv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), kv_valid.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), None if work is None else work.data_ptr(),
            None if tickets is None else tickets.data_ptr(), *_tail(q, dims, causal))
    return dk, dv


def dq(q, k, v, dout, kv_valid, lse, delta, *, causal: bool = True) -> torch.Tensor:
    """dQ, shaped and typed as q."""
    dims = _check(q, k, v, kv_valid, (dout,))
    _check_stats(q, lse, delta)
    out = torch.empty_like(q)
    _launch("attn_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            kv_valid.data_ptr(), lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
            *_tail(q, dims, causal))
    return out


def attention_bwd(
    q: torch.Tensor,         # (B, Sq, Hq, D) bf16
    k: torch.Tensor,         # (B, Skv, Hkv, D) bf16
    v: torch.Tensor,
    out: torch.Tensor,       # (B, Sq, Hq, D) the forward's output
    dout: torch.Tensor,      # (B, Sq, Hq, D) its gradient
    kv_valid: torch.Tensor,  # (B,) int32
    lse: torch.Tensor,       # (B, Hq, Sq) f32, the forward's (return_lse=True)
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of attention over fresh K/V: the three kernels in turn."""
    _check_stats(q, lse)
    dl = delta(out, dout)
    dk, dv = dkdv(q, k, v, dout, kv_valid, lse, dl, causal=causal)
    return dq(q, k, v, dout, kv_valid, lse, dl, causal=causal), dk, dv
