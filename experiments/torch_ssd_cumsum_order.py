"""How far the SSD scan's cumsum order alone moves y and the state, on the CPU.

    PYTHONPATH=src python3 experiments/torch_ssd_cumsum_order.py

The SSD kernel (``csrc/ssd_scan.cu``) takes each chunk's running sum of
dt * A by a warp scan; the plain version's ``torch.cumsum`` adds step by step
on the card. At the mamba2-370m widths of ``chip_smoke.py``'s SSD cases
(H=32, P=64, N=128, chunk 256; inputs made the same way, from a numpy seed)
this runs the kernel's decomposition (``ref.ssd_scan_sliced_ref``) twice, with
a step-by-step running sum and with the kernel's warp-scan order, and prints
the largest absolute differences in y (bf16) and in the f32 state between
the two, beside the running sum's value at the end of the first chunk. Every
other step is the same in both runs, so the differences are the order's. It
needs no card and measures no time.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ref  # noqa: E402

# chip_smoke.py's full-width SSD cases: (B, S, H, P, N, chunk)
CASES = [(1, 199, 32, 64, 128, 256), (1, 512, 32, 64, 128, 256), (2, 300, 32, 64, 128, 256)]


def step_by_step(v: torch.Tensor) -> torch.Tensor:
    """The running sum over dim 1, one addition per step in order."""
    out, acc = torch.empty_like(v), torch.zeros_like(v[:, 0])
    for j in range(v.shape[1]):
        acc = acc + v[:, j]
        out[:, j] = acc
    return out


def main() -> int:
    torch.set_num_threads(4)
    for B, S, H, P, N, chunk in CASES:
        rng = np.random.default_rng(S)
        xbc = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * N)).astype(np.float32))
        xbc = xbc.to(torch.bfloat16)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((B, S, H))
                                                           .astype(np.float32)))
        A = -torch.exp(torch.from_numpy(rng.standard_normal(H).astype(np.float32)) * 0.5)
        h0 = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32))
        args = (x, dt, A, Bm, Cm, h0)
        y_seq, h_seq = ref.ssd_scan_sliced_ref(*args, chunk=chunk, cumsum=step_by_step)
        y_warp, h_warp = ref.ssd_scan_sliced_ref(*args, chunk=chunk, cumsum=ref.warp_scan_cumsum)
        print(json.dumps({
            "shape": f"B={B} S={S} H={H} P={P} N={N} chunk={chunk}",
            "cum_at_chunk_end_min": (dt[:, :min(chunk, S)] * A).sum(dim=1).min().item(),
            "y_err": (y_warp.float() - y_seq.float()).abs().max().item(),
            "y_max": y_seq.float().abs().max().item(),
            "state_err": (h_warp - h_seq).abs().max().item(),
            "state_rel_err": ((h_warp - h_seq).abs() / (1 + h_seq.abs())).max().item(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
