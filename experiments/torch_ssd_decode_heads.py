"""Whether the SSD verify recurrence's output of a head depends on how many
heads run beside it, on the card.

    PYTHONPATH=src python3 experiments/torch_ssd_decode_heads.py

Under a mesh each model rank runs the recurrence of ``mamba2.ssd_layer_decode``
over its half of the heads and half of the rows; one rank runs every head of
every row. At mamba2-370m's widths (H 32, P 64, N 128; B 4 on one rank, 2
rows and 16 heads a mesh rank) and zamba2-1.2b's (H 64, N 64), this takes one
step's state h (B, H, P, N) f32 and C (B, N) f32 from a numpy seed and
forms y = C . h over N for all of them and for the rank's block, two ways:
``torch.einsum("bn,bhpn->bhp")`` (a batched product; the library picks its
kernel by shape) and an elementwise product summed over N (a reduction
whose order is set by N alone). Prints, per way, the largest absolute
difference between a block's y and the same entries of the whole's, and
each way's time per call (CUDA events, mean of 200 calls).
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

# (label, B, H, P, N): the one-rank shape; a mesh rank's is (B/2, H/2)
SHAPES = [("mamba2-370m", 4, 32, 64, 128), ("zamba2-1.2b", 4, 64, 64, 64)]


def _einsum(c, h):
    return torch.einsum("bn,bhpn->bhp", c, h)


def _mul_sum(c, h):
    return (h * c[:, None, None, :]).sum(-1)


def _ms(fn, iters: int = 200) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(0)
    for label, B, H, P, N in SHAPES:
        h = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32)).cuda()
        c = torch.from_numpy(rng.standard_normal((B, N)).astype(np.float32)).cuda()
        out = {"shape": label, "B": B, "H": H, "P": P, "N": N}
        for name, fn in (("einsum", _einsum), ("mul_sum", _mul_sum)):
            whole = fn(c, h)
            worst = 0.0
            for rows in (slice(0, B // 2), slice(B // 2, B)):
                for heads in (slice(0, H // 2), slice(H // 2, H)):
                    block = fn(c[rows].contiguous(), h[rows, heads].contiguous())
                    worst = max(worst, (block - whole[rows, heads]).abs().max().item())
            out[f"{name}_max_abs_diff"] = worst
            out[f"{name}_ms"] = _ms(lambda: fn(c, h))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
