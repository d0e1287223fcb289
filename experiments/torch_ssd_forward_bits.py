"""Whether the SSD scan kernel's y and state keep their bits against another tree's.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 experiments/torch_ssd_forward_bits.py --base build/base/src   # on an H100

A serve runs ``ssd_scan`` without the chunk states that training keeps, and
its y and final state should be the same bits as another version's kernel
where the arithmetic was not meant to change. Each tree runs in a process of
its own (both packages are named ``repro_torch``), builds its kernel from its
own sources, scans the same seeded inputs on the card (x, B and C as strided
bf16 views of one conv output, a start state; chip_smoke.py's six SSD cases
and mamba2-370m's training rows) and saves y and the state; this process
then prints, per shape, whether the two trees' y and state are equal bit for
bit, and exits 1 if any differs. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (B, S, H, P, N, chunk)
SHAPES = [(1, 199, 32, 64, 128, 256), (1, 512, 32, 64, 128, 256), (2, 300, 32, 64, 128, 256),
          (2, 64, 4, 16, 32, 16), (1, 199, 64, 64, 64, 256), (2, 64, 8, 16, 16, 16),
          (8, 128, 32, 64, 128, 256)]


def scan(out: str) -> None:
    """Scan every shape with the ``repro_torch`` on the path; save (y, state)."""
    from repro_torch.kernels import ssd_scan

    res = {}
    for B, S, H, P, N, chunk in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(B * 1000 + S)

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        xbc = rnd(B, S, H * P + 2 * N).to(torch.bfloat16)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt, A, h0 = torch.nn.functional.softplus(rnd(B, S, H)), -torch.exp(rnd(H) * 0.5), rnd(
            B, H, P, N)
        y, h = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
        res[(B, S, H, P, N, chunk)] = (y.cpu(), h.cpu())
    torch.save(res, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other tree's src directory")
    ap.add_argument("--scan", help=argparse.SUPPRESS)  # the child process's output file
    args = ap.parse_args()
    if args.scan:
        scan(args.scan)
        return 0
    with tempfile.TemporaryDirectory() as d:
        outs = {}
        for name, src in (("base", Path(args.base).resolve()), ("this", ROOT / "src")):
            outs[name] = os.path.join(d, f"{name}.pt")
            subprocess.run([sys.executable, __file__, "--base", args.base, "--scan", outs[name]],
                           check=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(src)})
        base, this = torch.load(outs["base"]), torch.load(outs["this"])
    same = {str(k): torch.equal(base[k][0], this[k][0]) and torch.equal(base[k][1], this[k][1])
            for k in base}
    print(json.dumps({"card": torch.cuda.get_device_name(0), "y_and_state_bit_equal": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
