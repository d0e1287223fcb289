"""How far batch composition alone moves the port's greedy tokens, on the card.

    PYTHONPATH=src python3 experiments/torch_batch_noise.py

For each serving path of ``chip_smoke.py`` (qwen2-1.5b on a bf16 and an
int8 pool, mamba2-370m; full widths, the same seeded bundles and prompts)
the port's reference backend serves the 6-device fleet in one batch (R6),
then each device alone (R1) and the fleet in two batches of 3 (R3), and the
engine backend serves the fleet (E). For every run and device it prints the
first token where the stream departs from R6 and the reference's top-2
logit gap there (from a batch-1 prefill of the prompt and the common
prefix). R1 and R3 compute the same function as R6 with other numbers of
rows, so their departures measure the reference's own batch-composition
noise: the yardstick for the engine's divergences in ``chip_smoke.py``'s
check phase. Runs on a CUDA device only.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_batch_noise: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.api import System

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, kv in (("qwen2-1.5b", "bf16"), ("qwen2-1.5b", "int8"), ("mamba2-370m", "bf16")):
        bundle = cs.full_width_bundle(arch)
        vocab = bundle.target_cfg.vocab_size
        prompts = (np.random.default_rng(2).integers(0, 151936, size=(6, 200)) % vocab)
        prompts = prompts.astype(np.int32)

        def serve(backend, p):
            system = System.build(cs.serve_spec(backend, arch, kv), models=bundle)
            return list(system.serve(p).outputs.values())

        r6 = serve("reference", prompts)
        runs = {
            "R1": [serve("reference", prompts[i:i + 1])[0] for i in range(6)],
            "R3": serve("reference", prompts[:3]) + serve("reference", prompts[3:]),
            "E": serve("engine", prompts),
        }
        for name, outs in runs.items():
            row = []
            for d in range(6):
                p = cs._first_difference(outs[d], r6[d])
                gap = None if p is None else cs._top2_gap(bundle, prompts[d], r6[d][:p], kv)
                row.append((p, None if gap is None else round(gap, 4)))
            print(f"{arch} {kv} {name} vs R6, per device (first departure, top-2 gap): {row}",
                  flush=True)
        del bundle
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
