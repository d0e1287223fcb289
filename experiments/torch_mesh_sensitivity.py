"""How far the mesh phase's logits move under rounding noise, and under a
fault that puts SSD heads in the wrong place, on one rank of the card.

    PYTHONPATH=src python3 experiments/torch_mesh_sensitivity.py

``chip_smoke.py``'s mesh phase holds each rank's logits within a bound of
one rank's. Its ranks differ from one rank only in sum order: the
tensor-parallel attention and MLP round their summed partial products to
bf16 once, where one rank rounds one product. This script measures, for
mamba2-370m and zamba2-1.2b at full width and depth with the mesh phase's
weights (``chip_smoke._mesh_weights``, its seeds), the prefill's f32
logits (B 2, prompt 200) against an unchanged run's, max abs over all
entries, in four cases:

- ``control``: the same run again (0 where the run is deterministic);
- ``ulp``: every shared block's output (the hybrid's, where the mesh's
  sums enter) with a random half of its bf16 elements moved by one unit
  in the last place, a stand-in for the mesh's other sum order;
- ``swap_all``: every SSD layer's scan output with its two halves of heads
  exchanged, as a gather that puts the model ranks' heads in each other's
  place would give;
- ``swap_one``: the same in the first SSD layer only.

Each case under two draws of the SSD layers' ``D`` and ``dt_bias``: the
families' init (D 1, dt_bias log(expm1(0.01))) and the mesh phase's (D from
N(0, 0.1), dt_bias 0). Prints one JSON line per (arch, draw) with the
logits' std and each case's difference, and the card's name and power
limit.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import verification  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

B, PROMPT = 2, 200
_mesh_leaf = cs._mesh_leaf


def _init_leaf(cfg, leaf, shape, gen):
    """The families' init for D and dt_bias, the mesh phase's otherwise."""
    if leaf == "D":
        return torch.ones(shape, device="cuda")
    if leaf == "dt_bias":
        return torch.full(shape, math.log(math.expm1(0.01)), device="cuda")
    return _mesh_leaf(cfg, leaf, shape, gen)


def _swapping(scan, layers):
    """``ops.ssd_scan`` with its output's two halves of heads exchanged at
    the calls whose index (from 0, counted in ``state``) is in ``layers``."""
    state = {"i": 0}

    def run(*args, **kw):
        y, h = scan(*args, **kw)
        if layers is None or state["i"] in layers:
            H = y.shape[2]
            y = torch.cat([y[:, :, H // 2:], y[:, :, :H // 2]], dim=2)
        state["i"] += 1
        return y, h

    return run


def _ulp_blocks(block):
    gen = torch.Generator(device="cuda").manual_seed(7)

    def run(*args, **kw):
        x = block(*args, **kw)
        bits = x.contiguous().view(torch.int16)
        flip = torch.randint(0, 2, x.shape, generator=gen, device="cuda", dtype=torch.int16)
        return (bits + flip).view(torch.bfloat16)  # one unit in the last place, or none

    return run


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for label in ("mamba2", "zamba2"):
        run = cs.MESH_RUNS[label]
        cfg = cs._mesh_cfg(run.arch, run.layers)
        model = build_model(cfg)
        prompts = torch.from_numpy(np.random.default_rng(run.seed).integers(
            0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)).cuda()
        prefill = verification.make_prefill_step(model)
        for draw, leaf in (("init", _init_leaf), ("mesh", _mesh_leaf)):
            cs._mesh_leaf = leaf
            params = cs._mesh_weights(cfg, run.seed)
            cs._mesh_leaf = _mesh_leaf

            def logits():
                out = prefill(params, model.make_cache(B, run.max_len, device="cuda"), prompts)
                return out[0].float()

            base = logits()
            res = {"arch": run.arch, "draw": draw, "logits_std": base.std().item()}
            cases = [("control", None, None), ("swap_all", "scan", None),
                     ("swap_one", "scan", {0})]
            if cfg.family == "hybrid":
                cases.insert(1, ("ulp", "block", None))
            scan, block = ops.ssd_scan, T.block_forward
            for name, where, layers in cases:
                if where == "scan":
                    ops.ssd_scan = _swapping(scan, layers)
                elif where == "block":
                    T.block_forward = _ulp_blocks(block)
                try:
                    res[name] = (logits() - base).abs().max().item()
                finally:
                    ops.ssd_scan, T.block_forward = scan, block
            print(json.dumps(res), flush=True)
            del params
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
