"""Where the time of a full-width target's verify step goes on the card
(torch.profiler).

    PYTHONPATH=src python3 experiments/torch_verify_profile.py [ARCH]

Builds ARCH (default llama-11b-target; a dense or moe config) at its
published widths with the port's seeded init (as chip_smoke.py's bundles,
output projections, attention's ``wo`` and the MLP's or the experts' ``wd``,
scaled by 0.5) on an engine of 8 slots, and for buckets 1 and 8 runs the verify step as
``EngineCore.warmup`` does (scratch rows, ending in a host read): 5 steps
without the profiler (host wall, median), then 5 under ``torch.profiler``.
Prints per step: wall, device busy (the union of kernel intervals) and its
share of the wall, kernels launched, the host's waits on the card (calls of
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
``aten::_local_scalar_dense``) beside its ``cudaMemcpy*`` calls (copies on
the card as well as to the host; a copy to the host waits through one of
the former), device time by kernel name (top entries), and host time by
op. Runs on a CUDA device only; the traces go
to ``build/torch_verify_profile_{ARCH}_b{1,8}.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
STEPS = 5


def _busy_seconds(events) -> float:
    """Union of device kernel intervals (seconds)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_verify_profile: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.server_engine import ServerEngine
    from repro_torch.models.model_zoo import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    arch = sys.argv[1] if len(sys.argv) > 1 else "llama-11b-target"
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        for blk in params.layers:
            blk.attn.wo.mul_(0.5)
            (blk.moe if cfg.family == "moe" else blk.mlp).wd.mul_(0.5)
    engine = ServerEngine(model, params, n_slots=8, max_len=512, k_max=4)
    core = engine.core
    core.warmup()
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    for b in (1, 8):
        core.buckets = [b]
        core.warmup()
        walls = sorted(core.warmup()[b] for _ in range(STEPS))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                core.warmup()
            traced = (time.perf_counter() - t0) / STEPS
        trace = out / f"torch_verify_profile_{arch}_b{b}.json"
        prof.export_chrome_trace(str(trace))
        trace_events = json.loads(trace.read_text())["traceEvents"]
        events = [e for e in trace_events if e.get("cat") == "kernel" and "dur" in e]
        waits: dict = {}
        copies: dict = {}
        for e in trace_events:
            name = e.get("name", "")
            if name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "aten::_local_scalar_dense"):
                waits[name] = waits.get(name, 0) + 1
            elif name.startswith("cudaMemcpy"):
                copies[name] = copies.get(name, 0) + 1
        busy = _busy_seconds(events) / STEPS
        wall = walls[STEPS // 2]
        print(f"bucket {b}: step {wall * 1e3:.3f} ms wall without the profiler (median of "
              f"{STEPS}: {[round(w * 1e3, 3) for w in walls]}), {traced * 1e3:.3f} ms under it; "
              f"device busy {busy * 1e3:.3f} ms a step ({100 * busy / wall:.1f}% of the wall, "
              f"idle {100 * (1 - busy / wall):.1f}%); {len(events) / STEPS:.0f} kernels a step",
              flush=True)
        print(f"bucket {b}: host waits a step: "
              f"{ {k: v / STEPS for k, v in sorted(waits.items())} }; copy calls a step: "
              f"{ {k: v / STEPS for k, v in sorted(copies.items())} }", flush=True)
        by_name: dict = {}
        for e in events:
            d = by_name.setdefault(e["name"][:90], [0.0, 0])
            d[0] += e["dur"] * 1e-3 / STEPS
            d[1] += 1
        print(f"bucket {b}: device ms a step by kernel (top 12):")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {ms:9.4f} ms {n // STEPS:6d} launches  {name}")
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=14,
                                        max_name_column_width=48), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
