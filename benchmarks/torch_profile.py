"""Where the time goes in the port's serve path on the card (torch.profiler).

    PYTHONPATH=src:. python benchmarks/torch_profile.py

Builds the same full-width qwen2-1.5b bundle as ``chip_smoke.py`` (28-layer
target, 1-layer draft, seeded random weights), warms the engine up, serves
the 6-device fleet once without the profiler (the wall time), then once
more on a fresh System under ``torch.profiler`` and prints:
  * the device's busy time in the traced serve (the union of kernel
    intervals on the card) and its share of the unprofiled wall time, the
    idle share this reports; the profiler slows the host, so the share of
    the traced wall time is printed too, labelled as such;
  * device time by kernel name, top entries, with launch counts;
  * host time by top-level op.
Runs on a CUDA device only. The trace is written to
``build/torch_profile_trace.json`` for a timeline viewer.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


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
        print("torch_profile: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    from chip_smoke import full_width_bundle, serve_spec
    from repro_torch.api import System

    bundle = full_width_bundle()
    prompts = np.random.default_rng(2).integers(0, 151936, size=(6, 200)).astype(np.int32)
    system = System.build(serve_spec("engine"), models=bundle)
    system.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.serve(prompts)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    system = System.build(serve_spec("engine"), models=bundle)
    system.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = system.serve(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    trace = out / "torch_profile_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e]
    busy = _busy_seconds(events)
    print(f"serve: {res.total_tokens} tokens, {plain_wall:.3f} s wall without the profiler, "
          f"device busy {busy:.3f} s ({100 * busy / plain_wall:.1f}% of that wall, "
          f"idle {100 * (1 - busy / plain_wall):.1f}%)")
    print(f"traced serve: {wall:.3f} s wall under the profiler, {len(events)} kernels, "
          f"device busy {100 * busy / wall:.1f}% of the traced wall")
    by_name: dict = {}
    for e in events:
        d = by_name.setdefault(e["name"][:90], [0.0, 0])
        d[0] += e["dur"] * 1e-3
        d[1] += 1
    print("device ms by kernel (top 15):")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:10.3f} ms {n:7d} launches  {name}")
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=15, max_name_column_width=50))
    return 0


if __name__ == "__main__":
    sys.exit(main())
