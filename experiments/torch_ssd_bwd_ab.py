"""The SSD scan's backward (``ssd_scan_bwd``) of this tree against another's, in turns.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 experiments/torch_ssd_bwd_ab.py --base build/base/src   # on an H100

Each tree runs in a process of its own (both packages are named
``repro_torch``) and builds its kernels from its own sources; the processes
run base, this, this, base (``--repeat`` times). Each scans the same seeded
inputs on the card with ``ssd_scan(return_states=True)`` (x, B and C as
strided bf16 views of one conv output, a start state, both cotangents) and
then times ``ssd_scan_bwd`` at mamba2-370m's and zamba2-1.2b's training rows
and at two chunk-256 prefill shapes:
  graph_ms   device time per call, a CUDA graph of 28 calls replayed 5 times;
  kernels    each CUDA kernel's device time per call by name, from
             ``torch.profiler`` over 10 calls (the split of the call);
  err        the largest |kernel - plain| / max |plain| over the six outputs
             against the tree's own plain backward (``ref.ssd_scan_bwd_ref``).
The summary gives each tree's mean graph_ms, this tree's speed-up, and the
first run's split of each tree. It prints the card's name and power limit
(``nvidia-smi``) and imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, B, S, H, P, N, chunk)
SHAPES = [
    ("mamba2 train", 8, 128, 32, 64, 128, 256),
    ("zamba2 train", 8, 128, 64, 64, 64, 256),
    ("prefill S=199", 1, 199, 32, 64, 128, 256),
    ("S=512", 1, 512, 32, 64, 128, 256),
]
GRAPH_CALLS = 28
PROFILE_CALLS = 10


def _graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = 5) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _split(fn) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us <= 0:
            continue
        key = evt.key.replace("(anonymous namespace)::", "")
        name = (re.sub(r"[(<].*$", "", key).split("::")[-1].split() or [key])[-1]
        out[name] = out.get(name, 0.0) + us / 1e3 / PROFILE_CALLS
    return out


def run(out: str) -> None:
    """Time every shape with the ``repro_torch`` on the path."""
    import torch

    from repro_torch.kernels import ref, ssd_scan

    res = {}
    for label, B, S, H, P, N, chunk in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(B * 1000 + S + H)

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        xbc = rnd(B, S, H * P + 2 * N).to(torch.bfloat16)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt, A = torch.nn.functional.softplus(rnd(B, S, H)), -torch.exp(rnd(H) * 0.5)
        h0, dh = rnd(B, H, P, N), rnd(B, H, P, N)
        dy = rnd(B, S, H, P).to(torch.bfloat16)
        _, _, states = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk, return_states=True)

        def call():
            return ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, dh, chunk=chunk)

        got = call()
        want = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk)
        err = max(float((g.double() - w.double()).abs().max() / w.double().abs().max())
                  for g, w in zip(got, want))
        del got, want
        res[label] = {"graph_ms": _graph_ms(call), "kernels": _split(call), "err": err}
    with open(out, "w") as f:
        json.dump(res, f)


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi unavailable"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other tree's src directory")
    ap.add_argument("--repeat", type=int, default=1, help="rounds of base, this, this, base")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # the child process's output file
    args = ap.parse_args()
    if args.run:
        run(args.run)
        return 0
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the A/B runs on the card only", file=sys.stderr)
        return 2
    trees = {"base": Path(args.base).resolve(), "this": ROOT / "src"}
    runs = {"base": [], "this": []}
    with tempfile.TemporaryDirectory() as d:
        for r in range(args.repeat):
            for i, name in enumerate(("base", "this", "this", "base")):
                out = os.path.join(d, f"{r}_{i}.json")
                subprocess.run([sys.executable, __file__, "--base", args.base, "--run", out],
                               check=True, cwd=ROOT,
                               env={**os.environ, "PYTHONPATH": str(trees[name])})
                with open(out) as f:
                    runs[name].append(json.load(f))
                print(json.dumps({"tree": name, "round": r, **{
                    k: {"graph_ms": v["graph_ms"], "err": v["err"]}
                    for k, v in runs[name][-1].items()}}), flush=True)
    print(_card())
    summary = {}
    for label, *_ in SHAPES:
        mean = {n: sum(x[label]["graph_ms"] for x in runs[n]) / len(runs[n]) for n in runs}
        summary[label] = {"base_graph_ms": mean["base"], "this_graph_ms": mean["this"],
                          "speedup": mean["base"] / mean["this"],
                          "base_kernels": runs["base"][0][label]["kernels"],
                          "this_kernels": runs["this"][0][label]["kernels"],
                          "base_err": max(x[label]["err"] for x in runs["base"]),
                          "this_err": max(x[label]["err"] for x in runs["this"])}
    print(json.dumps({"card": torch.cuda.get_device_name(0), "ssd_scan_bwd": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
