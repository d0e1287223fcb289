"""Time the port's CUDA kernel entries at the serving paths' main shapes, for
this checkout or against other source trees in turns (on an H100).

    python3 benchmarks/torch_kernel_ab.py                          # this checkout
    git archive <commit> | tar -x -C build/base                    # an ignored directory
    python3 benchmarks/torch_kernel_ab.py --base build/base/src    # base, this, this, base

Each version runs in a process of its own (both packages are named
``repro_torch``), builds its kernels from its own sources, and prints one JSON
line per shape. With ``--base`` (repeatable) the processes run in the order
base..., this, this, ...base (``--repeat`` times), and a summary with the
mean of each version's runs follows; a base is labelled by the name of the directory above its
``src`` (``build/base/src`` -> ``base``). Inputs come from a seeded generator
on the card and are the same for every version; the timing helpers are this
checkout's (``chip_smoke.py``), so every version is timed the same way. Per
shape:
  ms        back-to-back calls from Python, as the eager serve pays them
            (host time of the wrapper included): the median of 5 rounds of
            50 calls;
  host_us   the host's time to issue one call (wrapper, checks, launch),
            without waiting for the card: the median of 5 rounds of 1000;
  graph_ms  device time per call: a CUDA graph of 56 calls on one layer of
            the stacked cache (K/V warm in the 50 MB L2 after the first
            call), without the host;
  walk_graph_ms  the same, the graph's calls walking the 28 layers of the
            stacked cache in turn, as the model's layer loop reads them (at
            the verify shape ~100 MB of K/V, cold in L2);
  SSD shapes also give y_err / state_err, the largest absolute differences
            from the version's own plain scan (kernels/ref.py) on the card.
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 28  # qwen2-1.5b
GRAPH_CALLS = 2 * LAYERS
# (name, entry, kv dtype, B, Sq, Hq, Hkv, D, Skv, kv_valid, slots)
ATTN_SHAPES = [
    ("draft decode", "packed", "bf16", 1, 1, 12, 2, 128, 512, [230], None),
    ("engine verify bf16", "paged", "bf16", 6, 5, 12, 2, 128, 512,
     [205, 233, 240, 5, 5, 5], [3, 0, 5, 6, 6, 6]),
    ("engine verify int8", "paged", "int8", 6, 5, 12, 2, 128, 512,
     [205, 233, 240, 5, 5, 5], [3, 0, 5, 6, 6, 6]),
    ("slot prefill int8", "packed", "int8", 1, 199, 12, 2, 128, 512, [199], None),
]
# (name, B, S, H, P, N, chunk): mamba2-370m
SSD_SHAPES = [
    ("ssd prefill S=199", 1, 199, 32, 64, 128, 256),
    ("ssd S=512", 1, 512, 32, 64, 128, 256),
    ("ssd B=2 S=300", 2, 300, 32, 64, 128, 256),
]
KEYS = ("ms", "host_us", "graph_ms", "walk_graph_ms", "y_err", "state_err")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _host_us(fn, iters: int = 1000, rounds: int = 5) -> float:
    """Host time to issue one call, without waiting for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        res.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return _median(res)


def worker(src: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import build, ref, ssd_scan, verify_attn

    # the timing helpers of this checkout's chip_smoke.py (imported after
    # the version under test, whose package stays the one in use)
    sys.path.insert(1, str(ROOT))
    from chip_smoke import _graph_ms, _time_ms

    for name in ("verify_attn", "ssd_scan"):
        build.build(name)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for name, entry, kv, B, Sq, Hq, Hkv, D, Skv, kvv, slots in ATTN_SHAPES:
        rows = (max(slots) + 1) if slots is not None else B
        k = rnd(LAYERS, rows, Skv, Hkv, D).to(torch.bfloat16)
        v = rnd(LAYERS, rows, Skv, Hkv, D).to(torch.bfloat16)
        ks = vs = None
        if kv == "int8":
            ks = k.float().abs().amax(dim=(2, 4)) / 127.0 + 1e-6
            vs = v.float().abs().amax(dim=(2, 4)) / 127.0 + 1e-6
            k = torch.round(k.float() / ks[:, :, None, :, None]).clamp(-127, 127).to(torch.int8)
            v = torch.round(v.float() / vs[:, :, None, :, None]).clamp(-127, 127).to(torch.int8)
        q = rnd(B, Sq, Hq, D).to(torch.bfloat16)
        kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
        sl = torch.tensor(slots, dtype=torch.int32, device=dev) if slots is not None else None

        def call(layer, q=q, k=k, v=v, ks=ks, vs=vs, kv_valid=kv_valid, sl=sl, entry=entry):
            if entry == "paged":
                return verify_attn.verify_attention_paged(q, k, v, sl, kv_valid, layer=layer,
                                                          k_scale=ks, v_scale=vs)
            return verify_attn.verify_attention_packed(q, k, v, kv_valid, layer=layer,
                                                       k_scale=ks, v_scale=vs)

        kv_mb = (k.numel() * k.element_size() * 2) / 1e6
        last = lambda call=call: call(LAYERS - 1)  # noqa: E731
        print(json.dumps({
            "shape": name, "ms": _median([_time_ms(last) for _ in range(5)]),
            "host_us": _host_us(last), "graph_ms": _graph_ms([last] * GRAPH_CALLS),
            "walk_graph_ms": _graph_ms([lambda li=li: call(li) for li in range(LAYERS)] * 2),
            "stacked_kv_mb": kv_mb,
        }), flush=True)

    for name, B, S, H, P, N, chunk in SSD_SHAPES:
        xbc = rnd(B, S, H * P + 2 * N).to(torch.bfloat16)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        A = -torch.exp(rnd(H) * 0.5)
        h0 = rnd(B, H, P, N)

        def scan(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, h0=h0, chunk=chunk):
            return ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)

        (y, h), (y_p, h_p) = scan(), ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk)
        print(json.dumps({
            "shape": name, "ms": _median([_time_ms(scan) for _ in range(5)]),
            "host_us": _host_us(scan), "graph_ms": _graph_ms([scan] * GRAPH_CALLS),
            "y_err": (y.float() - y_p.float()).abs().max().item(),
            "state_err": (h - h_p).abs().max().item(),
        }), flush=True)


def run(src: str, label: str) -> list:
    out = subprocess.run([sys.executable, __file__, "--worker", src], capture_output=True,
                         text=True, cwd=ROOT)
    if out.returncode != 0:
        raise RuntimeError(f"{label} ({src}) failed:\n{out.stdout}\n{out.stderr}")
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    for ln in lines:
        print(json.dumps({"version": label, **ln}), flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", action="append", default=[],
                    help="src/ directory of a version to compare against (repeatable)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="times to run the order base..., this, this, ...base")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    this = str(ROOT / "src")
    if not args.base:
        run(this, "this")
        return 0
    bases = [(src, Path(src).resolve().parent.name) for src in args.base]
    order = (bases + [(this, "this"), (this, "this")] + bases[::-1]) * args.repeat
    runs = {label: [] for _, label in order}
    for src, label in order:
        runs[label].append(run(src, label))
    summary = {}
    for label, each in runs.items():
        for lines in zip(*each):  # one shape's line from every run of this version
            summary.setdefault(lines[0]["shape"], {})[label] = {
                key: sum(ln[key] for ln in lines) / len(lines) for key in KEYS if key in lines[0]}
    print(json.dumps({"card": smi, "runs_per_version": 2 * args.repeat,
                      "mean_of_runs": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
