"""``python -m repro_torch.launch.tune`` — profiling-driven
auto-configuration of a fleet spec (the port of ``repro tune``).

    python -m repro_torch.launch.tune --spec examples/specs/fleet.json \
        --quick --server h100 --json bench.json --out tuned.json
    python -m repro_torch.launch.tune --spec examples/specs/fleet.json \
        --quick --device cpu

Profiles a short measured run of the fleet (per-class acceptance, verify
span calibration), sweeps per-class candidates (k, c_th, draft model,
quant bits; placement when there is a replica set) through the calibrated
simulator + Eq. 2 cost model, validates the top candidates on the real
engine, and emits:

  stdout         the sweep narrative + winning per-class configuration
  --out PATH     the winning ServeSpec as a committable JSON artifact
  --json PATH    the full BENCH record: calibration, every scored
                 candidate, real-engine validation rows

It runs on the card (``--device cuda``, the default; it raises without
one) unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

from repro_torch.api import ServeSpec, SpecError
from repro_torch.runtime import resolve_device
from repro_torch.serving.devices import SERVERS
from repro_torch.tuning import TuneConfig, tune


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.tune",
        description="Auto-tune a heterogeneous fleet ServeSpec from a "
                    "profiled run (see src/repro_torch/tuning/).",
    )
    ap.add_argument("--spec", type=str, required=True,
                    help="fleet ServeSpec JSON artifact (fleet.classes non-empty)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller sweep axes + shorter probes (CI smoke)")
    ap.add_argument("--server", choices=sorted(SERVERS), default="a100x4",
                    help="ServerProfile for roofline calibration + Eq. 2 cost")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-round deadline seconds (0: derive from the "
                         "profiled round latency)")
    ap.add_argument("--miss-cap", type=float, default=0.1,
                    help="matched deadline-miss rate across candidates")
    ap.add_argument("--validate", type=int, default=2,
                    help="finalists to re-measure on the real engine")
    ap.add_argument("--validate-mult", type=int, default=1,
                    help=">1: rank surviving finalists by throughput with "
                         "the fleet scaled by this factor (stress ranking)")
    ap.add_argument("--json", type=str, default="",
                    help="write the full tuning record as a BENCH artifact")
    ap.add_argument("--out", type=str, default="",
                    help="write the winning ServeSpec JSON here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the profiling and validation serves run "
                         "(cuda, the default, raises without a card)")
    return ap


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    try:
        with open(args.spec) as f:
            spec = ServeSpec.from_json(f.read())
    except OSError as e:
        raise SystemExit(f"cannot read spec {args.spec}: {e}")
    except SpecError as e:
        raise SystemExit(f"invalid ServeSpec: {e}")
    if not spec.fleet.active:
        raise SystemExit(
            f"{args.spec} has no fleet.classes — the tuner configures "
            "heterogeneous fleets (see examples/specs/fleet.json)"
        )
    tcfg = TuneConfig(
        server=args.server,
        deadline_s=args.deadline,
        miss_cap=args.miss_cap,
        n_validate=args.validate,
        validate_mult=args.validate_mult,
        quick=args.quick,
    )
    result = tune(spec, tcfg, device=device)
    if args.out:
        with open(args.out, "w") as f:
            f.write(result.winner.to_json_str())
        print(f"wrote winning spec to {args.out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"benchmark": "tune", "quick": args.quick,
                       **result.to_json()}, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
