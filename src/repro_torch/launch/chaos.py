"""Run a deterministic fault schedule against a fleet of replicas.

The port of ``repro.launch.chaos``: build a ServeSpec whose ``faults``
schedule kills, hangs or flaps replicas at fixed Router steps, serve it,
and report what the supervision did (evictions, respawns, recovered and
shed streams) and, with ``--check`` (the default), whether the tokens
equal those of the same spec served without faults::

    python -m repro_torch.launch.chaos --device cpu       # 2 replicas, kill #1 at step 5
    python -m repro_torch.launch.chaos --kill 1:5 --kill 0:9
    python -m repro_torch.launch.chaos --no-recover       # evict only
    python -m repro_torch.launch.chaos --flavor remote    # worker processes (a real SIGKILL)
    python -m repro_torch.launch.chaos --spec chaos.json --json out.json

It runs on the card (``--device cuda``, the default; it raises without
one) unless ``--device cpu`` asks for the CPU. The exit status is 1 when
``--check`` finds a divergence: with recovery every stream must equal the
fault-free one; without it every survivor must, and every shed stream
must be a prefix of its fault-free stream.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

from repro_torch.api import ServeSpec, System
from repro_torch.api.spec import ClusterSpec, FaultSpec, ModelSpec


def _parse_kill(text: str) -> dict:
    """``REPLICA:ROUND`` (or ``KIND:REPLICA:ROUND``) -> a FaultEvent dict."""
    parts = text.split(":")
    if len(parts) == 2:
        kind, replica, rnd = "kill", parts[0], parts[1]
    elif len(parts) == 3:
        kind, replica, rnd = parts
    else:
        raise argparse.ArgumentTypeError(
            f"bad fault {text!r} (want REPLICA:ROUND or KIND:REPLICA:ROUND)")
    return {"kind": kind, "replica": int(replica), "round": int(rnd)}


def spec_from_args(args) -> ServeSpec:
    events = tuple(args.kill) if args.kill else ({"kind": "kill", "replica": 1, "round": 5},)
    policy = {"respawn": args.recover, "recover_streams": args.recover,
              "backoff_base_s": args.backoff, "backoff_max_s": args.backoff * 8}
    replicas: object = args.replicas
    if args.flavor == "remote":
        replicas = [{"flavor": "remote"}] * args.replicas
    return ServeSpec(
        backend="cluster",
        model=ModelSpec(vocab_size=128, target_layers=2, draft_layers=1, draft_noise=0.03),
        cluster=ClusterSpec(replicas=replicas, faults=policy),
        devices=args.devices, max_new=args.max_new, k_max=4,
        faults=FaultSpec(seed=args.seed, events=events), telemetry=True,
    )


def check_streams(result, ref, recovered: bool) -> bool:
    """With recovery every stream equals the fault-free one; without it
    every survivor does and every shed stream is a prefix of its own."""
    want = ref.outputs
    if recovered:
        return result.outputs == want
    return all(want[s.device_id][:len(s.tokens)] == s.tokens if s.shed
               else s.tokens == want[s.device_id] for s in result.sessions)


def run_chaos(spec: ServeSpec, *, check: bool = True, device="cuda") -> dict:
    """Serve the chaos spec, print the supervision report, and return the
    record (the spec, the result, the report; ``report["check"]`` is "ok"
    or "mismatch" when checked)."""
    kinds = [f"{e.kind}@r{e.round}->replica{e.replica}" for e in spec.faults.events]
    print(f"chaos: {spec.cluster.n_replicas} replicas, {spec.devices} devices, schedule "
          f"[{', '.join(kinds)}] (seed {spec.faults.seed}), recovery "
          f"{'ON' if spec.cluster.faults.recover_streams else 'OFF'}", flush=True)
    with System.build(spec, device=device) as system:
        t0 = time.time()
        result = system.serve()
        wall = time.time() - t0
        router = system.engine
        models = system.models
    fired = list(router.chaos.fired) if router.chaos is not None else []
    report = {
        "fired": [{"round": r, "kind": k, "replica": i} for r, k, i in fired],
        "evictions": router.evictions, "respawns": router.respawns,
        "recovered_streams": router.recovered_streams, "shed_streams": router.shed_streams,
        "retries": sum(getattr(r, "retries", 0) for r in router.replicas),
        "lost_devices": sorted(result.lost_devices),
        "committed_tokens": result.total_tokens, "wall_seconds": wall,
        "tokens_per_s": result.total_tokens / max(wall, 1e-9),
    }
    for r, k, i in fired:
        print(f"  fired {k} on replica {i} at round {r}")
    print(f"supervision: {report['evictions']} evictions, {report['respawns']} respawns, "
          f"{report['recovered_streams']} streams recovered, {report['shed_streams']} shed "
          f"{report['lost_devices']}, {report['retries']} retried RPCs")
    print(f"served {result.total_tokens} tokens in {wall:.3f} s "
          f"({report['tokens_per_s']:.1f} tokens/s)", flush=True)
    if check:
        with System.build(dataclasses.replace(spec, faults=FaultSpec()), models=models,
                          device=device) as twin:
            ref = twin.serve()
        recovered = spec.cluster.faults.recover_streams
        ok = check_streams(result, ref, recovered)
        what = "fault-free token identity" if recovered else "survivors and shed prefixes"
        print(f"{what}: {'OK' if ok else 'MISMATCH'}", flush=True)
        report["check"] = "ok" if ok else "mismatch"
    return {"spec": spec.to_json(), "result": result.to_json(), "chaos": report}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.chaos",
                                 description="deterministic fault injection against a fleet")
    ap.add_argument("--spec", type=str, default="",
                    help="ServeSpec JSON file (its faults schedule runs as it is)")
    ap.add_argument("--kill", action="append", type=_parse_kill, default=None,
                    metavar="REPLICA:ROUND",
                    help="a fault event (repeatable); KIND:REPLICA:ROUND for "
                         "hang/drop/delay/flap")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--flavor", choices=("local", "remote"), default="local",
                    help="remote: spawned worker processes (a real SIGKILL)")
    ap.add_argument("--recover", action=argparse.BooleanOptionalAction, default=True,
                    help="respawn and device-replay recovery (off: evict only)")
    ap.add_argument("--backoff", type=float, default=0.05,
                    help="respawn backoff base seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--check", action=argparse.BooleanOptionalAction, default=True,
                    help="compare with the fault-free twin run")
    ap.add_argument("--json", type=str, default="",
                    help="write the record (spec, result, chaos report) to this file")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.spec:
        with open(args.spec) as f:
            spec = ServeSpec.from_json(f.read())
    else:
        spec = spec_from_args(args)
    record = run_chaos(spec, check=args.check, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2, default=str)
        print(f"wrote {args.json}")
    return 1 if record["chaos"].get("check") == "mismatch" else 0


if __name__ == "__main__":
    sys.exit(main())
