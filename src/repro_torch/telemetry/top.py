"""``top`` and ``trace``: fleet observability front-ends.

The port of ``repro.telemetry.top`` (``python -m repro_torch.cli top`` and
``... trace``). ``top`` is a live refreshing table over the cluster control
plane: it
dials each worker's control socket with its OWN :class:`ControlChannel`
(never sharing a Router's blocking socket), polls ``StatsRequest``, and
renders per-replica fill, acceptance, p50/p95 round latency, and the
speculation-length histogram from the telemetry payload riding codec v3
``ReplicaStats`` frames.  The last-seen payload is kept per replica, so when
a worker dies mid-poll its flight-recorder rows — the last N rounds it
served — are printed as a post-mortem instead of silently disappearing.

``trace`` runs a spec with telemetry forced on and dumps the per-round
:class:`~repro_torch.telemetry.trace.TraceEvent` records as JSONL (one event
per line, globally time-ordered), plus an optional Prometheus text
exposition. ``render`` is a pure function of the views' last-seen dicts and
gives the JAX package's text for the same dicts. ``--demo`` and ``trace``
build the spec's System on ``--device`` (cuda, the default, raises without
a card; the tests pass cpu).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from typing import List, Optional

from repro_torch import telemetry

_SPARK = "▁▂▃▄▅▆▇█"
DEMO_READY_S = 300.0  # longest wait for the demo's first serve pass


def _sparkline(per_bucket: List[int]) -> str:
    top = max(per_bucket) if per_bucket else 0
    if top <= 0:
        return "-"
    return "".join(_SPARK[min(len(_SPARK) - 1, (c * len(_SPARK)) // (top + 1))]
                   for c in per_bucket)


def _hist(payload: Optional[dict], name: str) -> Optional[dict]:
    if not payload:
        return None
    return (payload.get("snapshot") or {}).get("histograms", {}).get(name)


def _gauge(payload: Optional[dict], name: str) -> Optional[float]:
    if not payload:
        return None
    return (payload.get("snapshot") or {}).get("gauges", {}).get(name)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _per_bucket(h: dict) -> List[int]:
    """De-cumulate snapshot bucket rows ([[le, cum], ...]) into raw counts."""
    prev, out = 0, []
    for _, cum in h.get("buckets", []):
        out.append(int(cum) - prev)
        prev = int(cum)
    return out


class ReplicaView:
    """Last-seen state of one worker: stats + telemetry survive the worker."""

    def __init__(self, idx: int, address: str):
        self.idx = idx
        self.address = address
        self.channel = None
        self.stats: Optional[dict] = None
        self.telemetry: Optional[dict] = None
        self.alive = False
        self.error = ""

    def poll(self) -> None:
        from repro_torch.cluster.remote import ControlChannel, ReplicaGone, WorkerError
        from repro_torch.transport import codec

        try:
            if self.channel is None:
                self.channel = ControlChannel(self.address, timeout=5.0)
            reply = self.channel.request(codec.StatsRequest(now=0.0, has_now=False))
            self.stats = json.loads(reply.stats_json)
            if reply.telemetry_json:
                self.telemetry = json.loads(reply.telemetry_json)
            self.alive = True
            self.error = ""
        except WorkerError as e:  # alive, but e.g. no engine placed yet
            self.alive = True
            self.error = str(e)
        except (ReplicaGone, OSError) as e:
            self.alive = False
            self.error = str(e)
            self.channel = None

    def row(self) -> str:
        addr = self.address if len(self.address) <= 34 else "…" + self.address[-33:]
        if not self.alive:
            return f"{self.idx:<3} {addr:<34} {'LOST':<5} {self.error[:40]}"
        if self.stats is None:
            return f"{self.idx:<3} {addr:<34} {'up':<5} ({self.error or 'no stats yet'})"
        st = self.stats
        lat = _hist(self.telemetry, "engine_round_latency_seconds")
        p50 = f"{lat['p50'] * 1e3:7.2f}" if lat else "      -"
        p95 = f"{lat['p95'] * 1e3:7.2f}" if lat else "      -"
        kh = _hist(self.telemetry, "engine_k")
        spark = _sparkline(_per_bucket(kh)) if kh else "-"
        # adaptive confidence controllers publish cctl_c_th; fixed -> "-"
        ch = _hist(self.telemetry, "cctl_c_th")
        cspark = _sparkline(_per_bucket(ch)) if ch else "-"
        # KV-pool capacity gauges (int8 pools show ~half the bytes/slot)
        pool_b = _gauge(self.telemetry, "engine_kv_pool_bytes")
        slot_b = _gauge(self.telemetry, "engine_bytes_per_slot")
        pool = _fmt_bytes(pool_b) if pool_b else "-"
        bslot = _fmt_bytes(slot_b) if slot_b else "-"
        return (
            f"{self.idx:<3} {addr:<34} {'up':<5} "
            f"{st.get('streams_served', 0):>6} {st.get('rounds', 0):>7} "
            f"{st.get('mean_batch_fill', 0.0):>5.2f} "
            f"{st.get('acceptance_rate', 0.0):>6.3f} "
            f"{bslot:>8} {pool:>8} {p50} {p95}  {spark:<9} {cspark}"
        )


_HEADER = (
    f"{'ID':<3} {'ADDRESS':<34} {'STATE':<5} "
    f"{'SERVED':>6} {'ROUNDS':>7} {'FILL':>5} {'ACCEPT':>6} "
    f"{'B/SLOT':>8} {'POOL':>8} "
    f"{'p50ms':>7} {'p95ms':>7}  {'K':<9} C_TH"
)


def render(views: List[ReplicaView], flight: int) -> str:
    lines = ["repro top — fleet control-plane poll", _HEADER]
    lines += [v.row() for v in views]
    for v in views:
        if v.alive or not v.telemetry:
            continue
        rows = (v.telemetry.get("flight") or [])[-flight:]
        if not rows:
            continue
        lines.append(f"-- replica {v.idx} lost: last {len(rows)} rounds "
                     f"from its flight recorder --")
        for ev in rows:
            lines.append(
                f"   dev={ev.get('device_id')} round={ev.get('round')} "
                f"k={ev.get('k')} acc={ev.get('n_accepted')} "
                f"commit={ev.get('n_commit')} queue={ev.get('queue_s', 0.0):.4f}s "
                f"verify={ev.get('verify_s', 0.0):.4f}s"
                + (" FALLBACK" if ev.get("fallback") else "")
            )
    return "\n".join(lines)


def _spec_addresses(spec) -> List[str]:
    return [r.address for r in spec.cluster.replica_specs
            if r.flavor == "remote" and r.address]


def _load_spec(path: str):
    from repro_torch.api.spec import ServeSpec

    with open(path) as f:
        return ServeSpec.from_json(f.read())


def _start_demo(spec, device: str) -> tuple:
    """Build the spec's fleet on ``device`` (spawning its workers there),
    drive serve() rounds in a daemon thread for load, and return (system,
    worker addresses, stop event, thread) once the first serve pass has
    ended (at most ``DEMO_READY_S``; the JAX demo returns at once), so the
    first frame already shows the fleet under load: on the card a worker's
    first steps load the kernels and library handles, which takes longer
    than a few refreshes."""
    from repro_torch.api.system import System

    spec = dataclasses.replace(spec, telemetry=True)
    system = System.build(spec, device=device)
    addrs = [r.address for r in system.engine.replicas
             if getattr(r, "flavor", "local") == "remote"]
    stop, ready = threading.Event(), threading.Event()

    def serve_loop():
        try:
            system.warmup()
            while not stop.is_set():
                system.serve()
                ready.set()
        except Exception:
            pass  # demo load only; the table keeps polling regardless
        finally:
            ready.set()

    thread = threading.Thread(target=serve_loop, daemon=True)
    thread.start()
    ready.wait(timeout=DEMO_READY_S)
    return system, addrs, stop, thread


def main_top(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro-torch top",
        description="Live fleet table over worker control sockets.",
    )
    ap.add_argument("--connect", action="append", default=[],
                    help="worker control address to poll (repeatable)")
    ap.add_argument("--spec", type=str, default="",
                    help="ServeSpec JSON: poll its remote replicas' addresses")
    ap.add_argument("--demo", action="store_true",
                    help="with --spec: spawn the fleet and drive load while topping")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--iterations", type=int, default=0,
                    help="stop after N refreshes (0 = until interrupted)")
    ap.add_argument("--no-clear", action="store_true",
                    help="append refreshes instead of clearing the screen (CI)")
    ap.add_argument("--flight", type=int, default=8,
                    help="flight-recorder rows shown for a lost replica")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="--demo: where the fleet runs (cuda, the default, "
                         "raises without a card)")
    args = ap.parse_args(argv)

    system = stop = demo_thread = None
    addresses = list(args.connect)
    if args.spec:
        spec = _load_spec(args.spec)
        if args.demo:
            system, demo_addrs, stop, demo_thread = _start_demo(spec, args.device)
            addresses += demo_addrs
        else:
            addresses += _spec_addresses(spec)
    if not addresses:
        ap.error("nothing to poll: pass --connect ADDR, or --spec with remote "
                 "replica addresses (or --spec ... --demo to spawn a fleet)")

    views = [ReplicaView(i, a) for i, a in enumerate(addresses)]
    try:
        n = 0
        while True:
            for v in views:
                v.poll()
            frame = render(views, flight=args.flight)
            if not args.no_clear:
                print("\x1b[2J\x1b[H", end="")
            print(frame, flush=True)
            n += 1
            if args.iterations and n >= args.iterations:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if stop is not None:
            stop.set()
        if demo_thread is not None:
            # let the in-flight serve pass finish before the workers are
            # drained under it
            demo_thread.join(timeout=60.0)
        if system is not None:
            system.close()


def main_trace(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro-torch trace",
        description="Run a spec with telemetry on; dump per-round trace JSONL.",
    )
    ap.add_argument("--spec", type=str, default="",
                    help="ServeSpec JSON (default: the built-in engine spec)")
    ap.add_argument("--out", type=str, default="trace.jsonl")
    ap.add_argument("--exposition", type=str, nargs="?", const="-", default="",
                    help="also emit the Prometheus text exposition "
                         "(to PATH, or stdout when given bare)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the spec runs (cuda, the default, raises without a card)")
    args = ap.parse_args(argv)

    from repro_torch.api.spec import ServeSpec
    from repro_torch.api.system import System

    spec = _load_spec(args.spec) if args.spec else ServeSpec(backend="engine")
    spec = dataclasses.replace(spec, telemetry=True)
    system = System.build(spec, device=args.device)
    try:
        system.warmup()
        result = system.serve()
    finally:
        system.close()
    rows = sorted((ev.to_json() for ev in result.trace),
                  key=lambda e: (e["t"], e["device_id"], e["round"]))
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    # parse-check the snapshot round trip before reporting success
    snapshot = json.loads(json.dumps(telemetry.registry().snapshot()))
    if args.exposition == "-":
        print(telemetry.registry().exposition(), end="")
    elif args.exposition:
        with open(args.exposition, "w") as f:
            f.write(telemetry.registry().exposition())
    devices = sorted({r["device_id"] for r in rows})
    print(f"wrote {len(rows)} trace events for {len(devices)} devices -> {args.out}")
    print(f"registry: {len(snapshot['counters'])} counters, "
          f"{len(snapshot['gauges'])} gauges, "
          f"{len(snapshot['histograms'])} histograms"
          + (f"; exposition -> {args.exposition}"
             if args.exposition and args.exposition != "-" else ""))


if __name__ == "__main__":
    main_top()
