"""SLED serving launcher: a thin argparse -> ServeSpec adapter.

The port of ``repro.launch.serve``: translate flags into a
:class:`~repro_torch.api.ServeSpec`, build a :class:`~repro_torch.api.System`
on ``--device``, and print the run. The flags are the JAX launcher's (the
legacy ones map 1:1 onto spec fields) plus ``--device``, and two make runs
reproducible from a single artifact:

    --dump-spec      print the resolved ServeSpec as JSON and exit (the
                     JAX launcher's JSON for the same flags)
    --spec PATH      run a ServeSpec JSON from disk (flags that shape the
                     deployment are ignored; --check/--dump-spec/--telemetry
                     still apply)

Backends (``--backend``, or inferred from the legacy ``--transport`` flag):

  reference  lock-step sled_generate loop (algorithmic ground truth)
  engine     in-process ServerEngine
  cluster    Router over N engine replicas (``--replicas``); per-replica
             placement (including remote worker processes) is spec-only —
             see examples/specs/cluster_remote.json
  transport  wire-protocol runtime over loopback or simulated links

On lossless links with fixed k every backend must be token-for-token
identical to the reference loop; ``--check`` (default on) verifies it by
running the reference backend on the same built models. The run is on the
card (``--device cuda``, the default; it raises without one) unless
``--device cpu`` asks for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.serve --devices 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --transport sim --net wlan
    python -m repro_torch.cli serve --spec examples/specs/cluster.json --check
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from repro_torch.api import ServeSpec, SpecError, System
from repro_torch.api.spec import (
    BACKENDS,
    ClusterSpec,
    ModelSpec,
    PLACEMENTS,
    POLICIES,
    QMODES,
    SchedulerSpec,
    TransportSpec,
)
from repro_torch.runtime import resolve_device
from repro_torch.serving.devices import NETS


def spec_from_args(args) -> ServeSpec:
    """Map the (legacy) flag soup onto the declarative spec, 1:1."""
    if args.backend:
        backend = args.backend
    elif args.transport == "inproc":
        backend = "cluster" if args.replicas > 1 else "engine"
    else:
        backend = "transport"
    return ServeSpec(
        backend=backend,
        model=ModelSpec(
            arch=args.arch,
            vocab_size=256,
            bits=args.bits,
            draft_noise=args.draft_noise,
        ),
        transport=TransportSpec(
            link="sim" if args.transport == "sim" else "loopback",
            net=args.net,
            qmode=args.qmode,
            pipeline=args.pipeline,
            verify_timeout=args.verify_timeout,
            stagger_s=args.stagger_s,
        ),
        cluster=ClusterSpec(replicas=args.replicas, placement=args.placement),
        scheduler=SchedulerSpec(
            policy=args.policy,
            max_wait=args.max_wait,
            slots=args.slots,
            straggler_timeout=args.verify_timeout,
            stagger_ticks=args.stagger,
        ),
        devices=args.devices,
        max_new=args.max_new,
        k_max=args.k_max,
        c_th=args.c_th,
        kctl=args.kctl,
        cctl=args.cctl,
        paged_attention=args.paged_attention,
        telemetry=args.telemetry,
    )


def serve(spec: ServeSpec, *, check: bool = True, device="cuda") -> dict:
    """Build the spec's System on ``device``, run the fleet, print the run,
    return the uniform ServeResult record."""
    dev = resolve_device(device)
    system = System.build(spec, device=dev)
    if spec.cluster.n_replicas > 1 or spec.cluster.has_remote:
        flavors = [r.flavor for r in spec.cluster.replica_specs]
        sharing = (
            "worker processes on the v3 control plane"
            if spec.cluster.has_remote
            else "shared step bundle"
        )
        print(
            f"cluster: {spec.cluster.n_replicas} replicas "
            f"({', '.join(flavors)}) x {spec.slots_per_replica} slots, "
            f"placement {spec.cluster.placement}, {sharing}"
        )
    if spec.transport.link == "sim" and spec.backend == "transport":
        net = NETS[spec.transport.net]
        print(
            f"simulated links: rtt {net.rtt_mean*1e3:.1f}ms ± {net.rtt_jitter*1e3:.1f}ms, "
            f"{net.bandwidth_bps/1e6:.0f} Mbps, drop {net.drop_prob:.1%}"
        )
    if spec.model.bits < 16:
        print(f"serving int{spec.model.bits} weight-only quantized target")

    try:
        result = system.serve()
    except BaseException:
        system.close()  # reap any spawned workers before surfacing the error
        raise
    st = result.engine
    print(
        f"[{spec.backend}] served {st.streams_served or len(result.sessions)} streams, "
        f"{result.total_tokens} tokens in {st.rounds} rounds / {result.wall_seconds:.1f}s "
        f"({st.wstgr:.1f} tok/s) — mean fill {st.mean_batch_fill:.2f}/{spec.devices}, "
        f"{st.partial_rounds} partial, queue depth {st.mean_queue_depth:.2f}, "
        f"acceptance {st.acceptance_rate:.2f}"
    )
    if result.telemetry:
        snap = result.telemetry.get("snapshot", {})
        print(
            f"telemetry: {len(snap.get('counters', {}))} counters, "
            f"{len(snap.get('gauges', {}))} gauges, "
            f"{len(snap.get('histograms', {}))} histograms, "
            f"{len(result.telemetry.get('flight', []))} flight-recorder rows"
        )
    if result.clients is not None:
        fleet = result.clients
        print(
            f"wire: {st.bytes_rx} B up / {st.bytes_tx} B down in "
            f"{st.frames_rx + st.frames_tx} frames, "
            f"{st.frames_dropped + fleet.frames_dropped} dropped — "
            f"pipeline {fleet.pipeline_hits} hits / {fleet.pipeline_misses} misses, "
            f"{fleet.fallback_rounds} fallback rounds "
            f"({st.fallback_tokens} unverified tokens)"
        )
        if spec.kctl == "adaptive":
            print(f"adaptive k: mean {fleet.k_mean:.2f}, final {fleet.k_final} "
                  f"(k_max {spec.k_max})")
    if spec.cluster.n_replicas > 1:
        print(
            f"cluster: per-replica rounds "
            f"{[s.rounds for s in system.engine.replica_stats()]}, "
            f"{system.engine.migrations} migrations, "
            f"{system.engine.evictions} evictions"
        )
    system.close()  # drain remote workers; reap the ones this run spawned

    if check:
        if spec.backend == "reference":
            pass  # the reference IS the check target
        elif st.fallback_tokens:
            print("skipping equivalence check: fallback released unverified tokens")
        elif spec.kctl != "fixed":
            print("skipping equivalence check: adaptive spec length changes round shapes")
        elif spec.fleet.active:
            # heterogeneous fleet: each class is internally homogeneous, so
            # check every class against its own lock-step reference on the
            # SAME prompt slice the fleet run served (devices lo..hi)
            prompts = system.prompts()
            match = True
            for lo, hi, refspec in spec.fleet_reference_specs():
                ref = System.build(refspec, device=dev).serve(prompts[lo:hi])
                # the reference slice serves as devices 0..count-1; the
                # fleet run served the same prompts as devices lo..hi-1
                if any(
                    ref.outputs[i] != result.outputs[lo + i]
                    for i in range(hi - lo)
                ):
                    match = False
            n = len(spec.fleet.classes)
            print(f"greedy per-class reference match ({n} classes): "
                  f"{'OK' if match else 'MISMATCH'}")
            assert match, (
                f"{spec.backend} fleet serving must be output-identical to "
                "the per-class lock-step references"
            )
        else:
            ref = System.build(
                spec.with_backend("reference"), models=system.models, device=dev
            ).serve()
            match = ref.outputs == result.outputs
            print(f"greedy lock-step reference match: {'OK' if match else 'MISMATCH'}")
            assert match, (
                f"{spec.backend} serving must be output-identical to the "
                "lock-step reference"
            )
    return result.to_json()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro-torch serve",
        description="Serve a SLED deployment from a ServeSpec (or legacy flags).",
        epilog="Legacy flags are deprecated: prefer --spec FILE; use "
               "--dump-spec to capture any flag combination as a spec artifact.",
    )
    ap.add_argument("--spec", type=str, default="",
                    help="run a ServeSpec JSON artifact (deployment flags ignored)")
    ap.add_argument("--dump-spec", action="store_true",
                    help="print the resolved ServeSpec JSON and exit")
    ap.add_argument("--backend", choices=BACKENDS, default="",
                    help="execution backend (default: inferred from --transport)")
    ap.add_argument("--arch", type=str, default="qwen2-1.5b")
    ap.add_argument("--transport", choices=("loopback", "sim", "inproc"), default="loopback",
                    help="[legacy] loopback/sim -> backend=transport; "
                         "inproc -> backend=engine (or cluster with --replicas>1)")
    ap.add_argument("--net", choices=sorted(NETS), default="wlan",
                    help="NetProfile for simulated links")
    ap.add_argument("--devices", type=int, default=6)
    ap.add_argument("--replicas", type=int, default=1,
                    help="server engine replicas behind the cluster router")
    ap.add_argument("--placement", choices=PLACEMENTS, default="least-loaded",
                    help="replica placement policy for new streams")
    ap.add_argument("--kctl", choices=("fixed", "adaptive"), default="fixed",
                    help="spec-length control: fixed k_max, or closed-loop "
                         "AIMD on Verdict acceptance/queue-depth feedback")
    ap.add_argument("--cctl", choices=("fixed", "adaptive"), default="fixed",
                    help="confidence-threshold control: fixed c_th, or "
                         "per-device adaptation on Verdict acceptance "
                         "feedback (transport backend, qmode >= int8)")
    ap.add_argument("--slots", type=int, default=0,
                    help="cache pool rows PER REPLICA (0: ceil(devices/replicas))")
    ap.add_argument("--k-max", type=int, default=4)
    ap.add_argument("--c-th", type=float, default=0.3)
    ap.add_argument("--max-new", "--steps", dest="max_new", type=int, default=24,
                    help="tokens committed per device")
    ap.add_argument("--policy", choices=POLICIES, default="continuous")
    ap.add_argument("--max-wait", type=float, default=0.05)
    ap.add_argument("--qmode", choices=QMODES, default="none",
                    help="draft-probability payload precision on the wire")
    ap.add_argument("--pipeline", action=argparse.BooleanOptionalAction, default=True,
                    help="draft ahead while a verify round is in flight")
    ap.add_argument("--paged-attention", action=argparse.BooleanOptionalAction, default=True,
                    help="slot-indexed verify attention straight out of the KV "
                         "pool (gather/scatter fallback when off or unsupported)")
    ap.add_argument("--verify-timeout", type=float, default=30.0,
                    help="device-side round timeout before §III-A fallback "
                         "(generous default: the first rounds build the kernels)")
    ap.add_argument("--stagger", type=int, default=3,
                    help="in-process: device i joins i*stagger scheduler ticks in")
    ap.add_argument("--stagger-s", type=float, default=0.2,
                    help="transport: device i joins i*stagger_s seconds in")
    ap.add_argument("--bits", type=int, default=16, choices=(4, 8, 16))
    ap.add_argument("--draft-noise", type=float, default=0.0,
                    help="perturb draft params (random-init models otherwise "
                         "agree greedily -> trivial 1.0 acceptance)")
    ap.add_argument("--check", action=argparse.BooleanOptionalAction, default=True,
                    help="verify output equals the lock-step reference")
    ap.add_argument("--telemetry", action=argparse.BooleanOptionalAction, default=False,
                    help="collect the metrics registry + per-round traces "
                         "(repro_torch.telemetry); observation-only, off by default")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the models run (cuda, the default, raises without a card)")
    return ap


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    try:
        if args.spec:
            try:
                with open(args.spec) as f:
                    spec = ServeSpec.from_json(f.read())
            except OSError as e:
                raise SystemExit(f"cannot read spec {args.spec}: {e}")
            print(f"loaded ServeSpec from {args.spec} (backend={spec.backend})")
            if args.telemetry:
                # observation-only, so (like --check) it composes with --spec
                # instead of being ignored with the deployment-shaping flags
                spec = dataclasses.replace(spec, telemetry=True)
        else:
            spec = spec_from_args(args)
    except SpecError as e:
        raise SystemExit(f"invalid ServeSpec: {e}")
    if args.dump_spec:
        print(spec.to_json_str())
        return
    if not args.spec:
        print("note: flag-driven config is deprecated — rerun with --dump-spec "
              "to capture this run as a ServeSpec artifact (repro-torch serve --spec FILE)")
    serve(spec, check=args.check, device=args.device)


if __name__ == "__main__":
    main()
