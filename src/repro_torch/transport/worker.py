"""Remote replica worker: one engine replica per OS process, behind a socket.

The port of ``repro.transport.worker``. Run one as::

    python -m repro_torch.transport.worker --listen uds:/tmp/w.sock [--spec FILE] \\
        [--device cuda|cpu]

It listens on a TCP or UDS address for the codec's control frames from a
cluster Router (``repro_torch.cluster.remote.RemoteReplica`` dials it):

  * ``PlaceReplica`` carries a serialized ServeSpec; the worker builds its
    engine through ``System.build``, so its weights come from the spec's
    model seed: two processes placing one spec on one kind of device hold
    the same weights, which keeps a cross-process fleet token-identical to
    the in-process cluster;
  * every driver RPC (admit / submit / step / retire / cancel /
    force-extend / export / import / stats / warmup) mirrors the
    ServerEngine surface, and every ``now`` is the Router's clock;
  * ``ExportStream``/``ImportStream`` move a stream's state and its pool
    row bit for bit (a bf16 leaf as its uint16 words, turned into a
    ``torch.bfloat16`` tensor by a bit view);
  * ``Drain`` acks and ends the process.

A connection that opens with a data-plane frame (``Hello``) is served by a
:class:`~repro_torch.transport.server.TransportServer` around the engine
instead (do not mix router-driven stepping and direct device service on
one worker: the two step clocks are independent).

The worker runs on the card unless ``--device cpu`` asks for the CPU; with
no card and no ``--device cpu`` it raises. Dispatch is transport-free in
:class:`WorkerCore` (message in, reply out), so tests drive the wire
dispatch without sockets or processes.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.admission import DeviceStream
from repro_torch.runtime import resolve_device
from repro_torch.transport import codec
from repro_torch.transport.links import Endpoint, listen_addr

log = logging.getLogger(__name__)


def row_to_wire(row: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """A pool row's leaves as codec leaves: numpy arrays, a bf16 leaf as
    :class:`~repro_torch.transport.codec.BF16Words` (its bits)."""
    out = {}
    for name, t in row.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[name] = codec.BF16Words(t.view(torch.int16).numpy().view(np.uint16))
        else:
            out[name] = t.numpy()
    return out


def row_from_wire(row: Dict[str, object], device: torch.device) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`row_to_wire`, on ``device``: a bit view, no cast."""
    out = {}
    for name, leaf in row.items():
        if isinstance(leaf, codec.BF16Words):
            t = torch.from_numpy(leaf.words.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(leaf))
        out[name] = t.to(device)
    return out


def stream_to_state(stream: DeviceStream, row: Optional[dict] = None) -> codec.StreamState:
    """A server-side DeviceStream for the wire (``row``: codec leaves)."""
    return codec.StreamState(
        device_id=stream.device_id,
        slot=stream.slot,
        prev_token=int(stream.prev_token),
        committed=tuple(int(t) for t in stream.committed),
        admitted_at=float(stream.admitted_at),
        rounds=int(stream.rounds),
        drafted=int(stream.drafted),
        accepted=int(stream.accepted),
        row={} if row is None else dict(row),
    )


def state_to_stream(state: codec.StreamState) -> DeviceStream:
    """Inverse of :func:`stream_to_state` (the row travels separately)."""
    return DeviceStream(
        device_id=state.device_id,
        slot=state.slot,
        prev_token=state.prev_token,
        committed=[int(t) for t in state.committed],
        admitted_at=state.admitted_at,
        rounds=state.rounds,
        drafted=state.drafted,
        accepted=state.accepted,
    )


def build_engine_from_spec(spec, device="cuda"):
    """One engine replica from a ServeSpec, through ``System.build`` on
    ``device`` (the backend forced to "engine")."""
    from repro_torch.api.system import System

    if spec.backend != "engine":
        spec = spec.with_backend("engine")
    return System.build(spec, device=device).engine


class WorkerCore:
    """Control-frame dispatch against one engine: message in, reply out.

    A handler's exception becomes an :class:`~repro_torch.transport.codec.ErrorReply`
    (the dialing side raises it again); the connection survives, since a
    refused RPC is a protocol answer, not a crash.

    Replay protection (v4): a side-effectful request with a non-zero
    ``seq`` is deduplicated through a bounded cache keyed by (frame type,
    device, seq), so a router that lost a reply can resend the frame and
    get the original reply instead of applying it twice.
    """

    REPLAY_CAP = 512  # cached replies; enough to cover any in-flight window

    _REPLAYABLE = (
        codec.AdmitRequest, codec.SubmitRequest, codec.StepRequest, codec.RetireRequest,
        codec.CancelRequest, codec.ForceExtendRequest, codec.ExportStream, codec.ImportStream,
    )

    def __init__(self, engine=None, *, device="cuda"):
        self.engine = engine
        self.device = resolve_device(device) if engine is None else engine.core.device
        self.draining = False
        self._replay: "OrderedDict[tuple, codec.Message]" = OrderedDict()
        self.replay_hits = 0

    def _replay_key(self, msg: codec.Message) -> Optional[tuple]:
        if not isinstance(msg, self._REPLAYABLE) or msg.seq == 0:
            return None
        if isinstance(msg, codec.ImportStream):
            dev = msg.stream.device_id
        else:
            dev = getattr(msg, "device_id", -1)
        return (type(msg).__name__, dev, msg.seq)

    def handle(self, msg: codec.Message) -> codec.Message:
        if isinstance(msg, codec.Ping):  # heartbeat: no engine, no side effects
            return codec.Pong(seq=msg.seq, t=msg.t)
        key = self._replay_key(msg)
        if key is not None and key in self._replay:
            self.replay_hits += 1
            telemetry.count("worker_replay_hits_total")
            return self._replay[key]
        try:
            reply = self._dispatch(msg)
        except Exception as e:  # answered to the router, not a crash here
            reply = codec.ErrorReply(f"{type(e).__name__}: {e}")
        if key is not None:
            self._replay[key] = reply
            while len(self._replay) > self.REPLAY_CAP:
                self._replay.popitem(last=False)
        return reply

    def _dispatch(self, msg: codec.Message) -> codec.Message:
        if isinstance(msg, codec.PlaceReplica):
            return self._place(msg)
        if isinstance(msg, codec.Drain):
            self.draining = True
            return codec.DrainAck(
                streams_left=0 if self.engine is None else len(self.engine.streams))
        if self.engine is None:
            raise RuntimeError("worker has no engine yet (send PlaceReplica first)")
        engine = self.engine
        if isinstance(msg, codec.AdmitRequest):
            stream = engine.admit(msg.device_id, msg.prompt, msg.now)
            if stream is None:
                return codec.AdmitReply(msg.device_id, ok=False)
            return codec.AdmitReply(msg.device_id, ok=True, slot=stream.slot,
                                    prev_token=int(stream.prev_token))
        if isinstance(msg, codec.SubmitRequest):
            engine.submit(msg.device_id, msg.tokens, msg.now, draft_q=msg.draft_q)
            return codec.SubmitAck(msg.device_id)
        if isinstance(msg, codec.StepRequest):
            recs = tuple(
                codec.VerdictRec(
                    device_id=v.device_id, n_accepted=int(v.n_accepted),
                    tokens=np.asarray(v.tokens, np.int32), next_prev=int(v.next_prev),
                    accept_rate=float(v.accept_rate), queue_depth=int(v.queue_depth),
                    queue_s=float(v.queue_s), verify_s=float(v.verify_s),
                )
                for v in engine.step(msg.now) or []
            )
            return codec.StepReply(verdicts=recs, queue_depth=engine.queue_depth,
                                   n_free=engine.pool.n_free,
                                   hint=engine.next_event_hint(msg.now))
        if isinstance(msg, codec.RetireRequest):
            return codec.RetireReply(stream=stream_to_state(engine.retire(msg.device_id)))
        if isinstance(msg, codec.CancelRequest):
            return codec.CancelReply(msg.device_id, ok=engine.cancel_request(msg.device_id))
        if isinstance(msg, codec.ForceExtendRequest):
            nxt = engine.force_extend(msg.device_id, msg.tokens)
            return codec.ForceExtendReply(msg.device_id, next_prev=int(nxt))
        if isinstance(msg, codec.ExportStream):
            stream, row = engine.export_stream(msg.device_id)
            return codec.ExportReply(stream=stream_to_state(stream, row_to_wire(row)))
        if isinstance(msg, codec.ImportStream):
            stream = state_to_stream(msg.stream)
            engine.import_stream(stream, row_from_wire(msg.stream.row, self.device))
            return codec.ImportAck(msg.stream.device_id, slot=stream.slot)
        if isinstance(msg, codec.StatsRequest):
            st = engine.stats(msg.now if msg.has_now else None)
            payload = engine.telemetry_payload()
            return codec.ReplicaStats(stats_json=json.dumps(st.to_json()),
                                      telemetry_json=json.dumps(payload) if payload else "")
        if isinstance(msg, codec.WarmupRequest):
            secs = engine.warmup()
            return codec.WarmupReply(compile_json=json.dumps({str(k): v for k, v in secs.items()}))
        raise codec.CodecError(f"worker cannot handle {type(msg).__name__}")

    def _place(self, msg: codec.PlaceReplica) -> codec.Message:
        from repro_torch.api.spec import ServeSpec

        if self.engine is not None:
            return codec.PlaceAck(ok=False, error="worker already has an engine placed")
        try:
            self.engine = build_engine_from_spec(ServeSpec.from_json(msg.spec_json), self.device)
        except Exception as e:
            return codec.PlaceAck(ok=False, error=f"{type(e).__name__}: {e}")
        return codec.PlaceAck(
            ok=True, n_slots=self.engine.pool.n_slots, k_max=self.engine.k_max,
            max_len=self.engine.pool.max_len, greedy=self.engine.greedy,
            paged_attention=self.engine.paged_attention,
        )


class ReplicaWorker:
    """The worker process's accept loop: control sessions drive WorkerCore;
    a connection that opens with a data-plane frame is served by the
    TransportServer around the engine instead."""

    def __init__(self, listen: str, *, engine=None, device="cuda"):
        self.listen = listen
        self.core = WorkerCore(engine, device=device)
        self.resolved: Optional[str] = None
        self._drained: Optional[asyncio.Event] = None  # made on the serve loop
        self._transport = None  # TransportServer, on the first data-plane connection
        self._watch: Optional[asyncio.Task] = None
        self._error: Optional[BaseException] = None

    async def serve(self) -> None:
        """Serve until a Drain arrives. A failed task of the TransportServer
        ends the serve with its error (the worker does not hang on it)."""
        self._drained = asyncio.Event()
        server, self.resolved = await listen_addr(self._serve_conn, self.listen)
        print(f"repro-torch-worker listening on {self.resolved}", flush=True)
        log.info("worker listening on %s", self.resolved)
        try:
            await self._drained.wait()
            if self._error is not None:
                raise self._error
        finally:
            if self._watch is not None:
                self._watch.cancel()
            if self._transport is not None:
                await self._transport.stop()
            server.close()
            await server.wait_closed()

    async def _watch_transport(self) -> None:
        try:
            await self._transport.raise_on_error()
        except Exception as e:
            self._error = e
            self._drained.set()

    async def _serve_conn(self, ep: Endpoint) -> None:
        while True:
            frame = await ep.recv()
            if frame is None:
                return
            msg, _ = codec.decode_frame(frame)
            if isinstance(msg, (codec.Hello, codec.DraftPacket, codec.Fallback, codec.Close)):
                await self._serve_device(ep, msg)
                return
            reply = self.core.handle(msg)
            await ep.send(codec.encode_frame(reply))
            if isinstance(msg, codec.Drain):
                self._drained.set()
                return

    async def _serve_device(self, ep: Endpoint, first: codec.Message) -> None:
        """Hand a data-plane connection to the TransportServer."""
        from repro_torch.transport.server import TransportServer

        if self.core.engine is None:
            raise RuntimeError("worker has no engine yet (send PlaceReplica or pass --spec)")
        if self._transport is None:
            self._transport = TransportServer(self.core.engine)
            self._watch = asyncio.get_running_loop().create_task(self._watch_transport())
        await self._transport.serve_endpoint(ep, first)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.transport.worker",
        description="Run one SLED engine replica behind a TCP/UDS control socket.",
    )
    ap.add_argument("--listen", type=str, default="tcp:127.0.0.1:0",
                    help="listen address: tcp:HOST:PORT (port 0 = a free port) or uds:/path.sock")
    ap.add_argument("--spec", type=str, default="",
                    help="optional ServeSpec JSON file: build the engine up front instead of "
                         "waiting for a PlaceReplica frame")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--log-level", type=str, default="warning",
                    help="log level of the repro_torch loggers (debug/info/warning/error)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)
    engine = None
    if args.spec:
        from repro_torch.api.spec import ServeSpec

        with open(args.spec) as f:
            engine = build_engine_from_spec(ServeSpec.from_json(f.read()), device)
    asyncio.run(ReplicaWorker(args.listen, engine=engine, device=device).serve())


if __name__ == "__main__":
    main()
