"""Asyncio verification server: an engine (or replica cluster) behind the wire.

The port of ``repro.transport.server``. Prompts and tokens arrive as numpy
arrays; the engine makes its tensors on its own device at admission.

One ``TransportServer`` fronts either a single
:class:`~repro_torch.core.server_engine.ServerEngine` or a
:class:`~repro_torch.cluster.router.Router` of N replicas — both expose the same
admit/submit/step/retire surface, so the frame adapter below is identical
and "how many replicas serve this port" is purely a construction choice.
It serves any number of device channels (transport/links.py endpoints):

  * a per-connection task decodes frames and feeds the engine — ``Hello``
    admits (or queues the admission until a pool slot frees), ``DraftPacket``
    submits to the BatchPlanner, ``Close`` retires the stream;
  * one stepper task drives ``engine.step`` — concurrently-arriving requests
    batch under whichever policy the engine was built with (static /
    deadline / continuous), and the §III-A straggler timeout drops stalled
    requests out of the batch inside the planner;
  * the ``Fallback`` handler arbitrates the timeout race atomically: if the
    device's request is still queued (or never arrived) it is cancelled and
    the stream is force-extended with the locally-released tokens (lossy
    resync, paper §III-A); if it was already verified, the stored verdict is
    resent and remains authoritative.  Duplicate control frames are answered
    by replaying the last reply, so lossy links converge by retry.

Race discipline: verdicts are *recorded* (last-reply table) synchronously in
the same no-await stretch as ``engine.step``, so a Fallback frame processed
later can never force-extend a stream whose round was already verified.

Single-process, single event loop: engine steps and device drafting
interleave at await points rather than truly overlapping.

A connection or step task that raises records its error in ``error`` and
wakes :meth:`TransportServer.raise_on_error`, which a serve awaits beside
its clients, so the serve fails with that error instead of waiting for
ever on a task nothing awaits (a departure from the JAX package, whose
serve hangs there). A stream a Router shed with an evicted replica fails
the serve the same way: its device would wait for a verdict that never
comes (the JAX package's client waits out its retries, 64 timeouts).
"""
from __future__ import annotations

import asyncio
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.cluster.router import Router
from repro_torch.core.server_engine import EngineStats, ServerEngine
from repro_torch.transport import codec
from repro_torch.transport.links import Endpoint


class TransportServer:
    def __init__(self, engine: Union[ServerEngine, Router], *, idle_tick: float = 0.05):
        self.engine = engine  # single replica or a cluster router: same surface
        self.idle_tick = idle_tick
        self._conns: Dict[int, Endpoint] = {}
        self._endpoints: List[Endpoint] = []  # every endpoint ever attached
        self._req_seq: Dict[int, int] = {}  # device -> seq of in-flight round
        self._last_reply: Dict[int, bytes] = {}
        self._last_reply_seq: Dict[int, int] = {}
        self._pending_admits: Deque[Tuple[int, np.ndarray]] = deque()
        self._wake = asyncio.Event()
        self._tasks: List[asyncio.Task] = []
        self._stepper: Optional[asyncio.Task] = None
        self._t0: Optional[float] = None
        self.late_verdicts_resent = 0
        self.fallback_acks = 0
        self.error: Optional[BaseException] = None  # the first task failure
        self._errored = asyncio.Event()

    # -- lifecycle -----------------------------------------------------------

    def now(self) -> float:
        loop = asyncio.get_running_loop()
        if self._t0 is None:
            self._t0 = loop.time()
        return loop.time() - self._t0

    def attach(self, endpoint: Endpoint) -> None:
        """Register a device channel; starts its connection task (and the
        engine stepper, on first attach)."""
        self._endpoints.append(endpoint)
        self._tasks.append(self._spawn(self._serve_conn(endpoint)))
        self._start_stepper()

    def _start_stepper(self) -> None:
        if self._stepper is None:
            self._stepper = self._spawn(self._step_loop())

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro)
        task.add_done_callback(self._task_done)
        return task

    def _task_done(self, task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            self.fail(task.exception())

    def fail(self, exc: BaseException) -> None:
        """Record a task's failure; the first one is what the serve raises."""
        if self.error is None:
            self.error = exc
        self._errored.set()

    async def raise_on_error(self) -> None:
        """Wait until a connection or step task fails, then raise its error."""
        await self._errored.wait()
        raise self.error

    async def serve_endpoint(self, ep: Endpoint, first) -> None:
        """Serve a connection whose first frame, ``first``, was already read
        (a worker hands over a connection that opened with a data-plane
        frame). Its task belongs to the caller: an error is recorded here
        and raised again."""
        self._endpoints.append(ep)  # wire stats: this connection counts in stats()
        try:
            await self._dispatch(first, ep)
            self._start_stepper()
            await self._serve_conn(ep, device_id=getattr(first, "device_id", None))
        except Exception as e:
            self.fail(e)
            raise

    async def stop(self) -> None:
        tasks = [*self._tasks, *([self._stepper] if self._stepper else [])]
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks, self._stepper = [], None

    # -- connection handling -------------------------------------------------

    async def _serve_conn(self, ep: Endpoint, device_id: Optional[int] = None) -> None:
        while True:
            frame = await ep.recv()
            if frame is None:
                break
            msg, _ = codec.decode_frame(frame)
            device_id = msg.device_id
            await self._dispatch(msg, ep)
        # peer vanished without a Close: reclaim the slot — unless the
        # device already redialed on a fresh endpoint (EdgeClient reconnect
        # maps the new conn via Hello before closing the dead one), in
        # which case this conn is just the corpse of the old link
        if (
            device_id is not None
            and device_id in self.engine.streams
            and self._conns.get(device_id) is ep
        ):
            await self._retire(device_id)

    def _record(self, device_id: int, frame: bytes, seq: int) -> None:
        """No-await bookkeeping: must happen before the frame hits the wire."""
        self._last_reply[device_id] = frame
        self._last_reply_seq[device_id] = seq

    async def _send(self, device_id: int, frame: bytes) -> None:
        ep = self._conns.get(device_id)
        if ep is None:
            return
        try:
            await ep.send(frame)
        except ConnectionError:
            # the device's link died under us: drop the frame rather than
            # crash the stepper.  The reply is already in the last-reply
            # table, so the client recovers it through Fallback arbitration
            # after it redials.
            pass

    async def _dispatch(self, msg, ep: Endpoint) -> None:
        dev = msg.device_id
        if isinstance(msg, codec.Hello):
            self._conns[dev] = ep
            if dev in self.engine.streams:
                # duplicate Hello: the Admit was lost — resend, don't re-admit
                slot = self.engine.streams[dev].slot
                await self._send(dev, codec.encode_frame(codec.Admit(dev, ok=True, slot=slot)))
                return
            if any(d == dev for d, _ in self._pending_admits):
                return  # already queued for a slot
            stream = self.engine.admit(dev, np.asarray(msg.prompt, np.int32), self.now())
            if stream is None:
                self._pending_admits.append((dev, np.asarray(msg.prompt, np.int32)))
                await self._send(dev, codec.encode_frame(codec.Admit(dev, ok=False)))
            else:
                await self._send(
                    dev, codec.encode_frame(codec.Admit(dev, ok=True, slot=stream.slot))
                )
        elif isinstance(msg, codec.DraftPacket):
            if dev not in self.engine.streams:
                return  # raced a retirement; the client is closing
            if self.engine.has_inflight(dev):
                return  # duplicate frame for the round already queued
            if self._last_reply_seq.get(dev, -1) >= msg.seq:
                return  # stale resend of a round that already resolved
            self._req_seq[dev] = msg.seq
            self.engine.submit(dev, msg.tokens, self.now(), draft_q=msg.draft_q)
            self._wake.set()
        elif isinstance(msg, codec.Fallback):
            await self._handle_fallback(msg)
        elif isinstance(msg, codec.Close):
            if dev in self.engine.streams:
                await self._retire(dev)
        else:
            raise codec.CodecError(f"server cannot handle {type(msg).__name__}")

    async def _handle_fallback(self, msg: codec.Fallback) -> None:
        dev = msg.device_id
        if dev not in self.engine.streams:
            return
        if self._last_reply_seq.get(dev, -1) >= msg.seq:
            # this round already resolved (verdict or earlier ack) — the
            # stored reply is authoritative; resend it, the device reconciles
            self.late_verdicts_resent += 1
            await self._send(dev, self._last_reply[dev])
            return
        # request still queued (cancel it) or lost on the wire (nothing to
        # cancel): either way the stream resyncs with the released tokens
        self.engine.cancel_request(dev)
        next_prev = self.engine.force_extend(dev, msg.tokens)
        self.fallback_acks += 1
        ack = codec.encode_frame(codec.FallbackAck(dev, msg.seq, next_prev))
        self._record(dev, ack, msg.seq)
        await self._send(dev, ack)

    async def _retire(self, device_id: int) -> None:
        self.engine.retire(device_id)
        self._req_seq.pop(device_id, None)
        self._last_reply.pop(device_id, None)
        self._last_reply_seq.pop(device_id, None)
        self._conns.pop(device_id, None)
        if self._pending_admits:
            dev, prompt = self._pending_admits.popleft()
            stream = self.engine.admit(dev, prompt, self.now())
            if stream is None:  # still full (another admit raced us)
                self._pending_admits.appendleft((dev, prompt))
            else:
                await self._send(
                    dev, codec.encode_frame(codec.Admit(dev, ok=True, slot=stream.slot))
                )

    # -- the serving loop ----------------------------------------------------

    async def _step_loop(self) -> None:
        while True:
            now = self.now()
            verdicts = self.engine.step(now)
            shed = [d for d in getattr(self.engine, "lost_devices", ()) if d in self._conns]
            if shed:
                raise RuntimeError(f"the streams of devices {shed} were shed with an evicted "
                                   "replica; their clients would wait out every retry")
            if verdicts:
                # encode + record with NO awaits in between: once anything
                # else runs, every verdict of this round must be authoritative
                outgoing = []
                for v in verdicts:
                    seq = self._req_seq.get(v.device_id, 0)
                    frame = codec.encode_frame(
                        codec.Verdict(
                            device_id=v.device_id,
                            seq=seq,
                            n_accepted=v.n_accepted,
                            tokens=np.asarray(v.tokens, np.int32),
                            next_prev=v.next_prev,
                            accept_rate=v.accept_rate,
                            queue_depth=v.queue_depth,
                            queue_s=v.queue_s,
                            verify_s=v.verify_s,
                        )
                    )
                    self._record(v.device_id, frame, seq)
                    outgoing.append((v.device_id, frame))
                for dev, frame in outgoing:
                    await self._send(dev, frame)
                await asyncio.sleep(0)  # let replies land before re-stepping
                continue
            hint = self.engine.next_event_hint(now)
            timeout = self.idle_tick
            if self.engine.queue_depth:
                # work is queued but the policy hasn't fired: wake at the
                # planner's next deadline/straggler event (or quickly, for
                # policies that fire on arrival)
                timeout = max(hint - now, 0.0) + 1e-4 if hint is not None else 1e-3
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    # -- stats ---------------------------------------------------------------

    def stats(self, now: Optional[float] = None) -> EngineStats:
        """EngineStats with the wire fields filled from this server's side of
        every link (tx = verdicts/control out, rx = drafts/control in)."""
        st = self.engine.stats(self.now() if now is None else now)
        for ep in self._endpoints:
            st.bytes_tx += ep.stats.bytes_tx
            st.bytes_rx += ep.stats.bytes_rx
            st.frames_tx += ep.stats.frames_tx
            st.frames_rx += ep.stats.frames_rx
            st.frames_dropped += ep.stats.frames_dropped
        return st
