"""Asyncio edge-device client: pipelined drafting over a transport link.

The port of ``repro.transport.client``. The device drafts on its kit's
device; each round's tokens and q row leave it once (``.cpu().numpy()``)
for the wire.

``EdgeClient`` runs one device's §III-A loop against a TransportServer:

  admission   Hello -> Admit (retried on loss; waits out a full pool)
  round       DraftPacket(seq) -> [draft ahead while in flight] -> Verdict
  pipelining  after sending a round the client keeps drafting on the
              assumption of full acceptance (EdgeDevice.draft_ahead); a
              confirmed guess submits the pre-drafted round immediately —
              draft latency hides under the network round trip, which is
              where edge-assisted serving wins (SpecEdge)
  timeout     no verdict within ``verify_timeout`` -> the client releases
              its drafts locally (paper fallback) and sends a Fallback
              frame; the server's reply arbitrates the race — FallbackAck
              confirms the resync, a (late) Verdict overrides it.  The
              client never mutates draft-cache state until the server has
              arbitrated, so client and server token streams can never
              diverge.
  link loss   a ConnectionError mid-stream (peer closed, socket died) no
              longer kills the session coroutine: with a ``reconnect``
              hook installed the client redials under a bounded, seeded
              jittered backoff, re-Hellos (the server resends Admit for an
              admitted stream), and resyncs the open round through the
              SAME Fallback arbitration as a timeout — so a flapped link
              converges exactly like a slow one.
  adaptive k  with ``kctl="adaptive"`` the client feeds each Verdict's
              accept_rate/queue_depth feedback to a bounded AIMD controller
              (serving/speclen.py) and caps the next round's draft length
              at the controller's k — closed-loop spec-length control.
              ``kctl="fixed"`` (default) always drafts the kit's k_max and
              is bit-identical to the pre-feedback client.
  adaptive c  ``cctl="adaptive"`` moves the drafting confidence bar c_th
              from the same feedback (serving/speclen.ConfidenceController):
              low acceptance raises the bar (shorter, surer rounds), high
              acceptance lowers it.  c_th is an argument of each draft
              round.

The client's committed stream is exactly the server's committed stream for
its slot; on zero-latency lossless links it is token-for-token identical to
the lock-step reference (the tests hold it there).
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch import telemetry
from repro_torch.cluster.faults import Backoff
from repro_torch.core.server_engine import EdgeDevice, EdgeDeviceKit
from repro_torch.serving.speclen import make_confidence_controller, make_controller
from repro_torch.transport import codec
from repro_torch.transport.links import Endpoint


@dataclasses.dataclass
class ClientStats:
    device_id: int
    rounds: int = 0
    committed: int = 0
    pipeline_hits: int = 0
    pipeline_misses: int = 0
    fallback_rounds: int = 0
    fallback_tokens: int = 0
    drafted: int = 0  # device-side draft() tokens (excludes ahead-drafts)
    late_verdicts: int = 0
    hello_retries: int = 0
    reconnects: int = 0  # mid-stream link deaths survived by redialing
    bytes_tx: int = 0
    bytes_rx: int = 0
    frames_tx: int = 0
    frames_rx: int = 0
    frames_dropped: int = 0
    wall_seconds: float = 0.0
    k_final: int = 0  # spec length after the last controller update
    k_mean: float = 0.0  # mean proposal length actually sent per round
    c_th_final: float = 0.0  # confidence bar after the last controller update
    c_th_mean: float = 0.0  # mean confidence bar across controller updates

    def to_json(self) -> dict:
        """Uniform stats record (json.dumps-safe), mirroring
        EngineStats.to_json — the one shape BENCH artifacts emit."""
        return dataclasses.asdict(self)

    @classmethod
    def merge(cls, stats: List["ClientStats"]) -> "ClientStats":
        """Fleet-level sum (count fields) / mean (k, wall): launchers and
        benchmarks report one record instead of hand-summing per client."""
        if not stats:
            return cls(device_id=-1)
        out = cls(device_id=-1)
        for f in dataclasses.fields(cls):
            if f.name == "device_id":
                continue
            vals = [getattr(s, f.name) for s in stats]
            if f.name == "k_final":
                out.k_final = round(sum(vals) / len(vals))
            elif f.name in ("k_mean", "wall_seconds", "c_th_final", "c_th_mean"):
                setattr(out, f.name, float(sum(vals) / len(vals)))
            else:
                setattr(out, f.name, sum(vals))
        return out


class ProtocolError(RuntimeError):
    pass


class EdgeClient:
    def __init__(
        self,
        kit: EdgeDeviceKit,
        device_id: int,
        prompt: np.ndarray,
        endpoint: Endpoint,
        *,
        max_new: int,
        max_len: int,
        qmode: str = "none",
        pipeline: bool = True,
        verify_timeout: float = 2.0,
        admit_timeout: float = 2.0,
        max_retries: int = 64,
        draft_rate: Optional[float] = None,
        kctl: str = "fixed",
        kctl_kw: Optional[dict] = None,
        cctl: str = "fixed",
        cctl_kw: Optional[dict] = None,
        seed: int = 0,
        on_round: Optional[Callable[[np.ndarray, int, int, bool], None]] = None,
        reconnect: Optional[Callable[[], "asyncio.Future"]] = None,
        max_reconnects: int = 4,
    ):
        self.kit = kit
        self.device_id = device_id
        self.prompt = np.asarray(prompt, np.int32)
        self.ep = endpoint
        self.max_new = max_new
        self.max_len = max_len
        self.qmode = qmode
        self.pipeline = pipeline and kit.supports_pipeline
        self.verify_timeout = verify_timeout
        self.admit_timeout = admit_timeout
        self.max_retries = max_retries
        # emulated device speed (tokens/s): tiny reduced models draft orders
        # of magnitude faster than the paper's edge boards, so a fleet can
        # throttle to DeviceProfile rates — the sleep overlaps other clients'
        # compute, restoring the concurrency a real fleet would have
        self.draft_rate = draft_rate
        # closed-loop spec length: None (fixed k_max) or an AIMD controller
        # fed by the Verdict accept_rate/queue_depth feedback fields
        self.kctl = make_controller(kctl, k_max=kit.k_max, **(kctl_kw or {}))
        # closed-loop drafting confidence: None (the kit's fixed c_th) or a
        # bounded additive controller on the same Verdict feedback — the
        # k/c_th pair is the full per-device drafting policy
        self.cctl = make_confidence_controller(
            cctl, c_init=kit.c_th, device_id=device_id, **(cctl_kw or {})
        )
        # per-round observer (repro_torch.api streaming events): called with
        # (committed_tokens, n_drafted, n_accepted, fallback) as each round
        # resolves — fallback rounds pass the locally-released tokens
        self.on_round = on_round
        # mid-stream link recovery: an async callable returning a FRESH
        # Endpoint already attached to the server (None = legacy behavior,
        # ConnectionError escapes).  Redials are bounded by max_reconnects
        # and paced by a seeded jittered backoff so chaos runs replay.
        self.reconnect_cb = reconnect
        self.max_reconnects = max_reconnects
        self._backoff = None
        self.seed = seed
        self.stats = ClientStats(device_id=device_id)
        self.device: Optional[EdgeDevice] = None
        # per-round trace (telemetry on): each verdict's server-timing fields
        # let the client attribute round latency to queue vs verify vs wire
        self.trace: List[telemetry.TraceEvent] = []

    # -- wire helpers --------------------------------------------------------

    async def _send(self, msg) -> None:
        await self.ep.send(codec.encode_frame(msg))

    async def _recv(self, timeout: Optional[float]):
        """One decoded message, or None on timeout; ConnectionError if the
        server side closed."""
        try:
            frame = await asyncio.wait_for(self.ep.recv(), timeout)
        except asyncio.TimeoutError:
            return None
        if frame is None:
            raise ConnectionError(f"device {self.device_id}: server closed the link")
        return codec.decode_frame(frame)[0]

    async def _redial(self, cause: BaseException) -> None:
        """The link died mid-stream: dial a fresh endpoint (bounded, seeded
        jittered backoff) and re-Hello.  The server answers a duplicate
        Hello for an admitted stream by resending Admit — re-admission is
        state-free — after which the caller resyncs any open round through
        the Fallback arbitration path.  The new link is live (and mapped in
        the server's connection table) BEFORE the dead one is closed, so
        the server never mistakes the redial for a device that vanished."""
        if self.reconnect_cb is None:
            raise cause
        if self._backoff is None:
            self._backoff = Backoff(
                base_s=0.05, max_s=1.0, jitter=0.1, seed=self.device_id
            )
        while True:
            if self.stats.reconnects >= self.max_reconnects:
                raise ProtocolError(
                    f"device {self.device_id}: link lost and "
                    f"{self.max_reconnects} reconnects exhausted"
                ) from cause
            await asyncio.sleep(self._backoff.attempt())
            self.stats.reconnects += 1
            telemetry.count("client_reconnects_total")
            try:
                fresh = await self.reconnect_cb()
                old = self.ep
                self.ep = fresh
                await self._admission()
            except ConnectionError:
                continue
            self._fold_link_stats(old)
            old.close()
            return

    def _fold_link_stats(self, ep: Endpoint) -> None:
        """Bank a dead endpoint's wire counters before abandoning it."""
        for f in ("bytes_tx", "bytes_rx", "frames_tx", "frames_rx", "frames_dropped"):
            setattr(self.stats, f, getattr(self.stats, f) + getattr(ep.stats, f))

    # -- protocol phases -----------------------------------------------------

    async def _admission(self) -> None:
        for _ in range(self.max_retries):
            await self._send(codec.Hello(self.device_id, self.prompt))
            deadline = asyncio.get_running_loop().time() + self.admit_timeout
            while True:
                left = deadline - asyncio.get_running_loop().time()
                msg = await self._recv(max(left, 0.0)) if left > 0 else None
                if msg is None:
                    self.stats.hello_retries += 1
                    break  # resend Hello
                if isinstance(msg, codec.Admit):
                    if msg.ok:
                        return
                    # pool full: the server queued us; wait for the real Admit
                    # without a deadline cap tied to admission retries
                    deadline = asyncio.get_running_loop().time() + 60.0
                # anything else pre-admission is a stale frame; keep waiting
        raise ProtocolError(f"device {self.device_id}: admission failed after retries")

    async def _await_verdict(self, seq: int, draft_tokens: np.ndarray):
        """Wait out one round.  Returns (verdict, fell_back): a codec.Verdict
        for seq (authoritative), or (None, True) after a server-confirmed
        fallback resync."""
        sent_fallback = False
        for _ in range(self.max_retries):
            try:
                msg = await self._recv(self.verify_timeout)
            except ConnectionError as e:
                # link died while the round was in flight: redial, then let
                # the same Fallback arbitration below resolve the round —
                # the server either resends the stored verdict or confirms
                # a resync, exactly as if the verdict had merely been slow
                await self._redial(e)
                msg = None
            if msg is None:
                # round timed out (or the link was just re-dialed): ask the
                # server to resync on our local release; state stays
                # untouched until the server arbitrates
                sent_fallback = True
                try:
                    await self._send(codec.Fallback(self.device_id, seq, draft_tokens))
                except ConnectionError as e:
                    await self._redial(e)
                continue
            if isinstance(msg, codec.Verdict):
                if msg.seq == seq:
                    if sent_fallback:
                        self.stats.late_verdicts += 1
                    return msg, False
                continue  # duplicate of an older round
            if isinstance(msg, codec.FallbackAck):
                if msg.seq == seq:
                    return None, True
                continue
            if isinstance(msg, codec.Admit):
                continue  # duplicate admission reply
            raise ProtocolError(f"device {self.device_id}: unexpected {type(msg).__name__}")
        raise ProtocolError(f"device {self.device_id}: round {seq} unresolved after retries")

    # -- main loop -----------------------------------------------------------

    async def run(self) -> List[int]:
        t0 = asyncio.get_running_loop().time()
        await self._admission()
        dev = self.device = EdgeDevice(
            self.kit, self.device_id, self.prompt, max_len=self.max_len, seed=self.seed
        )
        loop = asyncio.get_running_loop()

        async def throttle(n: int, since: Optional[float] = None) -> float:
            """Emulate drafting ``n`` tokens at the device's rate; time spent
            waiting on the network (``since``) already counts (sim's
            draft-ahead carry: need/device_rate).  Returns the NOMINAL
            drafting bill — the full n/rate — which ``draft_s`` reports so
            profiling recovers the emulated hardware rate even when
            pipelining hid part of the sleep under the round trip."""
            if not self.draft_rate:
                return 0.0
            need = n / self.draft_rate
            wait = need if since is None else need - (loop.time() - since)
            if wait > 0:
                await asyncio.sleep(wait)
            return need

        seq = 0
        k = self.kctl.k if self.kctl else None  # None: fixed k_max drafting
        c = self.cctl.c if self.cctl else None  # None: fixed kit c_th
        k_log = []
        t_d = loop.time()
        tokens = dev.draft(k=k, c_th=c)
        draft_s = loop.time() - t_d
        draft_s += await throttle(len(tokens))
        while True:
            q = dev.pending_q if self.qmode != "none" else None
            try:
                await self._send(
                    codec.DraftPacket(self.device_id, seq, tokens, draft_q=q, qmode=self.qmode)
                )
            except ConnectionError as e:
                # link died between rounds: redial and resend this round's
                # packet on the fresh link (the server dedups by seq)
                await self._redial(e)
                continue
            self.stats.rounds += 1
            # log what actually went on the wire: under pipelining a verdict
            # may shrink k after the next proposal was already pre-drafted,
            # and c_th confidence stopping shortens rounds below the cap
            k_log.append(len(tokens))
            t_sent = loop.time()
            if self.pipeline:
                # the round trip is in flight: keep drafting on speculation
                dev.draft_ahead(k=k, c_th=c)
                await asyncio.sleep(0)  # hand the loop to the server/link
            verdict, fell_back = await self._await_verdict(seq, tokens)
            rtt = loop.time() - t_sent
            traced = telemetry.enabled()
            if fell_back:
                released = dev.fallback_release()
                self.stats.fallback_rounds += 1
                next_tokens = None
                if traced:
                    telemetry.count("client_fallback_rounds_total")
                    self.trace.append(telemetry.TraceEvent(
                        device_id=self.device_id, round=seq, t=loop.time(),
                        k=len(tokens), n_accepted=0, n_commit=len(released),
                        draft_s=draft_s, fallback=True,
                    ))
                if self.on_round is not None:
                    self.on_round(released, len(tokens), 0, True)
            else:
                next_tokens = dev.on_verdict(verdict)
                if self.kctl is not None:
                    # closed loop: acceptance + replica congestion -> next k
                    k = self.kctl.update(verdict.accept_rate, verdict.queue_depth)
                if self.cctl is not None:
                    # same feedback moves the confidence bar the other way:
                    # low acceptance tightens, high acceptance relaxes
                    c = self.cctl.update(verdict.accept_rate, verdict.queue_depth)
                if traced:
                    # server-timing attribution: what the round trip spent in
                    # the replica's queue + verify; the rest was the wire
                    wire_s = max(rtt - verdict.queue_s - verdict.verify_s, 0.0)
                    telemetry.observe("client_round_seconds", rtt)
                    telemetry.observe("client_wire_seconds", wire_s)
                    telemetry.observe("client_draft_seconds", draft_s)
                    self.trace.append(telemetry.TraceEvent(
                        device_id=self.device_id, round=seq, t=loop.time(),
                        k=len(tokens), n_accepted=int(verdict.n_accepted),
                        n_commit=len(verdict.tokens),
                        queue_s=float(verdict.queue_s),
                        verify_s=float(verdict.verify_s),
                        wire_s=wire_s, draft_s=draft_s,
                    ))
                if self.on_round is not None:
                    self.on_round(verdict.tokens, len(tokens), verdict.n_accepted, False)
            seq += 1
            if len(dev.committed) >= self.max_new:
                break
            if next_tokens is not None:
                tokens = next_tokens
                # pre-drafted during the round trip: only the remainder of
                # the emulated drafting time is paid in the foreground, but
                # the trace bills the full nominal cost (see throttle)
                draft_s = await throttle(len(tokens), since=t_sent)
            else:
                t_d = loop.time()
                tokens = dev.draft(k=k, c_th=c)
                draft_s = loop.time() - t_d
                draft_s += await throttle(len(tokens))
        try:
            await self._send(codec.Close(self.device_id))
        except ConnectionError:
            pass  # best effort; the server reclaims the slot on conn loss
        self.ep.close()
        self.stats.committed = min(len(dev.committed), self.max_new)
        self.stats.pipeline_hits = dev.pipeline_hits
        self.stats.pipeline_misses = dev.pipeline_misses
        self.stats.fallback_tokens = dev.fallback_tokens
        self.stats.drafted = dev.drafted
        self._fold_link_stats(self.ep)  # += : earlier links already banked
        self.stats.wall_seconds = asyncio.get_running_loop().time() - t0
        self.stats.k_final = self.kctl.k if self.kctl else self.kit.k_max
        self.stats.k_mean = float(sum(k_log) / len(k_log)) if k_log else 0.0
        self.stats.c_th_final = self.cctl.c if self.cctl else self.kit.c_th
        self.stats.c_th_mean = self.cctl.c_mean if self.cctl else self.kit.c_th
        return dev.committed[: self.max_new]
