"""RemoteReplica: the Router's proxy for a worker process across a socket.

The port of ``repro.cluster.remote``. The Router (cluster/router.py)
drives every replica through one synchronous surface: admit / submit /
step / retire / export / import / stats / warmup. A :class:`RemoteReplica`
implements it by sending each call as a codec control frame over a
blocking :class:`ControlChannel` (a socket and a FrameDecoder; the Router
stays synchronous and steps its remotes concurrently on a thread pool).

A SHADOW of each stream's server-side record (slot, prev token, committed
tokens, counters) is kept from the admit / verdict / retire traffic, so
placement (``n_free``, ``streams``, ``has_inflight``) never pays a round
trip: only engine work (admit's prefill, step's verification, a
migration's row) crosses the wire.

Failures: a transport failure of a side-effect-free RPC (stats) is retried
once over a fresh connection. Side-effectful RPCs carry a per-channel
``seq`` (codec v4), so with ``retry_rpcs`` on (the default FaultPolicy)
they too get one reconnect-and-resend, which the worker's replay cache
answers with the original reply if the first copy landed. A failure that
outlives the retry raises :class:`ReplicaGone`, and the Router evicts the
replica and, if its FaultPolicy says so, revives it (:meth:`RemoteReplica.revive`:
a fresh worker spawned with the first spawn's arguments, or the address
dialed again, its spec placed again). A worker-side handler error arrives
as an ErrorReply and raises :class:`WorkerError`: the worker is alive,
the request was refused. :meth:`RemoteReplica.ping` probes the worker on
a connection of its own, for the Router's heartbeat.

Workers are started with ``subprocess`` (a fresh interpreter), never by
forking: a process that has touched CUDA cannot fork a child that uses it.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.admission import DeviceStream
from repro_torch.core.engine import EngineStats, Verdict
from repro_torch.runtime import resolve_device
from repro_torch.transport import codec
from repro_torch.transport.links import parse_addr
from repro_torch.transport.worker import state_to_stream, stream_to_state

DEFAULT_TIMEOUT = 120.0  # control RPCs; a crash shows up as EOF, not a timeout
WARMUP_TIMEOUT = 900.0  # placement and warmup build and run every verify bucket


class ReplicaGone(ConnectionError):
    """The worker is unreachable (crash, kill, network partition)."""


class WorkerError(ValueError):
    """The worker handled the request and refused it (an engine-level error)."""


class ControlChannel:
    """Blocking request/reply frame channel to one worker (TCP or UDS).

    ``bytes_tx``/``bytes_rx`` and ``frames_tx``/``frames_rx`` count what
    crossed this channel, over every reconnect, ``seconds`` the time spent
    in ``request`` (encode, wire, the worker's work, decode) and
    ``longest_s`` the longest request (a heartbeat's timeout must sit above
    it: the worker answers a Ping after the request it is handling)."""

    def __init__(self, address: str, *, timeout: float = DEFAULT_TIMEOUT):
        self.address = address
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._decoder = codec.FrameDecoder()
        self._seq = 0  # per-channel RPC seq (the worker's replay keys); 0 = none
        self.bytes_tx = self.bytes_rx = self.frames_tx = self.frames_rx = 0
        self.seconds = self.longest_s = 0.0

    def next_seq(self) -> int:
        """Monotonic non-zero seq for a side-effectful RPC; it survives
        reconnects of this channel (the worker's replay cache is keyed by
        it)."""
        self._seq += 1
        return self._seq

    def connect(self) -> None:
        parsed = parse_addr(self.address)
        try:
            if parsed[0] == "uds":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    sock.settimeout(self.timeout)
                    sock.connect(parsed[1])
                except OSError:
                    sock.close()
                    raise
            else:
                sock = socket.create_connection((parsed[1], parsed[2]), timeout=self.timeout)
        except OSError as e:
            raise ReplicaGone(f"cannot dial worker at {self.address}: {e}") from e
        self._sock = sock
        self._decoder = codec.FrameDecoder()

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def reconnect(self) -> None:
        self.close()
        self.connect()

    def request(self, msg: codec.Message, *, timeout: Optional[float] = None):
        """Send one frame and block for its reply. An ErrorReply raises
        WorkerError; a transport failure raises ReplicaGone (the channel is
        then closed)."""
        t0 = time.perf_counter()
        if self._sock is None:
            self.connect()
        sock = self._sock
        frame = codec.encode_frame(msg)
        try:
            if timeout is not None:
                sock.settimeout(timeout)
            sock.sendall(frame)
            self.bytes_tx += len(frame)
            self.frames_tx += 1
            while True:
                raw = self._decoder.next_raw()
                if raw is not None:
                    break
                data = sock.recv(1 << 20)
                if not data:
                    raise ReplicaGone(f"worker at {self.address} closed the control connection")
                self._decoder.feed(data)
        except ReplicaGone:
            self.close()
            raise
        except (OSError, codec.CodecError) as e:
            self.close()
            raise ReplicaGone(f"worker at {self.address} failed: {e}") from e
        finally:
            if timeout is not None and self._sock is not None:
                self._sock.settimeout(self.timeout)
        self.bytes_rx += len(raw)
        self.frames_rx += 1
        reply, _ = codec.decode_frame(raw)
        took = time.perf_counter() - t0
        self.seconds += took
        self.longest_s = max(self.longest_s, took)
        if isinstance(reply, codec.ErrorReply):
            raise WorkerError(reply.message)
        return reply


def repro_python_env() -> dict:
    """The environment of a spawned worker: this interpreter's repro_torch
    must be importable when the parent runs from the source tree with
    PYTHONPATH=src."""
    import repro_torch

    env = dict(os.environ)
    src_root = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    parts = [src_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    return env


def worker_sock_dir(address: str) -> Optional[str]:
    """The private ``repro-worker-*`` directory behind a spawned worker's
    UDS address, or None when the address is not one of ours."""
    if not address.startswith("uds:"):
        return None
    d = os.path.dirname(address[len("uds:"):])
    if os.path.basename(d).startswith("repro-worker-"):
        return d
    return None


def cleanup_worker_dir(address: str) -> None:
    """Remove the private socket directory a spawned worker listened under."""
    d = worker_sock_dir(address)
    if d is not None:
        shutil.rmtree(d, ignore_errors=True)


def kill_worker_proc(proc: Optional[subprocess.Popen], *, wait_s: float = 5.0) -> None:
    """Reap a worker process: terminate, wait a bounded time, then kill, so
    a worker that ignores SIGTERM leaves no process behind."""
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=wait_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            proc.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            pass


def spawn_worker(address: Optional[str] = None, *, spec_path: str = "", device="cuda",
                 startup_timeout: float = 120.0, cmd: Optional[List[str]] = None):
    """Start a worker process and wait until it accepts a dial.

    Returns ``(proc, address)``. Without an address the worker listens on a
    fresh UDS socket under a private temporary directory, removed by
    :meth:`RemoteReplica.close` (or here, when the start fails). The worker
    runs ``python -m repro_torch.transport.worker`` on ``device`` (the card
    unless the caller asks for the CPU; without a card this raises before
    spawning); ``cmd`` replaces that command line (the address is appended
    as ``--listen ADDRESS``)."""
    dev = resolve_device(device)
    made_dir = None
    if address is None:
        made_dir = tempfile.mkdtemp(prefix="repro-worker-")
        address = f"uds:{os.path.join(made_dir, uuid.uuid4().hex[:8] + '.sock')}"
    if cmd is None:
        cmd = [sys.executable, "-m", "repro_torch.transport.worker", "--device", dev.type]
        if spec_path:
            cmd += ["--spec", spec_path]
    cmd = [*cmd, "--listen", address]
    proc = subprocess.Popen(cmd, env=repro_python_env(), stdout=subprocess.DEVNULL)
    deadline = time.monotonic() + startup_timeout
    probe = ControlChannel(address, timeout=5.0)
    while True:
        if proc.poll() is not None:
            if made_dir is not None:
                shutil.rmtree(made_dir, ignore_errors=True)
            raise RuntimeError(f"worker exited with code {proc.returncode} during startup "
                               f"(cmd: {' '.join(cmd)})")
        try:
            probe.connect()
            probe.close()
            return proc, address
        except ReplicaGone:
            if time.monotonic() > deadline:
                kill_worker_proc(proc)
                if made_dir is not None:
                    shutil.rmtree(made_dir, ignore_errors=True)
                raise RuntimeError(
                    f"worker at {address} did not come up within {startup_timeout}s") from None
            time.sleep(0.05)


class RemoteReplica:
    """One worker process behind the replica driver surface: the parts of
    :class:`~repro_torch.core.server_engine.ServerEngine` the Router and
    the serving loops touch (see the module docstring for the shadow state
    and the failure rules)."""

    flavor = "remote"

    def __init__(self, channel: ControlChannel, *, address: str = "",
                 proc: Optional[subprocess.Popen] = None):
        self.channel = channel
        self.address = address or channel.address
        self.proc = proc  # set when this replica spawned its worker
        self.spawned = proc is not None
        # spawn_worker's keyword arguments of the first spawn, which a revive
        # repeats (the device above all: a CPU fleet respawns on the CPU)
        self.spawn_kw: dict = {}
        self.dead = False
        self.suspect = False  # the heartbeat monitor: the worker stopped answering
        self.retry_rpcs = False  # FaultPolicy.retry_rpcs: one resend over a reconnect
        self.retries = 0
        self.spec = None  # the placed ServeSpec (a revive places it again)
        self._n_slots = 0
        self.k_max = 0
        self.max_len = 0
        self.greedy = True
        self.paged_attention = True
        self._streams: Dict[int, DeviceStream] = {}
        self._pending: Dict[int, int] = {}  # device -> tokens in flight
        self._hint: Optional[float] = None
        self.last_telemetry: Optional[dict] = None  # the worker's payload from stats()
        self._hb_channel: Optional[ControlChannel] = None  # heartbeat probes
        # how revive() gets a fresh channel (a test's or chip_smoke.py's);
        # None: respawn the worker, or dial the address again
        self.channel_factory: Optional[Callable[[], ControlChannel]] = None

    @classmethod
    def dial(cls, address: str, *, timeout: float = DEFAULT_TIMEOUT) -> "RemoteReplica":
        channel = ControlChannel(address, timeout=timeout)
        channel.connect()
        return cls(channel, address=address)

    @classmethod
    def spawn(cls, *, timeout: float = DEFAULT_TIMEOUT, **spawn_kw) -> "RemoteReplica":
        """Start a worker (``spawn_worker(**spawn_kw)``) and dial it; the
        arguments are kept for a revive. A worker that cannot be dialed is
        reaped."""
        proc, addr = spawn_worker(**spawn_kw)
        try:
            remote = cls.dial(addr, timeout=timeout)
        except BaseException:
            kill_worker_proc(proc)
            cleanup_worker_dir(addr)
            raise
        remote.proc, remote.spawned, remote.spawn_kw = proc, True, dict(spawn_kw)
        return remote

    def adopt(self, *, n_slots: int, k_max: int, max_len: int, greedy: bool,
              paged_attention: bool = True) -> None:
        """Take the shape of an engine the worker was started with (no
        PlaceReplica): what a PlaceAck would have said."""
        self._n_slots, self.k_max, self.max_len = n_slots, k_max, max_len
        self.greedy, self.paged_attention = greedy, paged_attention

    # -- placement -----------------------------------------------------------

    def place(self, spec) -> None:
        """Ship the ServeSpec; the worker builds its engine from it."""
        ack = self.channel.request(codec.PlaceReplica(spec.to_json_str()),
                                   timeout=WARMUP_TIMEOUT)
        if not isinstance(ack, codec.PlaceAck):
            raise WorkerError(f"expected PlaceAck, got {type(ack).__name__}")
        if not ack.ok:
            raise WorkerError(f"worker at {self.address} refused placement: {ack.error}")
        self.spec = spec
        self.adopt(n_slots=ack.n_slots, k_max=ack.k_max, max_len=ack.max_len,
                   greedy=ack.greedy, paged_attention=ack.paged_attention)

    def _request(self, msg: codec.Message, *, timeout: Optional[float] = None):
        """A side-effectful RPC. The frame carries a fresh non-zero seq;
        with ``retry_rpcs`` on, one ReplicaGone is absorbed by reconnecting
        and resending the same frame (the worker's replay cache answers a
        copy that had landed)."""
        try:
            return self.channel.request(msg, timeout=timeout)
        except ReplicaGone:
            if not self.retry_rpcs or getattr(msg, "seq", 0) == 0:
                raise
            self.retries += 1
            self.channel.reconnect()
            return self.channel.request(msg, timeout=timeout)

    # -- supervision: heartbeat, chaos hooks, revive -------------------------

    def ping(self, *, timeout: float = 2.0) -> bool:
        """Heartbeat probe on a connection of its own (the main channel
        belongs to the router's thread). False on any failure (a refused
        dial, a timeout, a wrong reply); the failed connection is closed,
        so the next probe dials afresh."""
        try:
            if self._hb_channel is None:
                self._hb_channel = ControlChannel(self.address, timeout=timeout)
                self._hb_channel.connect()
            reply = self._hb_channel.request(
                codec.Ping(seq=self._hb_channel.next_seq(), t=time.monotonic()), timeout=timeout)
            return isinstance(reply, codec.Pong)
        except Exception:
            ch, self._hb_channel = self._hb_channel, None
            if ch is not None:
                ch.close()
            return False

    def chaos_kill(self) -> None:
        """Fault injection: make the worker unreachable as a crash would
        (SIGKILL a spawned process, or sever the control link of a dialed
        or fake one). The Router finds out at its next RPC, as it would of
        a real failure."""
        self._kill_proc()
        kill = getattr(self.channel, "kill", None)
        if kill is not None:
            kill()  # a FaultyChannel or a test's channel: its killed flag
        else:
            self.channel.close()

    def _kill_proc(self) -> None:
        """SIGKILL a spawned worker and reap it (a stopped one too, which
        SIGTERM would not end)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass

    def chaos_hang(self) -> None:
        """SIGSTOP a spawned worker: connected but silent (as a partition
        looks); only the heartbeat or an RPC timeout notices."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGSTOP)
        else:
            hang = getattr(self.channel, "hang", None)
            if hang is not None:
                hang()

    def can_revive(self) -> bool:
        return self.channel_factory is not None or self.spawned or bool(self.address)

    def revive(self) -> None:
        """Bring a dead replica back: a fresh channel (``channel_factory``,
        or a worker respawned with the first spawn's arguments, or the
        address dialed again), the stored spec placed again and warmed up.
        The new engine rebuilds its weights from the spec's seed, so
        recovered streams keep their tokens; a replica shaped by
        :meth:`adopt` keeps its shape. Raises ReplicaGone or RuntimeError
        on failure; the caller owns the backoff and the retry budget."""
        if self.spec is None and self.channel_factory is None:
            raise ReplicaGone(f"replica at {self.address} was never placed")
        self.channel.close()
        if self._hb_channel is not None:
            self._hb_channel.close()
            self._hb_channel = None
        if self.channel_factory is not None:
            self.channel = self.channel_factory()
        else:
            if self.spawned:
                self._kill_proc()
                cleanup_worker_dir(self.address)
                self.proc, self.address = spawn_worker(**self.spawn_kw)
            self.channel = ControlChannel(self.address, timeout=self.channel.timeout)
            self.channel.connect()
        self._streams.clear()
        self._pending.clear()
        self._hint = None
        if self.spec is not None:
            try:
                self.place(self.spec)
                self.warmup()
            except WorkerError as e:
                raise ReplicaGone(f"revived worker refused placement: {e}") from e
        self.dead = False
        self.suspect = False

    @property
    def fingerprint(self) -> tuple:
        # kv_dtype comes from the placed spec (the worker builds its pool
        # from it), as a LocalReplica's comes from its engine
        kv_dtype = getattr(self.spec, "kv_dtype", "bf16") if self.spec is not None else "bf16"
        return (self.k_max, self.max_len, self.greedy, self.paged_attention, kv_dtype)

    # -- shadowed introspection (no round trips) -----------------------------

    @property
    def streams(self) -> Dict[int, DeviceStream]:
        return self._streams

    @property
    def n_free(self) -> int:
        return self._n_slots - len(self._streams)

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    def has_inflight(self, device_id: int) -> bool:
        return device_id in self._pending

    def next_event_hint(self, now: float) -> Optional[float]:
        return self._hint

    # -- driver surface (proxied) --------------------------------------------

    def admit(self, device_id: int, prompt, now: float = 0.0) -> Optional[DeviceStream]:
        reply = self._request(codec.AdmitRequest(
            device_id, np.asarray(prompt, np.int32), now, seq=self.channel.next_seq()))
        if not reply.ok:
            return None
        stream = DeviceStream(device_id=device_id, slot=reply.slot,
                              prev_token=int(reply.prev_token), admitted_at=now)
        self._streams[device_id] = stream
        return stream

    def submit(self, device_id: int, draft_tokens, now: float, draft_q=None) -> None:
        toks = np.asarray(draft_tokens, np.int32).reshape(-1)
        self._request(codec.SubmitRequest(
            device_id, toks, now,
            draft_q=None if draft_q is None else np.asarray(draft_q, np.float32),
            qmode="none" if draft_q is None else "f32",
            seq=self.channel.next_seq(),
        ))
        self._pending[device_id] = int(toks.shape[0])

    def step(self, now: float) -> Optional[List[Verdict]]:
        if not self._pending:
            return None  # nothing queued on this worker: no round trip
        reply = self._request(codec.StepRequest(now, seq=self.channel.next_seq()))
        self._hint = reply.hint
        verdicts: List[Verdict] = []
        for rec in reply.verdicts:
            stream = self._streams.get(rec.device_id)
            drafted = self._pending.pop(rec.device_id, 0)
            if stream is not None:
                stream.committed.extend(int(t) for t in rec.tokens)
                stream.prev_token = int(rec.next_prev)
                stream.rounds += 1
                stream.drafted += drafted
                stream.accepted += int(rec.n_accepted)
            verdicts.append(Verdict(
                device_id=rec.device_id, n_accepted=int(rec.n_accepted),
                tokens=np.asarray(rec.tokens, np.int32), next_prev=int(rec.next_prev),
                accept_rate=float(rec.accept_rate), queue_depth=int(rec.queue_depth),
                queue_s=float(rec.queue_s), verify_s=float(rec.verify_s),
            ))
        return verdicts or None

    def retire(self, device_id: int) -> DeviceStream:
        reply = self._request(codec.RetireRequest(device_id, seq=self.channel.next_seq()))
        self._pending.pop(device_id, None)
        self._streams.pop(device_id, None)
        return state_to_stream(reply.stream)

    def cancel_request(self, device_id: int) -> bool:
        reply = self._request(codec.CancelRequest(device_id, seq=self.channel.next_seq()))
        if reply.ok:
            self._pending.pop(device_id, None)
        return reply.ok

    def force_extend(self, device_id: int, tokens) -> int:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        reply = self._request(codec.ForceExtendRequest(device_id, toks,
                                                       seq=self.channel.next_seq()))
        stream = self._streams.get(device_id)
        if stream is not None:
            stream.committed.extend(int(t) for t in toks)
            stream.prev_token = int(reply.next_prev)
        return int(reply.next_prev)

    # -- migration (streams cross the wire bit for bit) ----------------------

    def export_stream(self, device_id: int):
        """``(stream, row)``: the row as codec leaves, handed unchanged to
        another remote replica's :meth:`import_stream`."""
        reply = self._request(codec.ExportStream(device_id, seq=self.channel.next_seq()))
        self._pending.pop(device_id, None)
        self._streams.pop(device_id, None)
        return state_to_stream(reply.stream), dict(reply.stream.row)

    def import_stream(self, stream: DeviceStream, row_cache) -> DeviceStream:
        reply = self._request(codec.ImportStream(stream_to_state(stream, row_cache),
                                                 seq=self.channel.next_seq()))
        stream.slot = reply.slot
        self._streams[stream.device_id] = stream
        return stream

    # -- stats / warmup / lifecycle ------------------------------------------

    def stats(self, now: Optional[float] = None) -> EngineStats:
        req = codec.StatsRequest(now=0.0 if now is None else float(now), has_now=now is not None)
        try:
            reply = self.channel.request(req)
        except ReplicaGone:
            # side-effect free: one reconnect-and-retry before giving up
            self.channel.reconnect()
            reply = self.channel.request(req)
        if reply.telemetry_json:
            self.last_telemetry = json.loads(reply.telemetry_json)
        return EngineStats(**json.loads(reply.stats_json))

    def warmup(self) -> Dict[int, float]:
        reply = self.channel.request(codec.WarmupRequest(), timeout=WARMUP_TIMEOUT)
        return {int(k): v for k, v in json.loads(reply.compile_json).items()}

    def drain(self) -> None:
        """Best effort: ask the worker to exit; reap a spawned process and
        remove its private socket directory."""
        try:
            if self.channel.connected or not self.dead:
                self.channel.request(codec.Drain(), timeout=10.0)
        except (ReplicaGone, WorkerError):
            pass
        self.close()
        if self.dead:  # an evicted worker (killed, stopped or cut off) gets no say
            self._kill_proc()
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                kill_worker_proc(self.proc)
            self.proc = None

    def close(self) -> None:
        self.channel.close()
        if self._hb_channel is not None:
            self._hb_channel.close()
            self._hb_channel = None
        if self.spawned:
            cleanup_worker_dir(self.address)
