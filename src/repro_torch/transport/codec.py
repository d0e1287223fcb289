"""SLED wire protocol: versioned, length-prefixed binary frames.

The port's copy of the data plane of ``repro.transport.codec``; its frames
are byte for byte the JAX package's, so a device of either package talks
to a server of either. Every frame is ``header || payload`` with an 8-byte
header::

    magic "SL" (2) | version u8 | msg_type u8 | payload_len u32 (big-endian)

so frames survive byte-stream transports (reassembly by ``FrameDecoder``)
as well as message-oriented links. Multi-byte integers are big-endian;
token vectors are little-endian int32 arrays behind a u16 count.

The draft-probability payload of a ``DraftPacket`` (the q(token) row that
sampling-mode verification needs) can ride the wire quantized, ``qmode``:

    "none"  no q payload (greedy verification)
    "f32"   4 bytes/token, exact
    "f16"   2 bytes/token
    "int8"  1 byte/token + one f32 scale (the JAX package's symmetric
            per-row scheme, computed here with numpy)

Decoding returns f32 either way.

Message types 8-34 are the CONTROL PLANE a Router speaks to a remote
replica worker (transport/worker.py) over one TCP/UDS connection, byte for
byte the JAX package's codec v3/v4: ``PlaceReplica`` ships a serialized
ServeSpec and the worker builds its engine from it; admit / submit / step /
retire / cancel / force-extend proxy the replica driver surface (every
``now`` is the Router's clock); ``ExportStream``/``ImportStream`` carry a
stream's server-side state and its pool row bit for bit (``StreamState``);
``ReplicaStats`` returns the EngineStats record; ``Drain`` retires the
worker; ``Ping``/``Pong`` are the v4 heartbeat. Every side-effectful
request carries a per-channel ``seq`` (v4; 0 = none) that keys the
worker's replay cache, so a resent frame returns the original reply.

A row leaf of dtype bfloat16 rides the wire as its raw little-endian
uint16 words under the dtype name ``"bfloat16"``, as in the JAX package.
numpy has no bfloat16 and the port imports no ``ml_dtypes``, so such a
leaf is a :class:`BF16Words` here, on both sides of the codec: its words,
never a float conversion, so no bit of a migrated row can move.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Optional, Union

import numpy as np

MAGIC = b"SL"
VERSION = 4  # v4: per-RPC seq ids (replay-safe retries) + Ping/Pong heartbeat
_HEADER = struct.Struct(">2sBBI")
HEADER_SIZE = _HEADER.size
# the JAX package's cap, sized for the control plane's serialized KV rows
MAX_PAYLOAD = 1 << 26

# message type ids (wire-stable: append only)
T_HELLO = 1
T_ADMIT = 2
T_DRAFT = 3
T_VERDICT = 4
T_FALLBACK = 5
T_FALLBACK_ACK = 6
T_CLOSE = 7
# v3 control plane (Router <-> remote replica worker)
T_PLACE = 8
T_PLACE_ACK = 9
T_ADMIT_REQ = 10
T_ADMIT_REPLY = 11
T_SUBMIT = 12
T_SUBMIT_ACK = 13
T_STEP = 14
T_STEP_REPLY = 15
T_RETIRE = 16
T_RETIRE_REPLY = 17
T_CANCEL = 18
T_CANCEL_REPLY = 19
T_FORCE_EXTEND = 20
T_FORCE_EXTEND_REPLY = 21
T_EXPORT = 22
T_EXPORT_REPLY = 23
T_IMPORT = 24
T_IMPORT_ACK = 25
T_STATS = 26
T_REPLICA_STATS = 27
T_WARMUP = 28
T_WARMUP_REPLY = 29
T_DRAIN = 30
T_DRAIN_ACK = 31
T_ERROR = 32
# v4 heartbeat
T_PING = 33
T_PONG = 34

QMODES = ("none", "f32", "f16", "int8")


class CodecError(ValueError):
    """Malformed, truncated, or version-incompatible frame."""


@dataclasses.dataclass(frozen=True)
class Hello:
    """Device -> server admission request; prompt is prefilled server-side."""

    device_id: int
    prompt: np.ndarray  # (P,) int32


@dataclasses.dataclass(frozen=True)
class Admit:
    """Server -> device admission verdict (ok=False: pool full, wait)."""

    device_id: int
    ok: bool
    slot: int = 0


@dataclasses.dataclass(frozen=True)
class DraftPacket:
    """Device -> server: one drafting round's proposal."""

    device_id: int
    seq: int
    tokens: np.ndarray  # (k,) int32
    draft_q: Optional[np.ndarray] = None  # (k,) f32 (decoded), or None
    qmode: str = "none"


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Server -> device: verification outcome for DraftPacket ``seq``.

    ``accept_rate`` (this round's acceptance; smoothing is the receiver's
    job) and ``queue_depth`` (the serving replica's planner queue after
    dispatch) are the v2 feedback fields that the adaptive controllers
    (serving/speclen.py) read. ``queue_s``/``verify_s`` are the server's
    timing: the client's round trip minus both is time on the wire.
    """

    device_id: int
    seq: int
    n_accepted: int
    tokens: np.ndarray  # committed this round (accepted + correction/bonus)
    next_prev: int
    flags: int = 0  # reserved protocol bits (always 0)
    accept_rate: float = 0.0  # this round's accepted/drafted, in [0, 1]
    queue_depth: int = 0  # replica queue depth after this round's dispatch
    queue_s: float = 0.0  # admission-queue wait for this round (server clock)
    verify_s: float = 0.0  # verify-step wall time for this round's batch


@dataclasses.dataclass(frozen=True)
class Fallback:
    """Device -> server: round ``seq`` timed out device-side; the device
    released ``tokens`` locally (§III-A) and asks the server to resync."""

    device_id: int
    seq: int
    tokens: np.ndarray  # (k,) int32 locally-released draft tokens


@dataclasses.dataclass(frozen=True)
class FallbackAck:
    """Server -> device: resync applied; draft from ``next_prev``."""

    device_id: int
    seq: int
    next_prev: int


@dataclasses.dataclass(frozen=True)
class Close:
    """Either side: stream ends; server frees the slot."""

    device_id: int


# -- v3 control plane (Router <-> remote replica worker) ---------------------


class BF16Words:
    """A bfloat16 array as its raw uint16 words (numpy has no bfloat16).

    The codec writes it under the dtype name ``"bfloat16"``, as the JAX
    package writes an ``ml_dtypes.bfloat16`` array, and decodes such a leaf
    back to one; the worker turns it into a ``torch.bfloat16`` tensor by a
    bit view."""

    __slots__ = ("words",)

    def __init__(self, words):
        words = np.asarray(words)
        if words.dtype != np.uint16:
            raise CodecError(f"bfloat16 words must be uint16, got {words.dtype}")
        self.words = words

    @property
    def shape(self) -> tuple:
        return self.words.shape

    def __eq__(self, other) -> bool:
        if not isinstance(other, BF16Words):
            return NotImplemented
        return self.shape == other.shape and bool(np.array_equal(self.words, other.words))

    __hash__ = None

    def __repr__(self) -> str:
        return f"BF16Words(shape={self.shape})"


@dataclasses.dataclass(frozen=True)
class PlaceReplica:
    """Router -> worker: build your engine from this ServeSpec (JSON; the
    worker forces backend "engine")."""

    spec_json: str


@dataclasses.dataclass(frozen=True)
class PlaceAck:
    """Worker -> router: engine built (or not); the fields echo the engine's
    shape so the router can fingerprint replicas for migration."""

    ok: bool
    n_slots: int = 0
    k_max: int = 0
    max_len: int = 0
    greedy: bool = True
    paged_attention: bool = True
    error: str = ""


@dataclasses.dataclass(frozen=True)
class AdmitRequest:
    """Router -> worker: place a stream (its prompt prefilled worker-side).
    ``now`` is the router's clock; ``seq`` (v4, every side-effectful
    request) keys the worker's replay cache."""

    device_id: int
    prompt: np.ndarray  # (P,) int32
    now: float = 0.0
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class AdmitReply:
    device_id: int
    ok: bool
    slot: int = 0
    prev_token: int = 0


@dataclasses.dataclass(frozen=True)
class SubmitRequest:
    """Router -> worker: one drafting round's proposal for verification."""

    device_id: int
    tokens: np.ndarray  # (k,) int32
    now: float = 0.0
    draft_q: Optional[np.ndarray] = None
    qmode: str = "none"
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class SubmitAck:
    device_id: int


@dataclasses.dataclass(frozen=True)
class StepRequest:
    """Router -> worker: run one engine.step at the router's clock."""

    now: float
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class VerdictRec:
    """One verdict inside a StepReply (mirrors core.engine.Verdict)."""

    device_id: int
    n_accepted: int
    tokens: np.ndarray  # (n,) int32 committed this round
    next_prev: int
    accept_rate: float = 0.0
    queue_depth: int = 0
    queue_s: float = 0.0
    verify_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class StepReply:
    """Worker -> router: the round's verdicts and the replica's load
    signals (queue depth, free slots, next planner event)."""

    verdicts: tuple  # tuple[VerdictRec, ...]
    queue_depth: int = 0
    n_free: int = 0
    hint: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RetireRequest:
    device_id: int
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class CancelRequest:
    device_id: int
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class CancelReply:
    device_id: int
    ok: bool


@dataclasses.dataclass(frozen=True)
class ForceExtendRequest:
    """Router -> worker: append unverified fallback tokens (§III-A)."""

    device_id: int
    tokens: np.ndarray  # (n,) int32
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class ForceExtendReply:
    device_id: int
    next_prev: int


def _leaf_equal(a, b) -> bool:
    if isinstance(a, BF16Words) or isinstance(b, BF16Words):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.all(a == b))


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Full server-side state of one stream (RetireReply, migration).

    ``committed`` is the stream's lifetime committed-token list; ``row`` is
    its pool row, name -> numpy array (a bfloat16 leaf: :class:`BF16Words`),
    empty for replies that do not move the cache."""

    device_id: int
    slot: int
    prev_token: int
    committed: tuple  # tuple[int, ...]
    admitted_at: float = 0.0
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    row: dict = dataclasses.field(default_factory=dict)

    # arrays in a frozen dataclass: compare fields, not array truthiness
    def __eq__(self, other):
        if not isinstance(other, StreamState):
            return NotImplemented
        head = ("device_id", "slot", "prev_token", "committed", "admitted_at", "rounds",
                "drafted", "accepted")
        if any(getattr(self, f) != getattr(other, f) for f in head):
            return False
        return sorted(self.row) == sorted(other.row) and all(
            _leaf_equal(self.row[k], other.row[k]) for k in self.row)


@dataclasses.dataclass(frozen=True)
class RetireReply:
    stream: StreamState


@dataclasses.dataclass(frozen=True)
class ExportStream:
    """Router -> worker: detach a quiescent stream for migration."""

    device_id: int
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class ExportReply:
    stream: StreamState  # row populated


@dataclasses.dataclass(frozen=True)
class ImportStream:
    """Router -> worker: adopt a stream exported elsewhere (row populated)."""

    stream: StreamState
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class ImportAck:
    device_id: int
    slot: int


@dataclasses.dataclass(frozen=True)
class StatsRequest:
    now: float = 0.0
    has_now: bool = False


@dataclasses.dataclass(frozen=True)
class ReplicaStats:
    """Worker -> router: the EngineStats record as JSON, and the worker's
    telemetry payload (metrics snapshot) when telemetry is on."""

    stats_json: str
    telemetry_json: str = ""


@dataclasses.dataclass(frozen=True)
class WarmupRequest:
    pass


@dataclasses.dataclass(frozen=True)
class WarmupReply:
    compile_json: str = "{}"  # bucket -> seconds


@dataclasses.dataclass(frozen=True)
class Drain:
    """Router -> worker: exit after the ack."""


@dataclasses.dataclass(frozen=True)
class DrainAck:
    streams_left: int = 0


@dataclasses.dataclass(frozen=True)
class ErrorReply:
    """Worker -> router: the request raised; ``message`` carries the detail."""

    message: str


@dataclasses.dataclass(frozen=True)
class Ping:
    """Heartbeat probe (v4): ``t`` is the sender's monotonic time, echoed in
    the Pong. Side-effect free: never enters the replay cache."""

    seq: int
    t: float = 0.0


@dataclasses.dataclass(frozen=True)
class Pong:
    """Heartbeat reply: echoes the Ping's seq and time."""

    seq: int
    t: float = 0.0


Message = Union[
    Hello, Admit, DraftPacket, Verdict, Fallback, FallbackAck, Close,
    PlaceReplica, PlaceAck, AdmitRequest, AdmitReply, SubmitRequest,
    SubmitAck, StepRequest, StepReply, RetireRequest, RetireReply,
    CancelRequest, CancelReply, ForceExtendRequest, ForceExtendReply,
    ExportStream, ExportReply, ImportStream, ImportAck, StatsRequest,
    ReplicaStats, WarmupRequest, WarmupReply, Drain, DrainAck, ErrorReply,
    Ping, Pong,
]


# -- primitive encoders ------------------------------------------------------


def _put_tokens(out: List[bytes], toks: np.ndarray) -> None:
    toks = np.ascontiguousarray(np.asarray(toks, dtype="<i4"))
    if toks.ndim != 1:
        raise CodecError(f"token vector must be 1-D, got shape {toks.shape}")
    if toks.shape[0] > 0xFFFF:
        raise CodecError(f"token vector too long: {toks.shape[0]}")
    out.append(struct.pack(">H", toks.shape[0]))
    out.append(toks.tobytes())


def _put_str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    out.append(struct.pack(">I", len(b)))
    out.append(b)


def _put_tokens32(out: List[bytes], toks) -> None:
    """Token vector behind a u32 count (a lifetime committed list can
    exceed the data plane's u16 cap)."""
    arr = np.ascontiguousarray(np.asarray(toks, dtype="<i4").reshape(-1))
    out.append(struct.pack(">I", arr.shape[0]))
    out.append(arr.tobytes())


def _put_array(out: List[bytes], arr) -> None:
    """Bit-exact array: dtype name, shape, little-endian raw bytes. A
    :class:`BF16Words` leaf rides as its uint16 words under "bfloat16"."""
    if isinstance(arr, BF16Words):
        a, name = np.ascontiguousarray(arr.words), "bfloat16"
    else:
        a = np.ascontiguousarray(np.asarray(arr))
        name = a.dtype.name
    nb = name.encode("ascii")
    if len(nb) > 0xFF:
        raise CodecError(f"dtype name too long: {name!r}")
    if a.ndim > 0xFF:
        raise CodecError(f"array rank {a.ndim} too large")
    out.append(struct.pack(">B", len(nb)))
    out.append(nb)
    out.append(struct.pack(">B", a.ndim))
    if a.ndim:
        out.append(struct.pack(f">{a.ndim}I", *a.shape))
    raw = a.astype(a.dtype.newbyteorder("<")).tobytes()
    out.append(struct.pack(">I", len(raw)))
    out.append(raw)


def _put_row(out: List[bytes], row: dict) -> None:
    """Flat name -> array dict (a pool row), leaves in name order."""
    if len(row) > 0xFFFF:
        raise CodecError(f"row has too many leaves: {len(row)}")
    out.append(struct.pack(">H", len(row)))
    for name in sorted(row):
        nb = name.encode("utf-8")
        if len(nb) > 0xFFFF:
            raise CodecError(f"row leaf name too long: {name!r}")
        out.append(struct.pack(">H", len(nb)))
        out.append(nb)
        _put_array(out, row[name])


def _put_stream_state(out: List[bytes], s: StreamState) -> None:
    out.append(struct.pack(">IIidIII", s.device_id, s.slot, s.prev_token, s.admitted_at,
                           s.rounds, s.drafted, s.accepted))
    _put_tokens32(out, list(s.committed))
    _put_row(out, s.row)


class _Reader:
    """Bounds-checked cursor over a payload; raises CodecError on overrun."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise CodecError(
                f"truncated payload: need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}"
            )
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def f32(self) -> float:
        return struct.unpack(">f", self.take(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.take(8))[0]

    def tokens(self) -> np.ndarray:
        n = self.u16()
        return np.frombuffer(self.take(4 * n), dtype="<i4").astype(np.int32)

    def tokens32(self) -> np.ndarray:
        n = self.u32()
        if 4 * n > len(self.buf) - self.pos:
            raise CodecError(f"token32 vector of {n} overruns the payload")
        return np.frombuffer(self.take(4 * n), dtype="<i4").astype(np.int32)

    def string(self) -> str:
        n = self.u32()
        try:
            return self.take(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise CodecError(f"malformed utf-8 string payload: {e}") from e

    def array(self):
        try:
            name = self.take(self.u8()).decode("ascii")
        except UnicodeDecodeError as e:
            raise CodecError(f"malformed dtype name: {e}") from e
        ndim = self.u8()
        shape = tuple(self.u32() for _ in range(ndim))
        nbytes = self.u32()
        raw = self.take(nbytes)
        bf16 = name == "bfloat16"
        try:
            dt = np.dtype(np.uint16 if bf16 else name)
        except TypeError as e:
            raise CodecError(f"unknown array dtype {name!r}") from e
        if dt.hasobject:
            raise CodecError(f"array dtype {name!r} has no raw byte form")
        n_items = 1
        for d in shape:
            n_items *= d
        if nbytes != n_items * dt.itemsize:
            raise CodecError(
                f"array payload of {nbytes} bytes does not match "
                f"{name}{list(shape)} ({n_items * dt.itemsize} expected)"
            )
        arr = np.frombuffer(raw, dtype=dt.newbyteorder("<")).astype(dt).reshape(shape)
        return BF16Words(arr) if bf16 else arr

    def row(self) -> dict:
        row = {}
        for _ in range(self.u16()):
            try:
                name = self.take(self.u16()).decode("utf-8")
            except UnicodeDecodeError as e:
                raise CodecError(f"malformed row leaf name: {e}") from e
            row[name] = self.array()
        return row

    def stream_state(self) -> StreamState:
        dev, slot, prev = self.u32(), self.u32(), self.i32()
        admitted_at = self.f64()
        rounds, drafted, accepted = self.u32(), self.u32(), self.u32()
        committed = tuple(int(t) for t in self.tokens32())
        return StreamState(device_id=dev, slot=slot, prev_token=prev, committed=committed,
                           admitted_at=admitted_at, rounds=rounds, drafted=drafted,
                           accepted=accepted, row=self.row())

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise CodecError(f"{len(self.buf) - self.pos} trailing bytes in payload")


# -- q payload (quantized probability row) -----------------------------------


def _quantize_row_int8(q: np.ndarray):
    """The JAX package's symmetric int8 row scheme, in f32: scale =
    max(max|q| / 127, 1e-12), then clip(round(q / scale), -127, 127) with
    round half to even. An empty row has no max: the JAX encoder fails
    there with a ValueError, and this raises CodecError, also a
    ValueError."""
    if q.size == 0:
        raise CodecError("qmode 'int8' needs at least one token (no scale for an empty row)")
    scale = np.maximum(np.max(np.abs(q)) / np.float32(127), np.float32(1e-12))
    codes = np.clip(np.round(q / scale), -127, 127).astype(np.int8)
    return np.float32(scale), codes


def _encode_q(out: List[bytes], q: Optional[np.ndarray], qmode: str) -> None:
    if qmode not in QMODES:
        raise CodecError(f"unknown qmode {qmode!r}")
    out.append(bytes([QMODES.index(qmode)]))
    if qmode == "none":
        return
    if q is None:
        raise CodecError(f"qmode {qmode!r} requires a draft_q payload")
    q = np.asarray(q, np.float32).reshape(-1)
    out.append(struct.pack(">H", q.shape[0]))
    if qmode == "f32":
        out.append(q.astype("<f4").tobytes())
    elif qmode == "f16":
        out.append(q.astype("<f2").tobytes())
    else:
        scale, codes = _quantize_row_int8(q)
        out.append(struct.pack(">f", float(scale)))
        out.append(codes.astype("|i1").tobytes())


def _decode_q(r: _Reader):
    mode_id = r.u8()
    if mode_id >= len(QMODES):
        raise CodecError(f"unknown qmode id {mode_id}")
    qmode = QMODES[mode_id]
    if qmode == "none":
        return None, qmode
    n = r.u16()
    if qmode == "f32":
        q = np.frombuffer(r.take(4 * n), dtype="<f4").astype(np.float32)
    elif qmode == "f16":
        q = np.frombuffer(r.take(2 * n), dtype="<f2").astype(np.float32)
    else:
        scale = np.float32(r.f32())
        q = np.frombuffer(r.take(n), dtype="|i1").astype(np.float32) * scale
    return q, qmode


# -- frame encode/decode -----------------------------------------------------


def encode_frame(msg: Message) -> bytes:
    out: List[bytes] = []
    if isinstance(msg, Hello):
        mtype = T_HELLO
        out.append(struct.pack(">I", msg.device_id))
        _put_tokens(out, msg.prompt)
    elif isinstance(msg, Admit):
        mtype = T_ADMIT
        out.append(struct.pack(">IBI", msg.device_id, int(msg.ok), msg.slot))
    elif isinstance(msg, DraftPacket):
        mtype = T_DRAFT
        out.append(struct.pack(">II", msg.device_id, msg.seq))
        _put_tokens(out, msg.tokens)
        _encode_q(out, msg.draft_q, msg.qmode)
    elif isinstance(msg, Verdict):
        mtype = T_VERDICT
        out.append(
            struct.pack(
                ">IIHiBfHff",
                msg.device_id,
                msg.seq,
                msg.n_accepted,
                msg.next_prev,
                msg.flags,
                float(msg.accept_rate),
                min(int(msg.queue_depth), 0xFFFF),
                float(msg.queue_s),
                float(msg.verify_s),
            )
        )
        _put_tokens(out, msg.tokens)
    elif isinstance(msg, Fallback):
        mtype = T_FALLBACK
        out.append(struct.pack(">II", msg.device_id, msg.seq))
        _put_tokens(out, msg.tokens)
    elif isinstance(msg, FallbackAck):
        mtype = T_FALLBACK_ACK
        out.append(struct.pack(">IIi", msg.device_id, msg.seq, msg.next_prev))
    elif isinstance(msg, Close):
        mtype = T_CLOSE
        out.append(struct.pack(">I", msg.device_id))
    else:
        mtype = _encode_control(out, msg)
    payload = b"".join(out)
    return _HEADER.pack(MAGIC, VERSION, mtype, len(payload)) + payload


def _encode_control(out: List[bytes], msg: Message) -> int:
    """The payload of a control-plane frame into ``out``; its type id."""
    if isinstance(msg, PlaceReplica):
        _put_str(out, msg.spec_json)
        return T_PLACE
    if isinstance(msg, PlaceAck):
        out.append(struct.pack(">BIIIBB", int(msg.ok), msg.n_slots, msg.k_max, msg.max_len,
                               int(msg.greedy), int(msg.paged_attention)))
        _put_str(out, msg.error)
        return T_PLACE_ACK
    if isinstance(msg, AdmitRequest):
        out.append(struct.pack(">IId", msg.seq, msg.device_id, float(msg.now)))
        _put_tokens(out, msg.prompt)
        return T_ADMIT_REQ
    if isinstance(msg, AdmitReply):
        out.append(struct.pack(">IBIi", msg.device_id, int(msg.ok), msg.slot, msg.prev_token))
        return T_ADMIT_REPLY
    if isinstance(msg, SubmitRequest):
        out.append(struct.pack(">IId", msg.seq, msg.device_id, float(msg.now)))
        _put_tokens(out, msg.tokens)
        _encode_q(out, msg.draft_q, msg.qmode)
        return T_SUBMIT
    if isinstance(msg, SubmitAck):
        out.append(struct.pack(">I", msg.device_id))
        return T_SUBMIT_ACK
    if isinstance(msg, StepRequest):
        out.append(struct.pack(">Id", msg.seq, float(msg.now)))
        return T_STEP
    if isinstance(msg, StepReply):
        if len(msg.verdicts) > 0xFFFF:
            raise CodecError(f"too many verdicts in one step: {len(msg.verdicts)}")
        out.append(struct.pack(">IIBd", msg.queue_depth, msg.n_free, int(msg.hint is not None),
                               0.0 if msg.hint is None else float(msg.hint)))
        out.append(struct.pack(">H", len(msg.verdicts)))
        for v in msg.verdicts:
            out.append(struct.pack(">IHifIff", v.device_id, v.n_accepted, v.next_prev,
                                   float(v.accept_rate), v.queue_depth, float(v.queue_s),
                                   float(v.verify_s)))
            _put_tokens(out, v.tokens)
        return T_STEP_REPLY
    if isinstance(msg, (RetireRequest, CancelRequest, ExportStream)):
        out.append(struct.pack(">II", msg.seq, msg.device_id))
        return {RetireRequest: T_RETIRE, CancelRequest: T_CANCEL,
                ExportStream: T_EXPORT}[type(msg)]
    if isinstance(msg, (RetireReply, ExportReply)):
        _put_stream_state(out, msg.stream)
        return T_RETIRE_REPLY if isinstance(msg, RetireReply) else T_EXPORT_REPLY
    if isinstance(msg, CancelReply):
        out.append(struct.pack(">IB", msg.device_id, int(msg.ok)))
        return T_CANCEL_REPLY
    if isinstance(msg, ForceExtendRequest):
        out.append(struct.pack(">II", msg.seq, msg.device_id))
        _put_tokens(out, msg.tokens)
        return T_FORCE_EXTEND
    if isinstance(msg, ForceExtendReply):
        out.append(struct.pack(">Ii", msg.device_id, msg.next_prev))
        return T_FORCE_EXTEND_REPLY
    if isinstance(msg, ImportStream):
        out.append(struct.pack(">I", msg.seq))
        _put_stream_state(out, msg.stream)
        return T_IMPORT
    if isinstance(msg, ImportAck):
        out.append(struct.pack(">II", msg.device_id, msg.slot))
        return T_IMPORT_ACK
    if isinstance(msg, StatsRequest):
        out.append(struct.pack(">dB", float(msg.now), int(msg.has_now)))
        return T_STATS
    if isinstance(msg, ReplicaStats):
        _put_str(out, msg.stats_json)
        _put_str(out, msg.telemetry_json)
        return T_REPLICA_STATS
    if isinstance(msg, WarmupRequest):
        return T_WARMUP
    if isinstance(msg, WarmupReply):
        _put_str(out, msg.compile_json)
        return T_WARMUP_REPLY
    if isinstance(msg, Drain):
        return T_DRAIN
    if isinstance(msg, DrainAck):
        out.append(struct.pack(">I", msg.streams_left))
        return T_DRAIN_ACK
    if isinstance(msg, ErrorReply):
        _put_str(out, msg.message)
        return T_ERROR
    if isinstance(msg, (Ping, Pong)):
        out.append(struct.pack(">Id", msg.seq, float(msg.t)))
        return T_PING if isinstance(msg, Ping) else T_PONG
    raise CodecError(f"cannot encode {type(msg).__name__}")


def decode_frame(buf: bytes) -> tuple:
    """Decode one frame from the head of ``buf``; returns (message, consumed).

    Raises CodecError on a malformed header or payload; an *incomplete* frame
    (fewer bytes than the header announces) also raises: stream transports
    use FrameDecoder, which buffers instead.
    """
    if len(buf) < HEADER_SIZE:
        raise CodecError(f"truncated header: {len(buf)} < {HEADER_SIZE} bytes")
    magic, version, mtype, plen = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r}")
    if version != VERSION:
        raise CodecError(f"unsupported protocol version {version} (speak {VERSION})")
    if plen > MAX_PAYLOAD:
        raise CodecError(f"payload length {plen} exceeds cap {MAX_PAYLOAD}")
    if len(buf) < HEADER_SIZE + plen:
        raise CodecError(
            f"truncated frame: payload needs {plen} bytes, have {len(buf) - HEADER_SIZE}"
        )
    r = _Reader(bytes(buf[HEADER_SIZE : HEADER_SIZE + plen]))
    if mtype == T_HELLO:
        msg: Message = Hello(device_id=r.u32(), prompt=r.tokens())
    elif mtype == T_ADMIT:
        msg = Admit(device_id=r.u32(), ok=bool(r.u8()), slot=r.u32())
    elif mtype == T_DRAFT:
        dev, seq = r.u32(), r.u32()
        toks = r.tokens()
        q, qmode = _decode_q(r)
        if q is not None and q.shape[0] != toks.shape[0]:
            raise CodecError(f"draft_q length {q.shape[0]} != token count {toks.shape[0]}")
        msg = DraftPacket(device_id=dev, seq=seq, tokens=toks, draft_q=q, qmode=qmode)
    elif mtype == T_VERDICT:
        dev, seq, n_acc, nxt, flags = r.u32(), r.u32(), r.u16(), r.i32(), r.u8()
        accept_rate, queue_depth = r.f32(), r.u16()
        queue_s, verify_s = r.f32(), r.f32()
        msg = Verdict(
            device_id=dev,
            seq=seq,
            n_accepted=n_acc,
            tokens=r.tokens(),
            next_prev=nxt,
            flags=flags,
            accept_rate=accept_rate,
            queue_depth=queue_depth,
            queue_s=queue_s,
            verify_s=verify_s,
        )
    elif mtype == T_FALLBACK:
        msg = Fallback(device_id=r.u32(), seq=r.u32(), tokens=r.tokens())
    elif mtype == T_FALLBACK_ACK:
        msg = FallbackAck(device_id=r.u32(), seq=r.u32(), next_prev=r.i32())
    elif mtype == T_CLOSE:
        msg = Close(device_id=r.u32())
    else:
        msg = _decode_control(mtype, r)
    r.done()
    return msg, HEADER_SIZE + plen


def _decode_control(mtype: int, r: _Reader) -> Message:
    """A control-plane frame's message from its payload."""
    if mtype == T_PLACE:
        return PlaceReplica(spec_json=r.string())
    if mtype == T_PLACE_ACK:
        ok, n_slots, k_max, max_len = bool(r.u8()), r.u32(), r.u32(), r.u32()
        greedy, paged = bool(r.u8()), bool(r.u8())
        return PlaceAck(ok=ok, n_slots=n_slots, k_max=k_max, max_len=max_len, greedy=greedy,
                        paged_attention=paged, error=r.string())
    if mtype == T_ADMIT_REQ:
        seq, dev, now = r.u32(), r.u32(), r.f64()
        return AdmitRequest(device_id=dev, prompt=r.tokens(), now=now, seq=seq)
    if mtype == T_ADMIT_REPLY:
        return AdmitReply(device_id=r.u32(), ok=bool(r.u8()), slot=r.u32(), prev_token=r.i32())
    if mtype == T_SUBMIT:
        seq, dev, now = r.u32(), r.u32(), r.f64()
        toks = r.tokens()
        q, qmode = _decode_q(r)
        if q is not None and q.shape[0] != toks.shape[0]:
            raise CodecError(f"draft_q length {q.shape[0]} != token count {toks.shape[0]}")
        return SubmitRequest(device_id=dev, tokens=toks, now=now, draft_q=q, qmode=qmode,
                             seq=seq)
    if mtype == T_SUBMIT_ACK:
        return SubmitAck(device_id=r.u32())
    if mtype == T_STEP:
        seq = r.u32()
        return StepRequest(now=r.f64(), seq=seq)
    if mtype == T_STEP_REPLY:
        depth, n_free, has_hint, hint = r.u32(), r.u32(), r.u8(), r.f64()
        verdicts = []
        for _ in range(r.u16()):
            dev, n_acc, nxt, rate, vdepth = r.u32(), r.u16(), r.i32(), r.f32(), r.u32()
            queue_s, verify_s = r.f32(), r.f32()
            verdicts.append(VerdictRec(device_id=dev, n_accepted=n_acc, tokens=r.tokens(),
                                       next_prev=nxt, accept_rate=rate, queue_depth=vdepth,
                                       queue_s=queue_s, verify_s=verify_s))
        return StepReply(verdicts=tuple(verdicts), queue_depth=depth, n_free=n_free,
                         hint=hint if has_hint else None)
    if mtype in (T_RETIRE, T_CANCEL, T_EXPORT):
        seq, dev = r.u32(), r.u32()
        cls = {T_RETIRE: RetireRequest, T_CANCEL: CancelRequest, T_EXPORT: ExportStream}[mtype]
        return cls(device_id=dev, seq=seq)
    if mtype == T_RETIRE_REPLY:
        return RetireReply(stream=r.stream_state())
    if mtype == T_CANCEL_REPLY:
        return CancelReply(device_id=r.u32(), ok=bool(r.u8()))
    if mtype == T_FORCE_EXTEND:
        seq = r.u32()
        return ForceExtendRequest(device_id=r.u32(), tokens=r.tokens(), seq=seq)
    if mtype == T_FORCE_EXTEND_REPLY:
        return ForceExtendReply(device_id=r.u32(), next_prev=r.i32())
    if mtype == T_EXPORT_REPLY:
        return ExportReply(stream=r.stream_state())
    if mtype == T_IMPORT:
        seq = r.u32()
        return ImportStream(stream=r.stream_state(), seq=seq)
    if mtype == T_IMPORT_ACK:
        return ImportAck(device_id=r.u32(), slot=r.u32())
    if mtype == T_STATS:
        return StatsRequest(now=r.f64(), has_now=bool(r.u8()))
    if mtype == T_REPLICA_STATS:
        return ReplicaStats(stats_json=r.string(), telemetry_json=r.string())
    if mtype == T_WARMUP:
        return WarmupRequest()
    if mtype == T_WARMUP_REPLY:
        return WarmupReply(compile_json=r.string())
    if mtype == T_DRAIN:
        return Drain()
    if mtype == T_DRAIN_ACK:
        return DrainAck(streams_left=r.u32())
    if mtype == T_ERROR:
        return ErrorReply(message=r.string())
    if mtype in (T_PING, T_PONG):
        seq, t = r.u32(), r.f64()
        return Ping(seq=seq, t=t) if mtype == T_PING else Pong(seq=seq, t=t)
    raise CodecError(f"unknown message type {mtype}")


class FrameDecoder:
    """Incremental decoder for byte-stream transports: feed arbitrary chunks,
    iterate complete messages (partial frames wait for more bytes)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def next_raw(self) -> Optional[bytes]:
        """Pop the next COMPLETE frame as raw bytes (header+payload), or None
        when more bytes are needed; a corrupt header raises the precise
        CodecError."""
        if len(self._buf) < HEADER_SIZE:
            return None
        magic, version, _, plen = _HEADER.unpack_from(self._buf)
        if magic != MAGIC or version != VERSION or plen > MAX_PAYLOAD:
            decode_frame(bytes(self._buf))  # raises the precise error
        if len(self._buf) < HEADER_SIZE + plen:
            return None
        raw = bytes(self._buf[: HEADER_SIZE + plen])
        del self._buf[: HEADER_SIZE + plen]
        return raw

    def __iter__(self) -> Iterator[Message]:
        while True:
            raw = self.next_raw()
            if raw is None:
                return
            yield decode_frame(raw)[0]
