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

Decoding returns f32 either way. Message types 8-34 (the Router <-> worker
control plane of codec v3/v4) are reserved: decoding one raises
:class:`CodecError` until the control plane is ported (ROADMAP.md Queue A).
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
# 8-34: the control plane (PlaceReplica ... Pong), not ported yet
_CONTROL_PLANE = range(8, 35)

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


Message = Union[Hello, Admit, DraftPacket, Verdict, Fallback, FallbackAck, Close]


# -- primitive encoders ------------------------------------------------------


def _put_tokens(out: List[bytes], toks: np.ndarray) -> None:
    toks = np.ascontiguousarray(np.asarray(toks, dtype="<i4"))
    if toks.ndim != 1:
        raise CodecError(f"token vector must be 1-D, got shape {toks.shape}")
    if toks.shape[0] > 0xFFFF:
        raise CodecError(f"token vector too long: {toks.shape[0]}")
    out.append(struct.pack(">H", toks.shape[0]))
    out.append(toks.tobytes())


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

    def tokens(self) -> np.ndarray:
        n = self.u16()
        return np.frombuffer(self.take(4 * n), dtype="<i4").astype(np.int32)

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
        raise CodecError(f"cannot encode {type(msg).__name__}")
    payload = b"".join(out)
    return _HEADER.pack(MAGIC, VERSION, mtype, len(payload)) + payload


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
    elif mtype in _CONTROL_PLANE:
        raise CodecError(
            f"message type {mtype} belongs to the control plane, which is not ported yet "
            "(ROADMAP.md Queue A)"
        )
    else:
        raise CodecError(f"unknown message type {mtype}")
    r.done()
    return msg, HEADER_SIZE + plen


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
