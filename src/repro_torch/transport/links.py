"""Pluggable edge<->server channels: loopback, simulated, and real sockets.

The port of ``repro.transport.links``, with the same classes, signatures and
random draws (a seeded ``random.Random`` in the JAX order, so one seed
gives the same delays and drops). One repair: on Python 3.12
``asyncio.Server.wait_closed()`` waits until every accepted connection is
closed, so the server that ``tcp_listen``/``listen_addr`` return closes its
accepted endpoints when it is closed (see :class:`_Listener`).

A link is a pair of :class:`Endpoint` halves (device side, server side); each
half sends and receives whole encoded frames (bytes).  Implementations:

  LoopbackLink   — in-memory queues, zero latency, nothing dropped: the
                   baseline for token-for-token equivalence checks.
  SimulatedLink  — every frame pays serialization (bytes * 8 / bandwidth, a
                   shared per-direction line: back-to-back frames queue behind
                   each other) plus propagation (one-way latency + gaussian
                   jitter), and may be dropped.  Delivery is FIFO per
                   direction — jitter never reorders frames, it only widens
                   gaps — which mirrors a TCP-like transport and keeps the
                   protocol free of sequence-gap handling.
  StreamEndpoint — one half of a REAL byte-stream socket (TCP or UDS):
                   frames ride an asyncio StreamReader/Writer and are
                   reassembled from arbitrary read chunks by the codec's
                   FrameDecoder (the wire format is already length-prefixed).
                   ``tcp_listen``/``tcp_connect`` open localhost-or-beyond
                   endpoint pairs, so client and server can run in separate
                   processes.

Per-endpoint LinkStats count frames/bytes both ways plus drops, so wire cost
is measurable end-to-end (the transport server folds them into EngineStats).
"""
from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Awaitable, Callable, List, Optional, Tuple

from repro_torch.serving.devices import NetProfile
from repro_torch.transport.codec import FrameDecoder

_CLOSE = object()  # queue sentinel: peer closed its sending half


@dataclasses.dataclass
class LinkStats:
    frames_tx: int = 0
    bytes_tx: int = 0
    frames_rx: int = 0
    bytes_rx: int = 0
    frames_dropped: int = 0


class Endpoint:
    """One half of a link: ``await send(frame)`` / ``await recv()``.

    ``recv`` returns None once the peer has closed and all in-flight frames
    have drained.  Concrete pipes are installed by the Link constructors.
    """

    def __init__(self):
        self.stats = LinkStats()
        self._out: Optional["_Pipe"] = None
        self._in: Optional["_Pipe"] = None
        self._closed = False

    async def send(self, frame: bytes) -> None:
        if self._closed:
            raise ConnectionError("endpoint is closed")
        self.stats.frames_tx += 1
        self.stats.bytes_tx += len(frame)
        await self._out.put(frame)

    async def recv(self) -> Optional[bytes]:
        frame = await self._in.get()
        if frame is _CLOSE:
            return None
        self.stats.frames_rx += 1
        self.stats.bytes_rx += len(frame)
        return frame

    def close(self) -> None:
        """Close the sending half; the peer's recv() drains then returns None."""
        if not self._closed:
            self._closed = True
            self._out.put_nowait_close()


class _Pipe:
    """Direct queue pipe (loopback): frames appear immediately, in order."""

    def __init__(self):
        self.q: asyncio.Queue = asyncio.Queue()

    async def put(self, frame) -> None:
        self.q.put_nowait(frame)

    def put_nowait_close(self) -> None:
        self.q.put_nowait(_CLOSE)

    async def get(self):
        return await self.q.get()


class _SimPipe(_Pipe):
    """One direction of a simulated link.

    The sender computes each frame's arrival time (line-busy serialization +
    propagation + jitter, monotonically non-decreasing so delivery stays
    FIFO); a forwarder task sleeps until that wall-clock instant and only
    then exposes the frame to the receiver.
    """

    def __init__(self, net: NetProfile, rng: random.Random, stats: LinkStats):
        super().__init__()
        self.net = net
        self.rng = rng
        self.stats = stats
        self._staged: asyncio.Queue = asyncio.Queue()
        self._line_free = 0.0
        self._last_arrival = 0.0
        self._task: Optional[asyncio.Task] = None

    def _ensure_forwarder(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._forward())

    async def put(self, frame) -> None:
        self._ensure_forwarder()
        if self.rng.random() < self.net.drop_prob:
            self.stats.frames_dropped += 1
            return
        now = asyncio.get_running_loop().time()
        start = max(now, self._line_free)
        self._line_free = start + len(frame) * 8.0 / self.net.bandwidth_bps
        propagation = max(0.0, self.net.one_way + self.rng.gauss(0.0, self.net.rtt_jitter / 2))
        arrival = max(self._line_free + propagation, self._last_arrival)
        self._last_arrival = arrival
        self._staged.put_nowait((arrival, frame))

    def put_nowait_close(self) -> None:
        # the close rides the wire behind any staged frames
        if self._task is None:
            self.q.put_nowait(_CLOSE)
        else:
            self._staged.put_nowait((self._last_arrival, _CLOSE))

    async def _forward(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            arrival, frame = await self._staged.get()
            delay = arrival - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            self.q.put_nowait(frame)
            if frame is _CLOSE:
                return


def _wire(a: Endpoint, b: Endpoint, ab: _Pipe, ba: _Pipe) -> None:
    a._out, b._in = ab, ab
    b._out, a._in = ba, ba


class LoopbackLink:
    """Zero-latency, lossless in-memory link."""

    def __init__(self):
        self.device = Endpoint()
        self.server = Endpoint()
        _wire(self.device, self.server, _Pipe(), _Pipe())

    @property
    def endpoints(self) -> Tuple[Endpoint, Endpoint]:
        return self.device, self.server


class SimulatedLink:
    """Link with a NetProfile imposed on every frame, both directions.

    Uplink (device->server) and downlink share the profile but have
    independent lines and jitter streams; ``seed`` makes a run reproducible.
    """

    def __init__(self, net: NetProfile, *, seed: int = 0):
        self.net = net
        self.device = Endpoint()
        self.server = Endpoint()
        up = _SimPipe(net, random.Random(seed * 2 + 1), self.device.stats)
        down = _SimPipe(net, random.Random(seed * 2 + 2), self.server.stats)
        _wire(self.device, self.server, up, down)

    @property
    def endpoints(self) -> Tuple[Endpoint, Endpoint]:
        return self.device, self.server


class StreamEndpoint(Endpoint):
    """Endpoint over a real asyncio byte stream (TCP / unix socket).

    ``send`` writes the already-encoded frame to the socket; ``recv`` feeds
    read chunks into a :class:`~repro_torch.transport.codec.FrameDecoder` and pops
    complete frames — the codec's length-prefixed header does the stream
    reassembly, so arbitrary TCP segmentation (half a header here, three
    frames there) never splits or merges a message.
    """

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        super().__init__()
        self._reader = reader
        self._writer = writer
        self._decoder = FrameDecoder()

    async def send(self, frame: bytes) -> None:
        if self._closed:
            raise ConnectionError("endpoint is closed")
        self.stats.frames_tx += 1
        self.stats.bytes_tx += len(frame)
        self._writer.write(frame)
        await self._writer.drain()

    async def recv(self) -> Optional[bytes]:
        while True:
            frame = self._decoder.next_raw()
            if frame is not None:
                self.stats.frames_rx += 1
                self.stats.bytes_rx += len(frame)
                return frame
            data = await self._reader.read(65536)
            if not data:  # peer closed; trailing partial frames are dropped
                return None
            self._decoder.feed(data)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._writer.close()


class _Listener:
    """The listening server plus the endpoints it accepted.

    On Python 3.12 ``asyncio.Server.wait_closed()`` waits until every
    accepted connection is closed, and ``close()`` closes only the listening
    socket: a caller that keeps a server-side endpoint open (the JAX
    package's links.py returns the bare server) waits for ever. This
    ``close()`` closes the accepted endpoints too, so ``wait_closed()``
    returns. Everything else is the asyncio server's.
    """

    def __init__(self, server: asyncio.AbstractServer, accepted: List["StreamEndpoint"]):
        self._server = server
        self._accepted = accepted

    def close(self) -> None:
        self._server.close()
        for ep in self._accepted:
            ep.close()

    def __getattr__(self, name: str):
        return getattr(self._server, name)


def _accepting(on_endpoint: Callable[[StreamEndpoint], Awaitable[None] | None],
               accepted: List[StreamEndpoint]):
    async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        ep = StreamEndpoint(reader, writer)
        accepted[:] = [e for e in accepted if not e._closed]  # a long-lived server
        accepted.append(ep)
        result = on_endpoint(ep)
        if asyncio.iscoroutine(result):
            await result

    return handle


async def tcp_listen(
    on_endpoint: Callable[[StreamEndpoint], Awaitable[None] | None],
    host: str = "127.0.0.1",
    port: int = 0,
) -> Tuple[asyncio.AbstractServer, int]:
    """Listen for frame-stream connections; ``on_endpoint`` is called with a
    StreamEndpoint per accepted socket (e.g. TransportServer.attach).
    Returns ``(server, bound_port)``; port 0 picks a free one. Closing the
    server closes the endpoints it accepted."""
    accepted: List[StreamEndpoint] = []
    server = await asyncio.start_server(_accepting(on_endpoint, accepted), host, port)
    bound = server.sockets[0].getsockname()[1]
    return _Listener(server, accepted), bound


async def tcp_connect(host: str, port: int) -> StreamEndpoint:
    """Device-side half of a TCP link (server side comes from tcp_listen)."""
    reader, writer = await asyncio.open_connection(host, port)
    return StreamEndpoint(reader, writer)


def parse_addr(addr: str):
    """Parse a listen/dial address into ``("tcp", host, port)`` or
    ``("uds", path)``.

    Accepted forms: ``tcp:HOST:PORT`` (port 0 = pick a free one),
    ``uds:/path/to.sock``, and bare ``HOST:PORT`` as a tcp shorthand.
    """
    if addr.startswith("uds:"):
        path = addr[len("uds:"):]
        if not path:
            raise ValueError(f"uds address needs a socket path: {addr!r}")
        return ("uds", path)
    rest = addr[len("tcp:"):] if addr.startswith("tcp:") else addr
    host, sep, port_s = rest.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"bad address {addr!r} (want tcp:HOST:PORT or uds:/path.sock)"
        )
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"bad port in address {addr!r}") from None
    return ("tcp", host, port)


async def listen_addr(
    on_endpoint: Callable[[StreamEndpoint], Awaitable[None] | None],
    addr: str,
) -> Tuple[asyncio.AbstractServer, str]:
    """Listen on a ``tcp:``/``uds:`` address; returns ``(server, resolved)``
    where ``resolved`` has any port-0 replaced by the bound port. Closing
    the server closes the endpoints it accepted."""
    parsed = parse_addr(addr)
    if parsed[0] == "uds":
        accepted: List[StreamEndpoint] = []
        server = await asyncio.start_unix_server(_accepting(on_endpoint, accepted),
                                                 path=parsed[1])
        return _Listener(server, accepted), f"uds:{parsed[1]}"
    _, host, port = parsed
    server, bound = await tcp_listen(on_endpoint, host, port)
    return server, f"tcp:{host}:{bound}"


async def connect_addr(addr: str) -> StreamEndpoint:
    """Dial a ``tcp:``/``uds:`` address; the other half of listen_addr."""
    parsed = parse_addr(addr)
    if parsed[0] == "uds":
        reader, writer = await asyncio.open_unix_connection(parsed[1])
        return StreamEndpoint(reader, writer)
    return await tcp_connect(parsed[1], parsed[2])


def make_link(kind: str, net: Optional[NetProfile] = None, *, seed: int = 0):
    """Factory: ``loopback`` or ``sim`` (requires a NetProfile).  TCP links
    are connection-oriented — open them with tcp_listen/tcp_connect."""
    if kind == "loopback":
        return LoopbackLink()
    if kind == "sim":
        if net is None:
            raise ValueError("sim links need a NetProfile (serving/devices.py NETS)")
        return SimulatedLink(net, seed=seed)
    raise ValueError(
        f"unknown link kind {kind!r} (loopback | sim; tcp endpoints come from "
        f"tcp_listen/tcp_connect)"
    )
