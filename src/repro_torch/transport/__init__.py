"""Async edge<->server transport runtime, the port of ``repro.transport``.

  codec.py   - length-prefixed binary frames, byte for byte the JAX
               package's: the data plane (Hello, Admit, DraftPacket,
               Verdict, Fallback, FallbackAck, Close) with the f16/int8
               draft-q payloads and the controllers' feedback, and the
               control plane (types 8-34: PlaceReplica ... Pong)
  links.py   - loopback, a SimulatedLink imposing a NetProfile's latency,
               bandwidth, jitter and drops on every frame, and
               StreamEndpoint over TCP/UDS sockets
  server.py  - asyncio TransportServer fronting a ServerEngine or a Router
  client.py  - asyncio EdgeClient: pipelined draft-ahead device loop with
               the §III-A fallback, reconnect, adaptive k and c_th
  worker.py  - the remote replica worker: WorkerCore dispatches the
               control frames (codec types 8-34) against one engine,
               ReplicaWorker serves them on a socket
               (``python -m repro_torch.transport.worker``)
"""

from repro_torch.transport.codec import (
    Admit,
    Close,
    CodecError,
    DraftPacket,
    Fallback,
    FallbackAck,
    FrameDecoder,
    Hello,
    Verdict,
    decode_frame,
    encode_frame,
)
from repro_torch.transport.links import (
    LinkStats,
    LoopbackLink,
    SimulatedLink,
    StreamEndpoint,
    connect_addr,
    listen_addr,
    make_link,
    parse_addr,
    tcp_connect,
    tcp_listen,
)

__all__ = [
    "Admit",
    "Close",
    "CodecError",
    "DraftPacket",
    "Fallback",
    "FallbackAck",
    "FrameDecoder",
    "Hello",
    "Verdict",
    "decode_frame",
    "encode_frame",
    "LinkStats",
    "LoopbackLink",
    "SimulatedLink",
    "StreamEndpoint",
    "connect_addr",
    "listen_addr",
    "make_link",
    "parse_addr",
    "tcp_connect",
    "tcp_listen",
]
