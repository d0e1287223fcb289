"""Async edge<->server transport runtime, the port of ``repro.transport``.

  codec.py   - length-prefixed binary frames of the data plane (Hello,
               Admit, DraftPacket, Verdict, Fallback, FallbackAck, Close),
               byte for byte the JAX package's, with the f16/int8 draft-q
               payloads; v2 Verdicts carry acceptance and queue-depth
               feedback for the adaptive controllers
  links.py   - loopback, a SimulatedLink imposing a NetProfile's latency,
               bandwidth, jitter and drops on every frame, and
               StreamEndpoint over TCP/UDS sockets
  server.py  - asyncio TransportServer fronting a ServerEngine or a Router
  client.py  - asyncio EdgeClient: pipelined draft-ahead device loop with
               the §III-A fallback, reconnect, adaptive k and c_th

The control plane (worker processes, codec frames 8-34) comes with the next
slice (ROADMAP.md Queue A).
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
