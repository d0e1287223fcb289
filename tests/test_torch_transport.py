"""The port's transport backend, held to the JAX package.

Links: loopback order, the SimulatedLink's delays and drops (the JAX
link's for one seed, on a frozen clock), TCP and UDS round trips, and a
listening server that closes with an accepted endpoint still open (Python
3.12's ``Server.wait_closed()`` waits for every accepted connection; the
port's listener closes them). Controllers: the JAX sequences of k and
c_th. Serving: ``System`` with ``backend="transport"`` on loopback (one
replica) and on a simulated lossless WLAN (two replicas) commits the
streams of the port's reference and of the JAX reference; a §III-A
fallback resyncs the server and the stream completes; a streamed session
closed early frees its slot.
"""
import asyncio
import dataclasses
import time

import numpy as np
import pytest

from repro.api import ServeSpec as JServeSpec
from repro.api import System as JSystem
from repro.serving import devices as jdevices
from repro.serving import speclen as jspeclen
from repro.transport import links as jlinks
from repro_torch import telemetry
from repro_torch.api import ServeSpec, System, build_models
from repro_torch.api.spec import ClusterSpec, DeviceClassSpec, FleetSpec, TransportSpec
from repro_torch.core.server_engine import EdgeDeviceKit, ServerEngine
from repro_torch.serving import devices, speclen
from repro_torch.transport import codec, links
from repro_torch.transport.client import EdgeClient
from repro_torch.transport.server import TransportServer
from test_torch_serve import SPEC_JSON, _assert_same_tokens, _port_bundle, jax_build_models

WAIT = 10.0  # every socket await in these tests is bounded


def test_loopback_link_is_immediate_fifo():
    async def inner():
        link = links.LoopbackLink()
        for i in range(5):
            await link.device.send(bytes([i]))
        got = [await link.server.recv() for _ in range(5)]
        assert got == [bytes([i]) for i in range(5)]
        link.device.close()
        assert await link.server.recv() is None
        assert link.device.stats.frames_tx == 5 and link.server.stats.bytes_rx == 5

    asyncio.run(inner())


async def _staged(mod, net, seed: int, sizes):
    """Frames of ``sizes`` sent both ways through ``mod.SimulatedLink`` on a
    frozen clock (1 ms apart): each direction's (arrival, frame) schedule
    and drop count, before any frame is forwarded."""
    loop = asyncio.get_running_loop()
    clock = [100.0]
    loop.time = lambda: clock[0]
    try:
        link = mod.SimulatedLink(net, seed=seed)
        for i, n in enumerate(sizes):
            clock[0] = 100.0 + 1e-3 * i
            await link.device.send(bytes(n))
            await link.server.send(bytes(n))
        pipes = (link.device._out, link.server._out)
        out = [list(p._staged._queue) for p in pipes]
        drops = (link.device.stats.frames_dropped, link.server.stats.frames_dropped)
        for p in pipes:
            p._task.cancel()
    finally:
        del loop.time
    return out, drops


@pytest.mark.parametrize("net", ["wlan", "lte", "lossy-wlan"])
def test_simulated_link_draws_the_jax_delays_and_drops(net):
    """One seed, one send schedule: every frame's arrival time and every
    drop equal the JAX link's, both directions."""
    sizes = np.random.default_rng(0).integers(8, 4000, size=300).tolist()
    mine = asyncio.run(_staged(links, devices.NETS[net], 7, sizes))
    theirs = asyncio.run(_staged(jlinks, jdevices.NETS[net], 7, sizes))
    assert mine == theirs
    if devices.NETS[net].drop_prob > 0:
        assert sum(mine[1]) > 0


FRAMES = [codec.encode_frame(m) for m in (
    codec.Hello(1, np.arange(300, dtype=np.int32)),
    codec.DraftPacket(1, 0, np.asarray([3, 4], np.int32), draft_q=np.asarray([0.5, 0.25],
                                                                             np.float32),
                      qmode="f16"),
    codec.Close(1),
)]


async def _echo_round_trip(listen, dial) -> None:
    """Frames through an echo server: back whole and in order."""
    async def echo(ep):
        while (frame := await ep.recv()) is not None:
            await ep.send(frame)

    server, where = await asyncio.wait_for(listen(echo), WAIT)
    ep = await asyncio.wait_for(dial(where), WAIT)
    for f in FRAMES:
        await asyncio.wait_for(ep.send(f), WAIT)
    back = [await asyncio.wait_for(ep.recv(), WAIT) for _ in FRAMES]
    assert back == FRAMES
    ep.close()
    server.close()
    await asyncio.wait_for(server.wait_closed(), WAIT)


def test_tcp_round_trip():
    asyncio.run(_echo_round_trip(lambda cb: links.tcp_listen(cb),
                                 lambda port: links.tcp_connect("127.0.0.1", port)))


def test_uds_round_trip(tmp_path):
    addr = f"uds:{tmp_path / 's.sock'}"
    asyncio.run(_echo_round_trip(lambda cb: links.listen_addr(cb, addr), links.connect_addr))


async def _close_with_an_endpoint_open(mod) -> bool:
    """A listener whose accepted endpoint stays open (the server side keeps
    it, as a TransportServer does); True when ``wait_closed()`` returns
    within a second of ``close()``."""
    held = []
    server, port = await mod.tcp_listen(held.append)
    ep = await asyncio.wait_for(mod.tcp_connect("127.0.0.1", port), WAIT)
    await ep.send(FRAMES[2])
    while not held:
        await asyncio.sleep(0.01)
    assert await asyncio.wait_for(held[0].recv(), WAIT) == FRAMES[2]
    server.close()
    try:
        await asyncio.wait_for(server.wait_closed(), 1.0)
        closed = True
    except asyncio.TimeoutError:
        closed = False
    for e in held + [ep]:
        e.close()
    return closed


def test_server_close_returns_with_an_accepted_endpoint_open():
    """Closing the port's listener closes what it accepted, so
    ``wait_closed()`` returns; the JAX package's listener, the same way, is
    still waiting after a second (on Python 3.12 and later)."""
    async def inner():
        mine = await asyncio.wait_for(_close_with_an_endpoint_open(links), 5.0)
        theirs = await asyncio.wait_for(_close_with_an_endpoint_open(jlinks), 5.0)
        return mine, theirs

    mine, theirs = asyncio.run(inner())
    assert mine
    assert not theirs


# (accept_rate, queue_depth) feedback: rejections, congestion, recovery
FEEDBACK = ([(1.0, 0)] * 6 + [(0.2, 0)] * 4 + [(0.9, 5)] * 3 + [(0.5, 1)] * 3
            + [(0.8, 0), (0.75, 2), (0.0, 3), (1.0, 0)] * 3)


@pytest.mark.parametrize("kw", [{}, {"k_init": 2, "ewma": 1.0}, {"k_min": 2, "queue_hi": 4}])
def test_spec_len_controller_gives_the_jax_k(kw):
    mine = speclen.make_controller("adaptive", k_max=8, **kw)
    theirs = jspeclen.make_controller("adaptive", k_max=8, **kw)
    assert [mine.update(a, d) for a, d in FEEDBACK] == [theirs.update(a, d) for a, d in FEEDBACK]
    assert (mine.increases, mine.decreases) == (theirs.increases, theirs.decreases)
    assert speclen.make_controller("fixed", k_max=4) is None


@pytest.mark.parametrize("kw", [{}, {"step": 0.1, "ewma": 1.0}, {"c_max": 0.6, "queue_hi": 4}])
def test_confidence_controller_gives_the_jax_c_th(kw):
    mine = speclen.make_confidence_controller("adaptive", c_init=0.3, **kw)
    theirs = jspeclen.make_confidence_controller("adaptive", c_init=0.3, **kw)
    assert [mine.update(a, d) for a, d in FEEDBACK] == [theirs.update(a, d) for a, d in FEEDBACK]
    assert mine.c_mean == theirs.c_mean
    with pytest.raises(ValueError, match="unknown cctl"):
        speclen.make_confidence_controller("warp", c_init=0.3)


@pytest.mark.parametrize("change", [
    dict(),
    dict(kctl="adaptive", cctl="adaptive"),
    dict(cluster=ClusterSpec(replicas=2), transport=TransportSpec(link="sim", net="wlan")),
])
def test_transport_serve_equals_reference_and_jax(change):
    """examples/specs/engine.json on the transport backend: loopback to one
    replica (fixed and adaptive k and c_th: greedy tokens do not depend on
    where a round stops), and a simulated lossless WLAN to two replicas.
    The streams equal the port's reference and the JAX reference; no round
    fell back and the wire counters are filled."""
    jspec = JServeSpec.from_json(SPEC_JSON)
    pspec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), backend="transport", **change)
    mb = jax_build_models(jspec.model)
    pb = _port_bundle(mb)
    prompts = np.random.default_rng(5).integers(
        0, jspec.model.vocab_size, size=(jspec.devices, jspec.prompt_len)).astype(np.int32)
    want = JSystem.build(jspec.with_backend("reference"), models=mb).serve(prompts).outputs
    ref = System.build(pspec.with_backend("reference"), models=pb, device="cpu").serve(prompts)
    res = System.build(pspec, models=pb, device="cpu").serve(prompts)
    n = len(want)
    _assert_same_tokens([ref.outputs[i] for i in range(n)], [want[i] for i in range(n)], mb,
                        prompts)
    _assert_same_tokens([res.outputs[i] for i in range(n)], [ref.outputs[i] for i in range(n)],
                        mb, prompts)
    st, cl = res.engine, res.clients
    assert st.replicas == pspec.cluster.n_replicas and st.streams_served == n
    assert st.fallback_rounds == st.timeouts == st.frames_dropped == cl.fallback_rounds == 0
    assert st.frames_rx == cl.frames_tx > 0 and st.bytes_tx == cl.bytes_rx > 0
    assert all(s.client is not None for s in res.sessions)


class _DropNthDraft(links.LoopbackLink):
    """Loopback that eats exactly the n-th DraftPacket on the uplink."""

    def __init__(self, n: int):
        super().__init__()
        self._n, self._count = n, 0
        inner_put = self.device._out.put

        async def put(frame):
            if isinstance(codec.decode_frame(frame)[0], codec.DraftPacket):
                self._count += 1
                if self._count == self._n:
                    self.device.stats.frames_dropped += 1
                    return
            await inner_put(frame)

        self.device._out.put = put


def test_fallback_resyncs_the_server_and_the_stream_completes():
    """The second draft packet is lost: the client times out, releases its
    drafts (§III-A), the server force-extends the stream with them, and the
    stream runs to its budget with client and server holding the same
    committed tokens."""
    spec = ServeSpec.from_json(SPEC_JSON)
    pb = build_models(spec.model, device="cpu")
    engine = ServerEngine(pb.target, pb.target_params, n_slots=1, max_len=128, k_max=4,
                          attn_chunk=32, device="cpu")
    kit = EdgeDeviceKit(pb.draft, pb.draft_params, k_max=4, c_th=0.3, attn_chunk=32,
                        device="cpu")
    retired = {}
    retire = engine.retire
    engine.retire = lambda dev: retired.setdefault(dev, retire(dev))
    prompt = np.random.default_rng(6).integers(0, 128, size=12).astype(np.int32)

    async def inner():
        server = TransportServer(engine)
        link = _DropNthDraft(2)
        server.attach(link.server)
        client = EdgeClient(kit, 0, prompt, link.device, max_new=10, max_len=128,
                            verify_timeout=1.0, admit_timeout=1.0)
        out = await asyncio.wait_for(client.run(), 60)
        for _ in range(500):
            if not engine.streams:
                break
            await asyncio.sleep(0.01)
        stats = server.stats()
        await server.stop()
        return out, client, stats

    out, client, stats = asyncio.run(inner())
    assert client.stats.fallback_rounds == stats.fallback_rounds == 1
    assert client.stats.fallback_tokens == stats.fallback_tokens > 0
    assert len(out) == 10 and retired[0].committed == client.device.committed
    assert stats.frames_dropped == 0 and client.stats.frames_dropped == 1


def test_streamed_session_closed_early_frees_its_slot():
    spec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), backend="transport", max_new=64)
    system = System.build(spec, models=build_models(spec.model, device="cpu"), device="cpu")
    gen = system.open_session(device_id=0).generate()
    assert next(gen) is not None  # the stream is live
    t0 = time.time()
    gen.close()
    deadline = t0 + 30.0
    while system.engine.streams and time.time() < deadline:
        time.sleep(0.05)
    assert not system.engine.streams and system.engine.pool.n_free == system.engine.pool.n_slots
    assert time.time() - t0 < 30.0


def test_rate_for_scales_the_class_rate():
    classes = (DeviceClassSpec(profile="jetson-orin-nano", count=2, bits=4, k=4),
               DeviceClassSpec(profile="rpi4b", count=1, bits=4, k=2))
    spec = ServeSpec(backend="transport", fleet=FleetSpec(classes=classes, emulate_rates=True,
                                                          rate_scale=2.5),
                     transport=TransportSpec(draft_rate=9.0))
    system = System.build(spec, models=build_models(spec.model, device="cpu"), device="cpu")
    assert [system.rate_for(d) for d in range(3)] == pytest.approx(
        [21.0 * 2.5, 21.0 * 2.5, 3.1 * 2.5])
    plain = System.build(dataclasses.replace(spec, fleet=FleetSpec(classes=classes)),
                         models=system.models, device="cpu")
    assert plain.rate_for(0) == 9.0


def test_telemetry_traces_rounds_and_reads_the_pools():
    """With telemetry on, each transport session carries its client's
    per-round trace (one event per round, wire time attributed) and the
    serve's payload holds the metrics snapshot, each replica's pool and
    the Router's flight rings (every round, tagged with its replica)."""
    spec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), backend="transport",
                               cluster=ClusterSpec(replicas=2), telemetry=True)
    try:
        res = System.build(spec, models=build_models(spec.model, device="cpu"),
                           device="cpu").serve()
    finally:
        telemetry.enable(False)
    for s in res.sessions:
        assert len(s.trace) == s.rounds > 0
        assert all(ev.wire_s >= 0 and ev.device_id == s.device_id for ev in s.trace)
    payload = res.telemetry
    assert set(payload["pools"]) == {"0", "1"}
    assert len(payload["flight"]) == sum(s.rounds for s in res.sessions)
    assert {ev["replica"] for ev in payload["flight"]} <= {0, 1}
    assert "client_round_seconds" in payload["snapshot"]["histograms"]
