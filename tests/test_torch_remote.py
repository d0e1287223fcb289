"""The port's remote replicas in real worker processes, on the CPU.

``System.build`` with two remote replicas spawns two
``python -m repro_torch.transport.worker --device cpu`` processes on
private unix sockets, places the spec on each and serves through a Router
over them; the streams must equal the port's in-process cluster on the
same spec (the workers rebuild the weights from its seed), on the cluster
and the transport backends, and ``close()`` must leave no process and no
socket directory behind. The mirror of the JAX package's
``tests/test_worker.py::test_spawned_workers_token_identical_across_backends``,
which is marked slow there; this one runs at that test's size, unmarked.

Every wait is bounded: the worker's start by ``spawn_worker``'s
``startup_timeout``, each RPC by the control channel's timeout, each serve
by a watchdog thread (``_bounded``), so a hang fails the test. The file
also holds the two repairs of the sampled transport serve that hung (a
spec refused at build; a server task that raises fails the serve, and a
worker's data plane fails its serve on the same bad frame).
"""
import asyncio
import dataclasses
import os
import threading

import numpy as np
import pytest

from repro_torch.api import ServeSpec, System, build_models
from repro_torch.api.spec import ClusterSpec, ModelSpec, SchedulerSpec
from repro_torch.cluster.remote import worker_sock_dir
from repro_torch.transport import codec
from repro_torch.transport.links import connect_addr
from repro_torch.transport.server import TransportServer
from repro_torch.transport.worker import ReplicaWorker, build_engine_from_spec

SERVE_BOUND_S = 120.0


def _spec(**kw) -> ServeSpec:
    base = dict(
        backend="cluster",
        model=ModelSpec(vocab_size=64, target_layers=2, draft_layers=1, draft_noise=0.03),
        cluster=ClusterSpec(replicas=2),
        scheduler=SchedulerSpec(slots=2, stagger_ticks=1),
        devices=4, prompt_len=6, max_new=6, k_max=3, c_th=0.3,
    )
    base.update(kw)
    return ServeSpec(**base)


def _bounded(fn, seconds: float = SERVE_BOUND_S):
    """``fn()`` on a watchdog thread: its result, its exception, or a
    failure when it has not returned within ``seconds``."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test's thread below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"no result within {seconds} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("backend", ["cluster", "transport"])
def test_spawned_workers_serve_the_inproc_clusters_tokens(backend):
    """Two real worker processes, spawned and placed by System.build on the
    CPU, commit the in-process cluster's streams; close() reaps both and
    removes their socket directories."""
    spec = _spec()
    want = System.build(spec, models=build_models(spec.model, device="cpu"),
                        device="cpu").serve().outputs
    remote = dataclasses.replace(
        spec, backend=backend, cluster=ClusterSpec(replicas=[{"flavor": "remote"}] * 2))
    system = _bounded(lambda: System.build(remote, device="cpu"))
    procs, dirs = [], []
    try:
        replicas = system.engine.replicas
        assert [r.flavor for r in replicas] == ["remote", "remote"]
        procs = [r.proc for r in replicas]
        dirs = [worker_sock_dir(r.address) for r in replicas]
        assert all(d is not None and os.path.isdir(d) for d in dirs)
        got = _bounded(lambda: system.serve().outputs)
        assert system.engine.evictions == 0
    finally:
        system.close()
    assert got == want, f"{backend} over worker processes diverged from the in-process cluster"
    for proc, d in zip(procs, dirs):
        assert proc.poll() is not None and not _alive(proc.pid)
        assert not os.path.exists(d)
    system.close()  # twice is safe


def test_sampled_transport_without_q_is_refused():
    """greedy=False on the transport backend needs a q payload: qmode 'none'
    is refused at build (the JAX package builds it and its serve hangs)."""
    spec = dataclasses.replace(_spec(), backend="transport", greedy=False,
                               cluster=ClusterSpec(replicas=1))
    with pytest.raises(ValueError, match="qmode"):
        System.build(spec, device="cpu")
    q = dataclasses.replace(spec, transport=dataclasses.replace(spec.transport, qmode="f32"))
    assert System.build(q, device="cpu").engine is not None


class _Raising:
    """An engine whose admission raises, as the sampled serve's did."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def admit(self, *args, **kwargs):
        raise ValueError("admission refused (test)")


def test_a_raising_server_task_fails_the_serve():
    """A TransportServer connection task that raises ends the transport
    serve with that error within the bound, instead of hanging it."""
    spec = dataclasses.replace(_spec(), backend="transport", cluster=ClusterSpec(replicas=1))
    system = System.build(spec, device="cpu")
    system.engine = _Raising(system.engine)
    with pytest.raises(ValueError, match="admission refused"):
        _bounded(system.serve, 60.0)


def test_raise_on_error_waits_for_the_first_failure():
    """raise_on_error returns nothing until a task fails, then raises the
    first failure only."""
    async def run():
        server = TransportServer(engine=None)
        waiter = asyncio.ensure_future(server.raise_on_error())
        await asyncio.sleep(0.01)
        assert not waiter.done()
        server.fail(KeyError("first"))
        server.fail(KeyError("second"))
        with pytest.raises(KeyError, match="first"):
            await asyncio.wait_for(waiter, 5.0)

    asyncio.run(run())


def test_a_worker_fails_on_a_bad_data_plane_frame():
    """A worker hands a connection that opens with Hello to its
    TransportServer: the device is admitted, and a sampled round without
    its q (which the admission refuses) ends the worker's serve with that
    error instead of hanging it."""
    engine = build_engine_from_spec(dataclasses.replace(_spec(), greedy=False), device="cpu")

    async def run():
        worker = ReplicaWorker("tcp:127.0.0.1:0", engine=engine)
        serving = asyncio.ensure_future(worker.serve())
        for _ in range(500):
            if worker.resolved is not None or serving.done():
                break
            await asyncio.sleep(0.01)
        ep = await asyncio.wait_for(connect_addr(worker.resolved), 10.0)
        try:
            await ep.send(codec.encode_frame(codec.Hello(0, np.arange(6, dtype=np.int32))))
            admit, _ = codec.decode_frame(await asyncio.wait_for(ep.recv(), 10.0))
            assert isinstance(admit, codec.Admit) and admit.ok
            await ep.send(codec.encode_frame(codec.DraftPacket(0, 1, np.asarray([1, 2], np.int32))))
            with pytest.raises(ValueError, match="draft_q"):
                await asyncio.wait_for(serving, 10.0)
        finally:
            ep.close()
            serving.cancel()

    asyncio.run(run())
