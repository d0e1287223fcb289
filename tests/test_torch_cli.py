"""The port's command line (``repro_torch.cli``), logs and Prometheus
exposition, against the JAX package.

``serve --dump-spec`` prints the JAX launcher's JSON for the same flags;
the serve parser has the JAX parser's options plus ``--device``; the
metrics registry's exposition is byte for byte the JAX registry's after the
same operations; ``setup_logging`` configures the ``repro_torch`` root as
the JAX one configures ``repro``; ``top``'s ``render`` gives the JAX text
for the same replica dicts. The commands run in process on the CPU
(``--device cpu``): serve with the reference check, trace, and top --demo
over two spawned CPU workers. Every subprocess and spawn is bounded.
"""
import json
import logging
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jserve
from repro.telemetry import metrics as jmetrics
from repro.telemetry import top as jtop
from repro_torch import cli, telemetry
from repro_torch.launch import serve
from repro_torch.telemetry import metrics, top

ROOT = Path(__file__).resolve().parents[1]
ENGINE_JSON = ROOT / "examples" / "specs" / "engine.json"
REMOTE_JSON = ROOT / "examples" / "specs" / "cluster_remote.json"


def _json_of(out: str) -> dict:
    return json.loads(out[out.index("{"):])


@pytest.mark.parametrize("flags", [
    ["--devices", "2", "--replicas", "2"],
    [],
    ["--transport", "inproc", "--replicas", "3", "--placement", "round-robin", "--slots", "2"],
    ["--arch", "zamba2-1.2b", "--no-paged-attention", "--transport", "sim", "--net", "lte",
     "--qmode", "int8", "--kctl", "adaptive", "--cctl", "adaptive", "--no-pipeline"],
    ["--backend", "engine", "--bits", "8", "--draft-noise", "0.05", "--k-max", "3",
     "--c-th", "0.4", "--max-new", "9", "--policy", "deadline", "--max-wait", "0.02",
     "--verify-timeout", "5", "--stagger", "1", "--stagger-s", "0.5", "--telemetry"],
])
def test_dump_spec_equals_the_jax_clis(flags, capsys):
    """The twin of the JAX tests/test_api.py ``test_cli_dump_spec``, and a
    few more flag sets: the same JSON text as ``repro.cli.main``."""
    from repro.cli import main as jax_main

    jax_main(["serve", "--dump-spec", *flags])
    want = capsys.readouterr().out
    cli.main(["serve", "--dump-spec", *flags])
    got = capsys.readouterr().out
    assert got == want
    if flags[:2] == ["--devices", "2"]:
        spec = _json_of(got)
        assert spec["backend"] == "transport" and spec["cluster"]["replicas"] == 2


def _options(parser) -> dict:
    return {opt: (a.default, a.choices) for a in parser._actions for opt in a.option_strings}


def test_serve_parser_has_the_jax_options_and_device():
    mine, theirs = _options(serve.build_parser()), _options(jserve.build_parser())
    assert set(mine) == set(theirs) | {"--device"}
    assert {k: mine[k] for k in theirs} == theirs
    assert mine["--device"] == ("cuda", ("cuda", "cpu"))


def _ops(reg):
    """One sequence of registry operations: every kind, labels, help text,
    custom buckets, +Inf observations, names needing the prefix and not."""
    reg.counter("rounds_total", help="total rounds").inc(4)
    reg.counter("rounds_total", labels={"replica": 1}).inc(2.5)
    reg.counter("repro_already_prefixed").inc()
    reg.gauge("engine_kv_pool_bytes", help="pool bytes").set(1.5e9)
    reg.gauge("weird-name.with:chars", labels={"b": "x", "a": 2}).inc(-3)
    h = reg.histogram("verify_seconds", buckets=(0.5, 1.0), help="verify step")
    for v in (0.1, 0.7, 3.0):
        h.observe(v)
    reg.histogram("engine_k", buckets=jmetrics.K_BUCKETS, labels={"replica": 0}).observe(4)
    reg.histogram("latency").observe(0.003)
    reg.histogram("empty_hist", buckets=(1.0,))


@pytest.mark.parametrize("ops", ["none", "all"])
def test_exposition_equals_the_jax_registrys(ops):
    """The twin of the JAX tests/test_telemetry.py exposition test: byte for
    byte the JAX registry's text after the same operations."""
    mine, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    if ops == "all":
        _ops(mine)
        _ops(theirs)
    assert mine.exposition() == theirs.exposition()
    if ops == "all":
        text = mine.exposition()
        assert "# HELP repro_rounds_total total rounds" in text
        assert 'repro_verify_seconds_bucket{le="+Inf"} 3' in text
        assert "repro_weird_name_with_chars" in text


def test_exposition_of_a_served_spec_equals_the_jax_rendering():
    """After an engine serve with telemetry on, the port's registry rendered
    by the port equals the same metrics (names, labels, help, buckets,
    counts, sums) rendered by the JAX registry."""
    from repro_torch.api import ServeSpec, System

    was = telemetry.enabled()
    reg = telemetry.registry()
    reg.reset()
    try:
        spec = ServeSpec.from_json(ENGINE_JSON.read_text())
        System.build(spec.with_backend("engine", telemetry=True), device="cpu").serve()
    finally:
        telemetry.enable(was)
    theirs = jmetrics.MetricsRegistry()
    for m in list(reg._metrics.values()):
        labels = dict(m.labels) or None
        if isinstance(m, metrics.Histogram):
            h = theirs.histogram(m.name, buckets=m.buckets, help=m.help, labels=labels)
            h.counts, h.sum, h.count = list(m.counts), m.sum, m.count
        elif isinstance(m, metrics.Counter):
            theirs.counter(m.name, help=m.help, labels=labels).inc(m.value)
        else:
            theirs.gauge(m.name, help=m.help, labels=labels).set(m.value)
    text = reg.exposition()
    assert text == theirs.exposition()
    assert "repro_engine_verify_seconds_count" in text
    reg.reset()


@pytest.fixture
def repro_torch_logger():
    """Restore the repro_torch root logger after a test configures it."""
    root = logging.getLogger("repro_torch")
    saved = (root.level, list(root.handlers), root.propagate)
    yield root
    root.setLevel(saved[0])
    root.handlers[:] = saved[1]
    root.propagate = saved[2]


def test_setup_logging_idempotent_and_leveled(repro_torch_logger, monkeypatch):
    """The twin of the JAX ``test_setup_logging_idempotent_and_leveled`` on
    the port's root, with the JAX environment fallback."""
    root = telemetry.setup_logging("debug")
    assert root is repro_torch_logger and root.name == "repro_torch"
    assert root.level == logging.DEBUG
    n = len(root.handlers)
    telemetry.setup_logging("info")
    assert len(root.handlers) == n  # no handler stacking
    assert root.level == logging.INFO
    assert not root.propagate
    monkeypatch.setenv("REPRO_LOG_LEVEL", "error")
    assert telemetry.setup_logging().level == logging.ERROR
    with pytest.raises(ValueError):
        telemetry.setup_logging("chatty")
    with pytest.raises(ValueError):
        cli.main(["--log-level=chatty", "--help"])


def _views(mod):
    """Replica views of ``mod``: live with stats and telemetry, live before
    placement, live with no telemetry, and lost with flight rows."""
    hist = {"p50": 0.012, "p95": 0.0451, "buckets": [[0.005, 1], [0.01, 3], [0.05, 9],
                                                       ["+Inf", 10]]}
    k_hist = {"buckets": [[1, 0], [2, 1], [3, 1], [4, 7], ["+Inf", 7]]}
    c_hist = {"buckets": [[0.1, 2], [0.3, 5], [1.0, 5], ["+Inf", 6]]}
    tel = {"snapshot": {"histograms": {"engine_round_latency_seconds": hist, "engine_k": k_hist,
                                       "cctl_c_th": c_hist},
                        "gauges": {"engine_kv_pool_bytes": 3.5 * 2 ** 30,
                                   "engine_bytes_per_slot": 14680068.0}},
           "flight": [{"device_id": d, "round": r, "k": 4, "n_accepted": 2, "n_commit": 3,
                       "queue_s": 0.00125, "verify_s": 0.031, "fallback": r == 2}
                      for d in range(2) for r in range(6)]}
    stats = {"streams_served": 7, "rounds": 123, "mean_batch_fill": 2.5,
             "acceptance_rate": 0.6125}
    views = []
    for i, (addr, alive, st, tl, err) in enumerate([
        ("uds:/tmp/repro-worker-abcdefgh/0123abcd.sock", True, stats, tel, ""),
        ("tcp:127.0.0.1:7001", True, None, None, "no engine placed"),
        ("tcp:127.0.0.1:7002", True, dict(stats, rounds=5), None, ""),
        ("uds:/a/very/long/path/that/does/not/fit/the/column/w.sock", False, stats, tel,
         "worker at uds:/x closed the control connection"),
    ]):
        v = mod.ReplicaView(i, addr)
        v.alive, v.stats, v.telemetry, v.error = alive, st, tl, err
        views.append(v)
    return views


@pytest.mark.parametrize("flight", [8, 3])
def test_render_equals_the_jax_render(flight):
    got = top.render(_views(top), flight=flight)
    assert got == jtop.render(_views(jtop), flight=flight)
    assert "LOST" in got and f"last {flight} rounds" in got
    assert ("FALLBACK" in got) == (flight == 8)  # device 1's round 2 is among the last 8


def test_serve_and_trace_run_in_process(capsys, tmp_path):
    """``serve --spec engine.json --check`` and ``trace`` through cli.main on
    the CPU: the reference matches; one trace row per session round; the
    exposition holds the verify-step histogram."""
    cli.main(["serve", "--spec", str(ENGINE_JSON), "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert "greedy lock-step reference match: OK" in out
    trace, expo = tmp_path / "trace.jsonl", tmp_path / "metrics.prom"
    was = telemetry.enabled()
    try:
        cli.main(["trace", "--spec", str(ENGINE_JSON), "--out", str(trace), "--exposition",
                  str(expo), "--device", "cpu"])
    finally:
        telemetry.enable(was)
    out = capsys.readouterr().out
    rows = [json.loads(ln) for ln in trace.read_text().splitlines()]
    per_dev = {}
    for r in rows:
        per_dev.setdefault(r["device_id"], []).append(r["round"])
    assert sorted(per_dev) == [0, 1, 2]
    assert all(sorted(v) == list(range(len(v))) for v in per_dev.values())
    assert f"wrote {len(rows)} trace events for 3 devices" in out
    assert "repro_engine_verify_seconds_count" in expo.read_text()


def test_top_demo_over_two_spawned_cpu_workers(capsys, monkeypatch, tmp_path):
    """``top --spec cluster_remote.json --demo`` on the CPU: two spawned
    workers with rounds in the last frame; after it, no worker process and
    no socket directory is left."""
    from repro_torch.cluster import remote

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    procs = []
    spawn = remote.spawn_worker

    def recording_spawn(*args, **kw):
        proc, address = spawn(*args, startup_timeout=60.0, **{
            k: v for k, v in kw.items() if k != "startup_timeout"})
        procs.append(proc)
        return proc, address

    monkeypatch.setattr(remote, "spawn_worker", recording_spawn)
    was = telemetry.enabled()
    try:
        cli.main(["top", "--spec", str(REMOTE_JSON), "--demo", "--iterations", "2",
                  "--interval", "0.1", "--no-clear", "--device", "cpu"])
    finally:
        telemetry.enable(was)
    out = capsys.readouterr().out
    frame = out.split("repro top — fleet control-plane poll")[-1].splitlines()
    rows = [ln.split() for ln in frame if ln[:1].isdigit()]
    assert len(rows) == 2 and all(r[2] == "up" and int(r[4]) > 0 for r in rows), out
    assert len(procs) == 2 and all(p.poll() is not None for p in procs)
    assert not list(tmp_path.glob("repro-worker-*"))


def test_help_imports_no_torch():
    """``python -m repro_torch.cli --help`` with torch blocked: the usage,
    and no import of torch (subcommands are imported lazily)."""
    code = ("import runpy, sys\n"
            "sys.modules['torch'] = None\n"
            "sys.argv = ['repro-torch', '--log-level', 'info', '--help']\n"
            "runpy.run_module('repro_torch.cli', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: repro-torch") and "tune" in out.stdout


@pytest.mark.parametrize("argv", [
    ["serve", "--spec", str(ENGINE_JSON)],
    ["trace", "--spec", str(ENGINE_JSON), "--out", "unused.jsonl"],
    ["top", "--spec", str(REMOTE_JSON), "--demo"],
])
def test_commands_default_to_the_card(argv):
    """Without a card and without ``--device cpu`` each command raises
    before it serves (and before it spawns a worker)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


def test_unknown_command_exits_with_the_usage(capsys):
    with pytest.raises(SystemExit, match="unknown command 'frobnicate'"):
        cli.main(["frobnicate"])
    assert capsys.readouterr().err.startswith("usage: repro-torch")
