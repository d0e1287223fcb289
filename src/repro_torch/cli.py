"""The port's console entry point (``python -m repro_torch.cli``, ``repro-torch``).

    repro-torch serve --spec spec.json [--check]     run a ServeSpec artifact
    repro-torch serve --devices 4 --dump-spec        resolve flags into a spec
    repro-torch serve --transport sim --net wlan     legacy-flag serving
    repro-torch worker --listen tcp:0.0.0.0:7001     run one replica worker process
    repro-torch top --connect tcp:host:7001          live fleet table (control plane)
    repro-torch trace --spec spec.json               per-round trace JSONL dump
    repro-torch chaos --kill 1:5                     seeded fault injection + identity
    repro-torch tune --spec fleet.json --quick       auto-tune a heterogeneous fleet

Every command that runs a model takes ``--device cuda|cpu``: the card by
default (raising without one), the CPU when asked. A global
``--log-level LEVEL`` (anywhere on the command line) configures the
``repro_torch.*`` logger hierarchy before the subcommand runs;
``REPRO_LOG_LEVEL`` is the environment fallback. Subcommands are imported
lazily, so ``--help`` imports no ``torch`` until a command actually runs.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

_USAGE = """\
usage: repro-torch [--log-level LEVEL] <command> [args...]

commands:
  serve    serve a SLED deployment from a ServeSpec (see: repro-torch serve --help)
  worker   run one engine replica behind a TCP/UDS control socket, to be
           placed and driven by a cluster Router (see: repro-torch worker --help)
  top      live refreshing per-replica fleet table, polled over worker
           control sockets (see: repro-torch top --help)
  trace    run a spec with telemetry on and dump the per-round trace as
           JSONL (see: repro-torch trace --help)
  chaos    run a deterministic fault schedule (kill/hang/drop/delay/flap at
           fixed rounds) against a replica fleet and report what the
           supervision layer recovered (see: repro-torch chaos --help)
  tune     profile a heterogeneous fleet spec, sweep per-class candidates
           through the calibrated simulator + cost model, and emit the
           winning ServeSpec + BENCH artifact (see: repro-torch tune --help)

Every command runs on the card (--device cuda, the default) unless given
--device cpu. Run configurations are declarative ServeSpec JSON artifacts;
`repro-torch serve --dump-spec` converts any flag combination into one.
"""


def _split_log_level(argv: List[str]) -> Tuple[Optional[str], List[str]]:
    """Strip a global --log-level[=LEVEL] from anywhere in argv."""
    level: Optional[str] = None
    rest: List[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--log-level" and i + 1 < len(argv):
            level = argv[i + 1]
            i += 2
            continue
        if arg.startswith("--log-level="):
            level = arg.split("=", 1)[1]
            i += 1
            continue
        rest.append(arg)
        i += 1
    return level, rest


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    level, argv = _split_log_level(argv)
    if level is not None:
        from repro_torch.telemetry.logs import setup_logging

        setup_logging(level)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE, end="")
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        from repro_torch.launch.serve import main as serve_main

        serve_main(rest)
        return
    if cmd == "worker":
        from repro_torch.transport.worker import main as worker_main

        worker_main(rest)
        return
    if cmd == "top":
        from repro_torch.telemetry.top import main_top

        main_top(rest)
        return
    if cmd == "trace":
        from repro_torch.telemetry.top import main_trace

        main_trace(rest)
        return
    if cmd == "chaos":
        from repro_torch.launch.chaos import main as chaos_main

        rc = chaos_main(rest)
        if rc:
            raise SystemExit(rc)  # --check found a divergence
        return
    if cmd == "tune":
        from repro_torch.launch.tune import main as tune_main

        tune_main(rest)
        return
    print(_USAGE, end="", file=sys.stderr)
    raise SystemExit(f"repro-torch: unknown command {cmd!r}")


if __name__ == "__main__":
    main()
