"""One logging setup for the ``repro_torch.*`` logger hierarchy.

Every module in the port logs through ``logging.getLogger(__name__)``,
which puts it under the single ``repro_torch`` root this helper configures:
one stderr handler, one format, one level knob (the CLI's ``--log-level``,
or REPRO_LOG_LEVEL in the environment, the variable the JAX package reads).
Library use stays silent by default — nothing is configured until an entry
point calls :func:`setup_logging`.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"


def setup_logging(level: Optional[str] = None, stream=None) -> logging.Logger:
    """Configure the ``repro_torch`` root logger and return it.

    ``level`` is a name ("debug" … "critical"); when None, REPRO_LOG_LEVEL
    or "warning".  Idempotent: re-calling adjusts the level without stacking
    handlers, so the CLI and a worker it spawned can both call it.
    """
    name = (level or os.environ.get("REPRO_LOG_LEVEL") or "warning").upper()
    resolved = getattr(logging, name, None)
    if not isinstance(resolved, int):
        raise ValueError(f"unknown log level {name!r}")
    root = logging.getLogger("repro_torch")
    root.setLevel(resolved)
    if not root.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
        root.addHandler(h)
        root.propagate = False
    return root
