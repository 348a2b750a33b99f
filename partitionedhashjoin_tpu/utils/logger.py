"""Severity logging with component / tableID attributes.

Counterpart of the reference's Boost.Log setup
(src/Common/Logger.hpp:9-35, src/Common/Logger.cpp:73-125): a stderr sink with
a global severity filter and the record format
``component(severity) (HH:MM:SS.ffffff) tableID: message``.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

#: Severity names accepted by the CLI (src/Common/Logger.hpp:9,
#: src/Common/Logger.cpp:9-36).  Python logging has no 'trace'/'critical'
#: split identical to Boost; trace maps below DEBUG.
TRACE = 5
_SEVERITIES = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_ROOT_NAME = "phjoin_tpu"


class _ReferenceFormatter(logging.Formatter):
    """Formats like Logger.cpp:88-96: component(sev) (time) tableID: msg."""

    def format(self, record: logging.LogRecord) -> str:
        component = getattr(record, "component", "Main")
        table_id = getattr(record, "table_id", "")
        sev = record.levelname.lower()
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        frac = f"{record.created % 1:.6f}"[2:]
        prefix = f"{component}({sev}) ({ts}.{frac})"
        if table_id:
            prefix += f" {table_id}"
        return f"{prefix}: {record.getMessage()}"


def initialize_logger(log_level: str = "debug") -> None:
    """Install the stderr sink + severity filter (Logger.cpp:73-100)."""
    logging.addLevelName(TRACE, "TRACE")
    root = logging.getLogger(_ROOT_NAME)
    root.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_ReferenceFormatter())
    root.addHandler(handler)
    level = _SEVERITIES.get(log_level)
    if level is None:
        raise ValueError(f"Unrecognized severity level: {log_level}")
    root.setLevel(level)
    root.propagate = False


def get_new_logger(component: str = "Main") -> logging.LoggerAdapter:
    """New logger bound to a component attribute (Logger.cpp:102-119)."""
    base = logging.getLogger(_ROOT_NAME)
    return logging.LoggerAdapter(base, {"component": component})


def add_table_id_to_logger(
    logger: logging.LoggerAdapter, table_id: str
) -> logging.LoggerAdapter:
    """Bind a tableID attribute (Logger.cpp:121-125)."""
    extra = dict(logger.extra or {})
    extra["table_id"] = table_id
    return logging.LoggerAdapter(logger.logger, extra)
