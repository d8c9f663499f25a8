"""Structured logging.

The reference's only observability is bare print() calls (SURVEY.md §5).
Here: a namespaced logger with an env-tunable level and an optional JSON-line
mode for machine consumption (MCGP_LOG_JSON=1), plus a `log_event` helper
the CLIs and backtest harness use for progress/metric records.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_configured = False


def get_logger(name: str = "mcgp") -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("MCGP_LOG_LEVEL", "INFO").upper()
        logging.basicConfig(
            level=getattr(logging, level, logging.INFO),
            format=_FORMAT,
            stream=sys.stderr,
        )
        _configured = True
    return logging.getLogger(name)


def log_event(event: str, **fields) -> None:
    """Emit a structured event: JSON line when MCGP_LOG_JSON=1, else a
    readable key=value line at INFO."""
    logger = get_logger()
    if os.environ.get("MCGP_LOG_JSON") == "1":
        logger.info(json.dumps({"event": event, "t": time.time(), **fields}))
    else:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.info("%s %s", event, kv)
