"""Structured JSON logging for the controller.

The analogue of the reference's zap setup
(upstream internal/logger/logger.go:14-54): single-line JSON to
stdout, level from the LOG_LEVEL environment variable (debug | info |
warn | error). Unlike the reference there is no package singleton —
`get_logger` configures a named stdlib logger idempotently and returns
it, so tests can construct isolated loggers and capture records.

Port copy of `inferno_tpu/controller/logger.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import json
import logging
import sys
import time

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts (RFC3339 UTC), level, logger, msg,
    plus any structured fields passed via `extra={"fields": {...}}`."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if fields:
            out.update(fields)
        if record.exc_info and record.exc_info[0] is not None:
            # structured split (zap's error/stacktrace convention): `error`
            # is the one-line "Type: message" a log query can match on;
            # `stack` carries the full traceback instead of dropping it
            etype, evalue, _ = record.exc_info
            out["error"] = f"{etype.__name__}: {evalue}"
            out["stack"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def get_logger(name: str = "inferno", stream=None) -> logging.Logger:
    """A JSON logger at the LOG_LEVEL env level. Idempotent per name."""
    logger = logging.getLogger(name)
    if not any(isinstance(h, _JsonHandler) for h in logger.handlers):
        handler = _JsonHandler(stream or sys.stdout)
        handler.setFormatter(JsonFormatter())
        logger.addHandler(handler)
        logger.propagate = False
    from inferno_tpu_torch.config.defaults import env_str

    level = _LEVELS.get(env_str("LOG_LEVEL", "info").lower(), logging.INFO)
    logger.setLevel(level)
    return logger


class _JsonHandler(logging.StreamHandler):
    """Marker subclass so get_logger stays idempotent without clobbering
    handlers tests may have attached."""


def kv(logger: logging.Logger, level: int, msg: str, **fields) -> None:
    """Log `msg` with structured fields: kv(log, logging.INFO, "cycle",
    variants=3, solver_ms=1.2)."""
    logger.log(level, msg, extra={"fields": fields})
