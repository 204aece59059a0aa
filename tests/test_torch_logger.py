"""JSON logger (reference zap parity: internal/logger/logger.go:14-54).

Port of tests/test_logger.py on the port's modules, the expectations unchanged.
"""

import io
import json
import logging

from inferno_tpu_torch.controller.logger import JsonFormatter, get_logger, kv


def fresh_logger(name, stream, monkeypatch=None, level=None):
    logger = logging.getLogger(name)
    logger.handlers.clear()
    if level is not None:
        import os

        os.environ["LOG_LEVEL"] = level
    out = get_logger(name, stream=stream)
    if level is not None:
        import os

        del os.environ["LOG_LEVEL"]
    return out


def test_single_line_json_with_fields():
    buf = io.StringIO()
    log = fresh_logger("t1", buf)
    kv(log, logging.INFO, "cycle", variants=3, solver_ms=1.25)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["msg"] == "cycle"
    assert rec["level"] == "info"
    assert rec["variants"] == 3 and rec["solver_ms"] == 1.25
    assert rec["ts"].endswith("Z")


def test_level_from_env():
    buf = io.StringIO()
    log = fresh_logger("t2", buf, level="error")
    log.info("quiet")
    log.error("loud")
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["msg"] == "loud"


def test_exception_serialized():
    buf = io.StringIO()
    log = fresh_logger("t3", buf)
    try:
        raise ValueError("boom")
    except ValueError:
        log.exception("failed")
    rec = json.loads(buf.getvalue().strip())
    assert "boom" in rec["error"]


def test_exception_split_into_error_and_stack():
    """exc_info renders as a structured pair: `error` is the one-line
    "Type: message" a log query matches on, `stack` the full traceback
    (previously both were jammed into `error`)."""
    buf = io.StringIO()
    log = fresh_logger("t5", buf)

    def inner():
        raise KeyError("missing-key")

    try:
        inner()
    except KeyError:
        log.exception("lookup failed")
    rec = json.loads(buf.getvalue().strip())
    assert rec["error"] == "KeyError: 'missing-key'"
    assert "Traceback (most recent call last)" in rec["stack"]
    assert "inner" in rec["stack"]  # frames preserved
    # still a single JSON line on the stream
    assert len(buf.getvalue().strip().splitlines()) == 1


def test_formatter_handles_nonserializable():
    f = JsonFormatter()
    rec = logging.LogRecord("x", logging.INFO, "p", 1, "m", (), None)
    rec.fields = {"obj": object()}
    assert json.loads(f.format(rec))["msg"] == "m"
