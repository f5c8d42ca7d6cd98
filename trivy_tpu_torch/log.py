"""Logging (reference pkg/log/logger.go — zap SugaredLogger to stderr).

One process-wide logger writing WARN+ to stderr by default; --debug
drops the threshold. Import `logger` or call `get(name)` for a child.

graftscope additions: the formatter includes the logger NAME (child
loggers from get() used to be indistinguishable from the root), every
line carries the active trace id (graftscope contextvar — the same id
the spans and the X-Trivy-Trace-Id header carry), and
TRIVY_TPU_LOG_FORMAT=json opts into a JSON-lines formatter for log
shippers.
"""

from __future__ import annotations

import json
import logging
import os
import sys

TEXT_FORMAT = ("%(asctime)s\t%(levelname)s\t%(name)s\t"
               "trace=%(trace_id)s\t%(message)s")
TIME_FORMAT = "%Y-%m-%dT%H:%M:%S"


class TraceContextFilter(logging.Filter):
    """Stamp the active graftscope trace id on every record ("-" when
    no trace is active). Attached to the HANDLER: records logged via
    child loggers skip ancestor-logger filters, but never handler
    filters."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            from .obs.trace import current_trace_id
            record.trace_id = current_trace_id() or "-"
        except Exception:
            record.trace_id = "-"
        return True


class RecorderHandler(logging.Handler):
    """Feed every record into the graftwatch flight recorder's log
    ring (bounded, always-on) so an incident snapshot carries the
    recent log tail next to the recent spans. The import is lazy and
    guarded: log.py is imported everywhere, including processes that
    never touch obs, and a recorder failure must never sink a log
    call."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            from .obs.recorder import RECORDER
            RECORDER.record_log({
                "ts_unix": round(record.created, 6),
                "level": record.levelname,
                "logger": record.name,
                "msg": record.getMessage(),
                "trace_id": getattr(record, "trace_id", "-"),
            })
        except Exception:  # noqa: BLE001 — never raise out of logging
            pass


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, msg, trace_id."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": self.formatTime(record, TIME_FORMAT),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "trace_id": getattr(record, "trace_id", "-"),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc)


_root = logging.getLogger("trivy_tpu_torch")
logger = _root


def configure(stream=None, fmt: str | None = None) -> logging.Handler:
    """(Re)install the process log handler. fmt: "json" | "text";
    None reads TRIVY_TPU_LOG_FORMAT (default text). Tests redirect
    output by passing their own stream."""
    if fmt is None:
        fmt = os.environ.get("TRIVY_TPU_LOG_FORMAT", "text")
    h = logging.StreamHandler(stream if stream is not None
                              else sys.stderr)
    h.addFilter(TraceContextFilter())
    h.setFormatter(JsonFormatter() if fmt == "json"
                   else logging.Formatter(TEXT_FORMAT, TIME_FORMAT))
    for old in list(_root.handlers):
        _root.removeHandler(old)
    _root.addHandler(h)
    # the flight-recorder tap rides alongside whatever stream handler
    # is installed: reconfiguring output must not silence the ring
    rh = RecorderHandler()
    rh.addFilter(TraceContextFilter())
    _root.addHandler(rh)
    return h


if not _root.handlers:
    configure()
    _root.setLevel(logging.WARNING)
    _root.propagate = False


def get(name: str) -> logging.Logger:
    return _root.getChild(name)


def set_debug(on: bool = True) -> None:
    _root.setLevel(logging.DEBUG if on else logging.WARNING)
