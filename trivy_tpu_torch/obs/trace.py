"""graftscope: context-local pipeline tracing.

The reference's observability is logs, because its unit of work is one
CLI run; a batched RPC service needs to answer "where did this 400ms
scan go — walker, host prep, first-of-shape launch, device execute, or hit
assembly?" per request. This module provides the span primitive the
whole pipeline is instrumented with:

    with span("detect.prepare", queries=len(qs)) as sp:
        ...
        sp.attrs["n_pairs"] = prep.n_pairs

Spans carry a trace id (stamped per scan / per RPC, propagated from
client to server via the X-Trivy-Trace-Id header), a span id, their
parent span id (contextvar nesting — correct across server handler
threads; a remote parent forwarded via the X-Trivy-Parent-Span header
links fragments across processes), wall + process time, and free-form
attributes.

Two sinks receive finished spans (graftwatch):

  * the always-on flight recorder (obs/recorder.py) — a bounded
    lock-free ring every span lands in, serving /debug/traces and
    incident capture; its per-span cost is one counter bump and one
    slot store;
  * the COLLECTOR, only while recording is enabled (`--trace FILE` on
    the CLI, the server's --trace flag, or bench.py's phase
    breakdown) — the opt-in complete-trace dump.

Export is Chrome trace-event JSON ("X" complete events, microsecond
timestamps), loadable in Perfetto / chrome://tracing.

Instrumentation stays on the host: a span around a kernel launch
times the launch (asynchronous on a GPU), and the device time shows
up in the span of the fetch that synchronizes with it.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid

from .recorder import RECORDER

# active span (for parent linkage) and active trace id; contextvars so
# each server handler thread / asyncio task nests independently
_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "trivy_tpu_torch_span", default=None)
_TRACE: contextvars.ContextVar = contextvars.ContextVar(
    "trivy_tpu_torch_trace", default="")
# remote parent span id (X-Trivy-Parent-Span): adopted by the first
# span opened under it with no LOCAL parent, so a server fragment's
# root span links to the router/client span that forwarded the RPC
_REMOTE_PARENT: contextvars.ContextVar = contextvars.ContextVar(
    "trivy_tpu_torch_remote_parent", default="")


def _new_id(nbytes: int = 8) -> str:
    return uuid.uuid4().hex[:2 * nbytes]


class Span:
    """One finished (or in-flight) timed region."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "wall_start", "start", "dur", "cpu", "thread_id")

    def __init__(self, name: str, trace_id: str, parent_id: str,
                 attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self.wall_start = 0.0   # time.time() at enter
        self.start = 0.0        # perf_counter at enter
        self.dur = 0.0          # perf_counter seconds
        self.cpu = 0.0          # process_time seconds
        self.thread_id = 0


class Collector:
    """Process-wide sink for finished spans (bounded, thread-safe).

    Shared across server handler threads — every mutation of the span
    buffer happens under the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._enabled = False
        self._limit = 200_000
        self._dropped = 0

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, limit: int | None = None) -> None:
        with self._lock:
            self._spans = []
            self._dropped = 0
            if limit is not None:
                self._limit = limit
            self._enabled = True

    def disable(self) -> None:
        with self._lock:
            self._enabled = False

    def record(self, s: Span) -> None:
        if not self._enabled:
            return
        with self._lock:
            if len(self._spans) >= self._limit:
                self._dropped += 1
                return
            self._spans.append(s)

    @property
    def dropped(self) -> int:
        return self._dropped

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> list[Span]:
        with self._lock:
            out = self._spans
            self._spans = []
            return out

    def phase_totals(self) -> dict[str, dict]:
        """Aggregate recorded spans by name → {count, total_ms,
        cpu_ms} (bench.py's per-phase breakdown)."""
        out: dict[str, dict] = {}
        for s in self.snapshot():
            agg = out.setdefault(s.name,
                                 {"count": 0, "total_ms": 0.0,
                                  "cpu_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += s.dur * 1e3
            agg["cpu_ms"] += s.cpu * 1e3
        for agg in out.values():
            agg["total_ms"] = round(agg["total_ms"], 3)
            agg["cpu_ms"] = round(agg["cpu_ms"], 3)
        return out

    def reset_for_tests(self) -> None:
        with self._lock:
            self._spans = []
            self._dropped = 0
            self._limit = 200_000
            self._enabled = False


COLLECTOR = Collector()


def recording() -> bool:
    return COLLECTOR.enabled


def phase_totals(doc: dict | None = None) -> dict[str, dict]:
    """Per-span-name totals → {name: {count, total_ms, cpu_ms}}: of a
    Chrome trace document as write_chrome_trace wrote it (a `--trace`
    file), or of the COLLECTOR's spans when `doc` is None. The phase
    breakdown of a scan."""
    if doc is None:
        return COLLECTOR.phase_totals()
    out: dict[str, dict] = {}
    for ev in doc.get("traceEvents") or ():
        if ev.get("ph") != "X":
            continue
        agg = out.setdefault(ev["name"], {"count": 0, "total_ms": 0.0,
                                          "cpu_ms": 0.0})
        agg["count"] += 1
        agg["total_ms"] += float(ev.get("dur", 0.0)) / 1e3
        agg["cpu_ms"] += float((ev.get("args") or {}).get("cpu_ms", 0.0))
    for agg in out.values():
        agg["total_ms"] = round(agg["total_ms"], 3)
        agg["cpu_ms"] = round(agg["cpu_ms"], 3)
    return out


def current_trace_id() -> str:
    return _TRACE.get()


def current_span_id() -> str:
    """Span id of the innermost active span ('' outside any span) —
    what the client/router forward as X-Trivy-Parent-Span."""
    s = _SPAN.get()
    return s.span_id if s is not None else ""


@contextlib.contextmanager
def new_trace(trace_id: str | None = None,
              parent_id: str | None = None):
    """Set a fresh trace id for the enclosed work (per-RPC stamp).
    `parent_id` installs a REMOTE parent span id: the first span
    opened inside (with no local parent) adopts it, stitching this
    process's fragment under the caller's forwarding span."""
    tid = trace_id or _new_id(16)
    tok = _TRACE.set(tid)
    ptok = _REMOTE_PARENT.set(parent_id) if parent_id else None
    try:
        yield tid
    finally:
        if ptok is not None:
            _REMOTE_PARENT.reset(ptok)
        _TRACE.reset(tok)


@contextlib.contextmanager
def ensure_trace(trace_id: str | None = None):
    """Reuse the active trace id, or start one if none is active —
    the per-scan stamp (scanner.scan_many) that must not clobber a
    server-stamped per-RPC id."""
    cur = _TRACE.get()
    if cur and trace_id is None:
        yield cur
        return
    with new_trace(trace_id) as tid:
        yield tid


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a region; nests via contextvars. Yields the Span so callers
    can attach attributes discovered mid-flight (`sp.attrs[...] = x`).
    Every finished span lands in the always-on flight recorder's ring
    (graftwatch); the COLLECTOR additionally keeps it only while
    recording is enabled. A span with no local parent adopts the
    remote parent id installed by new_trace(parent_id=...)."""
    parent = _SPAN.get()
    s = Span(name, _TRACE.get(),
             parent.span_id if parent is not None
             else _REMOTE_PARENT.get(), dict(attrs))
    s.thread_id = threading.get_ident()
    s.wall_start = time.time()
    s.cpu = time.process_time()
    s.start = time.perf_counter()
    tok = _SPAN.set(s)
    try:
        yield s
    finally:
        s.dur = time.perf_counter() - s.start
        s.cpu = time.process_time() - s.cpu
        _SPAN.reset(tok)
        RECORDER.record_span(s)
        COLLECTOR.record(s)


def add_attr(**attrs) -> None:
    """Attach attributes to the innermost active span (no-op outside
    any span)."""
    s = _SPAN.get()
    if s is not None:
        s.attrs.update(attrs)


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)

def chrome_trace(spans: list[Span] | None = None,
                 dropped: int | None = None) -> dict:
    """→ the Chrome trace-event JSON document for `spans` (default: the
    COLLECTOR's current buffer). "X" complete events; ts/dur in
    microseconds relative to the earliest span; span/trace/parent ids
    and attributes ride in `args`. Truncation is never silent: spans
    dropped at the collector's limit surface as a trailing instant
    event ("graftscope.dropped_spans")."""
    if spans is None:
        spans = COLLECTOR.snapshot()
    if dropped is None:
        dropped = COLLECTOR.dropped
    base = min((s.start for s in spans), default=0.0)
    pid = os.getpid()
    events = []
    for s in spans:
        events.append({
            "name": s.name,
            "cat": "graftscope",
            "ph": "X",
            "ts": round((s.start - base) * 1e6, 3),
            "dur": round(s.dur * 1e6, 3),
            "pid": pid,
            "tid": s.thread_id,
            "args": {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "cpu_ms": round(s.cpu * 1e3, 3),
                **s.attrs,
            },
        })
    if dropped:
        end = max((e["ts"] + e["dur"] for e in events), default=0.0)
        events.append({
            "name": "graftscope.dropped_spans", "cat": "graftscope",
            "ph": "i", "s": "g", "ts": end, "pid": pid, "tid": 0,
            "args": {"dropped": dropped},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       spans: list[Span] | None = None) -> None:
    doc = chrome_trace(spans)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
