"""graftwatch flight recorder: the always-on span/log ring.

graftscope's COLLECTOR (trace.py) is opt-in — it exists to dump a
complete Chrome trace of a run the operator asked to record. In
production nobody asked, and the trace you need is the one of the scan
that just misbehaved. The flight recorder closes that gap: every
finished span and every log record lands in a bounded ring buffer,
always, so the last few seconds of pipeline history are available the
moment something trips.

  ring        fixed-size slot arrays for spans and log records. The
              hot-path append is LOCK-FREE: an itertools counter
              (atomic in CPython — its __next__ is one C call) hands
              each writer a distinct slot, so concurrent handler
              threads never contend on a lock per span. Memory is
              bounded by construction — the ring never grows.
  pinning     tail-based retention. Most traces age out of the ring
              within seconds under load; traces worth keeping are
              PINNED into a side store that churn cannot evict:
              slow root spans (over `slow_trace_ms`), spans that
              recorded an error attribute, and every trace touching a
              watchdog trip, breaker transition, mesh rebuild, or
              fleet failover (the resilience stack calls note_event).
  incidents   auto-capture. A breaker opening or a failpoint-injected
              fault snapshots the ring + pins to a timestamped JSON
              file under `incident_dir` (cooldown-limited so a fault
              storm writes one file, not thousands). /debug/incidents
              lists them; `python -m trivy_tpu_torch.obs.check` validates
              them offline.

The recorder exposes the per-process bounded buffer that
`/debug/traces?trace_id=` serves (server/listen.py, fleet/router.py)
and `trivy_tpu_torch.obs.collect` assembles across processes.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import tempfile
import threading
import time

# span names that root a request/scan: only these pin a trace for
# being slow — a slow inner span is attributed through its root
_ROOT_SPANS = ("scan", "server.rpc", "router.rpc", "client.scan")

_SLUG_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


def span_to_json(s) -> dict:
    """Serialize one trace.Span (duck-typed: recorder must not import
    trace — trace imports the recorder)."""
    attrs = {}
    for k, v in s.attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            attrs[k] = v
        else:
            attrs[k] = str(v)
    return {
        "name": s.name,
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id,
        "ts_unix": round(s.wall_start, 6),
        "dur_ms": round(s.dur * 1e3, 3),
        "cpu_ms": round(s.cpu * 1e3, 3),
        "thread_id": s.thread_id,
        "attrs": attrs,
    }


class FlightRecorder:
    """Process-wide always-on recorder (RECORDER, shared like METRICS).

    Lock discipline: the ring
    slot stores are lock-free by design — each writer owns a distinct
    slot index from the atomic counter, so they are intentionally NOT
    under the lock and the slot arrays are never mutated under it.
    The pin store, incident clock, and event list are ordinary shared
    containers and every mutation of those happens under `_lock`."""

    SCHEMA = "trivy-tpu-incident/1"

    def __init__(self, span_slots: int = 4096, log_slots: int = 1024):
        self._lock = threading.Lock()
        # rings: rebound wholesale on configure(), slot-stored lock-free
        # on the hot path; readers take a local ref so a concurrent
        # resize can never index past the array they snapshotted
        self._span_ring = self._new_ring(span_slots)
        self._span_ctr = itertools.count()
        self._log_ring = self._new_ring(log_slots)
        self._log_ctr = itertools.count()
        # pinned traces: trace_id → {"reason", "pinned_unix", spans: []}
        self._pins: dict = {}
        self._pin_tids: frozenset = frozenset()
        self._events: list = []   # recent notable events (bounded)
        self.max_pinned = 32
        self.max_spans_per_pin = 512
        self.max_events = 256
        self.slow_trace_s = 1.0
        self.incident_cooldown_s = 30.0
        self.incident_dir = os.environ.get(
            "TRIVY_TPU_INCIDENT_DIR",
            os.path.join(tempfile.gettempdir(), "trivy-tpu-incidents"))
        self._last_incident = 0.0
        self._incident_seq = itertools.count()

    @staticmethod
    def _new_ring(n: int) -> list:
        # NOT a container literal: the ring is the one structure whose
        # writes stay outside the lock (see class docstring)
        return list(itertools.repeat(None, max(int(n), 16)))

    def configure(self, incident_dir: str | None = None,
                  slow_trace_ms: float | None = None,
                  incident_cooldown_s: float | None = None,
                  span_slots: int | None = None,
                  log_slots: int | None = None) -> None:
        if incident_dir is not None:
            self.incident_dir = incident_dir
        if slow_trace_ms is not None:
            self.slow_trace_s = slow_trace_ms / 1e3
        if incident_cooldown_s is not None:
            self.incident_cooldown_s = incident_cooldown_s
        if span_slots is not None:
            self._span_ring = self._new_ring(span_slots)
        if log_slots is not None:
            self._log_ring = self._new_ring(log_slots)

    # ---- hot path ------------------------------------------------------

    def record_span(self, s) -> None:
        """Called by trace.span() on every finished span. Ring append
        is one counter bump + one slot store; the pin checks are plain
        reads unless the trace is actually pinned/pin-worthy."""
        ring = self._span_ring
        ring[next(self._span_ctr) % len(ring)] = s
        tids = self._pin_tids
        if s.trace_id and s.trace_id in tids:
            self._append_pinned(s)
            return
        if s.dur >= self.slow_trace_s and s.name in _ROOT_SPANS:
            self.pin(s.trace_id, "slow_trace")
        elif "error" in s.attrs:
            self.pin(s.trace_id, "error")

    def record_log(self, rec: dict) -> None:
        """Called by the log handler (log.RecorderHandler) per record."""
        ring = self._log_ring
        ring[next(self._log_ctr) % len(ring)] = rec

    # ---- pinning -------------------------------------------------------

    def _append_pinned(self, s) -> None:
        with self._lock:
            entry = self._pins.get(s.trace_id)
            if entry is not None \
                    and len(entry["spans"]) < self.max_spans_per_pin:
                entry["spans"].append(s)

    def pin(self, trace_id: str, reason: str) -> None:
        """Pin one trace: its spans already in the ring are copied to
        the pin store and future spans append there too, so churn can
        never age an incident trace out."""
        if not trace_id:
            return
        existing = [s for s in self._span_ring
                    if s is not None and s.trace_id == trace_id]
        with self._lock:
            if trace_id in self._pins:
                return
            if len(self._pins) >= self.max_pinned:
                # evict the oldest pin — tail-based retention bounds
                # the pin store the same way the ring bounds itself
                oldest = min(self._pins,
                             key=lambda t: self._pins[t]["pinned_unix"])
                del self._pins[oldest]
            self._pins[trace_id] = {
                "reason": reason,
                "pinned_unix": time.time(),
                "spans": existing[:self.max_spans_per_pin],
            }
            self._pin_tids = frozenset(self._pins)

    def pinned(self) -> dict:
        """→ {trace_id: {reason, pinned_unix, spans: [json]}}."""
        with self._lock:
            snap = {t: dict(e) for t, e in self._pins.items()}
        return {t: {"reason": e["reason"],
                    "pinned_unix": round(e["pinned_unix"], 3),
                    "spans": [span_to_json(s) for s in e["spans"]]}
                for t, e in snap.items()}

    # ---- events --------------------------------------------------------

    def note_event(self, kind: str, incident: bool = False,
                   trace_id: str | None = None, **attrs) -> None:
        """Record one notable event (watchdog trip, breaker
        transition, mesh rebuild, fleet failover). Pins the active (or
        given) trace; `incident=True` additionally snapshots the ring
        to an incident file (cooldown-limited)."""
        if trace_id is None:
            from .trace import current_trace_id
            trace_id = current_trace_id()
        ev = {"kind": kind, "ts_unix": round(time.time(), 6),
              "trace_id": trace_id or "", **attrs}
        with self._lock:
            self._events.append(ev)
            del self._events[:-self.max_events]
        if trace_id:
            self.pin(trace_id, kind)
        if incident:
            self.incident(kind, detail=attrs)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    # ---- reads ---------------------------------------------------------

    def spans(self, trace_id: str | None = None) -> list[dict]:
        """Ring + pin snapshot as JSON dicts, deduped by span id and
        sorted by wall time; `trace_id` filters."""
        ring = [s for s in self._span_ring if s is not None]
        with self._lock:
            for entry in self._pins.values():
                ring.extend(entry["spans"])
        if trace_id:
            ring = [s for s in ring if s.trace_id == trace_id]
        seen: set = set()
        out = []
        for s in ring:
            if s.span_id in seen:
                continue
            seen.add(s.span_id)
            out.append(span_to_json(s))
        out.sort(key=lambda d: d["ts_unix"])
        return out

    def trace_ids(self) -> dict[str, int]:
        """→ {trace_id: span count} over the ring + pins (the
        /debug/traces listing when no trace_id is asked for)."""
        counts: dict[str, int] = {}
        for d in self.spans():
            if d["trace_id"]:
                counts[d["trace_id"]] = counts.get(d["trace_id"], 0) + 1
        return counts

    def logs(self) -> list[dict]:
        ring = [r for r in self._log_ring if r is not None]
        ring.sort(key=lambda d: d.get("ts_unix", 0.0))
        return ring

    # ---- incidents -----------------------------------------------------

    def incident(self, reason: str, detail: dict | None = None,
                 force: bool = False) -> str | None:
        """Snapshot the ring (spans, logs, pins, events) to a
        timestamped JSON file under `incident_dir`. Returns the path,
        or None when inside the cooldown window (`force` bypasses it —
        operator-requested captures are never rate-limited)."""
        now = time.time()
        with self._lock:
            if not force and \
                    now - self._last_incident < self.incident_cooldown_s:
                return None
            self._last_incident = now
        doc = {
            "schema": self.SCHEMA,
            "reason": reason,
            "detail": {k: str(v) for k, v in (detail or {}).items()},
            "captured_unix": round(now, 6),
            "pid": os.getpid(),
            "spans": self.spans(),
            "logs": self.logs(),
            "events": self.events(),
            "pinned": self.pinned(),
        }
        slug = _SLUG_RE.sub("-", reason)[:48] or "incident"
        ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        name = f"incident-{ts}-{slug}-{next(self._incident_seq)}.json"
        path = os.path.join(self.incident_dir, name)
        try:
            os.makedirs(self.incident_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            return None   # a full disk must never sink the caller
        from ..metrics import METRICS
        METRICS.inc("trivy_tpu_incidents_total",
                    reason=reason.split(":", 1)[0])
        return path

    def incidents(self, limit: int = 50) -> list[dict]:
        """List incident files, newest first (the /debug/incidents
        payload)."""
        try:
            names = [n for n in os.listdir(self.incident_dir)
                     if n.startswith("incident-") and n.endswith(".json")]
        except OSError:
            return []
        out = []
        for name in names:
            path = os.path.join(self.incident_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append({"file": name, "path": path,
                        "size": st.st_size,
                        "mtime_unix": round(st.st_mtime, 3)})
        out.sort(key=lambda d: d["mtime_unix"], reverse=True)
        return out[:limit]

    # ---- tests ---------------------------------------------------------

    def reset_for_tests(self) -> None:
        self._span_ring = self._new_ring(len(self._span_ring))
        self._log_ring = self._new_ring(len(self._log_ring))
        with self._lock:
            self._pins = {}
            self._pin_tids = frozenset()
            self._events = []
            self._last_incident = 0.0


RECORDER = FlightRecorder()


# ---------------------------------------------------------------------------
# /debug HTTP payloads — shared by the scan server (server/listen.py)
# and the fleet router (fleet/router.py), so every process answers the
# same debug surface from its own recorder

def debug_traces_payload(path: str) -> dict:
    """Payload for GET /debug/traces[?trace_id=...]: the named trace's
    spans, or (without a trace_id) the buffer's trace listing."""
    import urllib.parse
    q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
    trace_id = (q.get("trace_id") or [""])[0]
    if trace_id:
        return {
            "trace_id": trace_id,
            "pid": os.getpid(),
            "spans": RECORDER.spans(trace_id),
        }
    return {
        "pid": os.getpid(),
        "traces": RECORDER.trace_ids(),
        "pinned": {t: e["reason"]
                   for t, e in RECORDER.pinned().items()},
        "spans": RECORDER.spans(),
    }


def debug_incidents_payload() -> dict:
    """Payload for GET /debug/incidents: the incident-file listing."""
    return {
        "pid": os.getpid(),
        "dir": RECORDER.incident_dir,
        "incidents": RECORDER.incidents(),
    }
