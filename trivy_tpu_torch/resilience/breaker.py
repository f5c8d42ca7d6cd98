"""The closed → open → half-open circuit breaker, as routing state.

The port's copy of the JAX package's CircuitBreaker
(trivy_tpu/resilience/breaker.py). There it guards the device and routes
an open breaker's calls to a host join; here it guards nothing on the
card. The fleet's replica fault domains (fleet/supervisor.py) are its
only user: a replica whose forwards keep failing is routed past, and
another port server, on its own card, serves the request. No breaker
wraps a kernel launch and no launch falls back. The device guard, its
watchdog and the recovery listeners are not copied.

Failures count toward `fail_threshold`; reaching it opens the breaker.
After `reset_timeout_s` one caller is admitted as the half-open probe:
its success closes the breaker, its failure re-opens it. Opening notes
a `breaker_open` incident in the flight recorder.
"""

from __future__ import annotations

import threading
import time

from ..log import get as _get_logger
from ..metrics import METRICS

_log = _get_logger("resilience")

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker. `gauge` names an opt-in state series (0 closed, 1 open, 2
    half-open) under `gauge_labels`; a breaker without one owns no
    series."""

    def __init__(self, fail_threshold: int = 3,
                 reset_timeout_s: float = 5.0,
                 name: str = "breaker", gauge: str | None = None,
                 gauge_labels: dict | None = None):
        self._lock = threading.Lock()
        self.name = name
        self.fail_threshold = fail_threshold
        self.reset_timeout_s = reset_timeout_s
        self.gauge = gauge
        self._gauge_labels = dict(gauge_labels or {})
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._opens_total = 0
        if gauge:
            METRICS.set_gauge(gauge, 0.0, **self._gauge_labels)

    def _set_state(self, state: int) -> None:
        # callers hold self._lock
        if state == self._state:
            return
        self._state = state
        if state == OPEN:
            self._opened_at = time.monotonic()
            self._opens_total += 1
        if self.gauge:
            METRICS.set_gauge(self.gauge, float(state),
                              **self._gauge_labels)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def status(self) -> dict:
        with self._lock:
            return {
                "state": STATE_NAMES[self._state],
                "failures": self._failures,
                "opens_total": self._opens_total,
                "open_age_s": (round(time.monotonic() - self._opened_at, 3)
                               if self._state != CLOSED else None),
            }

    def allow(self) -> bool:
        """May this caller go ahead? While open, True for exactly one
        caller per reset window: the half-open probe."""
        if self._state == CLOSED:      # lock-free fast path
            return True
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and \
                    time.monotonic() - self._opened_at \
                    >= self.reset_timeout_s:
                self._set_state(HALF_OPEN)
                self._probing = True
                _log.warning("breaker %s: half-open probe admitted",
                             self.name)
                return True
            if self._state == HALF_OPEN and not self._probing:
                # the previous probe resolved without closing or
                # re-opening: admit a fresh one
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._set_state(CLOSED)
                self._probing = False
                _log.warning("breaker %s: probe succeeded, closed",
                             self.name)
            self._failures = 0

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            if self._state == HALF_OPEN:
                self._probing = False
                self._set_state(OPEN)
                opened = True
                _log.warning("breaker %s: probe failed, re-opened",
                             self.name)
            else:
                self._failures += 1
                if self._state == CLOSED and \
                        self._failures >= self.fail_threshold:
                    self._set_state(OPEN)
                    opened = True
                    _log.warning("breaker %s: opened after %d "
                                 "failures", self.name, self._failures)
        if opened:
            self._note_open()

    def _note_open(self) -> None:
        """The incident hook, called outside the breaker lock (it
        snapshots the flight recorder to disk): an opening pins the
        active trace and captures a cooldown-limited incident file."""
        try:
            from ..obs.recorder import RECORDER
            RECORDER.note_event("breaker_open", incident=True,
                                breaker=self.name)
        except Exception:   # observability must never sink the caller
            _log.exception("breaker incident capture failed")
