"""graftwatch SLO engine: declared objectives over sliding windows.

/metrics says what the process did since boot; an operator paging at
3am needs "are we inside our objectives RIGHT NOW, and how fast are we
burning error budget". This module tracks three declared objectives
over short+long sliding windows and exports multi-window burn-rate
gauges (the standard multi-window multi-burn-rate alerting shape —
page on the short window, ticket on the long one):

  scan_latency_p99   fraction of completed scans under the latency
                     threshold must stay ≥ target (default: 99% under
                     2s). Only completed scans count — a shed request
                     has no latency.
  scan_errors        fraction of Scan RPCs that did not fail must stay
                     ≥ target (default 99.9%). SHED-AWARE: admission
                     429/503s are LOAD the deployment chose to refuse,
                     not errors — they count in the denominator as
                     good (refusing work under pressure is the SLO
                     behaving, not breaking).
  device_serving     fraction of joins served by the device path (vs
                     the NumPy host fallback) must stay ≥ target
                     (default 95%) — the "is the TPU actually carrying
                     the fleet" objective.

burn rate = bad_fraction / (1 - target): 1.0 means burning budget
exactly at the rate that exhausts it over the window's SLO period,
>1 means faster. Windows with no events burn 0 (no traffic, no burn).

The engine is a process singleton (SLO) like METRICS/GUARD; gauges
are (re)computed on export() — the /metrics and /healthz handlers
call it — so scrapes always see current-window values under the
strict exposition parser.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from ..metrics import METRICS


@dataclass(frozen=True)
class Objective:
    name: str
    target: float       # good-event ratio the objective promises
    help: str


DEFAULT_OBJECTIVES = (
    Objective("scan_latency_p99", 0.99,
              "completed scans under the latency threshold"),
    Objective("scan_errors", 0.999,
              "Scan RPCs that did not fail (sheds count as good)"),
    Objective("device_serving", 0.95,
              "joins served by the device path, not the host fallback"),
)


class SLOEngine:
    """Sliding-window good/bad event tracker per objective.

    Thread-safe: scan handler threads, the detect engine, and the
    detectd dispatcher all observe concurrently — every event-store
    mutation happens under the lock.
    The clock is injectable so burn-rate math is testable on
    synthetic traffic without real sleeps."""

    def __init__(self, objectives=DEFAULT_OBJECTIVES,
                 windows=(300.0, 3600.0),
                 latency_threshold_s: float = 2.0,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.windows = tuple(float(w) for w in windows)
        self.latency_threshold_s = latency_threshold_s
        self.objectives = {o.name: o for o in objectives}
        # per-objective deque of (ts, good: bool); pruned past the
        # longest window on every observe
        self._events = {name: deque() for name in self.objectives}
        # graftcost: per-tenant scan_latency_p99 event deques, keyed
        # by the TenantAggregator's CLAMPED label (top-K + "other"),
        # so the tenant-labeled burn gauges share the cardinality
        # bound of every other tenant series
        self._tenant_events: dict[str, deque] = {}

    def configure(self, latency_threshold_ms: float | None = None,
                  windows=None, targets: dict | None = None,
                  clock=None) -> None:
        with self._lock:
            if latency_threshold_ms is not None:
                self.latency_threshold_s = latency_threshold_ms / 1e3
            if windows is not None:
                self.windows = tuple(float(w) for w in windows)
            if targets:
                for name, target in targets.items():
                    obj = self.objectives.get(name)
                    if obj is None:
                        raise ValueError(f"unknown SLO objective "
                                         f"{name!r}")
                    self.objectives[name] = Objective(
                        obj.name, float(target), obj.help)
            if clock is not None:
                self._clock = clock

    # ---- observation ---------------------------------------------------

    def _observe(self, name: str, good: bool) -> None:
        horizon = max(self.windows)
        with self._lock:
            now = self._clock()
            ev = self._events[name]
            ev.append((now, good))
            while ev and ev[0][0] < now - horizon:
                ev.popleft()

    def observe_scan(self, latency_s: float, outcome: str,
                     tenant: str | None = None) -> None:
        """One Scan RPC: outcome 'ok' | 'error' | 'shed'. Sheds are
        load, not errors — they count toward availability's
        denominator as good and are excluded from the latency
        objective entirely (a refused scan has no latency). `tenant`
        (already clamped by the caller) additionally lands the
        latency event in that tenant's burn-rate window."""
        if outcome != "shed":
            good = (outcome == "ok"
                    and latency_s <= self.latency_threshold_s)
            self._observe("scan_latency_p99", good)
            if tenant:
                horizon = max(self.windows)
                with self._lock:
                    now = self._clock()
                    ev = self._tenant_events.setdefault(tenant,
                                                        deque())
                    ev.append((now, good))
                    while ev and ev[0][0] < now - horizon:
                        ev.popleft()
        self._observe("scan_errors", outcome != "error")

    def observe_join(self, device: bool) -> None:
        """One join dispatch: device path (good) or host fallback."""
        self._observe("device_serving", bool(device))

    # ---- math ----------------------------------------------------------

    def _window_stats(self, name: str, window: float,
                      now: float) -> tuple[int, int]:
        """→ (total, bad) inside `window` seconds. Caller holds the
        lock."""
        total = bad = 0
        for ts, good in self._events[name]:
            if ts >= now - window:
                total += 1
                if not good:
                    bad += 1
        return total, bad

    def burn_rates(self) -> dict:
        """→ {objective: {target, windows: {"<w>s": {total, bad,
        bad_ratio, burn_rate}}}} — the /healthz `slo` block."""
        with self._lock:
            now = self._clock()
            out = {}
            for name, obj in self.objectives.items():
                windows = {}
                for w in self.windows:
                    total, bad = self._window_stats(name, w, now)
                    ratio = bad / total if total else 0.0
                    budget = 1.0 - obj.target
                    burn = ratio / budget if budget > 0 else 0.0
                    windows[f"{int(w)}s"] = {
                        "total": total, "bad": bad,
                        "bad_ratio": round(ratio, 6),
                        "burn_rate": round(burn, 4),
                    }
                out[name] = {"target": obj.target,
                             "windows": windows}
            return out

    def tenant_burn_rates(self) -> dict:
        """→ {tenant: {window: burn_rate}} for the scan_latency_p99
        objective — per-tenant error-budget burn over the same
        windows, keyed by clamped tenant label."""
        obj = self.objectives["scan_latency_p99"]
        budget = 1.0 - obj.target
        with self._lock:
            now = self._clock()
            out: dict = {}
            for tenant, ev in self._tenant_events.items():
                windows = {}
                for w in self.windows:
                    total = bad = 0
                    for ts, good in ev:
                        if ts >= now - w:
                            total += 1
                            if not good:
                                bad += 1
                    ratio = bad / total if total else 0.0
                    burn = ratio / budget if budget > 0 else 0.0
                    windows[f"{int(w)}s"] = round(burn, 4)
                out[tenant] = windows
            return out

    def export(self) -> dict:
        """Recompute and publish the burn-rate gauges (and the
        device-serving ratio over the short window); returns the
        burn_rates() document so /healthz shares one computation."""
        rates = self.burn_rates()
        for name, doc in rates.items():
            for wname, w in doc["windows"].items():
                METRICS.set_gauge("trivy_tpu_slo_burn_rate",
                                  w["burn_rate"], objective=name,
                                  window=wname)
        # graftcost: tenant-labeled latency burn (cardinality already
        # clamped at observe time — labels are TenantAggregator
        # output, never raw header values)
        for tenant, windows in self.tenant_burn_rates().items():
            for wname, burn in windows.items():
                METRICS.set_gauge("trivy_tpu_slo_burn_rate", burn,
                                  objective="scan_latency_p99",
                                  window=wname, tenant=tenant)
        short = f"{int(min(self.windows))}s"
        dev = rates["device_serving"]["windows"][short]
        ratio = 1.0 - dev["bad_ratio"] if dev["total"] else 1.0
        METRICS.set_gauge("trivy_tpu_device_serving_ratio", ratio)
        # graftprof auto-trigger: a short-window burn past the
        # configured threshold starts one background profile capture
        # (cooldown-limited), so the page this export feeds arrives
        # with an actionable device trace attached
        from .perf import PROF
        PROF.observe_burn(rates)
        return rates

    def reset_for_tests(self) -> None:
        with self._lock:
            for ev in self._events.values():
                ev.clear()
            self._tenant_events = {}


SLO = SLOEngine()
