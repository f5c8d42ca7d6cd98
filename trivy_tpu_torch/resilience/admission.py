"""Admission control for the Scan routes: a bounded, deadline-aware
queue.

  * at most `max_active` Scan RPCs run at once (0 = unbounded);
  * at most `max_queue` more may wait, each for at most
    min(queue budget, its own deadline): a handler thread is never
    parked past the point its client has given up;
  * everything else is shed at once with 429 + Retry-After. The server
    sheds 503 itself while it drains; with no breaker in the port, no
    shed depends on the device.

Per-request deadlines come in on `X-Trivy-Deadline-Ms`. Per-tenant
quotas (--admit-tenant-* flags, off by default): active and queued caps
and a token-bucket admit rate per clamped tenant label; with quotas
armed no tenant may hold more than max_queue - max(1, max_queue/4)
queued slots. The Retry-After hint follows the queue's observed drain
rate, floored at 1 s. Label "system" (and tenant=None) is exempt.

Follows the JAX package's resilience/admission.py, without its metrics
and its quota failpoint; `Deadline` is copied alone from its
resilience/breaker.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

# quota state stays bounded even if a caller skips the label clamp:
# past this many distinct labels, new tenants share "other"
_MAX_TENANT_STATE = 64

# window over which release() completions count toward the observed
# drain rate (seconds)
_DRAIN_WINDOW_S = 30.0

# tenants exempt from every per-tenant quota
EXEMPT_TENANTS = ("system",)


class Deadline:
    """Monotonic countdown. Immutable after construction; `None`
    seconds means no deadline (never expires)."""

    __slots__ = ("at",)

    def __init__(self, seconds: float | None,
                 _now: float | None = None):
        now = time.monotonic() if _now is None else _now
        self.at = None if seconds is None else now + seconds

    def remaining(self) -> float:
        if self.at is None:
            return float("inf")
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.at is not None and time.monotonic() >= self.at


@dataclass
class AdmissionOptions:
    """Server knobs (--admit-* flags)."""
    max_active: int = 0        # concurrent scans; 0 = unbounded
    max_queue: int = 16        # waiters beyond max_active
    queue_timeout_ms: float = 1000.0   # max queue wait per request
    # per-tenant quotas; 0 = that quota off
    tenant_max_active: int = 0   # concurrent scans per tenant
    tenant_max_queue: int = 0    # queued waiters per tenant
    tenant_rate: float = 0.0     # sustained admits/s per tenant
    tenant_burst: float = 0.0    # bucket depth; 0 ⇒ max(1, 2*rate)

    def tenant_quotas_on(self) -> bool:
        return (self.tenant_max_active > 0 or self.tenant_max_queue > 0
                or self.tenant_rate > 0.0)


class Shed(Exception):
    """Request rejected by admission (429) or by a draining server
    (503); `retry_after_s` feeds the Retry-After header."""

    def __init__(self, reason: str, http_code: int,
                 retry_after_s: float):
        super().__init__(reason)
        self.reason = reason
        self.http_code = http_code
        self.retry_after_s = retry_after_s


class _TenantState:
    """Per-tenant quota bookkeeping, all mutated under the queue's
    condition lock."""

    __slots__ = ("active", "queued", "tokens", "t_last")

    def __init__(self, tokens: float, now: float):
        self.active = 0
        self.queued = 0
        self.tokens = tokens    # token bucket fill
        self.t_last = now       # last refill timestamp


class AdmissionQueue:
    """Bounded admission for the Scan route. One instance per
    ServerState; release() must be called for every successful
    admit(), with the same `tenant` label (the handler's finally
    does)."""

    def __init__(self, opts: AdmissionOptions | None = None,
                 clock=time.monotonic):
        self.opts = opts or AdmissionOptions()
        self._clock = clock     # injectable for bucket/drain tests
        self._cv = threading.Condition()
        self._active = 0
        self._queued = 0
        self._tstate: dict[str, _TenantState] = {}
        # recent release() completion timestamps → observed drain rate
        self._done: deque[float] = deque(maxlen=64)

    # ---- introspection -------------------------------------------------

    def snapshot(self) -> dict:
        with self._cv:
            snap = {"active": self._active, "queued": self._queued,
                    "max_active": self.opts.max_active,
                    "max_queue": self.opts.max_queue}
            if self.opts.tenant_quotas_on():
                snap["tenant_quotas"] = {
                    "max_active": self.opts.tenant_max_active,
                    "max_queue": self._tenant_queue_cap(),
                    "rate": self.opts.tenant_rate,
                }
                snap["tenants"] = {
                    label: {"active": ts.active, "queued": ts.queued,
                            "tokens": round(ts.tokens, 3)}
                    for label, ts in sorted(self._tstate.items())
                }
            return snap

    # ---- tenant quota state --------------------------------------------

    def _burst(self) -> float:
        if self.opts.tenant_burst > 0.0:
            return self.opts.tenant_burst
        return max(1.0, 2.0 * self.opts.tenant_rate)

    def _tenant(self, label: str) -> tuple[str, _TenantState]:
        """State row for `label`, minting one full bucket on first
        sight. Defensively bounded: callers are expected to pass the
        aggregator-clamped label, but even raw names cannot mint more
        than _MAX_TENANT_STATE rows — the overflow shares "other"."""
        ts = self._tstate.get(label)
        if ts is None and len(self._tstate) >= _MAX_TENANT_STATE:
            label = "other"
            ts = self._tstate.get(label)
        if ts is None:
            ts = _TenantState(self._burst(), self._clock())
            self._tstate[label] = ts
        return label, ts

    def _tenant_queue_cap(self) -> int:
        """Queued-slot cap for any single tenant. Even when
        tenant_max_queue is off, quotas being armed reserves headroom:
        one tenant may hold at most max_queue - max(1, max_queue/4)
        global queue slots, so a flood never walls off the queue."""
        opts = self.opts
        cap = (opts.tenant_max_queue if opts.tenant_max_queue > 0
               else 1 << 30)
        if opts.max_active > 0 and opts.max_queue > 0:
            reserved = max(1, opts.max_queue // 4)
            cap = min(cap, max(1, opts.max_queue - reserved))
        return cap

    def _token_wait_s(self, ts: _TenantState) -> float:
        """Refill the tenant's bucket and try to take one token.
        Returns 0.0 on success, else seconds until the next token."""
        rate = self.opts.tenant_rate
        if rate <= 0.0:
            return 0.0
        now = self._clock()
        ts.tokens = min(self._burst(),
                        ts.tokens + (now - ts.t_last) * rate)
        ts.t_last = now
        if ts.tokens >= 1.0:
            ts.tokens -= 1.0
            return 0.0
        return (1.0 - ts.tokens) / rate

    # ---- admission -----------------------------------------------------

    def _drain_rate(self) -> float:
        """Observed service completions/s over the recent window
        (0.0 with fewer than two completions — no history yet)."""
        now = self._clock()
        lo = now - _DRAIN_WINDOW_S
        hist = [t for t in self._done if t >= lo]
        if len(hist) < 2:
            return 0.0
        span = hist[-1] - hist[0]
        if span <= 0.0:
            # a burst of completions inside one clock tick: treat the
            # window as one tick wide rather than dividing by zero
            span = 1e-3
        return (len(hist) - 1) / span

    def _retry_after(self, tenant: str | None = None) -> float:
        """Hint for shed clients, proportional to real congestion:
        queued-ahead / observed drain rate (the tenant's own queued
        count when quotas shed it, the global depth otherwise). With
        no completion history yet, fall back to the queue budget."""
        rate = self._drain_rate()
        if rate > 0.0:
            if tenant is not None and tenant in self._tstate:
                ahead = self._tstate[tenant].queued + 1
            else:
                ahead = self._queued + 1
            hint = ahead / rate
        else:
            hint = self.opts.queue_timeout_ms / 1e3
        return max(1.0, min(hint, 600.0))

    def _shed(self, reason: str, tenant: str | None = None,
              retry_after_s: float | None = None) -> Shed:
        if retry_after_s is None:
            retry_after_s = self._retry_after(tenant)
        return Shed(reason, 429, max(1.0, retry_after_s))

    def _blocked(self, ts: _TenantState | None) -> bool:
        if (self.opts.max_active > 0
                and self._active >= self.opts.max_active):
            return True
        return (ts is not None and self.opts.tenant_max_active > 0
                and ts.active >= self.opts.tenant_max_active)

    def admit(self, deadline: Deadline | None = None,
              tenant: str | None = None) -> None:
        """Block until a slot frees (within budget and deadline) or
        raise Shed. Callers MUST pair with release(tenant=...) using
        the same label. `tenant` is the aggregator-CLAMPED label;
        None or "system" bypasses every per-tenant quota (system
        work), global bounds still apply."""
        opts = self.opts
        quotas = (tenant is not None and tenant not in EXEMPT_TENANTS
                  and opts.tenant_quotas_on())
        with self._cv:
            ts = None
            if quotas:
                tenant, ts = self._tenant(tenant)
                wait_s = self._token_wait_s(ts)
                if wait_s > 0.0:
                    # rate overflow: Retry-After is THIS tenant's
                    # bucket refill, not global congestion
                    raise self._shed("tenant rate limited",
                                     tenant=tenant,
                                     retry_after_s=wait_s)
            if not self._blocked(ts):
                self._active += 1
                if ts is not None:
                    ts.active += 1
                return
            # must queue. Global overflow first (unchanged contract),
            # then the tenant's bounded share of the queue
            if opts.max_active > 0 and self._queued >= opts.max_queue:
                raise self._shed("queue overflow", tenant=tenant)
            if ts is not None and ts.queued >= self._tenant_queue_cap():
                raise self._shed("tenant queue overflow",
                                 tenant=tenant)
            budget = Deadline(opts.queue_timeout_ms / 1e3)
            self._queued += 1
            if ts is not None:
                ts.queued += 1
            try:
                while self._blocked(ts):
                    left = budget.remaining()
                    if deadline is not None:
                        left = min(left, deadline.remaining())
                    if left <= 0:
                        raise self._shed(
                            "deadline exceeded in queue"
                            if deadline is not None
                            and deadline.expired()
                            else "queue wait budget exhausted",
                            tenant=tenant)
                    self._cv.wait(timeout=left)
                # a slot freed — but if the CLIENT's deadline lapsed
                # while we were parked, admitting now runs a full scan
                # for a caller that already gave up; shed instead (the
                # slot stays free for the notify_all-woken others)
                if deadline is not None and deadline.expired():
                    raise self._shed("deadline exceeded in queue",
                                     tenant=tenant)
                self._active += 1
                if ts is not None:
                    ts.active += 1
            finally:
                self._queued -= 1
                if ts is not None:
                    ts.queued -= 1

    def release(self, tenant: str | None = None) -> None:
        with self._cv:
            self._active -= 1
            self._done.append(self._clock())
            if (tenant is not None and tenant not in EXEMPT_TENANTS
                    and self.opts.tenant_quotas_on()):
                _, ts = self._tenant(tenant)
                ts.active = max(0, ts.active - 1)
            # notify_all, not notify: a woken waiter may SHED (its own
            # deadline lapsed) without consuming the slot — a single
            # notify would then be lost while other waiters sleep out
            # their full budget next to a free slot
            self._cv.notify_all()
