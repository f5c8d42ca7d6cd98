"""The client's retry policy: full jitter, capped by a sleep budget.

A delay before retry n is drawn from U(0, min(max_delay, base·2^n)), so
a herd of clients spreads itself out; the total sleep never exceeds
`budget_s`, and a server's Retry-After hint is honoured within it. The
rng and sleep are injectable for tests. Follows the JAX package's
resilience/retry.py.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Immutable policy; share one instance per edge."""

    attempts: int = 3          # total tries (1 = no retries)
    base_delay_s: float = 0.2
    max_delay_s: float = 5.0
    budget_s: float = 30.0     # cap on cumulative sleep

    def delay(self, attempt: int, rng=None) -> float:
        """Full-jitter delay before retry number `attempt` (0-based)."""
        rng = rng if rng is not None else random
        return rng.uniform(
            0.0, min(self.max_delay_s,
                     self.base_delay_s * (2.0 ** attempt)))

    def call(self, fn, *, should_retry, sleep=time.sleep, rng=None):
        """Run `fn()` with retries. `should_retry(exc)` → None to
        re-raise, or the least delay in seconds (0.0 lets the policy
        decide; a server's Retry-After goes here)."""
        spent = 0.0
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                floor = should_retry(e)
                if floor is None or attempt + 1 >= self.attempts:
                    raise
                d = max(float(floor), self.delay(attempt, rng))
                if spent + d > self.budget_s:
                    raise
                sleep(d)
                spent += d
                attempt += 1


def http_should_retry(codes):
    """→ a should_retry for urllib calls: connection errors (URLError)
    retry after the policy's jitter; HTTPErrors whose code is in
    `codes` retry no sooner than their Retry-After; the rest raise."""
    import urllib.error

    def should_retry(e):
        if isinstance(e, urllib.error.HTTPError):
            if e.code in codes:
                try:
                    return float(e.headers.get("Retry-After") or 0.0)
                except ValueError:
                    return 0.0
            return None
        if isinstance(e, urllib.error.URLError):
            return 0.0
        return None
    return should_retry
