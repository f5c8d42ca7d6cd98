"""Tenant labels: who a scan is for, clamped to a bounded label set.

The server reads the `X-Trivy-Tenant` header of each request,
normalize_tenant cleans it, and `request_tenant` installs it for the
request's thread. detectd keys its fair queue on TENANTS.resolve() of
that name: the first `top_k` distinct names get a label of their own
and every later one shares "other", so the queue's state stays bounded
under a flood of names. Work outside a request (warmup, tests calling
the scheduler directly) is "system".

Of the JAX package's `obs/cost.py` only this label clamp is ported
(`normalize_tenant`, `TenantAggregator.resolve`, `TENANTS`); its cost
ledgers and tenant totals are not.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading

_TENANT_MAX_LEN = 64

_CURRENT: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "trivy_tpu_torch_tenant", default=None)


def normalize_tenant(raw: str | None) -> str:
    """Syntactic clamp of a raw tenant header: cut to 64 characters,
    non-printable characters made "_", and "default" when empty."""
    if not raw:
        return "default"
    cleaned = "".join(ch if ch.isprintable() else "_"
                      for ch in raw[:_TENANT_MAX_LEN]).strip()
    return cleaned or "default"


class TenantAggregator:
    """The bounded label space: "default", "system" and "other" are
    reserved, and at most `top_k` other names get a label of their
    own."""

    RESERVED = ("default", "system", "other")

    def __init__(self, top_k: int = 8):
        self._lock = threading.Lock()
        self.top_k = int(top_k)
        self._labels: set[str] = {"default", "system"}

    def resolve(self, tenant: str) -> str:
        """→ the bounded label for `tenant`, minting one while the
        budget allows."""
        t = tenant or "default"
        with self._lock:
            if t in self._labels:
                return t
            named = sum(1 for k in self._labels if k not in self.RESERVED)
            if named >= self.top_k:
                self._labels.add("other")
                return "other"
            self._labels.add(t)
            return t


TENANTS = TenantAggregator()


@contextlib.contextmanager
def request_tenant(name: str):
    """Install `name` (already normalized) as the current request's
    tenant for the duration of the block."""
    token = _CURRENT.set(name)
    try:
        yield name
    finally:
        _CURRENT.reset(token)


def current_label() -> str:
    """The clamped label of the current request's tenant, or "system"
    outside a request."""
    name = _CURRENT.get()
    return "system" if name is None else TENANTS.resolve(name)
