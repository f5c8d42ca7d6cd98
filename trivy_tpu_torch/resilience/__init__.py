"""The server's admission queue, the client's retry policy, the fleet's
circuit breaker, and the blameless mark of background work.

The JAX package's device breaker, watchdog, host-join fallback,
failpoints and mesh fault domains are not ported (ROADMAP A, "Not
ported"): a device failure raises here. Of its breaker module
`Deadline` (admission.py) and `CircuitBreaker` (breaker.py) are copied.
The breakers are routing state: one per replica of a fleet
(fleet/supervisor.py), so that the router walks past a lost replica to
another port server, which serves the request on its own card. No
breaker wraps a kernel launch, and no launch falls back.

`blameless()` stands for the two things the JAX package's
`GUARD.blameless()` does on redetectd's path (the post-swap memo sweep,
detect/redetect.py): the scanner takes the direct engine path instead of
a merged detectd dispatch, so live requests never share a launch with
guest work, and the engine's launches carry the ledger site "redetect".
There is no breaker to spare here, so that is all it does. The mark is a
context variable: it holds for the thread (or context) that entered the
block and for nothing else.
"""

import contextlib
import contextvars

from .admission import AdmissionOptions, AdmissionQueue, Deadline, Shed
from .retry import RetryPolicy, http_should_retry

_BLAMELESS: contextvars.ContextVar[int] = contextvars.ContextVar(
    "trivy_tpu_blameless", default=0)


@contextlib.contextmanager
def blameless():
    """Mark the work inside the block as background work (nestable)."""
    token = _BLAMELESS.set(_BLAMELESS.get() + 1)
    try:
        yield
    finally:
        _BLAMELESS.reset(token)


def blameless_active() -> bool:
    return _BLAMELESS.get() > 0


__all__ = ["AdmissionOptions", "AdmissionQueue", "Deadline", "Shed",
           "RetryPolicy", "blameless", "blameless_active",
           "http_should_retry"]
