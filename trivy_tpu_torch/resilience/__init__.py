"""The server's admission queue and the client's retry policy.

The JAX package's breaker, watchdog, host-join fallback, failpoints and
mesh fault domains are not ported (ROADMAP A, "Not ported"): a device
failure raises here. Of its breaker module only `Deadline` is copied.
"""

from .admission import AdmissionOptions, AdmissionQueue, Deadline, Shed
from .retry import RetryPolicy, http_should_retry

__all__ = ["AdmissionOptions", "AdmissionQueue", "Deadline", "Shed",
           "RetryPolicy", "http_should_retry"]
