"""Device status for /healthz.

The health endpoint must never block behind a device that is still
initializing, so it never touches torch.cuda itself: the detector's and
the secrets engine's launch paths call note_dispatch(device) right
after a launch (the CUDA context is live there), which caches the
device identity once and stamps the last-dispatch time; healthz reads
the cached view. Before the first dispatch the platform reports
"uninitialized" — an honest answer for a server that has not yet run
device work.

The port's copy of the JAX package's obs/device.py: the same keys
(platform, device_count, last_dispatch_age_s, memory), with platform
"gpu" on the card and "cpu" for a `--device cpu` run. The server stamps
the identity once at start (note_device) and keeps the card's name.
"""

from __future__ import annotations

import threading
import time

_lock = threading.Lock()
_state = {
    "platform": "",
    "device_count": 0,
    "last_dispatch_unix": 0.0,
}


def note_device(device) -> str:
    """Stamp the device identity once, where the owner resolved its
    device (the server at start), so /healthz names the platform before
    the first dispatch too (`last_dispatch_age_s` stays None until
    one). → the device's name ("cpu" for the CPU), for the owner to
    cache."""
    if getattr(device, "type", "cpu") == "cuda":
        import torch
        platform, count = "gpu", torch.cuda.device_count()
        name = torch.cuda.get_device_name(device)
    else:
        platform, count, name = "cpu", 1, "cpu"
    with _lock:
        _state["platform"], _state["device_count"] = platform, count
    return name


def note_dispatch(device=None) -> None:
    """Record a launch on `device` (a torch.device; called from the
    launch paths, where the CUDA context is already live)."""
    if not _state["platform"]:
        try:
            if getattr(device, "type", "cpu") == "cuda":
                import torch
                platform, count = "gpu", torch.cuda.device_count()
            else:
                platform, count = "cpu", 1
        except Exception:  # a device probe must never sink a launch
            platform, count = "unknown", 0
        with _lock:
            if not _state["platform"]:
                _state["platform"] = platform
                _state["device_count"] = count
    with _lock:
        _state["last_dispatch_unix"] = time.time()
    # graftprof memory telemetry rides the same contract: the context
    # is live HERE, so the throttled memory sample happens now and
    # /healthz only ever reads the cached view
    from .perf import LEDGER
    LEDGER.sample_memory(device)


def device_status() -> dict:
    """→ {platform, device_count, last_dispatch_age_s, memory} for
    /healthz. The memory block is graftprof's cached view (device
    memory sampled on the dispatch path + host-resident component
    bytes) — like everything here, it never touches torch.cuda."""
    from .perf import LEDGER
    with _lock:
        snap = dict(_state)
    last = snap.pop("last_dispatch_unix")
    snap["platform"] = snap["platform"] or "uninitialized"
    snap["last_dispatch_age_s"] = (
        round(time.time() - last, 3) if last else None)
    snap["memory"] = LEDGER.memory_status()
    return snap


def _reset_for_tests() -> None:
    with _lock:
        _state["platform"] = ""
        _state["device_count"] = 0
        _state["last_dispatch_unix"] = 0.0
