"""Replica fault domains: one circuit breaker per replica of the fleet.

The port's copy of trivy_tpu/fleet/supervisor.py. Each server replica
gets its own CircuitBreaker (BreakerRegistry keyed by replica URL,
exported as the labelled `trivy_tpu_fleet_replica_state{replica=
"<url>"}` gauge). A routed RPC that fails charges THAT replica's
breaker; once the breaker leaves closed the replica is LOST and the
router walks the ring past it. A maintenance thread readmits: once a
lost replica's breaker admits its half-open probe, a successful
`/healthz` round trip closes the breaker and the replica takes its keys
back (the ring never forgot them), its cache still warm.

This is routing state only. A lost replica is another port server
whose card the router never touches; the request it would have served
goes to a survivor, which runs it on its own card. The JAX package
keeps BreakerRegistry in resilience/meshguard.py, which the port does
not have (ROADMAP A, not ported by the north star): its copy lives
here.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from dataclasses import dataclass

from ..log import get as _get_logger
from ..resilience.breaker import CLOSED, CircuitBreaker

_log = _get_logger("fleet")


def replica_site(replica: str) -> str:
    """Breaker and log name of one replica's fault domain."""
    return f"fleet.replica:{replica}"


class BreakerRegistry:
    """One circuit breaker per replica, made on first use, each
    exporting its state (0 closed, 1 open, 2 half-open) as
    `trivy_tpu_fleet_replica_state{replica=}`
    (trivy_tpu/resilience/meshguard.py BreakerRegistry, with the
    fleet's gauge, label and names)."""

    def __init__(self, fail_threshold: int = 3,
                 reset_timeout_s: float = 5.0):
        self._lock = threading.Lock()
        self._breakers: dict = {}
        self.fail_threshold = fail_threshold
        self.reset_timeout_s = reset_timeout_s

    def get(self, replica: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(replica)
            if br is None:
                br = CircuitBreaker(
                    fail_threshold=self.fail_threshold,
                    reset_timeout_s=self.reset_timeout_s,
                    name=replica_site(replica),
                    gauge="trivy_tpu_fleet_replica_state",
                    gauge_labels={"replica": replica})
                self._breakers[replica] = br
        return br


def healthz_probe(replica: str, timeout_s: float) -> str:
    """The default readmission probe: one `/healthz` round trip; a
    non-2xx answer or a connection error raises. → the replica's
    advertised advisory-DB version ('' when absent), so the router's
    skew watch sees a readmitted replica's DB BEFORE traffic lands on
    it: a replica restarted mid-rollout may come back on another
    database than the fleet's."""
    req = urllib.request.Request(replica.rstrip("/") + "/healthz")
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        if r.status != 200:
            raise RuntimeError(f"healthz returned {r.status}")
        body = r.read()
    try:
        return str(json.loads(body).get("db_version") or "")
    except (ValueError, AttributeError):
        return ""   # plain `ok` or a foreign payload: no version


@dataclass
class ReplicaOptions:
    """Replica fault-domain knobs (router flags --replica-fail-threshold,
    --replica-reset-ms, --replica-probe-interval-ms,
    --replica-probe-timeout-ms)."""
    fail_threshold: int = 3           # errors that open a replica domain
    reset_timeout_ms: float = 2000.0  # open → half-open probe window
    probe_interval_ms: float = 200.0  # readmission loop cadence
    probe_timeout_ms: float = 2000.0  # /healthz probe bound


class ReplicaSet:
    """Breaker registry + readmission loop over a set of replicas. The
    /healthz probe runs only on the maintenance thread, never on the
    request path."""

    def __init__(self, replicas, opts: ReplicaOptions | None = None,
                 db_version_cb=None):
        self.replicas = list(replicas)
        self.opts = opts or ReplicaOptions()
        # the router's hook: a successful readmission probe reports the
        # replica's advertised db_version here (the skew watch)
        self._db_version_cb = db_version_cb
        self.registry = BreakerRegistry(
            fail_threshold=self.opts.fail_threshold,
            reset_timeout_s=self.opts.reset_timeout_ms / 1e3)
        self._lock = threading.Lock()
        self._lost: set[str] = set()
        self._readmissions = 0
        self._stop = threading.Event()
        # every replica's state series exists from boot, so a scrape
        # sees the whole fleet, not only the replicas that faulted
        for r in self.replicas:
            self.registry.get(r)
        self._thread = threading.Thread(
            target=self._run, name="fleet-readmit", daemon=True)
        self._thread.start()

    # ---- the request path ---------------------------------------------

    def available(self, replica: str) -> bool:
        """May the router forward to this replica? Lost domains wait
        for the probe loop: live traffic is never the half-open probe
        (a request-sized probe of a sick replica would burn a client's
        deadline on supervision)."""
        with self._lock:
            return replica not in self._lost

    def record_failure(self, replica: str) -> None:
        """Charge one routed-RPC failure to the replica's domain; once
        its breaker leaves closed the replica is lost."""
        br = self.registry.get(replica)
        br.record_failure()
        if br.state != CLOSED:
            with self._lock:
                if replica in self._lost or replica not in self.replicas:
                    return
                self._lost.add(replica)
            _log.warning("fleet: replica %s lost; routing past it "
                         "until a probe readmits", replica)
            try:
                from ..obs.recorder import RECORDER
                # pins the routed request's trace (this runs on the
                # router's handler thread, its context intact)
                RECORDER.note_event("fleet_replica_lost",
                                    replica=replica)
            except Exception:
                _log.exception("fleet event note failed")

    def record_success(self, replica: str) -> None:
        self.registry.get(replica).record_success()

    def lost(self) -> list[str]:
        with self._lock:
            return sorted(self._lost)

    # ---- the readmission loop -----------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.opts.probe_interval_ms / 1e3):
            try:
                self._probe_lost()
            except Exception:   # the supervisor must never die
                _log.exception("fleet readmission tick failed")

    def _probe_lost(self) -> None:
        with self._lock:
            lost = sorted(self._lost)
        for replica in lost:
            br = self.registry.get(replica)
            if not br.allow():
                continue   # still inside the open window
            try:
                version = healthz_probe(replica,
                                        self.opts.probe_timeout_ms / 1e3)
            except Exception:
                _log.warning("fleet: replica %s probe failed; domain "
                             "stays open", replica, exc_info=True)
                br.record_failure()
                continue
            br.record_success()
            # the version is noted while the replica is still lost, so
            # the skew watch has it before the first routed request
            if version and self._db_version_cb is not None:
                try:
                    self._db_version_cb(replica, str(version))
                except Exception:
                    _log.exception("fleet: db-version note failed")
            with self._lock:
                self._lost.discard(replica)
                self._readmissions += 1
            _log.warning("fleet: replica %s readmitted", replica)

    # ---- introspection and lifecycle ----------------------------------

    def status(self) -> dict:
        """→ the router's /healthz `fleet` replica block."""
        with self._lock:
            lost = set(self._lost)
            readmissions = self._readmissions
        return {
            "replicas": {
                r: {**self.registry.get(r).status(),
                    "lost": r in lost}
                for r in self.replicas
            },
            "lost": sorted(lost),
            "readmissions": readmissions,
        }

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
