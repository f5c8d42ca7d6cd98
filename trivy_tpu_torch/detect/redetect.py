"""redetectd: the re-detect sweep behind the memo (fleet/memo.py).

A DB hot swap makes every memo entry keyed to the old db version stop
being addressed, and the first scan of each blob after it would pay a
live join. When swap_table installs a table with a NEW content digest,
the server schedules a background sweep that replays the memo's known
blobs through the detect path alone (apply_layers, query building, the
join on the card; no analysis) and publishes fresh entries under the
new version, ideally before the next request for them arrives.

The sweep is a guest, not a tenant:

  * it yields to traffic: between blobs it reads the AdmissionQueue
    snapshot and parks while live scans are queued (or the bounded
    active set is full);
  * it is blameless (resilience.blameless()): its replays join on the
    direct engine path, never inside a merged detectd dispatch, and
    their launches carry the ledger site "redetect"; a blob that fails
    to replay is counted and skipped;
  * it is preemptible: a newer swap, a drain or the server's close
    cancels it between blobs, and it stands down when the serving db
    version moves under it.

Progress shows in /healthz (`memo.sweep`: phase, blobs done/total, the
target db version) and in the trivy_tpu_redetect_* series.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

from .. import types as T
from ..log import get as _get_logger
from ..metrics import METRICS
from ..obs import span
from ..resilience import blameless

_log = _get_logger("detect.redetect")


# how long the sweep parks between looks at the admission queue, and
# how long a cancel or close waits for a running sweep to unwind
_YIELD_SLEEP_S = 0.02
_JOIN_TIMEOUT_S = 30.0


@dataclass
class RedetectOptions:
    """The server's knob (--redetect-concurrency; memo.redetect-
    concurrency in trivy.yaml)."""
    concurrency: int = 2   # blobs replayed in parallel; 0: no sweep


class RedetectDaemon:
    """One per ServerState. `scanner_fn` returns the CURRENT (scanner,
    db_version) pair, read together under the server's lock."""

    def __init__(self, memo, cache, admission, scanner_fn,
                 opts: Optional[RedetectOptions] = None, track=None):
        self.memo = memo
        self.cache = cache
        self.admission = admission
        self.scanner_fn = scanner_fn
        # (request_started, request_finished): a replay registers in the
        # server's generation tracking as a Scan handler does (register
        # first, then take the scanner), so a concurrent swap cannot
        # close the scanner under a replay's launch
        self.track = track
        self.opts = opts or RedetectOptions()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        self._status = {"phase": "idle", "done": 0, "total": 0,
                        "db_version": "", "sweeps": 0}

    # ---- lifecycle -----------------------------------------------------

    def schedule(self, db_version: str) -> None:
        """Start a sweep toward `db_version`, preempting a running one."""
        if self.opts.concurrency < 1:
            return
        # racing swaps can deliver schedule() calls out of order: an
        # older swap's late call must not preempt the sweep toward the
        # version being served (its replacement would stand down at
        # once as stale, leaving no sweep toward the live version)
        try:
            _, cur = self.scanner_fn()
        except Exception:  # noqa: BLE001 — a closing server; moot
            return
        if cur != db_version:
            _log.warning("redetectd: ignoring stale sweep target "
                         "%.19s... (serving %.19s...)", db_version, cur)
            return
        with self._lock:
            if self._closed:
                return
            old_thread = self._thread
            self._stop.set()
            stop = self._stop = threading.Event()
            self._status = {"phase": "pending", "done": 0, "total": 0,
                            "db_version": db_version,
                            "sweeps": self._status["sweeps"] + 1}
            t = self._thread = threading.Thread(
                target=self._sweep, name="redetectd-sweep",
                args=(db_version, stop, old_thread), daemon=True)
        t.start()

    def cancel(self) -> None:
        """Stop the running sweep (a drain) and wait for it, bounded, so
        a wedged replay cannot hold the drain."""
        with self._lock:
            self._stop.set()
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=_JOIN_TIMEOUT_S)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self.cancel()

    def status(self) -> dict:
        with self._lock:
            return dict(self._status)

    def _set_status(self, **kw) -> None:
        with self._lock:
            self._status.update(kw)

    # ---- the sweep -----------------------------------------------------

    def _yield_to_traffic(self, stop: threading.Event) -> None:
        """Park while live scans wait for admission: the replays take
        the same card as they do."""
        while not stop.is_set():
            snap = self.admission.snapshot()
            busy = snap["queued"] > 0 or (
                snap["max_active"] > 0
                and snap["active"] >= snap["max_active"])
            if not busy:
                return
            stop.wait(_YIELD_SLEEP_S)

    def _sweep(self, version: str, stop: threading.Event,
               predecessor: Optional[threading.Thread]) -> None:
        # one sweep at a time: the superseded one stops between blobs,
        # and waiting for it keeps done/total in /healthz coherent
        if predecessor is not None and predecessor.is_alive():
            predecessor.join(timeout=_JOIN_TIMEOUT_S)
        if stop.is_set():
            self._finish(version, "cancelled")
            return
        blobs = self.memo.known_blobs()
        METRICS.inc("trivy_tpu_redetect_sweeps_total")
        METRICS.set_gauge("trivy_tpu_redetect_active", 1.0)
        self._set_status(phase="sweeping", done=0, total=len(blobs),
                         db_version=version)
        _log.warning("redetectd: sweeping %d memoized blob(s) onto "
                     "db_version %.19s...", len(blobs), version)
        done = 0
        try:
            workers = self.opts.concurrency
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="redetectd") as pool:
                pending: list = []
                for blob_id in blobs:
                    if stop.is_set():
                        break
                    self._yield_to_traffic(stop)
                    if stop.is_set():
                        break
                    pending.append(pool.submit(
                        self._replay_one, blob_id, version, stop))
                    while len(pending) >= workers:
                        done += self._harvest(pending.pop(0), stop,
                                              version)
                for f in pending:
                    done += self._harvest(f, stop, version)
        except Exception:  # noqa: BLE001 — the daemon must not die
            _log.exception("redetectd: sweep toward %.19s... failed",
                           version)
            self._finish(version, "failed", done)
            return
        self._finish(version, "cancelled" if stop.is_set() else "done",
                     done)

    def _harvest(self, future, stop, version) -> int:
        outcome = future.result()
        METRICS.inc("trivy_tpu_redetect_blobs_total", outcome=outcome)
        if outcome == "stale":
            # the serving version moved: a newer schedule() owns it
            stop.set()
        with self._lock:
            if self._status.get("db_version") == version:
                self._status["done"] += 1
        return 1

    def _finish(self, version, phase, done: int = 0) -> None:
        with self._lock:
            mine = self._status.get("db_version") == version
            if mine:
                self._status["phase"] = phase
            running = self._thread is threading.current_thread()
        if mine or running:
            METRICS.set_gauge("trivy_tpu_redetect_active", 0.0)
        _log.warning("redetectd: sweep toward %.19s... %s (%d blob(s) "
                     "visited)", version, phase, done)

    def _replay_one(self, blob_id: str, version: str,
                    stop: threading.Event) -> str:
        """Replay one cached blob through the detect path; the memo scan
        publishes its entry under `version` → the outcome label."""
        if stop.is_set():
            return "cancelled"
        try:
            # a blob another server sharing the memo already refreshed
            if self.memo.get_entry(blob_id, version):
                return "fresh"
            blob = self.cache.get_blob(blob_id)
            if blob is None:
                return "missing"
            if blob.ingest_errors:
                return "partial"   # annotated partials never memoize
            gen = self.track[0]() if self.track else None
            try:
                scanner, cur = self.scanner_fn()
                if cur != version:
                    return "stale"
                with span("redetect.replay", blob=blob_id[:19]), \
                        blameless():
                    scanner.scan_many([(blob_id, blob_id, [blob_id])],
                                      T.ScanOptions())
            finally:
                if gen is not None:
                    self.track[1](gen)
            return "refreshed"
        except Exception as e:  # noqa: BLE001 — counted, never raised
            _log.warning("redetectd: replay of %.19s... failed (%s: %s)",
                         blob_id, type(e).__name__, e)
            return "failed"
