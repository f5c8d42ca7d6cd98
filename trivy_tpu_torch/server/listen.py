"""Scan server (reference pkg/rpc/server/listen.go).

One HTTP mux with the Scanner and Cache services, /healthz and
/version, optional token auth (Trivy-Token header), and a hot-swappable
advisory table. Routes speak both Twirp encodings (POST
/twirp/<service>/<Method>): JSON bodies with proto field names, and
application/protobuf (protowire.py) for the Go client. Every Scan runs
through the admission queue and then the shared LocalScanner, whose
detectd merges concurrent requests' batches into shared join launches
on the card.

Answers equal the JAX package's server's (trivy_tpu/server/listen.py)
on every route, its observability surface included: every POST runs
under a trace id (X-Trivy-Trace-Id, honored or minted, and
X-Trivy-Parent-Span from the client) with a `server.rpc` root span and
a request cost ledger (X-Trivy-Cost on the response); GET /metrics
serves METRICS in the Prometheus text format; /debug/traces,
/debug/incidents, /debug/perf, /debug/profile?ms=N and /debug/costs are
gated by the token that gates the POST routes; `serve(trace_path=)`
records a Chrome trace for the server's lifetime. With a memo backend
(`memo_backend`, fleet/memo.py) scans replay their units' memoized hits,
and a swap to a table of another content digest schedules redetectd's
sweep (detect/redetect.py); /healthz shows both under `memo`. With
StreamOptions (`stream_opts`; the CLI's --table-stream-slices,
--table-device-budget-mb) every scanner the server builds, after a DB
swap too, streams a table over the budget through resident slices
(parallel/stream.py), whose next slices detectd's peek warms
(SchedOptions.prefetch, --[no-]stream-prefetch), and /healthz shows
the slice plan under `stream`. With MeshOptions (`mesh_opts`; the CLI's
--mesh-devices, --mesh-db-shards) every scanner the server builds, after
a DB swap too (the new table re-sharded over the same mesh), joins over
a dp×db mesh of the server's device type (parallel/mesh.py), one kernel
launch per cell at ledger site "mesh" ("redetect" in redetectd's
sweep). Not ported: meshguard, the breaker and its recovery; a mesh
over more than one process (ROADMAP A19).
"""

from __future__ import annotations

import gc
import json
import queue
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import __version__
from .. import types as T
from ..detect.engine import BatchDetector
from ..detect.redetect import RedetectDaemon
from ..detect.sched import SchedOptions
from ..fanal.cache import blob_from_json, open_cache
from ..fleet.memo import open_memo
from ..log import get as _get_logger
from ..metrics import METRICS
from ..obs import PROF, SLO, device_status, new_trace, span
from ..obs import cost as _cost
from ..obs.device import note_device
from ..obs.perf import Profiler, debug_perf_payload, debug_profile_payload
from ..obs.recorder import debug_incidents_payload, debug_traces_payload
from ..resilience import AdmissionQueue, Deadline, Shed
from ..scanner import LocalScanner
from . import (COST_HEADER, DB_VERSION_HEADER, DEADLINE_HEADER,
               PARENT_SPAN_HEADER, ROUTE_DESCRIPTORS, TENANT_HEADER,
               TOKEN_HEADER, TRACE_HEADER)

_log = _get_logger("server")

# the pages that carry scan detail (file paths in analyzer spans, other
# tenants' trace ids) or cost (a live profile): gated by the token
DEBUG_PAGES = ("/debug/traces", "/debug/incidents", "/debug/perf",
               "/debug/profile", "/debug/costs")


@dataclass
class MeshOptions:
    """Mesh knobs (server flags --mesh-devices, --mesh-db-shards).
    devices=0 keeps the single-device detector; N > 0 takes the first N
    devices of the server's type, N < 0 all of them (on the CPU, N
    slots of it); db_shards is the preferred db width, fitted to the
    largest valid factorization of the device count."""
    devices: int = 0
    db_shards: int = 1


class LaunchRecord:
    """A few merged dispatches, kept for `server --debug-launches` so
    that a check can rerun each through the plain join: the full merged
    descriptors and the bits fetched for them, the descriptors the
    launch ran (the unique ones when deduped), its route and hit
    buffer, and the version pool; up to `per_kind` of each (deduped,
    route) kind."""

    def __init__(self, per_kind: int = 3):
        self.per_kind = per_kind
        self._lock = threading.Lock()
        self.entries: list[dict] = []

    def __call__(self, det, dev, preps, bits) -> None:
        from ..detect.engine import CompactBits, _PendingCompact
        from ..detect.feed import PendingExpand
        deduped = isinstance(dev, PendingExpand)
        launched = dev.dev if deduped else dev
        route = ("compacted" if isinstance(launched, _PendingCompact)
                 else "dense")
        with self._lock:
            kind = [e for e in self.entries
                    if e["deduped"] == deduped and e["route"] == route]
            if len(kind) >= self.per_kind:
                return
        q_start, q_count, q_ver, _offsets, total, t_pad, u_pad = \
            det._merge_descriptors(preps)
        launch = dev.launch if deduped else (q_start, q_count, q_ver,
                                             total, t_pad)
        dense = bits.dense() if isinstance(bits, CompactBits) else bits
        entry = {"deduped": deduped, "route": route,
                 "h_cap": getattr(launched, "h_cap", 0),
                 "batches": len(preps), "q_start": q_start,
                 "q_count": q_count, "q_ver": q_ver, "total": total,
                 "t_pad": t_pad, "ver": det.ver_snapshot(u_pad),
                 "bits": np.asarray(dense, np.int8),
                 **{"launch_" + k: v for k, v in zip(
                     ("q_start", "q_count", "q_ver", "total", "t_pad"),
                     launch)}}
        with self._lock:
            self.entries.append(entry)

    def save(self, path: str) -> int:
        """Write the entries as one .npz (keys `<i>_<field>`) → their
        count."""
        with self._lock:
            entries = list(self.entries)
        arrays = {f"{i}_{k}": np.asarray(v) for i, e in enumerate(entries)
                  for k, v in e.items()}
        np.savez(path, n=np.int64(len(entries)), **arrays)
        return len(entries)


class ServerState:
    def __init__(self, table, cache_dir: str, token: str = "",
                 cache_backend: str = "fs", detect_opts=None,
                 admission=None, device=None, sbom_opts=None,
                 launch_record: LaunchRecord | None = None,
                 memo_backend="", redetect_opts=None, stream_opts=None,
                 mesh_opts: MeshOptions | None = None):
        self.cache = open_cache(cache_backend, cache_dir)
        # graftmemo: the detection-result memo ("" = none), keyed by
        # (blob, table content digest)
        self.memo = open_memo(memo_backend, cache_dir)
        self.token = token
        self.device = device
        self._lock = threading.Lock()
        # detectd is on by default: concurrent RPCs' prepared batches
        # merge into shared join launches
        self.detect_opts = detect_opts if detect_opts is not None \
            else SchedOptions()
        self.sbom_opts = sbom_opts
        # graftstream: every scanner built here may stream its table
        # (plan_slices decides per table; None keeps every one resident)
        self.stream_opts = stream_opts
        # the mesh every scanner built here joins over (None: one device);
        # a table swap keeps it and re-shards the new table
        self.mesh = None
        if mesh_opts is not None and mesh_opts.devices:
            from ..parallel.mesh import device_slots, mesh_from_devices
            from ..parallel.multihost import CROSS_PROCESS, process_info
            if process_info()[1] > 1:
                raise SystemExit(f"--mesh-devices: {CROSS_PROCESS}")
            self.mesh = mesh_from_devices(
                device_slots(mesh_opts.devices, device),
                mesh_opts.db_shards)
        self.admission = AdmissionQueue(admission)
        self.launch_record = launch_record
        self._table = table
        # the serving table's content digest, stamped on every Scan
        # response and in /healthz; swap_table re-stamps it
        self.db_version = table.content_digest()
        self.db_previous_version = ""
        self.db_swapped_at = ""
        # graceful drain: once draining, Scans shed 503 + Retry-After
        # while the requests in flight finish
        self._draining = False
        self.drain_retry_after_s = 5.0
        self._scanner = self._new_scanner(table)
        self._inflight = 0
        self._closed = False
        # scanner generations: a request started under generation g may
        # hold that generation's scanner for its whole life, so a
        # swapped-out scanner closes when its generation's count drains
        self._gen = 0
        self._gen_active = {0: 0}
        # redetectd: after a swap to a new table, sweep the memo's known
        # blobs onto its version in the background
        self.redetect = None
        if self.memo is not None:
            self.redetect = RedetectDaemon(
                self.memo, self.cache, self.admission,
                self.scanner_with_version, redetect_opts,
                track=(self.request_started, self.request_finished))

    def _new_scanner(self, table) -> LocalScanner:
        scanner = LocalScanner(self.cache, table, self.device,
                               sched=self.detect_opts, memo=self.memo,
                               stream=self.stream_opts, mesh=self.mesh)
        # the identity /healthz names (never read from torch.cuda
        # there), and the profiler's activities
        self.device_name = note_device(scanner.detector.device)
        PROF.configure(device=scanner.detector.device.type)
        det = scanner.detector
        # a record holds one launch; a streamed dispatch launches once
        # per slice it touches, so it is not recorded
        if self.launch_record is not None and scanner.sched is not None \
                and isinstance(det, BatchDetector):
            scanner.sched.record = \
                lambda dev, preps, bits: self.launch_record(det, dev,
                                                            preps, bits)
        return scanner

    def request_started(self) -> int:
        """→ the scanner generation this request runs under; pass it
        back to request_finished."""
        with self._lock:
            self._inflight += 1
            self._gen_active[self._gen] += 1
            return self._gen

    def request_finished(self, gen: int) -> None:
        with self._lock:
            self._inflight -= 1
            self._gen_active[gen] -= 1
            if gen != self._gen and not self._gen_active[gen]:
                del self._gen_active[gen]

    @property
    def scanner(self) -> LocalScanner:
        with self._lock:
            return self._scanner

    def scanner_with_version(self) -> tuple[LocalScanner, str]:
        """The scanner and the digest of the table it serves, read
        together: a swap landing mid-scan must not stamp the new
        table's version on the old table's answer."""
        with self._lock:
            return self._scanner, self.db_version

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self, retry_after_s: float | None = None) -> None:
        """Stop admitting Scans: later ones shed 503 + Retry-After while
        the ones in flight keep running."""
        with self._lock:
            if retry_after_s is not None:
                self.drain_retry_after_s = retry_after_s
            self._draining = True
        # a draining server's sweep is work nobody will be served from
        if self.redetect is not None:
            self.redetect.cancel()

    def drain(self, timeout_s: float) -> bool:
        """Wait (bounded) for every request in flight to finish. → True
        when the server went quiet, False when the time ran out."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            with self._lock:
                if self._inflight == 0:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def close(self) -> None:
        """Shutdown: join the scanner's detectd and fetch threads
        (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            scanner = self._scanner
        if self.redetect is not None:
            self.redetect.close()
        scanner.close()

    def swap_table(self, table) -> None:
        """DB hot swap (reference listen.go dbWorker). The new scanner
        is built outside the lock; requests that started before the swap
        keep the old one, which closes once the last of them finishes.
        A new content digest schedules redetectd's sweep."""
        new_scanner = self._new_scanner(table)
        new_version = table.content_digest()
        version_changed = False
        with self._lock:
            if self._closed:
                old_scanner = None
            else:
                old_scanner, old_gen = self._scanner, self._gen
                self._gen += 1
                self._gen_active.setdefault(self._gen, 0)
                if not self._gen_active[old_gen]:
                    del self._gen_active[old_gen]
                self._scanner = new_scanner
                self._table = table
                version_changed = new_version != self.db_version
                if version_changed:
                    self.db_previous_version = self.db_version
                    self.db_swapped_at = time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                self.db_version = new_version
        if old_scanner is None:   # closed while the scanner was built
            new_scanner.close()
            return
        if version_changed and self.redetect is not None \
                and not self._draining:
            self.redetect.schedule(new_version)
            # a begin_drain racing in between found no sweep to cancel
            with self._lock:
                draining = self._draining
            if draining:
                self.redetect.cancel()
        # the old table's object graph is garbage once nothing holds it
        gc.collect()
        self._close_when_idle(old_scanner, old_gen)

    def _close_when_idle(self, scanner: LocalScanner, gen: int) -> None:
        with self._lock:
            idle = not self._gen_active.get(gen)
        if idle:
            scanner.close()
            return

        def waiter():
            # never force-close: that would pull the fetch thread out
            # from under a running detect
            while True:
                with self._lock:
                    if not self._gen_active.get(gen):
                        break
                time.sleep(0.05)
            scanner.close()
        threading.Thread(target=waiter, name="swap-close",
                         daemon=True).start()

    def healthz(self) -> dict:
        """The JSON /healthz: status, the DB identity, the cached device
        view (obs/device.py: it never touches torch.cuda) and the card's
        name read at start, the admission queue and the ingest breakers,
        the SLO burn rates, the tenants' cost split, what detectd's
        merged dispatches did, with a streamed table its slice plan and
        resident set and, with a memo, its backend, known blobs and
        redetectd's sweep."""
        from ..fanal.pipeline import INGEST
        scanner = self.scanner
        admission = self.admission.snapshot()
        payload = {
            "status": "draining" if self.draining else "ok",
            "db_version": self.db_version,
            "db_previous_version": self.db_previous_version,
            "db_swapped_at": self.db_swapped_at,
            "device": device_status(),
            "device_name": self.device_name,
            "resilience": {"admission": admission,
                           "ingest": INGEST.status()},
            "slo": SLO.export(),
            "tenants": {
                **_cost.TENANTS.healthz_block(),
                "qos": {"quotas": admission.get("tenant_quotas"),
                        "admission": admission.get("tenants", {}),
                        "burn_rates": SLO.tenant_burn_rates()},
            },
            "detectd": dict(scanner.sched.stats)
            if scanner.sched is not None else None,
        }
        stream_status = getattr(scanner.detector, "status", None)
        if callable(stream_status):
            payload["stream"] = stream_status()
        if self.memo is not None:
            memo = self.memo.status()
            if self.redetect is not None:
                memo["sweep"] = self.redetect.status()
            payload["memo"] = memo
        return payload


class ScanServer(ThreadingHTTPServer):
    # the accept backlog must exceed any burst admission is meant to
    # judge, or a flood's connections die as RSTs before it can shed
    request_queue_size = 128


class Handler(BaseHTTPRequestHandler):
    state: ServerState = None  # set per server by serve()
    protocol_version = "HTTP/1.1"
    _trace_id = ""    # per request; set by do_POST
    _db_version = ""  # stamped on Scan responses only
    _is_proto = False

    def log_message(self, *args):
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self._trace_id:
            self.send_header(TRACE_HEADER, self._trace_id)
        if self._db_version:
            self.send_header(DB_VERSION_HEADER, self._db_version)
        # the request's cost split rides every response made inside a
        # request ledger (do_POST installs one; GET pages have none)
        led = _cost.active()
        if led is not None:
            self.send_header(COST_HEADER, led.header_json())
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, payload: dict, headers: dict | None = None):
        self._send(code, json.dumps(payload).encode(), "application/json",
                   headers)

    def _twirp_error(self, code: int, twirp_code: str, msg: str):
        self._json(code, {"code": twirp_code, "msg": msg})

    def _reply(self, payload: dict, desc: str):
        """Encode in the request's encoding (Twirp answers in kind)."""
        if self._is_proto:
            from .protowire import encode_msg
            return self._send(200, encode_msg(payload, desc),
                              "application/protobuf")
        return self._json(200, payload)

    def do_GET(self):
        st = self.state
        # a probe on a keep-alive connection must not echo the trace id
        # a previous POST stamped on this handler
        self._trace_id = ""
        self._db_version = ""
        gen = st.request_started()
        try:
            self._do_get()
        finally:
            st.request_finished(gen)

    def _do_get(self):
        if self.path.startswith(DEBUG_PAGES):
            if self.state.token and \
                    self.headers.get(TOKEN_HEADER) != self.state.token:
                return self._twirp_error(401, "unauthenticated",
                                         "invalid token")
            if self.path.startswith("/debug/traces"):
                return self._json(200, debug_traces_payload(self.path))
            if self.path.startswith("/debug/perf"):
                return self._json(200, debug_perf_payload())
            if self.path.startswith("/debug/profile"):
                code, payload = debug_profile_payload(self.path)
                return self._json(code, payload)
            if self.path.startswith("/debug/costs"):
                return self._json(200, _cost.debug_costs_payload())
            return self._json(200, debug_incidents_payload())
        if self.path == "/healthz":
            # `Accept: text/plain` keeps the byte-exact probe answer
            if "text/plain" in (self.headers.get("Accept") or ""):
                return self._send(200, b"ok", "text/plain")
            return self._json(200, self.state.healthz())
        if self.path == "/version":
            return self._json(200, {"Version": __version__})
        if self.path == "/metrics":
            # the burn-rate gauges are window functions of the SLO
            # event store: recomputed at scrape time
            SLO.export()
            return self._send(200, METRICS.render().encode(),
                              "text/plain; version=0.0.4")
        self._twirp_error(404, "not_found", self.path)

    def do_POST(self):
        st = self.state
        self._db_version = ""
        gen = st.request_started()
        # the client's trace id when it sent one, a fresh one otherwise;
        # its forwarded span parents this process's root span
        tid = self.headers.get(TRACE_HEADER) or ""
        parent = self.headers.get(PARENT_SPAN_HEADER) or ""
        # the raw tenant header is the client's to choose: it is clamped
        # here, before it can mint a ledger, a quota or a metric label
        tenant = _cost.normalize_tenant(self.headers.get(TENANT_HEADER))
        try:
            with new_trace(tid or None, parent_id=parent or None) as tid:
                self._trace_id = tid
                with _cost.request_ledger(tenant) as led:
                    try:
                        with span("server.rpc", route=self.path,
                                  tenant=tenant):
                            self._do_post(st)
                    finally:
                        _cost.TENANTS.settle(led, led.outcome)
        finally:
            st.request_finished(gen)

    def _do_post(self, st: ServerState):
        if st.token and self.headers.get(TOKEN_HEADER) != st.token:
            return self._twirp_error(401, "unauthenticated",
                                     "invalid token")
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        self._is_proto = ctype in ("application/protobuf",
                                   "application/x-protobuf")
        route = self.path
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            if self._is_proto:
                from .protowire import decode_msg
                desc = ROUTE_DESCRIPTORS.get(route)
                if desc is None:
                    return self._twirp_error(404, "bad_route", route)
                req = decode_msg(body, desc)
            else:
                req = json.loads(body or b"{}")
        except ValueError:   # json.JSONDecodeError is a ValueError
            return self._twirp_error(400, "malformed", "bad body")

        try:
            if route == "/twirp/trivy.scanner.v1.Scanner/Scan":
                return self._scan_admitted(req)
            if route == "/twirp/trivy.scanner.v1.Scanner/ScanSBOM":
                return self._scan_admitted(req, sbom=True)
            if route == "/twirp/trivy.cache.v1.Cache/PutArtifact":
                st.cache.put_artifact(req.get("artifact_id", ""),
                                      req.get("artifact_info") or {})
                return self._reply({}, "Empty")
            if route == "/twirp/trivy.cache.v1.Cache/PutBlob":
                blob_j = req.get("blob_info") or {}
                if self._is_proto:
                    from .convert import proto_blob_to_json
                    blob_j = proto_blob_to_json(blob_j)
                st.cache.put_blob(req.get("diff_id", ""),
                                  blob_from_json(blob_j))
                return self._reply({}, "Empty")
            if route == "/twirp/trivy.cache.v1.Cache/MissingBlobs":
                missing_artifact, missing = st.cache.missing_blobs(
                    req.get("artifact_id", ""), req.get("blob_ids") or [])
                return self._reply({
                    "missing_artifact": missing_artifact,
                    "missing_blob_ids": missing,
                }, "MissingBlobsResponse")
            if route == "/twirp/trivy.cache.v1.Cache/DeleteBlobs":
                return self._reply({}, "Empty")
            return self._twirp_error(404, "bad_route", route)
        except KeyError as e:
            return self._twirp_error(400, "invalid_argument", str(e))
        except Exception as e:  # noqa: BLE001 — the server outlives a
            # failed request, a failed launch or fetch included
            return self._twirp_error(500, "internal",
                                     f"{type(e).__name__}: {e}")

    def _shed_response(self, s: Shed):
        """429/503 + Retry-After, with a Twirp error body."""
        self._json(s.http_code, {
            "code": "resource_exhausted" if s.http_code == 429
            else "unavailable",
            "msg": f"scan shed: {s.reason}",
        }, headers={"Retry-After": str(max(1, int(s.retry_after_s
                                                   + 0.999)))})

    def _scan_admitted(self, req: dict, sbom: bool = False):
        """Scan behind admission: bounded concurrency, bounded queue
        time, and the X-Trivy-Deadline-Ms deadline, so a handler thread
        is never parked past the point its client has given up."""
        st = self.state
        led = _cost.active()
        if st.draining:
            METRICS.inc("trivy_tpu_requests_shed_total")
            SLO.observe_scan(0.0, "shed", tenant=_cost.current_label())
            if led is not None:
                led.outcome = "shed"
            _log.warning("scan shed (draining): 503")
            return self._shed_response(
                Shed("server draining", 503, st.drain_retry_after_s))
        deadline = None
        hdr = self.headers.get(DEADLINE_HEADER)
        if hdr:
            try:
                deadline = Deadline(max(float(hdr), 0.0) / 1e3)
            except ValueError:
                deadline = None  # an unparseable header sets none
        label = _cost.current_label()   # the tenant do_POST installed
        # time parked in the admission queue is the request's queue ms,
        # on the shed path too
        t_adm = time.perf_counter()
        try:
            st.admission.admit(deadline, tenant=label)
        except Shed as s:
            _cost.charge_queue_ms((time.perf_counter() - t_adm) * 1e3,
                                  ledger=led)
            if led is not None:
                led.outcome = "shed"
            _log.warning("scan shed (%s): %d", s.reason, s.http_code)
            # a 429/503 is load the server refused on purpose: the SLO
            # counts it, but not as an error
            SLO.observe_scan(0.0, "shed", tenant=label)
            return self._shed_response(s)
        _cost.charge_queue_ms((time.perf_counter() - t_adm) * 1e3,
                              ledger=led)
        try:
            if sbom:
                return self._scan_sbom(req)
            return self._scan(req)
        except KeyError:
            raise   # 400 invalid_argument: the client's error
        except Exception:
            if led is not None:
                led.outcome = "error"
            SLO.observe_scan(0.0, "error", tenant=label)
            raise
        finally:
            st.admission.release(tenant=label)

    def _scan_sbom(self, req: dict):
        """The document in the request decoded into a content-addressed
        blob (a hostile document becomes an annotated partial result,
        not an error), then the Scan path."""
        import base64

        from ..sbom.artifact import SBOMArtifact
        raw = req.get("document") or b""
        if isinstance(raw, str):
            # JSON bodies carry the document base64-encoded; literal
            # text for hand-rolled callers
            try:
                raw = base64.b64decode(raw, validate=True)
            except (ValueError, TypeError):
                raw = raw.encode()
        ref = SBOMArtifact(raw, self.state.cache,
                           name=req.get("target", ""),
                           opts=self.state.sbom_opts).inspect()
        return self._scan({
            "target": req.get("target", "") or ref.name,
            "artifact_id": ref.id,
            "blob_ids": ref.blob_ids,
            "options": req.get("options") or {},
        })

    def _scan(self, req: dict):
        opts_j = req.get("options") or {}
        opts = T.ScanOptions(
            scanners=tuple(opts_j.get("scanners") or ("vuln",)),
            pkg_types=tuple(opts_j.get("vuln_type") or ("os", "library")),
            list_all_packages=bool(opts_j.get("list_all_packages")),
        )
        t0 = time.perf_counter()
        scanner, self._db_version = self.state.scanner_with_version()
        results, os_info = scanner.scan(
            req.get("target", ""), req.get("artifact_id", ""),
            req.get("blob_ids") or [], opts)
        elapsed = time.perf_counter() - t0
        METRICS.inc("trivy_tpu_scans_total")
        METRICS.inc("trivy_tpu_scan_seconds_total", elapsed)
        METRICS.observe("trivy_tpu_scan_latency_seconds", elapsed)
        led = _cost.active()
        if led is not None:
            led.outcome = "ok"
        SLO.observe_scan(elapsed, "ok", tenant=_cost.current_label())
        _log.debug("scan %s: %d results in %.1fms", req.get("target", ""),
                   len(results), elapsed * 1e3)
        if self._is_proto:
            from .convert import results_to_proto
            return self._reply(results_to_proto(results, os_info),
                               "ScanResponse")
        self._json(200, {
            "os": {"family": os_info.family, "name": os_info.name,
                   "eosl": os_info.eosl},
            "results": [r.to_json() for r in results],
        })


def drain_then_shutdown(httpd, state: ServerState,
                        grace_s: float = 10.0) -> None:
    """Graceful shutdown: stop admitting Scans (503 + Retry-After),
    wait up to `grace_s` for the requests in flight, then stop the
    accept loop."""
    print(f"drain: admission stopped; waiting up to {grace_s:.1f}s for "
          f"{state.inflight} request(s) in flight", file=sys.stderr)
    state.begin_drain()
    if not state.drain(grace_s):
        print(f"drain: grace period over with {state.inflight} "
              "request(s) in flight; shutting down", file=sys.stderr)
    httpd.shutdown()


def install_drain_handlers(httpd, state: ServerState,
                           grace_s: float) -> bool:
    """SIGTERM/SIGINT → graceful drain (main thread only). → True when
    installed."""
    import signal

    def _on_signal(signum, frame):
        # the handler returns at once; the drain runs on its own thread
        # and ends by stopping the accept loop
        threading.Thread(target=drain_then_shutdown,
                         args=(httpd, state, grace_s),
                         name="graceful-drain", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
        return True
    except ValueError:
        return False   # not the main thread


def _bind(host: str, port: int, state: ServerState) -> ScanServer:
    # a Handler subclass per server: two servers in one process must
    # not share a state
    handler = type("Handler", (Handler,), {"state": state})
    return ScanServer((host, port), handler)


def serve(host: str, port: int, table, cache_dir: str, token: str = "",
          ready_event: threading.Event | None = None, cache_backend="fs",
          detect_opts=None, admission=None, drain_grace_s: float = 10.0,
          device=None, launch_record: LaunchRecord | None = None,
          trace_path: str = "", memo_backend="",
          redetect_opts=None, stream_opts=None,
          mesh_opts: MeshOptions | None = None) -> ServerState:
    """Serve until SIGTERM/SIGINT drains the server (`drain_grace_s`
    bounds the wait for requests in flight) → the closed state.
    `trace_path` records every span for the server's lifetime and
    writes the Chrome trace there at shutdown (`server --trace FILE`)."""
    if trace_path:
        from ..obs import COLLECTOR
        COLLECTOR.enable()
    state = ServerState(table, cache_dir, token, cache_backend,
                        detect_opts=detect_opts, admission=admission,
                        device=device, launch_record=launch_record,
                        memo_backend=memo_backend,
                        redetect_opts=redetect_opts,
                        stream_opts=stream_opts, mesh_opts=mesh_opts)
    httpd = _bind(host, port, state)
    install_drain_handlers(httpd, state, drain_grace_s)
    # the accept loop runs on its own thread; this (main) thread runs
    # the profiler captures the handler threads ask for (/debug/profile,
    # the SLO trigger): the profiler sees the card only from here
    jobs: queue.SimpleQueue = queue.SimpleQueue()

    def on_main(fn):
        fut: Future = Future()
        jobs.put((fn, fut))
        return fut.result(timeout=Profiler.MAX_MS / 1e3 + 60.0)
    loop = threading.Thread(target=httpd.serve_forever, name="scan-server")
    PROF.run_captures_on(on_main)
    loop.start()
    if ready_event is not None:
        ready_event.set()
    try:
        while loop.is_alive():
            try:
                fn, fut = jobs.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — the asker's
                fut.set_exception(e)
    finally:
        PROF.run_captures_on(None)
        while True:   # a capture asked for as the loop ended
            try:
                _fn, fut = jobs.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("the server is stopping"))
        httpd.shutdown()
        loop.join()
        httpd.server_close()
        state.close()
        if trace_path:
            from ..obs import COLLECTOR, write_chrome_trace
            COLLECTOR.disable()
            write_chrome_trace(trace_path)
            _log.warning("graftscope trace written to %s", trace_path)
    return state


def serve_background(host: str, port: int, table, cache_dir: str,
                     token: str = "", cache_backend: str = "fs",
                     detect_opts=None, admission=None, device=None,
                     sbom_opts=None, memo_backend="", redetect_opts=None,
                     stream_opts=None, mesh_opts: MeshOptions | None = None):
    """Serve from a daemon thread → (httpd, state) once listening. The
    caller shuts down: `httpd.shutdown()`, then `state.close()`."""
    state = ServerState(table, cache_dir, token, cache_backend,
                        detect_opts=detect_opts, admission=admission,
                        device=device, sbom_opts=sbom_opts,
                        memo_backend=memo_backend,
                        redetect_opts=redetect_opts,
                        stream_opts=stream_opts, mesh_opts=mesh_opts)
    httpd = _bind(host, port, state)
    threading.Thread(target=httpd.serve_forever, name="scan-server",
                     daemon=True).start()
    return httpd, state
