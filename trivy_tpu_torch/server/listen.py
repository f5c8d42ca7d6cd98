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
on every route. Its /metrics and /debug/* pages are not ported
(ROADMAP A17), nor the mesh, the memo, redetectd, the breaker and its
recovery, or the trace recording.
"""

from __future__ import annotations

import gc
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import __version__
from .. import types as T
from ..detect.sched import SchedOptions
from ..fanal.cache import blob_from_json, open_cache
from ..obs.cost import current_label, normalize_tenant, request_tenant
from ..resilience import AdmissionQueue, Deadline, Shed
from ..scanner import LocalScanner
from . import (DB_VERSION_HEADER, DEADLINE_HEADER, ROUTE_DESCRIPTORS,
               TENANT_HEADER, TOKEN_HEADER)

UNPORTED_PAGES = ("/metrics", "/debug/")


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


def device_status(device) -> dict:
    """/healthz's view of the card: its name and memory, or the CPU."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "count": 0}
    free, total = torch.cuda.mem_get_info(device)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "memory": {"free_bytes": int(free), "total_bytes": int(total),
                       "allocated_bytes":
                           int(torch.cuda.memory_allocated(device))}}


class ServerState:
    def __init__(self, table, cache_dir: str, token: str = "",
                 cache_backend: str = "fs", detect_opts=None,
                 admission=None, device=None, sbom_opts=None,
                 launch_record: LaunchRecord | None = None):
        self.cache = open_cache(cache_backend, cache_dir)
        self.token = token
        self.device = device
        self._lock = threading.Lock()
        # detectd is on by default: concurrent RPCs' prepared batches
        # merge into shared join launches
        self.detect_opts = detect_opts if detect_opts is not None \
            else SchedOptions()
        self.sbom_opts = sbom_opts
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

    def _new_scanner(self, table) -> LocalScanner:
        scanner = LocalScanner(self.cache, table, self.device,
                               sched=self.detect_opts)
        if self.launch_record is not None and scanner.sched is not None:
            det = scanner.detector
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
        scanner.close()

    def swap_table(self, table) -> None:
        """DB hot swap (reference listen.go dbWorker). The new scanner
        is built outside the lock; requests that started before the swap
        keep the old one, which closes once the last of them finishes."""
        new_scanner = self._new_scanner(table)
        new_version = table.content_digest()
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
                if new_version != self.db_version:
                    self.db_previous_version = self.db_version
                    self.db_swapped_at = time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                self.db_version = new_version
        if old_scanner is None:   # closed while the scanner was built
            new_scanner.close()
            return
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
        """The JSON /healthz: status, the DB identity, the card, the
        admission queue and what detectd's merged dispatches did."""
        scanner = self.scanner
        return {
            "status": "draining" if self.draining else "ok",
            "db_version": self.db_version,
            "db_previous_version": self.db_previous_version,
            "db_swapped_at": self.db_swapped_at,
            "device": device_status(scanner.detector.device),
            "resilience": {"admission": self.admission.snapshot()},
            "detectd": dict(scanner.sched.stats)
            if scanner.sched is not None else None,
        }


class ScanServer(ThreadingHTTPServer):
    # the accept backlog must exceed any burst admission is meant to
    # judge, or a flood's connections die as RSTs before it can shed
    request_queue_size = 128


class Handler(BaseHTTPRequestHandler):
    state: ServerState = None  # set per server by serve()
    protocol_version = "HTTP/1.1"
    _db_version = ""  # stamped on Scan responses only
    _is_proto = False

    def log_message(self, *args):
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self._db_version:
            self.send_header(DB_VERSION_HEADER, self._db_version)
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
        self._db_version = ""
        gen = st.request_started()
        try:
            self._do_get()
        finally:
            st.request_finished(gen)

    def _do_get(self):
        if self.path == "/healthz":
            # `Accept: text/plain` keeps the byte-exact probe answer
            if "text/plain" in (self.headers.get("Accept") or ""):
                return self._send(200, b"ok", "text/plain")
            return self._json(200, self.state.healthz())
        if self.path == "/version":
            return self._json(200, {"Version": __version__})
        if self.path.startswith(UNPORTED_PAGES):
            return self._twirp_error(
                404, "not_found", f"{self.path}: the metrics and debug "
                "pages are not ported yet (ROADMAP A17)")
        self._twirp_error(404, "not_found", self.path)

    def do_POST(self):
        st = self.state
        self._db_version = ""
        gen = st.request_started()
        # the raw header is the client's to choose: it is clamped here,
        # before it can key a queue
        tenant = normalize_tenant(self.headers.get(TENANT_HEADER))
        try:
            with request_tenant(tenant):
                self._do_post(st)
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
        if st.draining:
            return self._shed_response(
                Shed("server draining", 503, st.drain_retry_after_s))
        deadline = None
        hdr = self.headers.get(DEADLINE_HEADER)
        if hdr:
            try:
                deadline = Deadline(max(float(hdr), 0.0) / 1e3)
            except ValueError:
                deadline = None  # an unparseable header sets none
        label = current_label()   # the clamped label do_POST installed
        try:
            st.admission.admit(deadline, tenant=label)
        except Shed as s:
            return self._shed_response(s)
        try:
            if sbom:
                return self._scan_sbom(req)
            return self._scan(req)
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
        scanner, self._db_version = self.state.scanner_with_version()
        results, os_info = scanner.scan(
            req.get("target", ""), req.get("artifact_id", ""),
            req.get("blob_ids") or [], opts)
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
          device=None, launch_record: LaunchRecord | None = None
          ) -> ServerState:
    """Serve until SIGTERM/SIGINT drains the server (`drain_grace_s`
    bounds the wait for requests in flight) → the closed state."""
    state = ServerState(table, cache_dir, token, cache_backend,
                        detect_opts=detect_opts, admission=admission,
                        device=device, launch_record=launch_record)
    httpd = _bind(host, port, state)
    install_drain_handlers(httpd, state, drain_grace_s)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        state.close()
    return state


def serve_background(host: str, port: int, table, cache_dir: str,
                     token: str = "", cache_backend: str = "fs",
                     detect_opts=None, admission=None, device=None,
                     sbom_opts=None):
    """Serve from a daemon thread → (httpd, state) once listening. The
    caller shuts down: `httpd.shutdown()`, then `state.close()`."""
    state = ServerState(table, cache_dir, token, cache_backend,
                        detect_opts=detect_opts, admission=admission,
                        device=device, sbom_opts=sbom_opts)
    httpd = _bind(host, port, state)
    threading.Thread(target=httpd.serve_forever, name="scan-server",
                     daemon=True).start()
    return httpd, state
