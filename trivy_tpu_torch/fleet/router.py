"""Scan router: the Twirp front end of a fleet of port servers.

The port's copy of trivy_tpu/fleet/router.py. Clients point at the
router UNCHANGED: it speaks the same `/twirp/trivy.{scanner,cache}.v1.*`
routes (JSON and binary encodings), plus `/healthz`, `/version` and
`/metrics`. Each RPC is keyed by its artifact (artifact_id, or diff_id
for PutBlob) and forwarded to the consistent-hash ring's owner; on a
replica fault the request fails over along `ring.successors(key)` while
the replica's own fault domain (supervisor.ReplicaSet) opens and
background `/healthz` probes readmit it.

Policy, per request:

  * 2xx              relay; the replica's breaker records a success.
  * 429/503          an admission shed: the replica is healthy but
                     busy, so its breaker is NOT charged; the router
                     tries the ring's next replica, and when every
                     replica sheds it sleeps a RetryPolicy delay floored
                     at the smallest Retry-After before walking again,
                     up to the retry budget.
  * other 4xx        the client's error, relayed as the answer (the
                     replica answered; its breaker records a success).
  * 5xx / conn error charge the replica's fault domain, fail over.
  * deadline         X-Trivy-Deadline-Ms is re-stamped with the
                     REMAINING budget on every forward, each forward's
                     socket timeout is bounded by it, and no failover or
                     backoff sleep starts past it: an exhausted budget
                     answers 504 at once.

Every response carries X-Trivy-Replica (the replica that answered) and
one X-Trivy-Cost, the sum of every hop's cost document. Each request
runs under a `router.rpc` span, each forward under a `router.forward`
span whose id rides X-Trivy-Parent-Span to the replica.

The router holds no table and no scan state, and never touches the
card: its replicas are port servers, each detecting on its own card,
and they share layer analysis through a common cache backend, so a
failover Scan finds its blobs wherever it lands. Its /debug/profile
captures the host only. The JAX router's `rpc.route` failpoint is not
ported (the port has no failpoints, by the north star).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import __version__
from ..log import get as _get_logger
from ..metrics import METRICS
from ..obs import (RECORDER, current_span_id, current_trace_id,
                   new_trace, span)
from ..obs import cost as _cost
from ..obs.recorder import debug_incidents_payload, debug_traces_payload
from ..resilience import Deadline, RetryPolicy
from ..server import (COST_HEADER, DB_VERSION_HEADER, DEADLINE_HEADER,
                      PARENT_SPAN_HEADER, REPLICA_HEADER,
                      ROUTE_DESCRIPTORS, TENANT_HEADER, TOKEN_HEADER,
                      TRACE_HEADER)
from .ring import HashRing
from .supervisor import ReplicaOptions, ReplicaSet

_log = _get_logger("fleet.router")


class _RouterServer(ThreadingHTTPServer):
    # the accept backlog must exceed any burst the replicas' admission
    # is meant to judge (listen.ScanServer's reason; defined here so the
    # router never imports the server stack)
    request_queue_size = 128


# request headers forwarded verbatim (the deadline is re-stamped with
# the remaining budget, and the trace and parent-span headers are
# stamped per forward from the active span); the tenant rides every
# hop, so each replica bills the ORIGINAL caller, not the router
_FORWARD_HEADERS = ("Content-Type", TOKEN_HEADER, TENANT_HEADER)
# replica response headers relayed to the client: the DB version tells
# the client WHICH advisory DB answered, and the router reads it for
# the skew watch. The replica's X-Trivy-Cost is not relayed: the router
# merges every hop's document, failed and shed hops included, into ONE
# header, so a failover's client sees the whole bill exactly once
_RELAY_HEADERS = ("Content-Type", "Retry-After", TRACE_HEADER,
                  DB_VERSION_HEADER)

# bounded cardinality of the skew counter's `versions` label: the first
# K distinct version pairs get their own series, later pairs fold into
# "other"; the full pair still reaches the log and the recorder
_SKEW_LABEL_BUDGET = 8


@dataclass
class RouterOptions:
    """Router knobs (the CLI `router` flags)."""
    vnodes: int = 64                  # ring points per replica
    replica_timeout_s: float = 60.0   # per-forward socket bound
    # gates the /debug pages (trace buffers carry scan detail) and is
    # sent when the router pulls its replicas' trace fragments; POST
    # bodies are relayed with the client's Trivy-Token for the replicas
    # to enforce
    token: str = ""
    retry: RetryPolicy = field(default_factory=lambda: RetryPolicy(
        attempts=3, base_delay_s=0.05, max_delay_s=1.0, budget_s=10.0))
    replica: ReplicaOptions = field(default_factory=ReplicaOptions)


class _Unrouted(RuntimeError):
    """One whole ring walk produced no relayable response. `shed` holds
    the best 429/503 to relay if the retry budget runs out; `floor` is
    the smallest Retry-After seen (0.0 when no replica shed)."""

    def __init__(self, floor: float, shed=None):
        super().__init__(f"no replica answered (floor={floor:g}s)")
        self.floor = floor
        self.shed = shed


class RouterState:
    def __init__(self, replicas, opts: RouterOptions | None = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.opts = opts or RouterOptions()
        self.replicas = [r.rstrip("/") for r in replicas]
        self.ring = HashRing(self.replicas, vnodes=self.opts.vnodes)
        self._lock = threading.Lock()
        # the last advertised advisory-DB digest per replica (relayed
        # forwards and readmission probes feed it; a disagreement is a
        # mid-rollout fleet whose failovers are not bit-identical)
        self._db_versions: dict[str, str] = {}
        # the router's OWN tenant aggregator, fed from the cost headers
        # the replicas relay: not the process-wide TENANTS, so a fleet
        # in one process never counts a scan twice
        self.costs = _cost.TenantAggregator()
        self._skew_labels: set[str] = set()
        self._draining = False
        self._inflight = 0
        self.supervisor = ReplicaSet(
            self.replicas, self.opts.replica,
            db_version_cb=self.note_db_version)

    # ---- advisory-DB identity -----------------------------------------

    def note_db_version(self, replica: str, version: str) -> None:
        """Record one replica's advertised db_version (from a relayed
        response or a readmission probe); warn and count when the fleet
        now disagrees. Counted per observed CHANGE, not per request."""
        if not version:
            return
        with self._lock:
            if self._db_versions.get(replica) == version:
                return
            self._db_versions[replica] = version
            skewed = len(set(self._db_versions.values())) > 1
            snap = dict(self._db_versions)
        if not skewed:
            return
        # the label names WHICH versions disagree (sorted short
        # digests): a rolling upgrade reads as one transient pair, a
        # split brain as the same pair climbing forever. Pairs past the
        # budget fold into "other", so N rolling swaps never mint N
        # series
        pair = "|".join(sorted(v[:19] for v in set(snap.values())))
        with self._lock:
            if pair in self._skew_labels or \
                    len(self._skew_labels) < _SKEW_LABEL_BUDGET:
                self._skew_labels.add(pair)
                label = pair
            else:
                label = "other"
        METRICS.inc("trivy_tpu_fleet_db_version_skew_total",
                    versions=label)
        RECORDER.note_event("fleet_db_version_skew", replica=replica,
                            versions=pair)
        _log.warning(
            "fleet: advisory-DB version skew — replicas disagree (%s); "
            "failovers are NOT bit-identical until the rollout "
            "converges", ", ".join(f"{r}={v[:19]}" for r, v in sorted(
                snap.items())))

    def db_versions(self) -> dict:
        with self._lock:
            return dict(self._db_versions)

    # ---- graceful drain ------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True

    def request_started(self) -> None:
        with self._lock:
            self._inflight += 1

    def request_finished(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def drain(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            with self._lock:
                if self._inflight == 0:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def status(self) -> dict:
        """→ the /healthz payload."""
        return {
            "status": "draining" if self._draining else "ok",
            "fleet": {
                "ring": {"replicas": self.ring.nodes(),
                         "vnodes": self.ring.vnodes},
                **self.supervisor.status(),
                "db_versions": self.db_versions(),
                "failovers_total": int(
                    METRICS.get("trivy_tpu_fleet_failovers_total")),
                # per-tenant scans and cost split, summed from the
                # relayed X-Trivy-Cost headers
                "tenants": self.costs.healthz_block(
                    include_system_live=False),
            },
        }

    def close(self) -> None:
        self.supervisor.close()


def route_key(path: str, req: dict) -> str:
    """The ring key of one decoded request: the artifact when the RPC
    names one, the blob otherwise, so an artifact's MissingBlobs,
    PutArtifact and Scan land on one replica and PutBlob spreads by
    layer digest."""
    return req.get("artifact_id") or req.get("diff_id") \
        or req.get("target") or path


class RouterHandler(BaseHTTPRequestHandler):
    state: RouterState = None  # set per server by _bind
    protocol_version = "HTTP/1.1"
    _trace_id = ""  # per request; set by do_POST before dispatch

    def log_message(self, *args):
        pass

    # ---- plumbing ------------------------------------------------------

    def _send(self, code: int, body: bytes, headers: dict) -> None:
        self.send_response(code)
        for k, v in headers.items():
            self.send_header(k, v)
        if self._trace_id and TRACE_HEADER not in headers:
            # the id is echoed end to end: the router's own answers
            # (shed relays, 504s, errors) carry it too
            self.send_header(TRACE_HEADER, self._trace_id)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload).encode(),
                   {"Content-Type": "application/json"})

    def _relay(self, resp, cost_doc: dict | None = None) -> None:
        code, headers, body, replica = resp
        out = {k: headers[k] for k in _RELAY_HEADERS if headers.get(k)}
        if replica:
            # which replica answered: a failover makes the ring owner a
            # guess
            out[REPLICA_HEADER] = replica
        if cost_doc is not None:
            # ONE merged cost header a request: every hop's document,
            # never the last replica's alone, never a hop twice
            out[COST_HEADER] = json.dumps(cost_doc,
                                          separators=(",", ":"))
        self._send(code, body, out)

    # ---- GET -----------------------------------------------------------

    def do_GET(self):
        self._trace_id = ""  # never echo a previous POST's id
        if self.path.startswith(("/debug/traces", "/debug/incidents",
                                 "/debug/perf", "/debug/profile",
                                 "/debug/costs")):
            token = self.state.opts.token
            if token and self.headers.get(TOKEN_HEADER) != token:
                return self._json(401, {"code": "unauthenticated",
                                        "msg": "invalid token"})
            if self.path.startswith("/debug/costs"):
                # the fleet-wide tenant table, built from the relayed
                # cost headers alone; no conservation block (the router
                # dispatches nothing; each replica reconciles its own)
                return self._json(200, {
                    "schema": _cost.COSTS_SCHEMA,
                    "scope": "fleet",
                    "tenants": self.state.costs.table(
                        include_system_live=False),
                })
            if self.path.startswith("/debug/traces"):
                self._json(200, debug_traces_payload(self.path))
            elif self.path.startswith("/debug/perf"):
                # the router launches nothing; its ledger stays empty,
                # but every process answers the same question
                from ..obs.perf import debug_perf_payload
                self._json(200, debug_perf_payload())
            elif self.path.startswith("/debug/profile"):
                # a host-only capture: the router has no card to profile
                # and must not open a CUDA context for one
                from ..obs.perf import debug_profile_payload
                code, payload = debug_profile_payload(self.path,
                                                      device="cpu")
                self._json(code, payload)
            else:
                self._json(200, debug_incidents_payload())
        elif self.path == "/healthz":
            if "text/plain" in (self.headers.get("Accept") or ""):
                self._send(200, b"ok", {"Content-Type": "text/plain"})
            else:
                self._json(200, self.state.status())
        elif self.path == "/version":
            self._json(200, {"Version": __version__})
        elif self.path == "/metrics":
            self._send(200, METRICS.render().encode(),
                       {"Content-Type": "text/plain; version=0.0.4"})
        else:
            self._json(404, {"code": "not_found", "msg": self.path})

    # ---- POST ----------------------------------------------------------

    def do_POST(self):
        t0 = time.perf_counter()
        st = self.state
        # counted BEFORE the draining check: a request that slipped past
        # the check as the signal landed still holds the drain open
        st.request_started()
        try:
            if st.draining:
                # stop admitting; forwards in flight run to completion.
                # Read the body first: answering with it still in the
                # socket would corrupt the connection's next request
                length = int(self.headers.get("Content-Length",
                                              "0") or 0)
                if length:
                    self.rfile.read(length)
                reset_s = st.opts.replica.reset_timeout_ms / 1e3
                return self._send(
                    503, json.dumps({"code": "unavailable",
                                     "msg": "router draining"}
                                    ).encode(),
                    {"Content-Type": "application/json",
                     "Retry-After": str(max(1, int(reset_s + 0.999)))})
            # the router mints the trace id when the client sent none;
            # every forward stamps it with the hop's parent span id
            tid = self.headers.get(TRACE_HEADER) or ""
            parent = self.headers.get(PARENT_SPAN_HEADER) or ""
            with new_trace(tid or None, parent_id=parent or None) as tid:
                self._trace_id = tid
                with span("router.rpc", route=self.path):
                    self._do_post()
        finally:
            st.request_finished()
            METRICS.observe("trivy_tpu_fleet_router_latency_seconds",
                            time.perf_counter() - t0)

    def _do_post(self):
        desc = ROUTE_DESCRIPTORS.get(self.path)
        if desc is None:
            return self._json(404, {"code": "bad_route",
                                    "msg": self.path})
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "") \
                .split(";")[0]
            if ctype in ("application/protobuf",
                         "application/x-protobuf"):
                from ..server.protowire import decode_msg
                req = decode_msg(body, desc)
            else:
                req = json.loads(body or b"{}")
        except (ValueError, json.JSONDecodeError):
            return self._json(400, {"code": "malformed",
                                    "msg": "bad body"})

        hdr = self.headers.get(DEADLINE_HEADER)
        deadline = Deadline(None)
        if hdr:
            try:
                deadline = Deadline(max(float(hdr), 0.0) / 1e3)
            except ValueError:
                pass   # an unparseable header: no deadline
        fwd = {k: self.headers[k] for k in _FORWARD_HEADERS
               if self.headers.get(k)}
        # the hops' cost documents, across failovers AND retry rounds:
        # each forward that did work appends exactly one
        hop_costs: list[dict] = []
        resp = self._route(route_key(self.path, req), body, fwd,
                           deadline, hop_costs)
        doc = None
        if hop_costs:
            doc = _cost.merge_cost_docs(hop_costs)
            code = resp[0]
            outcome = ("ok" if code < 400
                       else "shed" if code in (429, 503) else "error")
            # the fleet-wide table, from relayed headers only (the
            # replicas already settled these scans into their metrics)
            self.state.costs.fold_doc(doc, outcome=outcome)
        self._relay(resp, cost_doc=doc)

    def _route(self, key: str, body: bytes, fwd_headers: dict,
               deadline: Deadline, hop_costs: list | None = None):
        """→ (status, headers, body, replica) to relay. Walks the
        ring's failover order under the RetryPolicy; every decision is
        bounded by the client's deadline."""
        st = self.state
        # forwards past a request's first are failovers, counted across
        # retry rounds
        forwards = [0]
        if hop_costs is None:
            hop_costs = []

        def attempt():
            return self._walk_ring(key, body, fwd_headers, deadline,
                                   forwards, hop_costs)

        def should_retry(e):
            if isinstance(e, _Unrouted) \
                    and deadline.remaining() > e.floor:
                return e.floor
            return None

        try:
            return st.opts.retry.call(attempt,
                                      should_retry=should_retry)
        except _Unrouted as e:
            if deadline.expired():
                return self._deadline_response()
            if e.shed is not None:
                # every replica shed: relay the least loaded shed (the
                # smallest Retry-After) so the client backs off as
                # single-server admission taught it to
                return e.shed
            reset_s = st.opts.replica.reset_timeout_ms / 1e3
            return (503, {"Content-Type": "application/json",
                          "Retry-After": str(max(1, int(reset_s + 0.999)))},
                    json.dumps({"code": "unavailable",
                                "msg": "no replica available"}).encode(),
                    None)

    def _deadline_response(self):
        return (504, {"Content-Type": "application/json"},
                json.dumps({"code": "deadline_exceeded",
                            "msg": "client deadline exhausted before "
                                   "a replica answered"}).encode(),
                None)

    def _walk_ring(self, key, body, fwd_headers, deadline, forwards,
                   hop_costs):
        """One pass over the failover order → a relayable response, or
        raises _Unrouted."""

        def _note_cost(sp, raw) -> None:
            doc = _cost.parse_cost_header(raw or "")
            if doc is not None:
                hop_costs.append(doc)
                # what each hop billed, on its span (failed and shed
                # hops included)
                sp.attrs["cost_tenant"] = doc.get("tenant", "default")
                sp.attrs["cost_device_ms"] = doc.get("device_ms", 0)
                sp.attrs["cost_queue_ms"] = doc.get("queue_ms", 0)

        st = self.state
        shed = None
        shed_floor = float("inf")
        successors = st.ring.successors(key)
        owner = successors[0] if successors else None
        for replica in successors:
            if not st.supervisor.available(replica):
                continue
            remaining = deadline.remaining()
            if remaining <= 0:
                return self._deadline_response()
            forwards[0] += 1
            # a failover: any forward past the ring owner, after an
            # earlier replica faulted or shed, or past a lost owner
            failover = forwards[0] > 1 or replica != owner
            if failover:
                METRICS.inc("trivy_tpu_fleet_failovers_total")
                # a trace that failed over is kept past ring churn
                RECORDER.note_event("fleet_failover",
                                    trace_id=current_trace_id(),
                                    replica=replica, hop=forwards[0])
            # one span per HOP: its id rides X-Trivy-Parent-Span, so the
            # replica fragment that answered hangs under the hop that
            # reached it, and a failover reads as sibling forwards
            with span("router.forward", replica=replica,
                      hop=forwards[0], failover=failover) as sp:
                try:
                    resp = self._forward(
                        replica, body, fwd_headers,
                        timeout=min(st.opts.replica_timeout_s,
                                    remaining), deadline=deadline)
                except urllib.error.HTTPError as e:
                    resp_body = e.read()
                    headers = {k: e.headers[k] for k in _RELAY_HEADERS
                               if e.headers.get(k)}
                    # a shed or failed hop billed its tenant too
                    _note_cost(sp, e.headers.get(COST_HEADER))
                    sp.attrs["status"] = e.code
                    if e.code in (429, 503):
                        # busy, not faulty: remember the least loaded
                        # shed and walk on
                        try:
                            ra = float(e.headers.get("Retry-After")
                                       or 1.0)
                        except ValueError:
                            ra = 1.0
                        if ra < shed_floor:
                            shed_floor = ra
                            shed = (e.code, headers, resp_body,
                                    replica)
                        continue
                    if 400 <= e.code < 500:
                        # the replica answered and the CLIENT is wrong:
                        # relayed as the answer, no failover
                        st.supervisor.record_success(replica)
                        st.note_db_version(
                            replica,
                            e.headers.get(DB_VERSION_HEADER) or "")
                        return (e.code, headers, resp_body, replica)
                    sp.attrs["error"] = f"http {e.code}"
                    st.supervisor.record_failure(replica)
                    _log.warning("fleet: replica %s returned %d; "
                                 "failing over", replica, e.code)
                    continue
                except (urllib.error.URLError, OSError) as e:
                    sp.attrs["error"] = str(e)
                    st.supervisor.record_failure(replica)
                    _log.warning("fleet: replica %s unreachable (%s); "
                                 "failing over", replica, e)
                    continue
                sp.attrs["status"] = resp[0]
                _note_cost(sp, resp[1].get(COST_HEADER))
                st.supervisor.record_success(replica)
                # the skew watch: which DB answered this forward
                # (failovers included: landing on another DB is the
                # hazard)
                st.note_db_version(
                    replica, resp[1].get(DB_VERSION_HEADER) or "")
                return resp + (replica,)
        raise _Unrouted(0.0 if shed is None else shed_floor, shed)

    def _forward(self, replica: str, body: bytes, fwd_headers: dict,
                 timeout: float, deadline: Deadline):
        headers = dict(fwd_headers)
        # per hop: the router's (maybe minted) trace id, and THIS hop's
        # forward span as the remote parent
        headers[TRACE_HEADER] = current_trace_id()
        psid = current_span_id()
        if psid:
            headers[PARENT_SPAN_HEADER] = psid
        if deadline.at is not None:
            # the REMAINING budget: a replica's admission queue must
            # never park this request past what the client has left
            headers[DEADLINE_HEADER] = str(
                max(int(deadline.remaining() * 1e3), 1))
        req = urllib.request.Request(replica + self.path, data=body,
                                     headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()


def dump_fleet_trace(state: RouterState, path: str) -> None:
    """`router --trace FILE`: pull every replica's /debug/traces
    fragment (with the router's token), add the router's own recorder
    buffer, and write ONE assembled Chrome trace of the fleet's recent
    spans, the cross-process edges stitched."""
    from ..obs import collect as obs_collect
    fragments = [{"url": "router", "spans": RECORDER.spans()}]
    fragments += obs_collect.fetch_fragments(state.replicas,
                                             token=state.opts.token)
    obs_collect.write_trace(path, obs_collect.assemble(fragments))
    _log.warning("fleet trace written to %s", path)


def drain_router_then_shutdown(httpd, state: RouterState,
                               grace_s: float = 10.0) -> None:
    """Graceful shutdown: stop admitting (503 + Retry-After), let the
    forwards in flight finish (bounded), then stop the accept loop."""
    _log.warning("router drain: admission stopped; waiting up to "
                 "%.1fs for %d request(s) in flight", grace_s,
                 state.inflight)
    state.begin_drain()
    if not state.drain(grace_s):
        _log.warning("router drain: grace period over with %d "
                     "request(s) in flight; shutting down",
                     state.inflight)
    httpd.shutdown()


def _bind(host: str, port: int, state: RouterState) -> _RouterServer:
    # a handler subclass per server: a router and its replicas share a
    # process in tests and in the chip script
    handler = type("RouterHandler", (RouterHandler,), {"state": state})
    return _RouterServer((host, port), handler)


def serve_router(host: str, port: int, replicas,
                 opts: RouterOptions | None = None,
                 trace_path: str = "", drain_grace_s: float = 10.0):
    """Run the router in the foreground (the CLI `router` command) until
    SIGTERM/SIGINT drains it (`drain_grace_s` bounds the wait).
    `trace_path` writes the assembled fleet trace at shutdown."""
    import signal
    state = RouterState(replicas, opts)
    httpd = _bind(host, port, state)

    def _on_signal(signum, frame):
        # the handler returns at once; the drain runs on its own thread
        # and ends by stopping the accept loop this thread sits in
        threading.Thread(target=drain_router_then_shutdown,
                         args=(httpd, state, drain_grace_s),
                         name="router-drain", daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
    except ValueError:
        pass   # not the main thread
    try:
        httpd.serve_forever()
    finally:
        if trace_path:
            # pull the fragments BEFORE closing
            try:
                dump_fleet_trace(state, trace_path)
            except Exception:
                _log.exception("fleet trace dump failed")
        httpd.server_close()
        state.close()
    return httpd


def serve_router_background(host: str, port: int, replicas,
                            opts: RouterOptions | None = None):
    """Serve from a daemon thread → (httpd, state) once listening. The
    caller shuts down: `httpd.shutdown()`, `httpd.server_close()`,
    then `state.close()`."""
    state = RouterState(replicas, opts)
    httpd = _bind(host, port, state)
    threading.Thread(target=httpd.serve_forever, name="fleet-router",
                     daemon=True).start()
    return httpd, state
