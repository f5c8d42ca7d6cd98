"""graftcost — per-request cost attribution and tenant usage telemetry.

graftscope answers "what happened to THIS request"; graftprof answers
"what did the DEVICE do all day". Neither can say *whose scans* burned
the card: a detectd merged dispatch serves several requests with one
launch. graftcost closes that gap with a request-scoped CostLedger
carried on the same contextvars graftscope rides, charged at every
shared-resource seam:

  apportionment   merged dispatches (detectd) split the launch's device
                  ms and result transfer bytes pro-rata by each
                  coalesced request's real (nonzero) pair share — a
                  request that contributed 0 of 1024 pairs pays 0, one
                  that contributed 512 pays half. The split happens in
                  ONE place (`_apportion`, fed by `charge_device_ms` /
                  `ledgered_transfer`).
  conservation    every charge writes the graftprof LEDGER and the
                  cost side from the SAME measurement, so summed
                  per-tenant device ms / conserved transfer bytes
                  reconcile with the ledger totals by construction.
                  Work nobody requested — warmup launches, probes —
                  runs with no request ledger installed and lands in
                  the SYSTEM tenant, so nothing leaks and nothing
                  double-counts. `conservation_report()` is the
                  reconciliation read.
  queue vs service  admission-queue waits and detectd coalesce-window
                  waits are queue ms, kept distinct from service ms
                  (wall since ledger install minus queue).
  tenancy         identity arrives as the X-Trivy-Tenant header
                  (the RPC client stamps it from RemoteScanner's
                  tenant=; default "default"). Label cardinality is
                  bounded by a top-K-plus-"other" clamp: the first K
                  distinct tenants get their own series, the long tail
                  folds into "other", and the full tenant id still
                  rides the per-request X-Trivy-Cost header and trace
                  attrs. detectd's fair queue keys on the same label
                  (`current_label`).

"Device ms" means what it means in the JAX package: the host wall of
the launch region (uploads and the enqueue of the kernels) plus the
wall of the fetch that synchronizes with them.

Surfaces: the compact X-Trivy-Cost response header, the
trivy_tpu_tenant_* series, the token-gated /debug/costs table, the
/healthz `tenants` block, and per-tenant scan-latency burn rates in the
SLO engine.

Lock discipline: every mutation of shared ledger/aggregator state
happens under the owning instance lock. This module must stay
importable without the server stack — the client imports obs.

The port's copy of the JAX package's obs/cost.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time

from ..metrics import METRICS

# request-scoped ledger: installed by the server handler (or a test)
# around one Scan RPC; copied onto detectd/fetch threads by the same
# contextvars.copy_context() plumbing that carries graftscope spans
_COST: contextvars.ContextVar = contextvars.ContextVar(
    "trivy_tpu_torch_cost", default=None)
# merged-dispatch share vector: ((ledger-or-None, weight), ...) —
# installed into the dispatch/fetch Contexts by detectd's flush so
# every charge inside the merged launch apportions instead of
# charging one victim
_SHARES: contextvars.ContextVar = contextvars.ContextVar(
    "trivy_tpu_torch_cost_shares", default=None)

# transfer paths that participate in the conservation contract:
# device→host result bytes. shard_upload (host→device streaming) is
# excluded — it is charged per-walk by the streaming layer and the
# ledger already reports it separately under shard_uploads.
CONSERVED_TRANSFER_PATHS = ("compact", "dense", "overflow")

# numeric ledger fields a request accumulates; secret bytes use a
# "secret_bytes.<path>" key per serving path (device / host)
_CORE_FIELDS = ("queue_ms", "device_ms", "transfer_bytes", "host_ms",
                "ingest_bytes", "ingest_ms", "sbom_parse_ms",
                "avoided_ms")


class CostLedger:
    """One request's accumulated cost. Thread-safe: detectd dispatch
    and fetch threads charge the same ledger a handler thread settles.
    `live` ledgers (the SYSTEM tenant) export device/transfer charges
    to METRICS immediately — they never settle through a request."""

    def __init__(self, tenant: str = "default", live: bool = False):
        self.tenant = tenant or "default"
        self._lock = threading.Lock()
        self._v: dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._live = live
        self.outcome: str | None = None

    # ---- charging ------------------------------------------------------

    def charge(self, field: str, amount: float) -> None:
        if amount <= 0:
            return
        with self._lock:
            self._v[field] = self._v.get(field, 0.0) + float(amount)
        if self._live and field in ("device_ms", "transfer_bytes"):
            series = ("trivy_tpu_tenant_device_ms_total"
                      if field == "device_ms"
                      else "trivy_tpu_tenant_transfer_bytes_total")
            METRICS.inc(series, float(amount), tenant=self.tenant)

    # ---- reads ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._v)

    def value(self, field: str) -> float:
        with self._lock:
            return self._v.get(field, 0.0)

    def secret_bytes(self) -> float:
        with self._lock:
            return sum(v for k, v in self._v.items()
                       if k.startswith("secret_bytes."))

    def wall_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def header_doc(self) -> dict:
        """→ the X-Trivy-Cost JSON document: the per-request cost split
        a client (or the router's fleet aggregator) consumes.
        service_ms is wall-since-install minus queue ms — time the
        request was being WORKED, not parked."""
        v = self.snapshot()
        queue = v.get("queue_ms", 0.0)
        doc = {
            "tenant": self.tenant,
            "queue_ms": round(queue, 3),
            "service_ms": round(max(self.wall_ms() - queue, 0.0), 3),
            "device_ms": round(v.get("device_ms", 0.0), 3),
            "transfer_bytes": int(v.get("transfer_bytes", 0.0)),
            "host_ms": round(v.get("host_ms", 0.0), 3),
            "avoided_ms": round(v.get("avoided_ms", 0.0), 3),
            "hops": 1,
        }
        for opt in ("ingest_bytes", "ingest_ms", "sbom_parse_ms"):
            if v.get(opt, 0.0) > 0:
                doc[opt] = round(v[opt], 3)
        sb = sum(val for k, val in v.items()
                 if k.startswith("secret_bytes."))
        if sb > 0:
            doc["secret_bytes"] = int(sb)
        return doc

    def header_json(self) -> str:
        return json.dumps(self.header_doc(), separators=(",", ":"))


# work nobody requested: warmup compiles, blameless redetect sweeps,
# liveness probes. They run with no request ledger installed, so every
# unattributed charge lands here instead of leaking or double-counting
# into a tenant — the other half of the conservation contract.
SYSTEM = CostLedger("system", live=True)


# ---------------------------------------------------------------------------
# charge entry points (the ONE shared helper set every seam calls)

# bench baseline switch: bench.py measures what graftcost itself
# costs by re-running a point with attribution OFF. Disabled mode
# keeps every graftprof LEDGER write (perf telemetry must not change
# under the A/B) but skips ledger install, apportionment, and settle
# exports. Conservation is meaningless while off — only the bench
# A/B uses this, always restoring True in a finally.
_ENABLED = True


def set_attribution_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def attribution_enabled() -> bool:
    return _ENABLED


def active() -> CostLedger | None:
    """→ the current request's ledger, or None outside a request."""
    return _COST.get()


def current_label() -> str:
    """The clamped label of the current request's tenant (detectd's
    fair-queue key), or "system" outside a request."""
    led = _COST.get()
    return TENANTS.resolve(led.tenant) if led is not None else "system"


def install_shares(shares) -> None:
    """Install the merged-dispatch share vector into the CURRENT
    context. detectd's flush calls this via Context.run on the
    dispatch and fetch Contexts it builds per round — Context.run
    mutations persist in the Context object, so every subsequent
    charge inside that round apportions."""
    _SHARES.set(tuple(shares))


def _apportion(field: str, amount: float) -> None:
    """Charge `amount` of `field` to whoever owns the current context:
    pro-rata across an installed share vector (merged dispatch), else
    the request ledger, else SYSTEM. The single place the
    apportionment contract lives."""
    if amount <= 0 or not _ENABLED:
        return
    shares = _SHARES.get()
    if shares:
        total = sum(w for _led, w in shares)
        if total > 0:
            for led, w in shares:
                if w <= 0:
                    continue
                (led or SYSTEM).charge(field, amount * (w / total))
            return
    led = _COST.get()
    (led or SYSTEM).charge(field, amount)


class _Ewma:
    """Device ms per real row, exponentially smoothed — the exchange
    rate `note_work_avoided` uses to price memo hits in ms. An
    ESTIMATE by construction (the avoided dispatch never ran); kept
    out of the conservation sums for exactly that reason."""

    def __init__(self, alpha: float = 0.2):
        self._lock = threading.Lock()
        self._alpha = alpha
        self._ms_per_row = 0.0

    def update(self, ms: float, rows: int) -> None:
        if rows <= 0 or ms < 0:
            return
        rate = ms / rows
        with self._lock:
            if self._ms_per_row == 0.0:
                self._ms_per_row = rate
            else:
                self._ms_per_row += \
                    self._alpha * (rate - self._ms_per_row)

    def rate(self) -> float:
        with self._lock:
            return self._ms_per_row


_EWMA = _Ewma()


def charge_device_ms(site: str, ms: float, real_rows: int = 0) -> None:
    """One device-side launch+sync measurement: writes the graftprof
    LEDGER and the cost side from the SAME number (the conservation
    contract), then apportions across the current context. real_rows
    (when the caller knows it) feeds the work-avoided exchange
    rate."""
    if ms <= 0:
        return
    from .perf import LEDGER
    LEDGER.note_device_ms(site, ms)
    if not _ENABLED:
        return
    _EWMA.update(ms, real_rows)
    _apportion("device_ms", ms)


def ledgered_transfer(path: str, nbytes: float) -> None:
    """Device→host result bytes: one call feeds the graftprof transfer
    ledger AND the cost apportionment, replacing the bare
    LEDGER.note_transfer at every result-fetch seam so the two sides
    cannot drift."""
    if nbytes <= 0:
        return
    from .perf import LEDGER
    LEDGER.note_transfer(path, nbytes)
    if path in CONSERVED_TRANSFER_PATHS:
        _apportion("transfer_bytes", float(nbytes))


def charge_queue_ms(ms: float, ledger: CostLedger | None = None) -> None:
    """Admission-queue or coalesce-window wait. Queue time outside any
    request context is nobody's cost — dropped, not SYSTEM's."""
    led = ledger if ledger is not None else _COST.get()
    if led is not None and ms > 0:
        led.charge("queue_ms", ms)


def charge_host_ms(ms: float) -> None:
    """Host CPU ms for a fallback join (breaker-open / device-error
    paths). Apportioned like device ms — a merged round that fell back
    still served every coalesced request."""
    _apportion("host_ms", ms)


def charge_ingest(nbytes: float, ms: float) -> None:
    """fanald layer work: decompressed bytes plus walker/analyzer
    wall ms, charged per layer on the request's own thread."""
    _apportion("ingest_bytes", nbytes)
    _apportion("ingest_ms", ms)


def charge_sbom_parse(ms: float) -> None:
    """graftbom document decode wall ms. SBOM scans never bill fanal
    bytes — the document IS the inventory — so parse time is its own
    field rather than riding ingest_ms, keeping the archive-vs-SBOM
    cost split legible in /debug/costs."""
    _apportion("sbom_parse_ms", ms)


def charge_secret_bytes(path: str, nbytes: float) -> None:
    """Secrets-engine scanned bytes by serving path ("device" /
    "host")."""
    _apportion(f"secret_bytes.{path}", nbytes)


def note_work_avoided(units: int,
                      ledger: CostLedger | None = None) -> None:
    """Memo/cache replay — and graftfeed's merged-dispatch dedup:
    `units` detect units (pairs) served without dispatching. Priced in
    ms via the EWMA exchange rate — an estimate, surfaced as
    avoided_ms and excluded from conservation. Pass `ledger` to bill a
    specific request directly (detectd credits each coalesced
    request's collapsed duplicates from the dispatcher thread, where
    no request context is installed — the charge_queue_ms idiom);
    without one the current context's shares/ledger/SYSTEM chain
    applies."""
    if units <= 0 or not _ENABLED:
        return
    ms = units * _EWMA.rate()
    if ms <= 0:
        return
    if ledger is not None:
        ledger.charge("avoided_ms", ms)
        return
    _apportion("avoided_ms", ms)


@contextlib.contextmanager
def request_ledger(tenant: str):
    """Install a fresh CostLedger for one request on the current
    context (the server handler wraps _do_post in this); yields the
    ledger so the caller can stamp the outcome and settle it."""
    led = CostLedger(tenant)
    if not _ENABLED:
        # bench A/B baseline: the handler still gets a ledger object
        # to stamp outcomes on, but nothing installs, charges, or
        # exports — active() stays None so no header is stamped
        yield led
        return
    token = _COST.set(led)
    try:
        yield led
    finally:
        _COST.reset(token)


# ---------------------------------------------------------------------------
# tenant aggregation (top-K + "other" cardinality clamp)

_TENANT_MAX_LEN = 64


def normalize_tenant(raw: str | None) -> str:
    """Syntactic clamp for hostile tenant ids. X-Trivy-Tenant is
    attacker-controlled: an oversized value is truncated to
    _TENANT_MAX_LEN chars, control / non-printable characters are
    squashed to "_", and an empty or all-junk value falls back to
    "default". This runs at the server door BEFORE the id can mint
    quota state, a ledger, or a metric label. Cardinality bombs (10k
    *distinct* well-formed names) are the next layer's job: quota
    buckets and metric labels key on TENANTS.resolve(), whose top-K
    clamp folds the long tail into "other"."""
    if not raw:
        return "default"
    cleaned = "".join(
        ch if ch.isprintable() else "_"
        for ch in raw[:_TENANT_MAX_LEN])
    cleaned = cleaned.strip()
    return cleaned or "default"


def _new_tenant_row() -> dict:
    return {"scans": {}, "queue_ms": 0.0, "service_ms": 0.0,
            "device_ms": 0.0, "transfer_bytes": 0.0, "host_ms": 0.0,
            "ingest_bytes": 0.0, "ingest_ms": 0.0,
            "sbom_parse_ms": 0.0,
            "secret_bytes": 0.0, "avoided_ms": 0.0}


class TenantAggregator:
    """Per-tenant running totals behind /debug/costs, /healthz, and
    the trivy_tpu_tenant_* series. Cardinality is bounded: the first
    `top_k` distinct tenant ids get their own label, everything after
    folds into "other" — the full id
    still rides the X-Trivy-Cost header and span attrs. "default" and
    "system" are reserved rows outside the K budget."""

    RESERVED = ("default", "system", "other")

    def __init__(self, top_k: int = 8):
        self._lock = threading.Lock()
        self.top_k = int(top_k)
        self._rows: dict[str, dict] = {
            "default": _new_tenant_row(),
            "system": _new_tenant_row(),
        }

    def configure(self, top_k: int | None = None) -> None:
        with self._lock:
            if top_k is not None:
                self.top_k = int(top_k)

    def resolve(self, tenant: str) -> str:
        """→ the bounded label for `tenant`, minting its row if the K
        budget allows."""
        t = tenant or "default"
        with self._lock:
            if t in self._rows:
                return t
            named = sum(1 for k in self._rows
                        if k not in self.RESERVED)
            if named >= self.top_k:
                self._rows.setdefault("other", _new_tenant_row())
                return "other"
            self._rows[t] = _new_tenant_row()
            return t

    def _fold_numbers(self, label: str, doc: dict,
                      outcome: str | None) -> None:
        with self._lock:
            row = self._rows.setdefault(label, _new_tenant_row())
            for field in ("queue_ms", "service_ms", "device_ms",
                          "transfer_bytes", "host_ms", "ingest_bytes",
                          "ingest_ms", "sbom_parse_ms",
                          "secret_bytes", "avoided_ms"):
                row[field] += float(doc.get(field, 0.0))
            if outcome:
                row["scans"][outcome] = \
                    row["scans"].get(outcome, 0) + 1

    def _export(self, label: str, doc: dict,
                outcome: str | None) -> None:
        METRICS.inc("trivy_tpu_tenant_device_ms_total",
                    float(doc.get("device_ms", 0.0)), tenant=label)
        METRICS.inc("trivy_tpu_tenant_transfer_bytes_total",
                    float(doc.get("transfer_bytes", 0.0)),
                    tenant=label)
        avoided = float(doc.get("avoided_ms", 0.0))
        if avoided > 0:
            METRICS.inc("trivy_tpu_tenant_work_avoided_ms_total",
                        avoided, tenant=label)
        METRICS.observe("trivy_tpu_tenant_queue_ms",
                        float(doc.get("queue_ms", 0.0)), tenant=label)
        if outcome:
            METRICS.inc("trivy_tpu_tenant_scans_total", tenant=label,
                        outcome=outcome)

    def settle(self, ledger: CostLedger,
               outcome: str | None = None) -> str:
        """Fold one finished request's ledger into its (clamped)
        tenant row and export the tenant series. → the bounded
        label."""
        if not _ENABLED:
            return "default"
        label = self.resolve(ledger.tenant)
        doc = ledger.header_doc()
        self._fold_numbers(label, doc, outcome)
        self._export(label, doc, outcome)
        return label

    def fold_doc(self, doc: dict, outcome: str | None = None,
                 export: bool = False) -> str:
        """Fold one X-Trivy-Cost document (already merged across hops
        by the router) into the aggregate — the fleet-wide view the
        router's /debug/costs serves."""
        label = self.resolve(str(doc.get("tenant", "") or "default"))
        self._fold_numbers(label, doc, outcome)
        if export:
            self._export(label, doc, outcome)
        return label

    def labels(self) -> list[str]:
        with self._lock:
            return list(self._rows)

    def table(self, include_system_live: bool = True) -> dict:
        """→ {tenant: totals row} — the /debug/costs body. The SYSTEM
        ledger never settles, so its live totals merge into the
        "system" row here."""
        with self._lock:
            out = {k: {**{f: (round(v, 3)
                             if isinstance(v, float) else v)
                          for f, v in row.items() if f != "scans"},
                       "scans": dict(row["scans"])}
                   for k, row in self._rows.items()}
        if include_system_live:
            live = SYSTEM.snapshot()
            row = out.setdefault("system",
                                 {**_new_tenant_row(), "scans": {}})
            for field, val in live.items():
                key = ("secret_bytes"
                       if field.startswith("secret_bytes.") else field)
                if key in row:
                    row[key] = round(row[key] + val, 3)
        return out

    def totals(self) -> dict:
        """→ summed device_ms / transfer_bytes across every row plus
        the live SYSTEM ledger — the attributed side of the
        conservation equation."""
        dev = xfer = 0.0
        with self._lock:
            for row in self._rows.values():
                dev += row["device_ms"]
                xfer += row["transfer_bytes"]
        live = SYSTEM.snapshot()
        dev += live.get("device_ms", 0.0)
        xfer += live.get("transfer_bytes", 0.0)
        return {"device_ms": dev, "transfer_bytes": xfer}

    def healthz_block(self, include_system_live: bool = True) -> dict:
        """→ the /healthz `tenants` block: per-tenant scan counts and
        the headline cost split, small enough to read at 3am. The
        router's fleet aggregator passes include_system_live=False —
        the live SYSTEM ledger is the REPLICA process's background
        work, not something relayed headers attributed."""
        table = self.table(include_system_live)
        return {
            t: {"scans": sum(row["scans"].values()),
                "device_ms": round(row["device_ms"], 3),
                "transfer_bytes": int(row["transfer_bytes"]),
                "queue_ms": round(row["queue_ms"], 3),
                "avoided_ms": round(row["avoided_ms"], 3)}
            for t, row in table.items()
        }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._rows = {"default": _new_tenant_row(),
                          "system": _new_tenant_row()}


TENANTS = TenantAggregator()


# ---------------------------------------------------------------------------
# conservation + debug surfaces

def conservation_report(rel_tol: float = 0.01,
                        abs_tol_ms: float = 0.5,
                        abs_tol_bytes: float = 4096.0) -> dict:
    """Reconcile the attributed cost totals (tenant rows + live
    SYSTEM) against the graftprof dispatch LEDGER. Both sides are
    written from the same measurements by charge_device_ms /
    ledgered_transfer, so they agree by construction once traffic
    quiesces; the tolerances absorb float pro-rata splits and
    charges racing the two reads."""
    from .perf import LEDGER
    agg = LEDGER.aggregate()
    ledger_ms = float(agg.get("device_ms_total", 0.0))
    ledger_bytes = float(sum(
        int(agg.get("transfer_bytes", {}).get(p, 0))
        for p in CONSERVED_TRANSFER_PATHS))
    att = TENANTS.totals()

    def _ok(a: float, b: float, abs_tol: float) -> bool:
        return abs(a - b) <= max(abs_tol, rel_tol * max(a, b))

    return {
        "device_ms": {
            "ledger": round(ledger_ms, 3),
            "attributed": round(att["device_ms"], 3),
            "ok": _ok(ledger_ms, att["device_ms"], abs_tol_ms),
        },
        "transfer_bytes": {
            "ledger": int(ledger_bytes),
            "attributed": int(att["transfer_bytes"]),
            "ok": _ok(ledger_bytes, att["transfer_bytes"],
                      abs_tol_bytes),
        },
    }


COSTS_SCHEMA = "trivy-tpu-costs/1"


def debug_costs_payload() -> dict:
    """→ the token-gated /debug/costs body (server-local; the router
    builds its fleet-wide variant from relayed headers)."""
    return {
        "schema": COSTS_SCHEMA,
        "pid": os.getpid(),
        "tenants": TENANTS.table(),
        "conservation": conservation_report(),
        "avoided_ms_per_row_ewma": round(_EWMA.rate(), 6),
    }


def merge_cost_docs(docs: list[dict]) -> dict:
    """Sum X-Trivy-Cost documents across router failover hops into the
    ONE header the client sees: numeric fields add (each hop's queue
    and service time was really spent), hops accumulate, tenant comes
    from the last hop that stated one."""
    out: dict = {"tenant": "default", "hops": 0}
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        for k, v in doc.items():
            if k == "tenant":
                if v:
                    out["tenant"] = v
            elif k == "hops":
                out["hops"] += int(v) if isinstance(v, (int, float)) \
                    else 1
            elif isinstance(v, (int, float)):
                out[k] = round(out.get(k, 0) + v, 3)
    for field in ("queue_ms", "service_ms", "device_ms",
                  "transfer_bytes", "host_ms", "avoided_ms"):
        out.setdefault(field, 0)
    out["transfer_bytes"] = int(out["transfer_bytes"])
    return out


def parse_cost_header(raw: str) -> dict | None:
    """Parse one X-Trivy-Cost header value; None on junk (a cost
    header must never sink the response that carries it)."""
    if not raw:
        return None
    try:
        doc = json.loads(raw)
    except (ValueError, TypeError):
        return None
    return doc if isinstance(doc, dict) else None


def reset_for_tests() -> None:
    """Reset every module singleton (the SYSTEM ledger keeps its
    identity — context snapshots hold references to it)."""
    TENANTS.reset_for_tests()
    with SYSTEM._lock:
        SYSTEM._v = {}
    with _EWMA._lock:
        _EWMA._ms_per_row = 0.0
