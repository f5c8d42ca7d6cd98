"""Process-wide metrics registry, rendered as Prometheus text.

The reference exposes no metrics endpoint; its observability is logs.
For a long-lived scan server sharding work over a device mesh, the
operational questions are different — is the device busy, how big are
the batches, how much of each padded dispatch is real work, where do
requests stall — so the server publishes counters, gauges, and
histograms in the Prometheus text exposition format 0.0.4 at /metrics
(server/listen.py), fed from the detect and secret engines and the
RPC handlers.

Histograms use static bucket edges declared up front (declare()) so
series never change shape between scrapes; gauges cover in-flight
state (dispatch depth) the scraper cannot derive from rate().
Thread-safe: the detect engine is shared across server handler
threads, so every mutation happens under the lock.

The metric catalog — every series name, type, and help string — lives
at the bottom of this module. It is the JAX package's catalog, name
for name, type for type, help text and bucket edges included, so a
dashboard built for one package reads the other. A few series are fed
only by modules the port does not have yet and stay at 0 (listed in
UNFED below, each with the ROADMAP item that brings its feeder).
Label values that name a route are the port's own: the secrets
prefilter's `path` is "cuda" (the shift-or kernel), "torch" (its
plain torch version, on the CPU) or "host" (small batches).
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# default histogram edges: latency-shaped, seconds
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[tuple[str, tuple], float] = {}   # counters
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hist: dict[tuple[str, tuple], list] = {}      # bucket counts
        self._hist_sum: dict[tuple[str, tuple], float] = {}
        self._buckets: dict[str, tuple] = {}                # static edges
        self._help: dict[str, str] = {}
        self._types: dict[str, str] = {}

    # ---- declaration --------------------------------------------------

    def declare(self, name: str, kind: str, help_text: str = "",
                buckets: tuple | None = None) -> None:
        """Register a series' type, # HELP text, and (for histograms)
        its static bucket edges. Declaration is optional for counters
        and gauges; histograms observed without one get
        DEFAULT_BUCKETS."""
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric type {kind!r}")
        with self._lock:
            self._types[name] = kind
            if help_text:
                self._help[name] = help_text
            if kind == "histogram":
                edges = tuple(buckets) if buckets else DEFAULT_BUCKETS
                if list(edges) != sorted(edges):
                    raise ValueError(f"{name}: bucket edges not sorted")
                if self._buckets.get(name) not in (None, edges):
                    # re-declaring with different edges resets the
                    # series: rows sized for the old edges would render
                    # mis-bucketed counts (or crash at +Inf)
                    for key in [k for k in self._hist if k[0] == name]:
                        self._hist.pop(key)
                        self._hist_sum.pop(key, None)
                self._buckets[name] = edges

    # ---- writes -------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._types.setdefault(name, "gauge")
            self._gauges[key] = float(value)

    def gauge_add(self, name: str, delta: float, **labels):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._types.setdefault(name, "gauge")
            self._gauges[key] = self._gauges.get(key, 0.0) + delta

    def observe(self, name: str, value: float, **labels):
        """Record one histogram observation (bucket edges are the
        static ones from declare(), else DEFAULT_BUCKETS)."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._types.setdefault(name, "histogram")
            edges = self._buckets.get(name)
            if edges is None:
                edges = self._buckets[name] = DEFAULT_BUCKETS
            row = self._hist.get(key)
            if row is None:
                row = self._hist[key] = [0] * (len(edges) + 1)
            # le is an inclusive upper bound: first edge >= value
            row[bisect_left(edges, value)] += 1
            self._hist_sum[key] = self._hist_sum.get(key, 0.0) + value

    # ---- reads --------------------------------------------------------

    def get(self, name: str, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            return self._values.get(key, 0.0)

    def family_sum(self, name: str) -> float:
        """Sum one counter family across every label set — the read
        the fleet skew/memo probes want ("did ANY labeled series
        move"), which a labeled `get` cannot answer."""
        with self._lock:
            return sum(v for (n, _labels), v in self._values.items()
                       if n == name)

    def hist_get(self, name: str, **labels) -> tuple[list, float, int]:
        """→ (bucket_counts, sum, count) for one histogram series."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            row = list(self._hist.get(key) or ())
            total = self._hist_sum.get(key, 0.0)
        return row, total, sum(row)

    def reset(self):
        with self._lock:
            self._values.clear()
            self._gauges.clear()
            self._hist.clear()
            self._hist_sum.clear()

    # ---- exposition ---------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            values = sorted(self._values.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hist.items())
            hist_sum = dict(self._hist_sum)
            buckets = dict(self._buckets)
            helps = dict(self._help)
            types = dict(self._types)

        families: dict[str, list] = {}
        for (name, labels), value in values:
            families.setdefault(name, []).append(("c", labels, value))
        for (name, labels), value in gauges:
            families.setdefault(name, []).append(("g", labels, value))
        for (name, labels), row in hists:
            families.setdefault(name, []).append(("h", labels, row))

        out: list[str] = []
        for name in sorted(families):
            kind = types.get(name) or (
                "histogram" if families[name][0][0] == "h" else
                "gauge" if families[name][0][0] == "g" else "counter")
            if name in helps:
                out.append(f"# HELP {name} {_escape_help(helps[name])}")
            out.append(f"# TYPE {name} {kind}")
            for tag, labels, value in families[name]:
                if tag != "h":
                    out.append(
                        f"{name}{_labelstr(labels)} {_fmt(value)}")
                    continue
                edges = buckets[name]
                cum = 0
                for edge, n in zip(edges, value):
                    cum += n
                    out.append(
                        f"{name}_bucket"
                        f"{_labelstr(labels, le=_fmt(edge))} {cum}")
                cum += value[len(edges)]
                out.append(f"{name}_bucket"
                           f"{_labelstr(labels, le='+Inf')} {cum}")
                key = (name, labels)
                out.append(f"{name}_sum{_labelstr(labels)} "
                           f"{_fmt(hist_sum.get(key, 0.0))}")
                out.append(f"{name}_count{_labelstr(labels)} {cum}")
        return "\n".join(out) + "\n" if out else ""


def _labelstr(labels: tuple, le: str | None = None) -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in labels]
    if le is not None:
        parts.append(f'le="{le}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v) -> str:
    """Label-value escaping per the text exposition format."""
    return str(v).replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


def _escape_help(v: str) -> str:
    """HELP text escapes only backslash and newline."""
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    return str(int(v)) if v == int(v) else repr(v)


METRICS = Registry()

# ---------------------------------------------------------------------------
# metric catalog: every series the pipeline emits, with static buckets

METRICS.declare("trivy_tpu_scans_total", "counter",
                "Scan RPCs served.")
METRICS.declare("trivy_tpu_scan_seconds_total", "counter",
                "Total wall time spent serving Scan RPCs.")
METRICS.declare(
    "trivy_tpu_scan_latency_seconds", "histogram",
    "End-to-end latency of one Scan RPC (walker output to response).",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0))
METRICS.declare("trivy_tpu_detect_batches_total", "counter",
                "Query batches dispatched to the device join (device "
                "dispatches only — degraded-mode traffic counts in "
                "trivy_tpu_fallback_joins_total instead).")
METRICS.declare("trivy_tpu_detect_queries_total", "counter",
                "Package queries entering the detect engine.")
METRICS.declare("trivy_tpu_detect_pairs_total", "counter",
                "Candidate (package, advisory) pairs joined on device.")
METRICS.declare("trivy_tpu_detect_hits_total", "counter",
                "Detected (package, advisory-group) matches.")
METRICS.declare("trivy_tpu_detect_wait_assemble_seconds_total",
                "counter",
                "Wall time in device-result wait plus host assembly.")
METRICS.declare(
    "trivy_tpu_batch_occupancy_ratio", "histogram",
    "Real candidate pairs / padded dispatch rows, per device batch "
    "(1.0 = no padding waste).",
    buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))
METRICS.declare(
    "trivy_tpu_device_get_stall_seconds", "histogram",
    "Time the host blocked fetching one dispatched batch result "
    "(compile + execute + transfer not yet overlapped away).",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0))
METRICS.declare("trivy_tpu_dispatch_depth", "gauge",
                "Device dispatches currently in flight (dispatched, "
                "result not yet fetched).")
METRICS.declare(
    "trivy_tpu_detect_coalesce_size", "histogram",
    "Concurrent requests merged into one detectd device dispatch "
    "(1 = no coalescing happened for that dispatch).",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
METRICS.declare(
    "trivy_tpu_detect_queue_depth", "histogram",
    "Requests pending in the detectd queue when the dispatcher "
    "gathered a round.",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
METRICS.declare(
    "trivy_tpu_detect_transfer_bytes_total", "counter",
    "Join result bytes fetched device→host, by result path "
    "(path=\"compact\" O(hits) hit buffers, path=\"dense\" full "
    "padded bit vectors; an overflow fallback counts its wasted "
    "compact fetch AND the dense one).")
METRICS.declare(
    "trivy_tpu_detect_hit_occupancy", "histogram",
    "Hits per compacted dispatch ÷ hit-buffer capacity (mass above "
    "1.0 is the overflow-fallback rate — those dispatches re-fetched "
    "the dense bits).",
    buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 2.0))
METRICS.declare(
    "trivy_tpu_detect_compiles_total", "counter",
    "Distinct join dispatch shapes seen by this process — each one "
    "is an XLA compilation (the bucket ladder and --detect-warmup "
    "exist to bound this).")
METRICS.declare(
    "trivy_tpu_detect_breaker_state", "gauge",
    "graftguard device circuit breaker: 0 closed, 1 open, 2 half-open.")
METRICS.declare(
    "trivy_tpu_fallback_joins_total", "counter",
    "Joins served by the NumPy host fallback executor instead of the "
    "device (open breaker, or recovery after a supervised failure).")
METRICS.declare(
    "trivy_tpu_requests_shed_total", "counter",
    "Scan RPCs rejected by admission control (429/503 + Retry-After).")
METRICS.declare(
    "trivy_tpu_device_watchdog_trips_total", "counter",
    "Supervised device calls that outlived their watchdog deadline "
    "(each trip opens the breaker).")
METRICS.declare(
    "trivy_tpu_admission_queue_depth", "gauge",
    "Scan RPCs currently waiting in the admission queue.")
METRICS.declare(
    "trivy_tpu_mesh_devices", "gauge",
    "Devices in the active detect mesh (0 = mesh degraded to the "
    "host join; single-chip deployments never set this series).")
METRICS.declare(
    "trivy_tpu_mesh_breaker_state", "gauge",
    "meshguard per-device fault domain: 0 closed, 1 open, 2 half-open "
    "(one series per mesh device id).")
METRICS.declare(
    "trivy_tpu_mesh_rebuilds_total", "counter",
    "Mesh rebuilds through the swap_table generation drain "
    "(reason=\"shrink\" on device loss, reason=\"grow\" on "
    "readmission).")
METRICS.declare(
    "trivy_tpu_mesh_device_lost_total", "counter",
    "Mesh devices expelled from their fault domain (watchdog trip or "
    "breaker threshold).")
METRICS.declare(
    "trivy_tpu_mesh_host_lost_total", "counter",
    "Whole hosts lost from the mesh: every device sharing one host "
    "fault domain tripped inside the host-loss window, collapsing N "
    "single-chip shrinks into ONE debounced dp×db re-factorization "
    "over the survivors.")
METRICS.declare(
    "trivy_tpu_fleet_replica_state", "gauge",
    "graftfleet per-replica fault domain: 0 closed, 1 open, 2 "
    "half-open (one series per replica URL).")
METRICS.declare(
    "trivy_tpu_fleet_failovers_total", "counter",
    "Forwards past a request's ring owner: an earlier replica in the "
    "walk faulted or shed, or the owner is a lost domain (counted "
    "per forward, so a sustained outage keeps counting).")
METRICS.declare(
    "trivy_tpu_fleet_db_version_skew_total", "counter",
    "Observed advisory-DB version changes that left the fleet's "
    "replicas disagreeing (relayed X-Trivy-DB-Version headers and "
    "readmission probes feed it) — while nonzero-rate, failovers are "
    "not bit-identical. The versions label names the disagreeing "
    "digests (sorted, truncated, |-joined), so a rolling upgrade's "
    "transient skew is distinguishable from a split-brain pair that "
    "never converges. Label cardinality is CLAMPED (top-K pairs + "
    "\"other\"): a fleet churning through N swaps mints at most K+1 "
    "series; the full pair always reaches the warn log and the "
    "incident recorder.")
METRICS.declare(
    "trivy_tpu_fleet_cache_hits_total", "counter",
    "Layer-cache blob hits by backend (backend=\"fs\"/\"redis\"/"
    "\"s3\") — on a shared backend, a hit may be serving another "
    "replica's analysis.")
METRICS.declare(
    "trivy_tpu_fleet_router_latency_seconds", "histogram",
    "End-to-end router request latency (receive to relay, failovers "
    "and backoff included).",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
METRICS.declare(
    "trivy_tpu_slo_burn_rate", "gauge",
    "graftwatch SLO engine: error-budget burn rate per objective and "
    "sliding window (1.0 = burning exactly at the budget-exhausting "
    "rate; labels objective=\"scan_latency_p99\"/\"scan_errors\"/"
    "\"device_serving\", window=\"<seconds>s\"; graftcost adds "
    "tenant-labeled scan_latency_p99 series for the clamped top-K "
    "tenants).")
METRICS.declare(
    "trivy_tpu_device_serving_ratio", "gauge",
    "Fraction of join dispatches served by the device path (vs the "
    "NumPy host fallback) over the SLO engine's short window (1.0 "
    "when no joins ran).")
METRICS.declare(
    "trivy_tpu_incidents_total", "counter",
    "Flight-recorder incident snapshots written (reason=\"breaker_"
    "open\"/\"failpoint\"/\"manual\"; cooldown-limited, so a fault "
    "storm counts once per window).")
METRICS.declare(
    "trivy_tpu_ingest_breaker_state", "gauge",
    "fanald per-stage ingest fault domain: 0 closed, 1 open, 2 "
    "half-open (one series per stage, stage=\"walk\"/\"analyze\"/"
    "\"parse\" — \"parse\" is graftbom's SBOM decode stage).")
METRICS.declare(
    "trivy_tpu_ingest_partial_scans_total", "counter",
    "Layer walks the fanald pipeline degraded to an annotated "
    "partial BlobScan (budget trip, hostile input, stage timeout, or "
    "open ingest breaker) — partials cache only under salted ids, so "
    "the next scan re-walks.")
METRICS.declare(
    "trivy_tpu_ingest_budget_trips_total", "counter",
    "fanald ingest budgets tripped while a layer streamed "
    "(kind=\"budget.file_bytes\"/\"budget.layer_bytes\"/"
    "\"budget.members\"/\"deadline\"/\"bomb\").")
METRICS.declare(
    "trivy_tpu_ingest_inflight_bytes", "gauge",
    "File content currently in the fanald analysis window (read but "
    "not yet analyzed) — bounded by --ingest budgets via walker "
    "backpressure.")
METRICS.declare(
    "trivy_tpu_ingest_walker_busy", "gauge",
    "fanald layer walkers currently streaming a layer (walker-pool "
    "occupancy).")
METRICS.declare(
    "trivy_tpu_ingest_analyze_depth", "gauge",
    "fanald analyzer batches currently dispatched or queued on the "
    "analyzer pool.")
METRICS.declare(
    "trivy_tpu_sbom_docs_total", "counter",
    "SBOM documents decoded by graftbom (SBOMArtifact.inspect), by "
    "detected format (format=\"cyclonedx\"/\"spdx\"/\"spdx-json\"/"
    "\"unknown\" when detection never ran).")
METRICS.declare(
    "trivy_tpu_sbom_parse_seconds_total", "counter",
    "Wall time in the supervised SBOM decode stage (the same "
    "measurement billed to tenants as sbom_parse_ms).")
METRICS.declare(
    "trivy_tpu_sbom_components_total", "counter",
    "Packages decoded out of SBOM documents into BlobInfo inventory "
    "(OS package_infos plus application packages).")
METRICS.declare(
    "trivy_tpu_sbom_partial_total", "counter",
    "SBOM decodes degraded to an annotated partial (malformed "
    "document, budget trip, parse timeout, or open parse breaker) — "
    "cached only under salted ids, like fanald layer partials.")
METRICS.declare(
    "trivy_tpu_libscan_fingerprints_total", "counter",
    "Library-fingerprint corpus records flattened into a "
    "LibraryIndex advisory table (graftbom library workload).")
METRICS.declare(
    "trivy_tpu_libscan_queries_total", "counter",
    "Library-version observations turned into detect queries against "
    "a LibraryIndex.")
METRICS.declare(
    "trivy_tpu_memo_hits_total", "counter",
    "graftmemo detection-result memo: scan units (one OS or "
    "application query batch) served from a memoized (blob digest, "
    "db_version) entry instead of a device detect, by backend "
    "(backend=\"fs\"/\"memory\"/\"redis\"/\"s3\").")
METRICS.declare(
    "trivy_tpu_memo_misses_total", "counter",
    "graftmemo lookups for an attributable scan unit that found no "
    "matching entry (cold blob, new db_version, query drift, or a "
    "degraded memo backend) — the unit ran the plain detect path.")
METRICS.declare(
    "trivy_tpu_memo_stores_total", "counter",
    "graftmemo unit results published to the memo after a plain "
    "detect (partial/annotated blobs are never stored).")
METRICS.declare(
    "trivy_tpu_redetect_sweeps_total", "counter",
    "redetectd background sweeps started (one per DB hot swap that "
    "changed the advisory-table digest).")
METRICS.declare(
    "trivy_tpu_redetect_blobs_total", "counter",
    "Blobs visited by redetectd sweeps, by outcome "
    "(outcome=\"refreshed\"/\"fresh\"/\"missing\"/\"partial\"/"
    "\"stale\"/\"cancelled\"/\"failed\").")
METRICS.declare(
    "trivy_tpu_redetect_active", "gauge",
    "redetectd sweep state: 1 while a background re-detect sweep is "
    "running, 0 otherwise.")
METRICS.declare(
    "trivy_tpu_device_dispatches_total", "counter",
    "graftprof dispatch ledger: accepted device launches by site "
    "(site=\"detect\" single-chip engine, \"detectd\" merged "
    "coalesced dispatches, \"mesh\" sharded mesh launches, "
    "\"stream\" per-slice graftstream launches, \"secret\" the "
    "shift-or secrets engine, \"redetect\" blameless redetectd sweep "
    "replays). Warmup launches are compiles, not traffic, and are "
    "excluded.")
METRICS.declare(
    "trivy_tpu_device_padding_waste_ratio", "histogram",
    "Padding waste per device dispatch by launch site: (padded rows "
    "- real rows) / padded rows (0.0 = perfectly full dispatch; the "
    "complement of occupancy, ledger-attributed per site).",
    buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
             0.95, 1.0))
METRICS.declare(
    "trivy_tpu_device_compile_ms", "histogram",
    "First-dispatch-of-shape compile wall time in milliseconds, by "
    "phase (phase=\"warmup\" pre-compiles from warmup()/--detect-"
    "warmup, phase=\"traffic\" compiles paid by a live request — "
    "the ones a latency page cares about; each lands under a "
    "detect.compile span so it shows up in Perfetto too).",
    buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
             1000.0, 2500.0, 5000.0, 15000.0, 60000.0))
METRICS.declare(
    "trivy_tpu_device_transfer_bytes_total", "counter",
    "graftprof ledger: device link bytes by path "
    "(path=\"compact\" O(hits) hit buffers, path=\"dense\" full "
    "padded vectors, path=\"overflow\" the dense re-fetch a hit-"
    "buffer overflow pays on top of its wasted compact fetch — all "
    "device->host; path=\"shard_upload\" graftstream host->device "
    "advisory-slice uploads; path=\"query_upload\" graftfeed "
    "host->device CSR query-column uploads) — unlike "
    "trivy_tpu_detect_transfer_bytes_total this series separates the "
    "overflow re-fetch and covers every ledger site.")
METRICS.declare(
    "trivy_tpu_detect_dedup_ratio", "histogram",
    "graftfeed: unique pairs / real pairs per merged dispatch (1.0 = "
    "no duplicate query triples collapsed; fleet traffic sharing fat "
    "base layers should pile mass well below 0.5). Observed per "
    "dispatch_merged whenever dedup is enabled, including "
    "duplicate-free rounds, so the distribution says how duplicated "
    "admitted traffic actually is.",
    buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
             1.0))
METRICS.declare(
    "trivy_tpu_device_hit_budget_adaptations_total", "counter",
    "Hit-buffer budget adaptations in the compaction epilogue "
    "(direction=\"up\" an overflow doubled the budget, "
    "direction=\"down\" a sustained sparse streak halved it) — "
    "sustained flapping means the workload's hit density is bimodal "
    "and the streak window needs retuning.")
METRICS.declare(
    "trivy_tpu_device_hbm_bytes", "gauge",
    "Backend memory stats per device (kind=\"in_use\"/\"limit\"/"
    "\"peak\"), sampled (throttled) on the dispatch path; backends "
    "without memory_stats (CPU) never set this series.")
METRICS.declare(
    "trivy_tpu_device_resident_bytes", "gauge",
    "Host-resident footprint of the big scan structures "
    "(component=\"advisory_table\" columnar arrays plus its "
    "per-column \"advisory_table.<col>\" breakdown, "
    "\"advisory_slice_resident\" the graftstream double-buffered "
    "device slice pair, \"version_pool\" the encoded version matrix, "
    "\"secret_bank\" the shift-or word/mask planes) — the "
    "table-growth-toward-the-HBM-cliff early warning /healthz "
    "surfaces.")
METRICS.declare(
    "trivy_tpu_device_upload_stall_ms", "histogram",
    "graftstream/graftfeed: time one dispatch blocked making an "
    "advisory slice (or, for the query_upload ledger rows, its CSR "
    "query columns) device-resident. Double buffering prefetches the "
    "next upload during the previous dispatch's compute, so "
    "steady-state stalls sit in the lowest bucket; mass above it "
    "means transfer is outrunning compute (shrink the slice count or "
    "grow the budget).",
    buckets=(0.1, 0.5, 1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
             1000.0))
METRICS.declare(
    "trivy_tpu_profile_captures_total", "counter",
    "graftprof live profiler captures (reason=\"manual\" the "
    "/debug/profile endpoint, \"slo_burn\" the SLO auto-trigger, "
    "\"cli\" a --profile-dir scan; anything else clamps to "
    "\"other\" so operator-supplied reasons cannot mint unbounded "
    "series) — one-at-a-time and cooldown-limited, so this counts "
    "windows, not requests.")
METRICS.declare("trivy_tpu_secret_files_total", "counter",
                "Files through the secret scanner.")
METRICS.declare("trivy_tpu_secret_bytes_total", "counter",
                "Bytes through the secret scanner.")
METRICS.declare("trivy_tpu_secret_findings_total", "counter",
                "Confirmed secret findings.")
METRICS.declare(
    "trivy_tpu_secret_prefilter_path_total", "counter",
    "Keyword-prefilter launches by the path that actually served them "
    "(path=\"pallas\"/\"jnp\"/\"host\"): pallas = the TPU shift-or "
    "kernel, jnp = ac.shiftor_scan (CPU, mesh, or a logged pallas "
    "downgrade), host = small batches, open-breaker fallback, and "
    "device errors.")
METRICS.declare(
    "trivy_tpu_secret_scan_bytes_total", "counter",
    "Bytes through the keyword prefilter, by serving path "
    "(path=\"pallas\"/\"jnp\"/\"host\") — the MB/s numerator for each "
    "lane of the secrets engine.")
METRICS.declare(
    "trivy_tpu_secret_candidate_precision", "histogram",
    "Per scan batch: keyword-gated (file, rule) candidates that the "
    "rule regex then confirmed with a finding, divided by candidates "
    "flagged — the regex yield of the exact keyword gate.",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0))
METRICS.declare(
    "trivy_tpu_tenant_device_ms_total", "counter",
    "graftcost: device wall ms attributed per tenant (merged "
    "dispatches apportion pro-rata by real pair share; "
    "tenant=\"system\" absorbs warmup, blameless redetect, and probe "
    "work; label space is top-K-plus-\"other\" clamped).")
METRICS.declare(
    "trivy_tpu_tenant_transfer_bytes_total", "counter",
    "graftcost: conserved device->host result bytes "
    "(compact/dense/overflow paths) attributed per tenant — "
    "reconciles with trivy_tpu_device_transfer_bytes_total under the "
    "cost-conservation contract.")
METRICS.declare(
    "trivy_tpu_tenant_queue_ms", "histogram",
    "graftcost: per-request queue ms by tenant (admission-queue wait "
    "plus detectd coalesce-window wait) — time a request was PARKED, "
    "distinct from service ms.",
    buckets=(0.1, 0.5, 1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
             500.0, 1000.0, 5000.0))
METRICS.declare(
    "trivy_tpu_tenant_scans_total", "counter",
    "graftcost: settled Scan RPCs by tenant and outcome "
    "(outcome=\"ok\"/\"error\"/\"shed\").")
METRICS.declare(
    "trivy_tpu_tenant_work_avoided_ms_total", "counter",
    "graftcost: estimated device ms the memo/cache layer saved per "
    "tenant (replayed units priced at the EWMA device-ms-per-row "
    "exchange rate; an estimate — excluded from conservation).")
METRICS.declare(
    "trivy_tpu_tenant_qos_sheds_total", "counter",
    "graftfair: admission sheds charged to a tenant's quota "
    "(reason=\"queue_overflow\"/\"tenant_queue\"/\"tenant_rate\"/"
    "\"deadline\"/\"budget\"/\"quota_fault\"; tenant labels are "
    "top-K-plus-\"other\" clamped).")
METRICS.declare(
    "trivy_tpu_tenant_qos_quota_depth", "gauge",
    "graftfair: queued requests currently held against each tenant's "
    "quota — the per-tenant slice of "
    "trivy_tpu_admission_queue_depth.")
METRICS.declare(
    "trivy_tpu_tenant_qos_dispatch_share", "histogram",
    "graftfair: per merged detectd dispatch, each participating "
    "tenant's fraction of the round's real pairs — the fair sweep "
    "bounds the max at --detect-tenant-max-share when more than one "
    "tenant is pending.",
    buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0))

# ---------------------------------------------------------------------------
# series declared for the dashboards' sake but fed only by modules the
# port does not have (yet): each stays at 0 until its ROADMAP item
# lands. The breaker, watchdog, host join and meshguard are not ported
# by design (there is no fallback from the card), so theirs stay 0 for
# good: the mesh series are meshguard's (the reference feeds them from
# resilience/meshguard.py alone), not the mesh's. trivy_tpu_device_
# serving_ratio is fed (SLOEngine) and reads 1.0 for the same reason:
# every join is served by the card.
_NO_FALLBACK = "not ported: no breaker, watchdog or host join"
_NO_MESHGUARD = "not ported: no meshguard"
UNFED = {
    "trivy_tpu_detect_breaker_state": _NO_FALLBACK,
    "trivy_tpu_device_watchdog_trips_total": _NO_FALLBACK,
    "trivy_tpu_fallback_joins_total": _NO_FALLBACK,
    "trivy_tpu_mesh_devices": _NO_MESHGUARD,
    "trivy_tpu_mesh_breaker_state": _NO_MESHGUARD,
    "trivy_tpu_mesh_rebuilds_total": _NO_MESHGUARD,
    "trivy_tpu_mesh_device_lost_total": _NO_MESHGUARD,
    "trivy_tpu_mesh_host_lost_total": _NO_MESHGUARD,
    "trivy_tpu_fleet_replica_state": "A12",
    "trivy_tpu_fleet_failovers_total": "A12",
    "trivy_tpu_fleet_db_version_skew_total": "A12",
    "trivy_tpu_fleet_router_latency_seconds": "A12",
}
