"""graftprof — device-side performance telemetry.

graftwatch made the *request* path observable; graftprof does the same
for the *device* path with three pieces that every launch site feeds:

  ledger    the dispatch ledger (LEDGER): every launch site — the
            detector (per request), detectd's merged dispatches and
            the shift-or secrets engine — records per-dispatch
            padded-vs-real rows, device→host bytes by result path
            (compact / dense / the overflow re-fetch), hit-buffer fill
            and budget adaptations, host→device query uploads, and the
            wall time of each first launch of a shape. Exported as
            trivy_tpu_device_* series and summarized per shape at the
            token-gated /debug/perf.
  memory    device memory gauges from torch.cuda.memory_stats and
            max_memory_allocated, sampled (throttled) on the dispatch
            path — never from /healthz, which must not create or block
            on the CUDA context — plus resident-bytes accounting for
            the big host-side structures (advisory table, secret rule
            bank, version pool).
  profiler  on-demand live capture (PROF): /debug/profile?ms=N runs a
            torch.profiler capture (CPU and CUDA activities) against
            live traffic (token-gated, one-at-a-time,
            cooldown-limited) and writes the Chrome trace plus a
            trivy-tpu-profile/1 manifest into the incident dir; an SLO
            burn-rate threshold can auto-trigger one capture. The
            CLI's --profile-dir rides the same exclusivity
            (capture_dir). On the card a capture without a single CUDA
            kernel event raises instead of writing an empty profile;
            the profiler sees the card only from the main thread, which
            the server lends to the captures (run_captures_on).

The port has no compile step: "first of shape" is the first launch of
a (t_pad, h_cap) join shape or a (rows, row_len) shift-or shape in a
process, timed as the host wall of that launch call (the kernel
library's load, or its nvcc build, lands in the first one; later
first-of-shape launches time the enqueue alone). It keeps the JAX
package's `detect.compile` span name and `trivy_tpu_device_compile_ms`
series so the two packages' traces and dashboards line up.

The perf-regression gate lives next door in obs/perfcheck.py. Lock
discipline: every mutation of shared ledger/profiler state happens
under the instance lock, and nothing here synchronizes with the card.

The port's copy of the JAX package's obs/perf.py.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
import time

from ..metrics import METRICS

_SLUG_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


def _new_row() -> dict:
    return {
        "dispatches": 0, "warm_dispatches": 0,
        "real_rows": 0, "padded_rows": 0, "waste_bytes": 0,
        "compiles": 0, "compile_ms": 0.0,
        "hit_fill_sum": 0.0, "hit_fill_n": 0, "overflows": 0,
    }


def _new_upload_row() -> dict:
    return {
        "uploads": 0, "prefetched": 0, "bytes": 0,
        "waits": 0, "cold_waits": 0,
        "stall_ms": 0.0, "cold_stall_ms": 0.0,
    }


class DispatchLedger:
    """Process-wide per-shape dispatch accounting (LEDGER, shared like
    METRICS). Shape key = (site, padded rows, hit capacity): each key
    is one launch shape, so the /debug/perf table reads as "what
    shapes does this process launch, how often, how wasteful".

    row_bytes scales the waste accounting to the site's row size: a
    detect pair costs one dense-bit byte, a secrets chunk row costs
    its full chunk length — so waste_bytes is comparable across
    sites."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shapes: dict[tuple, dict] = {}
        self._transfers: dict[str, int] = {}
        self._device_ms: dict[str, float] = {}
        self._adapt = {"up": 0, "down": 0}
        self._resident: dict[str, int] = {}
        self._uploads: dict[str, dict] = {}
        self._mem: dict[str, dict] = {}
        self._mem_last = 0.0
        self._mem_peak = 0
        self.mem_sample_interval_s = 5.0

    # ---- dispatch accounting ------------------------------------------

    def note_dispatch(self, site: str, real: int, padded: int,
                      h_cap: int = 0, row_bytes: int = 1,
                      warm: bool = False) -> None:
        """One accepted device launch: `real` real rows inside a
        `padded`-row dispatch. Warmup dispatches are compiles, not
        traffic — counted separately so occupancy means what it
        says."""
        waste = max(padded - real, 0) * row_bytes
        with self._lock:
            row = self._shapes.setdefault((site, padded, h_cap),
                                          _new_row())
            if warm:
                row["warm_dispatches"] += 1
            else:
                row["dispatches"] += 1
                row["real_rows"] += real
                row["padded_rows"] += padded
                row["waste_bytes"] += waste
        if not warm:
            METRICS.inc("trivy_tpu_device_dispatches_total", site=site)
            if padded:
                METRICS.observe("trivy_tpu_device_padding_waste_ratio",
                                (padded - real) / padded, site=site)

    def note_compile(self, site: str, padded: int, h_cap: int,
                     ms: float, warm: bool = False) -> None:
        """First-launch-of-shape wall time (the launch call that met
        the shape first in this process). The phase
        label keeps warmup compiles distinguishable from the
        mid-traffic ones a latency page cares about."""
        with self._lock:
            row = self._shapes.setdefault((site, padded, h_cap),
                                          _new_row())
            row["compiles"] += 1
            row["compile_ms"] += ms
        METRICS.observe("trivy_tpu_device_compile_ms", ms,
                        phase="warmup" if warm else "traffic")

    def note_device_ms(self, site: str, ms: float) -> None:
        """Wall ms one launch+sync spent on the device path, by site.
        Written by obs.cost.charge_device_ms from the SAME measurement
        it apportions to tenants — the two sides of the graftcost
        conservation contract come from one clock read."""
        with self._lock:
            self._device_ms[site] = \
                self._device_ms.get(site, 0.0) + float(ms)

    def note_transfer(self, path: str, nbytes: float) -> None:
        """Device→host result bytes by path: "compact" (O(hits) hit
        buffers), "dense" (full padded vectors), "overflow" (the dense
        re-fetch a hit-buffer overflow pays on top of its wasted
        compact fetch)."""
        with self._lock:
            self._transfers[path] = \
                self._transfers.get(path, 0) + int(nbytes)
        METRICS.inc("trivy_tpu_device_transfer_bytes_total",
                    float(nbytes), path=path)

    def note_hits(self, site: str, padded: int, h_cap: int,
                  n_hits: int) -> None:
        """Hit-buffer fill fraction for one compacted dispatch (>1.0
        = overflow: that dispatch fell back to the dense fetch)."""
        if h_cap <= 0:
            return
        with self._lock:
            row = self._shapes.setdefault((site, padded, h_cap),
                                          _new_row())
            row["hit_fill_sum"] += n_hits / h_cap
            row["hit_fill_n"] += 1
            if n_hits > h_cap:
                row["overflows"] += 1

    def note_shard_upload(self, site: str, nbytes: int,
                          prefetched: bool,
                          path: str = "shard_upload") -> None:
        """One host→device upload (graftstream advisory slices;
        graftfeed query columns with site/path "query_upload").
        `prefetched` means the double buffer shipped it AHEAD of need,
        overlapped with the previous slice's (or dispatch's) compute;
        a non-prefetched upload ran inside a dispatch's wait (the cold
        path). Counts in the transfer ledger under `path` so streaming
        and input-feed overhead show at /debug/perf next to the result
        fetches."""
        with self._lock:
            row = self._uploads.setdefault(site, _new_upload_row())
            row["uploads"] += 1
            row["bytes"] += int(nbytes)
            if prefetched:
                row["prefetched"] += 1
        self.note_transfer(path, float(nbytes))

    def note_shard_wait(self, site: str, stall_ms: float,
                        cold: bool) -> None:
        """Time one dispatch spent blocked making a slice resident.
        Steady-state double buffering means stalls ≈ 0 after the first
        slice of a walk — the overlap property the streaming tests
        assert from these rows. `cold` = the upload itself ran inside
        this wait (nothing had prefetched the slice)."""
        with self._lock:
            row = self._uploads.setdefault(site, _new_upload_row())
            row["waits"] += 1
            row["stall_ms"] += stall_ms
            if cold:
                row["cold_waits"] += 1
                row["cold_stall_ms"] += stall_ms
        METRICS.observe("trivy_tpu_device_upload_stall_ms", stall_ms)

    def shard_upload_stats(self) -> dict:
        """→ {site: upload/stall aggregates} — the graftstream
        overlap view (/debug/perf `shard_uploads`, bench table_sweep,
        and the tier-1 double-buffer assertion)."""
        with self._lock:
            return {site: dict(row)
                    for site, row in self._uploads.items()}

    def note_budget_adapt(self, direction: str) -> None:
        """One hit-budget adaptation ("up" on overflow, "down" on a
        sustained sparse streak)."""
        with self._lock:
            self._adapt[direction] = self._adapt.get(direction, 0) + 1
        METRICS.inc("trivy_tpu_device_hit_budget_adaptations_total",
                    direction=direction)

    # ---- memory telemetry ---------------------------------------------

    def note_resident(self, component: str, nbytes: int) -> None:
        """Host-resident bytes of one big structure (advisory_table,
        secret_bank, version_pool, memo). Idempotent per component —
        callers re-stamp on growth/swap."""
        with self._lock:
            self._resident[component] = int(nbytes)
        METRICS.set_gauge("trivy_tpu_device_resident_bytes",
                          float(nbytes), component=component)

    def sample_memory(self, device=None, force: bool = False) -> None:
        """Throttled device memory sample of `device` (a CUDA
        torch.device). Called from the dispatch path
        (obs.device.note_dispatch) right after a launch, where the CUDA
        context is live — /healthz only ever reads the cached view, so
        it never touches torch.cuda. A CPU device leaves the view
        empty, as a backend without memory stats does in the JAX
        package."""
        if device is None or getattr(device, "type", "") != "cuda":
            return
        now = time.monotonic()
        with self._lock:
            if not force and \
                    now - self._mem_last < self.mem_sample_interval_s:
                return
            self._mem_last = now
        try:
            import torch
            ms = torch.cuda.memory_stats(device)
            idx = device.index if device.index is not None \
                else torch.cuda.current_device()
            in_use = int(ms.get("allocated_bytes.all.current", 0))
            peak = int(torch.cuda.max_memory_allocated(device))
            limit = int(torch.cuda.get_device_properties(
                idx).total_memory)
        except Exception:
            return  # a memory probe must never sink a dispatch
        dev_id = str(idx)
        stats = {dev_id: {"platform": "gpu", "bytes_in_use": in_use,
                          "bytes_limit": limit,
                          "peak_bytes_in_use": peak}}
        METRICS.set_gauge("trivy_tpu_device_hbm_bytes", float(in_use),
                          device=dev_id, kind="in_use")
        METRICS.set_gauge("trivy_tpu_device_hbm_bytes", float(limit),
                          device=dev_id, kind="limit")
        METRICS.set_gauge("trivy_tpu_device_hbm_bytes", float(peak),
                          device=dev_id, kind="peak")
        with self._lock:
            self._mem = stats
            self._mem_peak = max(self._mem_peak, peak)

    def memory_status(self) -> dict:
        """→ the /healthz `device.memory` block: the cached backend
        view plus host-resident components. Pure cache reads — never
        touches torch.cuda."""
        with self._lock:
            return {
                "backends": {k: dict(v) for k, v in self._mem.items()},
                "watermark_bytes": self._mem_peak,
                "resident_bytes": dict(self._resident),
            }

    # ---- reads ---------------------------------------------------------

    def shape_table(self) -> list[dict]:
        """→ the /debug/perf per-shape rows, sorted by site then
        size."""
        with self._lock:
            snap = {k: dict(v) for k, v in self._shapes.items()}
        rows = []
        for (site, padded, h_cap), r in sorted(snap.items()):
            rows.append({
                "site": site, "t_pad": padded, "h_cap": h_cap,
                "dispatches": r["dispatches"],
                "warm_dispatches": r["warm_dispatches"],
                "compiles": r["compiles"],
                "compile_ms": round(r["compile_ms"], 3),
                "mean_occupancy": round(
                    r["real_rows"] / r["padded_rows"], 4)
                if r["padded_rows"] else None,
                "waste_bytes": r["waste_bytes"],
                "mean_hit_fill": round(
                    r["hit_fill_sum"] / r["hit_fill_n"], 4)
                if r["hit_fill_n"] else None,
                "overflows": r["overflows"],
            })
        return rows

    def aggregate(self) -> dict:
        """→ the ledger's process totals — the bench-tail /
        device-child `graftprof` block perfcheck consumes."""
        with self._lock:
            shapes = [dict(v) for v in self._shapes.values()]
            transfers = dict(self._transfers)
            device_ms = dict(self._device_ms)
            adapt = dict(self._adapt)
            uploads = {site: dict(row)
                       for site, row in self._uploads.items()}
        real = sum(r["real_rows"] for r in shapes)
        padded = sum(r["padded_rows"] for r in shapes)
        return {
            "dispatches": sum(r["dispatches"] for r in shapes),
            "warm_dispatches": sum(r["warm_dispatches"]
                                   for r in shapes),
            "distinct_shapes": len(shapes),
            # raw row sums ride along so a scenario DELTA can
            # recompute the ratio over just its own dispatches
            "real_rows": real,
            "padded_rows": padded,
            "padding_waste_ratio": round(1.0 - real / padded, 4)
            if padded else None,
            "waste_bytes": sum(r["waste_bytes"] for r in shapes),
            "compiles": sum(r["compiles"] for r in shapes),
            "compile_ms": round(sum(r["compile_ms"] for r in shapes),
                                3),
            "overflows": sum(r["overflows"] for r in shapes),
            "transfer_bytes": transfers,
            # graftcost: per-site device wall ms (launch+sync), the
            # ledger side of the cost-conservation reconciliation
            "device_ms": {k: round(v, 3) for k, v in device_ms.items()},
            "device_ms_total": round(sum(device_ms.values()), 3),
            "budget_adaptations": adapt,
            # graftstream: host→device slice-upload overlap aggregates
            # (uploads/prefetched/stall_ms per site)
            "shard_uploads": uploads,
        }

    def site_dispatches(self) -> dict[str, int]:
        """→ {site: non-warm dispatch count} — the reconciliation read
        the acceptance drill sums against trivy_tpu_detect_* counts."""
        out: dict[str, int] = {}
        with self._lock:
            for (site, _padded, _h), r in self._shapes.items():
                out[site] = out.get(site, 0) + r["dispatches"]
        return out

    def reset_for_tests(self) -> None:
        with self._lock:
            self._shapes = {}
            self._transfers = {}
            self._device_ms = {}
            self._adapt = {"up": 0, "down": 0}
            self._resident = {}
            self._uploads = {}
            self._mem = {}
            self._mem_last = 0.0
            self._mem_peak = 0


LEDGER = DispatchLedger()


# ---------------------------------------------------------------------------
# resident-bytes helpers (called once per structure build, not hot)

def ndarray_bytes(*arrays) -> int:
    """Sum .nbytes over whatever numpy arrays the caller has; non-
    arrays are skipped (duck-typed so callers never import numpy just
    to account)."""
    total = 0
    for a in arrays:
        nb = getattr(a, "nbytes", None)
        if isinstance(nb, (int, float)):
            total += int(nb)
    return total


def table_resident_bytes(table) -> int:
    """Columnar footprint of one AdvisoryTable (the device-shippable
    arrays; the Python group objects are the GC-frozen long tail and
    not what the HBM cliff cares about)."""
    return ndarray_bytes(*(getattr(table, name, None)
                           for name in ("lo_tok", "hi_tok", "flags",
                                        "hash_u64", "group")))


def stamp_table_resident(table) -> int:
    """Stamp one AdvisoryTable's footprint into the resident-bytes
    view: the whole-table figure PLUS the per-column breakdown
    (`advisory_table.lo_tok`, …) the graftstream slice planner budgets
    from — the build sites used to stamp only the total, so /healthz
    could not say WHICH column was marching toward the HBM cliff."""
    cols = getattr(table, "nbytes_by_column", None)
    if not callable(cols):
        total = table_resident_bytes(table)
        LEDGER.note_resident("advisory_table", total)
        return total
    breakdown = cols()
    total = sum(breakdown.values())
    LEDGER.note_resident("advisory_table", total)
    for name, nb in breakdown.items():
        LEDGER.note_resident(f"advisory_table.{name}", nb)
    return total


# ---------------------------------------------------------------------------
# live profiler capture

class ProfilerBusy(RuntimeError):
    """A capture is already running (one-at-a-time by design: two
    concurrent torch.profiler sessions in one process refuse or corrupt
    each other)."""


class ProfilerCooldown(RuntimeError):
    """Inside the cooldown window after the previous capture."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"profiler cooling down; retry in "
                         f"{retry_after_s:.1f}s")
        self.retry_after_s = retry_after_s


class NoDeviceEvents(RuntimeError):
    """A capture on the card recorded no CUDA kernel event: the
    profiler did not see the device, and a CPU-only trace must never
    pass for the card's."""


def _activities(device: str) -> list:
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def kernel_summary(prof) -> dict:
    """→ {"kernels": {name: {"count", "device_ms"}}, "busy_ms",
    "events"} from a stopped torch.profiler session: every CUDA
    kernel event by name, and the card's busy time as the union of the
    kernel intervals (two kernels that overlap count once)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels: dict[str, dict] = {}
    spans = []
    for ev in prof.events():
        if getattr(ev, "device_type", None) != cuda:
            continue
        tr = ev.time_range
        row = kernels.setdefault(ev.name, {"count": 0, "device_ms": 0.0})
        row["count"] += 1
        row["device_ms"] += (tr.end - tr.start) / 1e3
        spans.append((tr.start, tr.end))
    busy_us = 0.0
    cur_lo = cur_hi = None
    for lo, hi in sorted(spans):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy_us += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy_us += cur_hi - cur_lo
    for row in kernels.values():
        row["device_ms"] = round(row["device_ms"], 6)
    return {"kernels": kernels, "busy_ms": round(busy_us / 1e3, 6),
            "events": len(spans)}


class Profiler:
    """On-demand torch.profiler capture against live traffic (PROF,
    process singleton). One capture at a time; operator captures are
    cooldown-limited so a curl loop cannot turn the serving process
    into a profiling appliance; artifacts (the Chrome trace plus a
    trivy-tpu-profile/1 manifest obs.check validates) land in the
    flight recorder's incident dir, where incident tooling already
    looks. `device` ("cuda" or "cpu", set by the server and the CLI
    from their --device) picks the activities: the CPU alone for a
    CPU run, the CPU and CUDA on the card, where a capture must hold
    at least one CUDA kernel event."""

    SCHEMA = "trivy-tpu-profile/1"
    MAX_MS = 60_000.0

    def __init__(self):
        self._lock = threading.Lock()
        self._active = False
        self._last_end = 0.0          # monotonic; 0 = never captured
        self._seq = itertools.count()
        self.cooldown_s = 30.0
        self.device = "cuda"
        # SLO auto-trigger: short-window burn rate at/above this
        # starts one capture (0 = off); auto captures share the
        # cooldown so a sustained burn yields one profile per window
        self.auto_burn_threshold = 0.0
        self.auto_capture_ms = 2000.0
        self._runner = None

    def configure(self, cooldown_s: float | None = None,
                  auto_burn_threshold: float | None = None,
                  auto_capture_ms: float | None = None,
                  device: str | None = None) -> None:
        with self._lock:
            if cooldown_s is not None:
                self.cooldown_s = float(cooldown_s)
            if auto_burn_threshold is not None:
                self.auto_burn_threshold = float(auto_burn_threshold)
            if auto_capture_ms is not None:
                self.auto_capture_ms = float(auto_capture_ms)
            if device is not None:
                self.device = str(device)

    def run_captures_on(self, runner) -> None:
        """`runner(fn)` runs `fn` on the process's main thread and
        returns its result (None: captures run where they are asked
        for). The profiler's CUDA activity starts only on the thread
        its client registered from, the main thread: a capture started
        on another thread records no CUDA event. The server hands its
        main thread to the captures /debug/profile and the SLO trigger
        ask for on other threads."""
        with self._lock:
            self._runner = runner

    def _admit(self, force: bool) -> None:
        with self._lock:
            if self._active:
                raise ProfilerBusy("a profile capture is already "
                                   "running")
            now = time.monotonic()
            if not force and self._last_end and \
                    now - self._last_end < self.cooldown_s:
                raise ProfilerCooldown(
                    self.cooldown_s - (now - self._last_end))
            self._active = True

    def _release(self) -> None:
        with self._lock:
            self._active = False
            self._last_end = time.monotonic()

    def _finish(self, prof, out_dir: str, device: str) -> dict:
        """Export the stopped session's Chrome trace into out_dir and
        summarize its kernels → the summary. Raises NoDeviceEvents on
        the card when no CUDA kernel ran during the capture."""
        summary = kernel_summary(prof)
        if device == "cuda" and not summary["events"]:
            raise NoDeviceEvents(
                "the profile recorded no CUDA kernel event: the capture "
                "did not see the card (no trace written)")
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        return summary

    def capture(self, ms: float, reason: str = "manual",
                force: bool = False) -> dict:
        """Blocking capture of `ms` milliseconds of live traffic. → the
        manifest document (schema trivy-tpu-profile/1, manifest path
        under `manifest`, the kernels seen and the card's busy ms).
        Raises ProfilerBusy / ProfilerCooldown when not admitted, and
        NoDeviceEvents when a capture on the card saw no kernel."""
        ms = min(max(float(ms), 1.0), self.MAX_MS)
        self._admit(force)
        try:
            from .recorder import RECORDER
            device = self.device
            started_unix = time.time()
            slug = _SLUG_RE.sub("-", reason)[:48] or "manual"
            name = "profile-{}-{}-{}".format(
                time.strftime("%Y%m%dT%H%M%S",
                              time.gmtime(started_unix)),
                slug, next(self._seq))
            out_dir = os.path.join(RECORDER.incident_dir, name)
            os.makedirs(out_dir, exist_ok=True)
            import torch

            def record():
                t0 = time.perf_counter()
                prof = torch.profiler.profile(
                    activities=_activities(device))
                prof.start()
                try:
                    time.sleep(ms / 1e3)
                finally:
                    prof.stop()
                return prof, (time.perf_counter() - t0) * 1e3
            with self._lock:
                runner = self._runner
            prof, duration_ms = runner(record) if runner else record()
            summary = self._finish(prof, out_dir, device)
            files = []
            for root, _dirs, names in os.walk(out_dir):
                for n in names:
                    files.append(os.path.relpath(
                        os.path.join(root, n), out_dir))
            doc = {
                "schema": self.SCHEMA,
                "reason": reason,
                "requested_ms": ms,
                "duration_ms": round(duration_ms, 1),
                "started_unix": round(started_unix, 3),
                "artifact_dir": out_dir,
                "files": sorted(files),
                "pid": os.getpid(),
                "device": device,
                **summary,
            }
            manifest = out_dir + ".json"
            tmp = manifest + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, manifest)
            doc["manifest"] = manifest
            # metric label clamped to the documented closed set: the
            # free-form reason (operator-supplied via ?reason=) lives
            # in the manifest only — unbounded label values would mint
            # permanent series in the registry
            label = reason.split(":", 1)[0]
            if label not in ("manual", "slo_burn", "cli"):
                label = "other"
            METRICS.inc("trivy_tpu_profile_captures_total",
                        reason=label)
            return doc
        finally:
            self._release()

    @contextlib.contextmanager
    def capture_dir(self, out_dir: str, device: str | None = None):
        """The CLI --profile-dir path: profile the enclosed work into
        a caller-chosen directory under the same one-at-a-time
        exclusivity (no cooldown — an operator-requested CLI run is
        never rate-limited). Writes trace.json (Chrome trace) and
        manifest.json (trivy-tpu-profile/1, with the kernels seen and
        the card's busy ms over the capture)."""
        device = device or self.device
        self._admit(force=True)
        try:
            import torch
            os.makedirs(out_dir, exist_ok=True)
            started_unix = time.time()
            t0 = time.perf_counter()
            prof = torch.profiler.profile(activities=_activities(device))
            prof.start()
            try:
                yield out_dir
            finally:
                prof.stop()
            duration_ms = (time.perf_counter() - t0) * 1e3
            summary = self._finish(prof, out_dir, device)
            doc = {"schema": self.SCHEMA, "reason": "cli",
                   "requested_ms": round(duration_ms, 1),
                   "duration_ms": round(duration_ms, 1),
                   "started_unix": round(started_unix, 3),
                   "artifact_dir": out_dir, "files": ["trace.json"],
                   "pid": os.getpid(), "device": device, **summary}
            with open(os.path.join(out_dir, "manifest.json"), "w") as f:
                json.dump(doc, f)
            METRICS.inc("trivy_tpu_profile_captures_total",
                        reason="cli")
        finally:
            # a failed start must release the one-at-a-time slot, or
            # the profiler is wedged busy for the process
            self._release()

    # ---- SLO auto-trigger ---------------------------------------------

    def observe_burn(self, rates: dict) -> None:
        """Called by SLO.export() with the burn_rates() document: when
        any objective's SHORT-window burn rate is at/above the
        configured threshold, start one background capture (cooldown-
        limited) so the page that burn rate fires comes with an
        actionable profile attached."""
        thr = self.auto_burn_threshold
        if not thr:
            return
        worst = None
        for name, doc in rates.items():
            windows = doc.get("windows") or {}
            if not windows:
                continue
            short = min(windows, key=lambda w: int(w.rstrip("s")))
            burn = windows[short].get("burn_rate", 0.0)
            if burn >= thr and (worst is None or burn > worst[1]):
                worst = (name, burn)
        if worst is None:
            return
        with self._lock:
            if self._active:
                return
            now = time.monotonic()
            if self._last_end and \
                    now - self._last_end < self.cooldown_s:
                return
        threading.Thread(target=self._auto_capture, args=worst,
                         name="graftprof-auto", daemon=True).start()

    def _auto_capture(self, objective: str, burn: float) -> None:
        from ..log import get as _get_logger
        log = _get_logger("perf")
        try:
            doc = self.capture(self.auto_capture_ms,
                               reason=f"slo_burn:{objective}")
        except (ProfilerBusy, ProfilerCooldown):
            return  # lost the admit race — one capture is plenty
        except Exception:
            log.exception("auto profile capture failed")
            return
        log.warning("SLO burn %.2f on %s auto-captured a device "
                    "profile: %s", burn, objective, doc["manifest"])
        from .recorder import RECORDER
        RECORDER.note_event("profile.auto", objective=objective,
                            burn=round(burn, 3),
                            artifact=doc["manifest"])

    def reset_for_tests(self) -> None:
        with self._lock:
            self._active = False
            self._last_end = 0.0
            self.cooldown_s = 30.0
            self.auto_burn_threshold = 0.0
            self.auto_capture_ms = 2000.0
            self.device = "cuda"


PROF = Profiler()


# ---------------------------------------------------------------------------
# /debug HTTP payloads — shared by the scan server and the fleet
# router, like recorder.debug_traces_payload

def debug_perf_payload() -> dict:
    """Payload for GET /debug/perf: the per-shape dispatch-ledger
    table, process totals, and the memory view."""
    return {
        "pid": os.getpid(),
        "shapes": LEDGER.shape_table(),
        "totals": LEDGER.aggregate(),
        "memory": LEDGER.memory_status(),
    }


def debug_profile_payload(path: str) -> tuple[int, dict]:
    """Handle GET /debug/profile?ms=N[&reason=...]: run one blocking
    capture against live traffic. → (http_code, json_payload); 409
    while another capture runs, 429 + retry_after_s inside the
    cooldown (the endpoint is already token-gated by the caller)."""
    import math
    import urllib.parse
    q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
    try:
        ms = float((q.get("ms") or ["500"])[0])
    except ValueError:
        return 400, {"code": "invalid_argument",
                     "msg": "ms must be a number"}
    # NaN fails BOTH range comparisons — without the isfinite check it
    # would slip through, start a capture, blow up in time.sleep, and
    # burn the cooldown window on a 500
    if not math.isfinite(ms) or ms <= 0 or ms > Profiler.MAX_MS:
        return 400, {"code": "invalid_argument",
                     "msg": f"ms must be in (0, {int(Profiler.MAX_MS)}]"}
    reason = (q.get("reason") or ["manual"])[0]
    try:
        doc = PROF.capture(ms, reason=reason)
    except ProfilerBusy as e:
        return 409, {"code": "already_exists", "msg": str(e)}
    except ProfilerCooldown as e:
        return 429, {"code": "resource_exhausted", "msg": str(e),
                     "retry_after_s": round(e.retry_after_s, 1)}
    except Exception as e:  # noqa: BLE001 — a broken profiler must
        # surface as a clean 500, never kill the handler thread
        return 500, {"code": "internal",
                     "msg": f"{type(e).__name__}: {e}"}
    return 200, doc
