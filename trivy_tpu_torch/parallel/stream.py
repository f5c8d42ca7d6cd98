"""graftstream: the advisory table streamed through a double-buffered
pair of resident hash-range slices, for tables larger than the card's
budget (the JAX package's parallel/stream.py).

The logical `AdvisoryTable` is split into S contiguous HASH-RANGE
slices (the table is hash-sorted, so a row range is a hash range). A
resident set of RESIDENT (2) uploaded slices holds the table's share
on the card, and each dispatch walks only the
slices its queries touch:

  * while the join runs against slice k, the host→device copy of the
    next touched slice is already in flight on the detector's upload
    stream (a side CUDA stream), from pinned host copies of every
    slice built when the detector is made, so a walk pays
    max(compute, transfer), not the sum;
  * each prepared CSR descriptor routes only to the slices its bucket
    interval overlaps (`clip_descriptors`): most dispatches touch one
    or two slices;
  * the per-slice results carry a slice-local → global pair map
    (`gmap`), so the merged bits, dense or `CompactBits`, are
    bit-identical to the resident join's: the predicate is elementwise
    and every pair meets the same advisory row either way.

`SliceCache.get` waits on the host for the slice's copy event (the
upload stall the dispatch ledger records as `shard_upload` waits),
makes the launching stream wait on it, and marks every uploaded tensor
as used by that stream (`record_stream`), so the caching allocator does
not hand an evicted slice's memory to a new upload while a join still
reads it; a walk also holds its slice's tensors until its synchronous
fetch has returned.

Slice planning (`plan_slices`) compares the table's `device_nbytes()`
(token vectors and flags, the JAX package's measure, so both packages
plan the same slices) with a byte budget: an explicit slice count,
else `device_budget_mb`, else BUDGET_FRACTION of the card's memory
(the dispatch ledger's memory view). A table that fits never engages:
the resident BatchDetector serves it unchanged. Each uploaded slice
also carries its own prefix planes (ops.join.prefix_planes of the
PADDED slice), which the kernel reads; `slice_device_nbytes` counts
them. The pinned host copies hold the whole table and its planes in
page-locked host memory for the detector's lifetime.

The device code is the unchanged join kernels (ops.join →
csrc/csr_join.cu) fed slice-shaped operands; on the CPU the same walk
runs their plain versions over host tensors. There is no host join: a
failed upload, launch or fetch raises and fails the requests the
dispatch carried. Not ported: the mesh's streamed walk (ROADMAP A11).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..detect import feed as _feed
from ..detect.engine import (_PAIR_FLOOR, _PAIR_GROWTH, BatchDetector,
                             CompactBits, _StagedMerged)
from ..log import get as _get_logger
from ..metrics import METRICS
from ..obs import note_dispatch, span
from ..obs.perf import LEDGER
from ..ops import bucket_size
from ..ops import join as J
from ..resilience import blameless_active

_log = _get_logger("stream")

_MiB = 1 << 20

# the auto budget's share of the card's memory (headroom for the version
# pool, the dispatch operands and the transient third slice while an
# eviction drains)
BUDGET_FRACTION = 0.35
# the double buffer: slices kept uploaded
RESIDENT = 2


@dataclass
class StreamOptions:
    """graftstream knobs (server flags --table-device-budget-mb,
    --table-stream-slices; trivy.yaml mesh.*). Streaming engages only
    when the table's device footprint exceeds the budget (or `slices`
    forces a count). detectd's prefetch peek is SchedOptions.prefetch
    (--[no-]stream-prefetch); the in-walk double buffer is
    unconditional."""
    device_budget_mb: float = 0.0  # budget for resident slices; 0 = auto
    slices: int = 0                # explicit slice count


def hbm_budget_bytes(fraction: float, device=None) -> int:
    """The auto budget: `fraction` of the smallest card's memory in the
    dispatch ledger's memory view, sampled from `device` first when the
    view is empty (a detector is built before any dispatch). 0 on the
    CPU, which has no memory view: streaming then engages only through
    an explicit budget or slice count."""
    def limits():
        backends = LEDGER.memory_status().get("backends") or {}
        return [b.get("bytes_limit", 0) for b in backends.values()
                if b.get("bytes_limit")]
    got = limits()
    if not got:
        LEDGER.sample_memory(device, force=True)
        got = limits()
    if not got:
        return 0
    return int(min(got) * fraction)


def plan_slices(table, opts: StreamOptions | None,
                device=None) -> np.ndarray | None:
    """→ int64[S+1] contiguous row bounds (equal hash-range slices of
    the sorted table), or None when streaming should not engage (the
    table fits the budget, or no budget source is configured).
    `device` is the card whose memory the auto budget reads."""
    if opts is None or len(table) == 0:
        return None
    dev_bytes = table.device_nbytes()
    if opts.slices > 0:
        n = opts.slices
    else:
        budget = int(opts.device_budget_mb * _MiB)
        if not budget:
            budget = hbm_budget_bytes(BUDGET_FRACTION, device)
        if not budget:
            return None
        per_slice = max(budget // RESIDENT, 1)
        n = -(-dev_bytes // per_slice)
    n = max(1, min(int(n), len(table)))
    if n <= 1:
        return None
    return slice_bounds(len(table), n)


def slice_bounds(n_rows: int, n_slices: int) -> np.ndarray:
    """Equal-row contiguous slice bounds over the hash-sorted table:
    int64[S+1] with bounds[k] ≤ bounds[k+1], covering [0, n_rows)."""
    return (np.arange(n_slices + 1, dtype=np.int64)
            * n_rows // n_slices)


# ---------------------------------------------------------------------------
# CSR descriptor routing: clip each query's bucket interval to the
# slices it overlaps

@dataclass
class SlicePlan:
    """One slice's share of a dispatch: slice-LOCAL CSR descriptors
    plus the map from slice-local pair offsets back to the dispatch's
    global pair index space (contiguous per clipped piece: both sides
    are hash-sorted, so a bucket's rows inside one slice are one
    contiguous run)."""
    idx: int
    q_start: np.ndarray   # int32[n] slice-local bucket starts
    q_count: np.ndarray   # int32[n]
    q_ver: np.ndarray     # int32[n]
    total: int            # true pair count in this slice
    gmap: np.ndarray      # int64[total] slice-local pair → global pair


def clip_descriptors(bounds: np.ndarray, q_start: np.ndarray,
                     q_count: np.ndarray,
                     q_ver: np.ndarray) -> list[SlicePlan]:
    """Route prepared CSR descriptors (global advisory-row intervals,
    zero-count padding allowed) to the hash-range slices they overlap.
    → SlicePlans for exactly the touched slices, in ascending slice
    order. The union of all plans' gmaps is a permutation of
    [0, total): every global pair lands in exactly one slice."""
    nz = q_count > 0
    starts = q_start[nz].astype(np.int64)
    counts = q_count[nz].astype(np.int64)
    vers = q_ver[nz]
    g_off = np.zeros(starts.size + 1, np.int64)
    np.cumsum(counts, out=g_off[1:])
    ends = starts + counts
    plans: list[SlicePlan] = []
    if starts.size == 0:
        return plans
    # only slices the dispatch's hash span can touch: the descriptors
    # are not sorted by row (query order rules), so use min/max
    k_lo = int(np.searchsorted(bounds, starts.min(), "right")) - 1
    k_hi = int(np.searchsorted(bounds, ends.max() - 1, "right")) - 1
    for k in range(max(k_lo, 0), min(k_hi, bounds.size - 2) + 1):
        r0, r1 = int(bounds[k]), int(bounds[k + 1])
        lo = np.maximum(starts, r0)
        hi = np.minimum(ends, r1)
        m = lo < hi
        if not m.any():
            continue
        cnt = hi[m] - lo[m]
        goff = g_off[:-1][m] + (lo[m] - starts[m])
        total = int(cnt.sum())
        loff = np.zeros(cnt.size, np.int64)
        np.cumsum(cnt[:-1], out=loff[1:])
        gmap = np.repeat(goff - loff, cnt) \
            + np.arange(total, dtype=np.int64)
        plans.append(SlicePlan(
            idx=k, q_start=(lo[m] - r0).astype(np.int32),
            q_count=cnt.astype(np.int32), q_ver=vers[m],
            total=total, gmap=gmap))
    return plans


def touched_slices(bounds: np.ndarray, q_start: np.ndarray,
                   q_count: np.ndarray) -> list[int]:
    """Which hash-range slices would a dispatch over these CSR
    descriptors touch? clip_descriptors' interval math without any
    SlicePlan, so detectd's admission peek can ask cheaply for requests
    it has not merged yet. → ascending slice indices."""
    nz = q_count > 0
    if not nz.any():
        return []
    starts = q_start[nz].astype(np.int64)
    ends = starts + q_count[nz].astype(np.int64)
    n = int(bounds.size - 1)
    lo = np.clip(np.searchsorted(bounds, starts, "right") - 1,
                 0, n - 1)
    hi = np.clip(np.searchsorted(bounds, ends - 1, "right") - 1,
                 0, n - 1)
    mark = np.zeros(n, bool)
    for a, b in np.unique(np.stack([lo, hi], axis=1), axis=0):
        mark[int(a):int(b) + 1] = True
    return [int(k) for k in np.nonzero(mark)[0]]


def merge_slice_bits(results: list, t_pad: int):
    """Concat-merge per-slice results into ONE dispatch result in the
    caller's global pair order. `results` is [(SlicePlan, bits)] where
    bits is a dense int8 vector (slice-local, padded) or a slice-local
    CompactBits. All-compact inputs merge into one global CompactBits
    (one stable argsort: per-slice hit lists interleave across
    queries); any dense input materializes the global dense vector.
    Either shape is downstream-identical (slice_bits/_assemble)."""
    if any(not isinstance(b, CompactBits) for _p, b in results):
        out = np.zeros(t_pad, np.int8)
        for plan, bits in results:
            if isinstance(bits, CompactBits):
                out[plan.gmap[bits.pair_idx]] = bits.bits
            else:
                out[plan.gmap] = bits[:plan.total]
        return out
    gidx: list = []
    gbits: list = []
    for plan, cb in results:
        if cb.pair_idx.size:
            gidx.append(plan.gmap[cb.pair_idx])
            gbits.append(cb.bits)
    if not gidx:
        return CompactBits(np.zeros(0, np.int32),
                           np.zeros(0, np.int8), t_pad)
    gi = np.concatenate(gidx)
    gb = np.concatenate(gbits)
    order = np.argsort(gi, kind="stable")
    return CompactBits(gi[order].astype(np.int32), gb[order], t_pad)


# ---------------------------------------------------------------------------
# the double-buffered resident set

class _Entry:
    __slots__ = ("ready", "arrays", "error", "nbytes")

    def __init__(self):
        self.ready = threading.Event()
        self.arrays = None
        self.error: BaseException | None = None
        self.nbytes = 0


class SliceCache:
    """Double-buffered resident set of uploaded slices.

    `upload(k)` issues slice k's upload and returns (arrays, bytes
    shipped); `prefetch(k)` issues it without waiting; `get(k)` returns
    the resident operands once they are ready: `settle(arrays)` (when
    given) waits for the copy and hands the operands to the caller's
    stream. The time get() blocks is the dispatch's UPLOAD STALL,
    recorded per wait in the dispatch ledger (`shard_upload` rows), so
    the double-buffer overlap is asserted, not hoped for: after the
    first slice of a walk, every wait hits a prefetched entry.

    Eviction is LRU over READY entries once the set exceeds RESIDENT;
    an entry another thread is still uploading is never evicted. All
    shared state changes under `_lock`; uploads and blocking waits run
    outside it."""

    def __init__(self, upload, settle=None):
        self._upload = upload
        self._settle = settle
        self._lock = threading.Lock()
        self._entries: OrderedDict[int, _Entry] = OrderedDict()

    def _admit(self, k: int):
        """→ (entry, owner): under the lock, find-or-create slice k's
        entry; `owner` means the caller must perform the upload."""
        with self._lock:
            e = self._entries.get(k)
            if e is not None:
                self._entries.move_to_end(k)
                return e, False
            e = _Entry()
            self._entries[k] = e
            # evict the least-recently-used READY entry; dropping the
            # last reference frees its device buffers (a walk keeps its
            # own reference to the slice it computes on)
            while len(self._entries) > RESIDENT:
                victim = next((key for key, v in self._entries.items()
                               if key != k and v.ready.is_set()), None)
                if victim is None:
                    break
                del self._entries[victim]
            return e, True

    def _do_upload(self, k: int, e: _Entry, prefetched: bool) -> None:
        try:
            arrays, nbytes = self._upload(k)
            e.arrays = arrays
            e.nbytes = int(nbytes)
        except BaseException as exc:
            # relayed to every waiter, and re-raised: a failed upload
            # must never wedge get() forever
            e.error = exc
            with self._lock:
                self._entries.pop(k, None)
            raise
        finally:
            e.ready.set()
        LEDGER.note_shard_upload("stream", e.nbytes,
                                 prefetched=prefetched)

    def prefetch(self, k: int) -> None:
        """Issue slice k's upload without waiting (called while the
        previous slice's join computes). Advisory: a failure is logged
        and leaves no entry, so the paying get() uploads it cold."""
        e, owner = self._admit(k)
        if not owner:
            return
        try:
            self._do_upload(k, e, prefetched=True)
        except Exception:  # noqa: BLE001 — costs one cold upload
            _log.warning("slice %d prefetch failed; the dispatch "
                         "uploads it cold", k, exc_info=True)

    def get(self, k: int):
        """Resident operands for slice k, uploading cold if needed.
        Blocks until the slice is ready; the blocked time is recorded as
        this wait's upload stall (cold: the upload itself ran inside
        the wait)."""
        t0 = time.perf_counter()
        e, owner = self._admit(k)
        if owner:
            self._do_upload(k, e, prefetched=False)
        else:
            e.ready.wait()
            if e.error is not None:
                raise RuntimeError(
                    f"slice {k} upload failed: {e.error}") from e.error
        arrays = e.arrays if self._settle is None \
            else self._settle(e.arrays)
        LEDGER.note_shard_wait("stream",
                               (time.perf_counter() - t0) * 1e3,
                               cold=owner)
        return arrays

    def drop_all(self) -> None:
        with self._lock:
            self._entries.clear()

    def resident(self) -> list[int]:
        with self._lock:
            return list(self._entries)


class _Uploaded(NamedTuple):
    """One slice's operands (lo_tok, hi_tok, flags, lo_pre, hi_pre) and
    the upload stream's event after their copy (None on the CPU)."""
    tensors: tuple
    event: Any


# ---------------------------------------------------------------------------
# the single-card streaming detector

class StreamingDetector:
    """A BatchDetector whose advisory table streams through a
    double-buffered resident slice pair instead of living on the card
    whole.

    Exposes the surface detectd and the scanners call (`_prepare`,
    `stage_merged`, `dispatch_merged`, `fetch_merged`, `_assemble`,
    `_get_pool`, `detect_many`, `detect`, `prefetch_ranges`), so a
    coalesced chunk walks the touched slices ONCE, not once per
    request, and the server's table swap retires it like any other
    detector. Dispatches resolve synchronously (the walk's merge is the
    fetch); pipelining comes from detectd coalescing above it and from
    the upload/compute overlap inside each walk."""

    def __init__(self, table, opts: StreamOptions | None = None,
                 bounds: np.ndarray | None = None,
                 device: str | torch.device | None = None):
        self.table = table
        self.opts = opts or StreamOptions()
        self._inner = BatchDetector(table, device=device)
        self.device = self._inner.device
        self.bounds = bounds if bounds is not None \
            else plan_slices(table, self.opts, device=self.device)
        if self.bounds is None:
            raise ValueError(
                "StreamingDetector: streaming did not engage (the table "
                "fits the budget, or no budget is configured): use "
                "BatchDetector, or pass explicit bounds")
        self.n_slices = int(self.bounds.size - 1)
        # one padded row count for every slice: one operand shape
        self.rows_pad = max(1, int(np.diff(self.bounds).max()))
        self._cache = SliceCache(self._upload_slice, settle=self._settle)
        # padded host copies of every slice (pinned on the card's host),
        # built here, once: walks re-upload evicted slices constantly,
        # and a prefetch then only issues the copy
        self._host_slices = [self._host_slice(k)
                             for k in range(self.n_slices)]
        self._stream = None       # the upload stream, made at first use
        self._stream_lock = threading.Lock()
        kw = table.lo_tok.shape[1]
        self.slice_nbytes = self.rows_pad * (
            table.lo_tok.dtype.itemsize * kw * 2 + table.flags.dtype.itemsize)
        # what one uploaded slice holds on the card: the above plus the
        # kernel's two [rows_pad, PREFIX_TOKENS] prefix planes
        self.slice_device_nbytes = self.slice_nbytes \
            + 2 * self.rows_pad * J.PREFIX_TOKENS * table.lo_tok.dtype.itemsize
        LEDGER.note_resident("advisory_slice_resident",
                             self.slice_device_nbytes
                             * min(RESIDENT, self.n_slices))

    def _host_slice(self, k: int) -> tuple:
        """Slice k's padded host columns and prefix planes. Padding rows
        carry lo = hi = 1 and flags = 0, but no pair ever references
        them: clipped descriptors cover real rows only."""
        t = self.table
        r0, r1 = int(self.bounds[k]), int(self.bounds[k + 1])
        n = r1 - r0
        kw = t.lo_tok.shape[1]
        lo = np.ones((self.rows_pad, kw), t.lo_tok.dtype)
        hi = np.ones((self.rows_pad, kw), t.hi_tok.dtype)
        fl = np.zeros(self.rows_pad, t.flags.dtype)
        lo[:n] = t.lo_tok[r0:r1]
        hi[:n] = t.hi_tok[r0:r1]
        fl[:n] = t.flags[r0:r1]
        lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
        cols = (lo_t, hi_t, torch.from_numpy(fl),
                *J.prefix_planes(lo_t, hi_t))
        if self.device.type == "cuda":
            cols = tuple(c.pin_memory() for c in cols)
        return cols

    def _upload_stream(self):
        with self._stream_lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            return self._stream

    def _upload_slice(self, k: int):
        """The SliceCache upload hook: on the card, non_blocking copies
        of the pinned host columns on the upload stream and an event
        after them; on the CPU the host tensors are the operands."""
        host = self._host_slices[k]
        nbytes = sum(c.numel() * c.element_size() for c in host)
        if self.device.type != "cuda":
            return _Uploaded(host, None), nbytes
        stream = self._upload_stream()
        with torch.cuda.stream(stream):
            dev = tuple(c.to(self.device, non_blocking=True) for c in host)
            event = torch.cuda.Event()
            event.record(stream)
        return _Uploaded(dev, event), nbytes

    def _settle(self, up: _Uploaded) -> tuple:
        """The SliceCache settle hook: wait on the host for the copy
        (the upload stall), make the launching (current) stream wait on
        it, and mark the tensors as used by that stream."""
        if up.event is not None:
            up.event.synchronize()
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(up.event)
            for t in up.tensors:
                t.record_stream(stream)
        return up.tensors

    def close(self) -> None:
        """Join the inner engine's fetch thread and drop the resident
        slices (idempotent)."""
        self._cache.drop_all()
        self._inner.close()

    # ---- scheduler surface (detectd routes through these) --------------

    @property
    def _get_pool(self):
        return self._inner._get_pool

    def _prepare(self, queries):
        return self._inner._prepare(queries)

    def _assemble(self, prep, bits):
        return self._inner._assemble(prep, bits)

    def stage_merged(self, preps, plan=None,
                     dedup: bool | None = None) -> _StagedMerged:
        """Merge and plan a future dispatch_merged. Nothing is uploaded:
        the walk uploads each slice's clipped descriptors itself."""
        merged, launch = self._inner._launch_args(preps, plan)
        return _StagedMerged(merged, plan, launch,
                             plan is not None if dedup is None else dedup,
                             None)

    def dispatch_merged(self, preps, plan=None,
                        staged: _StagedMerged | None = None):
        """ONE logical dispatch covering several prepared batches: the
        merged descriptors (the unique ones under a dedup plan) walk the
        touched slices once, and a deduped result is scattered back to
        the full merged pair space. → (host bits, per-prep offsets,
        t_pad)."""
        if staged is None:
            staged = self.stage_merged(preps, plan)
        plan = staged.plan
        _qs, _qc, _qv, offsets, total, t_pad, u_pad = staged.merged
        ls, lc, lv, l_total, l_tpad = staged.launch
        if staged.dedup:
            _feed.note_dedup_ratio(l_total, total)
        with span("detect.dispatch", n_pairs=total, t_pad=t_pad,
                  merged=len(preps), deduped=plan is not None):
            bits = self._walk(ls, lc, lv, l_total, l_tpad, u_pad)
            if plan is not None:
                bits = _feed.expand_bits(plan, bits, t_pad)
        note_dispatch(self.device)
        return bits, offsets, t_pad

    def fetch_merged(self, dev, preps, offsets, t_pad):
        """The walk fetched synchronously: `dev` is the host bits."""
        return dev

    def warmup(self, max_pairs: int = 1 << 18) -> int:
        """Pre-touch the stream: upload the first resident slices so the
        first request's walk starts warm. The join shapes follow each
        dispatch's clip geometry, so there is no ladder to launch.
        → 0 rungs."""
        for k in range(min(RESIDENT, self.n_slices)):
            self._cache.prefetch(k)
        return 0

    def prefetch_ranges(self, q_start: np.ndarray,
                        q_count: np.ndarray) -> list[int]:
        """detectd's admission peek: warm the slices the bucket ranges
        of the requests queued behind the round just dispatched will
        touch (with SchedOptions.prefetch on). Advisory: a failure costs
        a cold upload. → the slice indices issued."""
        resident = set(self._cache.resident())
        issued: list[int] = []
        for k in touched_slices(self.bounds, q_start, q_count):
            if k in resident:
                continue
            self._cache.prefetch(k)
            issued.append(k)
            # never churn more than one resident set: a peek spanning
            # the whole table must not evict what the current walk needs
            if len(issued) >= RESIDENT:
                break
        return issued

    # ---- the slice walk ------------------------------------------------

    def _walk(self, q_start, q_count, q_ver, total: int, t_pad: int,
              u_pad: int):
        """Join these descriptors slice by slice → int8[t_pad] or
        CompactBits host bits, equal to the resident join's."""
        if total == 0:
            return np.zeros(t_pad, np.int8)
        plans = clip_descriptors(self.bounds, q_start, q_count, q_ver)
        if not plans:
            return np.zeros(t_pad, np.int8)
        site = "redetect" if blameless_active() else "stream"
        results: list = []
        for i, plan in enumerate(plans):
            adv = self._cache.get(plan.idx)
            # double buffer: the next touched slice's upload rides
            # alongside this slice's join and fetch
            if i + 1 < len(plans):
                self._cache.prefetch(plans[i + 1].idx)
            results.append((plan, self._join_slice(adv, plan, u_pad,
                                                   site)))
        # tail prefetch: steady-state scans walk the same hash span
        # again, so ship the walk's first slice back into the freed
        # buffer before the next dispatch needs it
        if len(plans) > 1 or plans[0].idx not in self._cache.resident():
            self._cache.prefetch(plans[0].idx)
        # one traffic observation per logical dispatch; the ledger
        # carries the per-slice launches
        self._inner._account_traffic(
            total, sum(self._slice_tpad(p) for p in plans), warm=False)
        return merge_slice_bits(results, t_pad)

    @staticmethod
    def _slice_tpad(plan: SlicePlan) -> int:
        return bucket_size(plan.total, _PAIR_FLOOR, _PAIR_GROWTH)

    def _join_slice(self, adv: tuple, plan: SlicePlan, u_pad: int,
                    site: str):
        """One slice's launch and synchronous fetch through the resident
        detector's own launch and fetch, on the slice's operands and
        prefix planes. → dense int8[t_pad_k] or slice-local
        CompactBits."""
        n = plan.q_start.size
        cols = np.zeros((3, bucket_size(n, 64, _PAIR_GROWTH, align=64)),
                        np.int32)
        cols[0, :n] = plan.q_start
        cols[1, :n] = plan.q_count
        cols[2, :n] = plan.q_ver
        inner = self._inner
        return inner._fetch_bits(inner._launch(
            cols[0], cols[1], cols[2], n, plan.total,
            self._slice_tpad(plan), u_pad, site=site, adv=adv))

    def _bits(self, prep):
        return self._walk(prep.q_start, prep.q_count, prep.q_ver,
                          prep.n_pairs, prep.t_pad, prep.u_pad)

    # ---- direct detection ----------------------------------------------

    def detect_many(self, batches) -> list:
        """Per batch: prep → slice walk → assemble."""
        inner = self._inner
        out = []
        n_queries = n_pairs = n_hits = 0
        for qs in batches:
            if not qs or len(inner.table) == 0:
                out.append([])
                continue
            n_queries += len(qs)
            prep = inner._prepare(qs)
            if prep is None or prep.n_pairs == 0:
                out.append([])
                continue
            n_pairs += prep.n_pairs
            with span("detect.dispatch", n_pairs=prep.n_pairs,
                      t_pad=prep.t_pad):
                bits = self._bits(prep)
            note_dispatch(self.device)
            hits = inner._assemble(prep, bits)
            n_hits += len(hits)
            out.append(hits)
        METRICS.inc("trivy_tpu_detect_queries_total", n_queries)
        METRICS.inc("trivy_tpu_detect_pairs_total", n_pairs)
        METRICS.inc("trivy_tpu_detect_hits_total", n_hits)
        return out

    def detect(self, queries) -> list:
        return self.detect_many([queries])[0]

    def status(self) -> dict:
        """→ the /healthz `stream` block: the slice plan and the
        resident set."""
        return {
            "slices": self.n_slices,
            "rows_pad": self.rows_pad,
            "slice_nbytes": self.slice_nbytes,
            "slice_device_nbytes": self.slice_device_nbytes,
            "resident": self._cache.resident(),
        }
