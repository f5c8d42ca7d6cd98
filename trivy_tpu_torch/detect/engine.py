"""BatchDetector: host orchestration around the CUDA advisory join.

Per batch:
  host:   queries are encoded against two memo pools — unique
          (ecosystem, version) → token-vector row, unique (source, name)
          → fnv1a64 — and each query's bucket is located with one
          vectorized np.searchsorted pair over the table's sorted uint64
          hashes. Queries with empty buckets are dropped; the rest become
          [Q] CSR descriptors (bucket start, count, version row).
  device: the descriptors go up, the join kernel expands them to pair
          slots, evaluates the version-interval predicate and, when a
          hit buffer pays for itself, squeezes the hits into it in the
          same kernel (ops/join.py).
          One .cpu() brings back the O(hits) triple; the dense bits come
          back only when the hit buffer overflowed.
  host:   numpy group-by over the reported pairs — package-name
          verification (hash-collision guard), positive minus negative
          polarity per advisory group, exact re-check of INEXACT rows.

The reference evaluates the same predicate one package at a time
(pkg/detector/ospkg/alpine/alpine.go:86-117). Host prep and assembly
follow the JAX package's detect/engine.py so both produce the same
hits from the same table.

One detector serves every handler thread of the server: the version
pool, the hash cache, the hit budget and the group columns are guarded
by one lock. detectd (detect/sched.py) merges several threads' prepared
batches into one launch (dispatch_merged), with its query columns
staged ahead on a side stream (stage_merged, detect/feed.py), and
fetches it on the detector's fetch thread (fetch_merged). There is no
host join: a failed launch or fetch raises.

Instrumentation follows the JAX package's engine: graftscope spans
(detect.prepare, detect.dispatch, detect.compile on the first launch of
a (t_pad, h_cap) shape, detect.assemble, and under `--trace` the
fenced detect.device_fence / detect.device_wait), the detect series of
METRICS, the dispatch ledger (obs/perf.py) and the cost charges
(obs/cost.py). Nothing here synchronizes with the card outside the
fetch, except the fence of a recorded (`--trace`) run, which trades the
overlap for attribution as the JAX package's traced path does.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import version as V
from ..db.table import AdvisoryTable
from ..device import resolve_device
from ..metrics import METRICS
from ..obs import SLO, note_dispatch, recording, span
from ..obs import cost as _cost
from ..obs.perf import LEDGER, stamp_table_resident
from ..ops import bucket_ladder, bucket_size
from ..ops import join as J
from ..ops import next_pow2 as _next_pow2
from ..ops.hashing import fnv1a64_batch
from ..resilience import blameless_active

# hit-buffer budget: the fraction of a dispatch's padded pairs the
# compaction buffer is sized for, adapted by powers of two from observed
# occupancy (an overflow doubles it, a streak of <25%-full buffers
# halves it). Past t_pad/8 a 5-byte hit slot stops beating the 1-byte
# dense fetch, so such dispatches stay dense.
_HIT_BUDGET_INIT = 1.0 / 32
_HIT_BUDGET_MIN = 1.0 / 1024
_HIT_BUDGET_MAX = 0.25
_HIT_LOW_STREAK = 8
# smallest hit buffer, and the multiple every buffer is rounded up to
_HIT_FLOOR = 128
_HIT_ALIGN = 128
# padded pair dispatches: the JAX package's default bucket ladder
_PAIR_FLOOR = 256
_PAIR_GROWTH = 2.0


class CompactBits(NamedTuple):
    """Compacted join result: the nonzero entries of a dense int8 bits
    vector as (ascending pair index, bits), plus the dense length."""
    pair_idx: np.ndarray   # int32[n_hits], strictly increasing
    bits: np.ndarray       # int8[n_hits], all nonzero
    n_pairs: int

    def slice(self, off: int, n: int) -> "CompactBits":
        """The [off, off+n) window of the dense vector, found with one
        searchsorted over the sorted hit indices."""
        lo, hi = np.searchsorted(self.pair_idx, (off, off + n))
        return CompactBits(self.pair_idx[lo:hi] - np.int32(off),
                           self.bits[lo:hi], n)

    def dense(self) -> np.ndarray:
        """The dense int8[n_pairs] vector this stands for."""
        out = np.zeros(self.n_pairs, np.int8)
        out[self.pair_idx] = self.bits
        return out


def slice_bits(bits, off: int, n: int):
    """One batch's [off, off+n) window of a merged dispatch's result,
    dense or compacted: what a solo dispatch of that batch gives."""
    if isinstance(bits, CompactBits):
        return bits.slice(off, n)
    return bits[off:off + n]


class _PendingCompact(NamedTuple):
    """One launched compacted dispatch: device tensors for the O(hits)
    hit buffers plus the dense bits, fetched only on overflow."""
    hit_idx: Any
    hit_bits: Any
    n_hits: Any
    dense: Any
    h_cap: int
    t_pad: int
    site: str = "detect"


class _StagedMerged(NamedTuple):
    """stage_merged's product, handed back to dispatch_merged: the
    merged descriptor set, the dedup plan (or None), the descriptors
    the launch runs, whether dedup is on, and the staged query
    upload."""
    merged: tuple
    plan: Any
    launch: tuple
    dedup: bool
    queries: Any


@dataclass(slots=True)
class PkgQuery:
    source: str      # advisory bucket, e.g. "alpine 3.9"
    ecosystem: str   # version scheme key
    name: str        # join name (src package name for OS pkgs)
    version: str     # installed version (formatted, e.g. epoch:ver-rel)
    arch: str = ""   # for arch-scoped advisories (Rocky/Alma entries)
    cpe_indices: frozenset = frozenset()  # Red Hat content-set scope
    ref: Any = None  # caller's package object


class Hit(NamedTuple):
    """One detected (package, advisory-group) match."""
    query: PkgQuery
    vuln_id: str
    fixed_version: str
    status: str
    severity: str
    data_source: Optional[dict]
    vendor_ids: tuple


@dataclass
class _Prepared:
    """Host-side product of _prepare: the CSR descriptors of the
    candidate pairs. Pair slot i < n_pairs belongs to real query
    seg = searchsorted(q_offsets, i, 'right') - 1 and evaluates advisory
    row q_start[seg] + i - q_offsets[seg] (pair_owners)."""
    usable: list          # [(PkgQuery, exact_version: bool)]
    n_pairs: int          # T (pairs beyond are padding)
    t_pad: int            # pair slots of the dispatch
    u_pad: int            # version-pool rows to ship (power of two)
    q_start: np.ndarray = None   # int32[Q_pad] bucket start per query
    q_count: np.ndarray = None   # int32[Q_pad] bucket length per query
    q_ver: np.ndarray = None     # int32[Q_pad] version row per query
    n_queries: int = 0    # real (nonzero-bucket) queries in q_* arrays
    q_offsets: np.ndarray = None  # int64[n_queries] first pair slot
    q_usable: np.ndarray = None   # int64[n_queries] index into usable
    q_name: np.ndarray = None    # object[len(usable)] join names
    q_source: np.ndarray = None  # object[len(usable)] advisory sources
    q_exact: np.ndarray = None   # bool[len(usable)] exact-version keys
    q_obj: np.ndarray = None     # object[len(usable)] the PkgQuery objs


def launch_join(adv, ver_dev, qs, qc, qv, total: int, t_pad: int,
                h_cap: int, site: str = "detect"):
    """The kernel half of a launch: the join of the [Q] descriptors
    (qs, qc, qv) against `adv` (lo_tok, hi_tok, flags, lo_pre, hi_pre),
    compacted into an h_cap hit buffer when h_cap > 0, on the operands'
    device (the kernel on a GPU, the plain version on the CPU). → a
    _PendingCompact, else the dense int8[t_pad] bits tensor."""
    adv_lo, adv_hi, adv_flags, lo_pre, hi_pre = adv
    args = (adv_lo, adv_hi, adv_flags, ver_dev, qs, qc, qv, total)
    if h_cap:
        hit_idx, hit_bits, n_hits, dense = J.csr_pair_join_compact(
            *args, t_pad, h_cap, prefix=(lo_pre, hi_pre))
        return _PendingCompact(hit_idx, hit_bits, n_hits, dense, h_cap,
                               t_pad, site)
    return J.csr_pair_join(*args, t_pad, prefix=(lo_pre, hi_pre))


class BatchDetector:
    def __init__(self, table: AdvisoryTable,
                 device: str | torch.device | None = None):
        self.table = table
        self.device = resolve_device(device)
        stamp_table_resident(table)
        self._hit_budget = _HIT_BUDGET_INIT
        self._hit_low_streak = 0
        self._hit_dense_streak = 0
        kw = table.lo_tok.shape[1] if len(table) else V.KEY_WIDTH
        # version pool: unique (eco, version) → row in _ver_mat
        self._ver_idx: dict[tuple[str, str], Optional[int]] = {}
        self._ver_mat = np.zeros((256, kw), np.int32)
        self._ver_exact: list[bool] = []
        self._ver_count = 0
        self._ver_dev = None       # device copy of the pool
        self._ver_dev_rows = 0     # pool rows covered by the copy
        # hash pool: unique (source, name) → uint64
        self._hash_cache: dict[tuple[str, str], int] = {}
        # guards the pools, the hit budget and the group columns: the
        # server's handler threads share one detector
        self._lock = threading.Lock()
        self._g_arrays = None
        self._g_cols = None
        self._closed = False
        # launch shapes (t_pad, h_cap) met so far: the first launch of
        # each is the "compile" the ledger and the spans account
        self._seen_shapes: set = set()
        # one fetch thread for detectd's merged dispatches (one thread
        # keeps the transfers in launch order)
        self._get_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="detect-get")

    def close(self) -> None:
        """Join the fetch thread. Idempotent; every owner that retires a
        detector (the server's table swap and shutdown) calls it."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._get_pool.shutdown(wait=True)

    # ---- memo pools ---------------------------------------------------

    def _ver_index(self, eco: str, ver: str) -> Optional[int]:
        ck = (eco, ver)
        idx = self._ver_idx.get(ck, -1)
        if idx != -1:
            return idx
        try:
            k = V.encode_version(eco, ver)
        except (ValueError, KeyError):
            # the reference skips packages whose installed version does
            # not parse (alpine.go:96-100 logs debug and continues)
            with self._lock:
                self._ver_idx[ck] = None
            return None
        from ..db.constraints import _NPM_ECOS, _has_prerelease
        if eco in _NPM_ECOS and _has_prerelease(ver):
            # node-semver prerelease rule: interval tokens cannot express
            # it, so the exact host recheck decides
            k.exact = False
        with self._lock:
            idx = self._ver_idx.get(ck, -1)
            if idx != -1:   # another thread took the slot first
                return idx
            i = self._ver_count
            if i == self._ver_mat.shape[0]:
                self._ver_mat = np.concatenate(
                    [self._ver_mat, np.zeros_like(self._ver_mat)])
            self._ver_mat[i] = k.tokens
            self._ver_exact.append(k.exact)
            self._ver_count = i + 1
            self._ver_idx[ck] = i
        return i

    def _hashes(self, keys: list[tuple[str, str]]) -> np.ndarray:
        """→ uint64[len(keys)], hashing cold keys once."""
        cache = self._hash_cache
        cold = list({ck for ck in keys if ck not in cache})
        if cold:
            hv = fnv1a64_batch(
                [s.encode() + b"\x00" + n.encode() for s, n in cold])
            with self._lock:
                cache.update(zip(cold, hv))
        return np.fromiter((cache[ck] for ck in keys),
                           dtype=np.uint64, count=len(keys))

    def ver_snapshot(self, u_pad: int | None = None) -> np.ndarray:
        """Padded host snapshot of the version pool (rows beyond the
        pool are zero and never referenced)."""
        with self._lock:
            return self._ver_snapshot_locked(u_pad)

    def _ver_snapshot_locked(self, u_pad: int | None = None) -> np.ndarray:
        rows = max(u_pad or 0, _next_pow2(self._ver_count))
        snap = np.zeros((rows, self._ver_mat.shape[1]), np.int32)
        snap[:self._ver_count] = self._ver_mat[:self._ver_count]
        return snap

    def _ver_device(self, u_pad: int) -> torch.Tensor:
        """Device copy of the version pool, re-uploaded only when the
        pool outgrew the last upload. A launch keeps the tensor it was
        handed: a later re-upload binds a new one, and the caching
        allocator reuses the old memory only for work enqueued after
        that launch on the same stream."""
        with self._lock:
            if self._ver_dev is None \
                    or self._ver_dev_rows < self._ver_count \
                    or self._ver_dev.shape[0] < u_pad:
                snap = self._ver_snapshot_locked(u_pad)
                self._ver_dev = torch.from_numpy(snap).to(self.device)
                self._ver_dev_rows = self._ver_count
                LEDGER.note_resident("version_pool", snap.nbytes)
            return self._ver_dev

    # ---- batch pipeline -----------------------------------------------

    def _prepare(self, queries: list[PkgQuery]) -> Optional[_Prepared]:
        """One graftscope span per batch around _prepare_impl, with the
        padding it will cost."""
        with span("detect.prepare", queries=len(queries)) as sp:
            prep = self._prepare_impl(queries)
            if prep is not None and prep.n_pairs:
                sp.attrs.update(n_pairs=prep.n_pairs, t_pad=prep.t_pad,
                                pad_waste=prep.t_pad - prep.n_pairs)
            return prep

    def _prepare_impl(self, queries: list[PkgQuery]
                      ) -> Optional[_Prepared]:
        t = self.table
        usable: list[tuple[PkgQuery, bool]] = []
        ver_rows: list[int] = []
        for q in queries:
            vi = self._ver_index(q.ecosystem, q.version)
            if vi is not None:
                usable.append((q, self._ver_exact[vi]))
                ver_rows.append(vi)
        if not usable:
            return None
        hashes = self._hashes([(q.source, q.name) for q, _ in usable])
        start = np.searchsorted(t.hash_u64, hashes, side="left")
        end = np.searchsorted(t.hash_u64, hashes, side="right")
        counts = end - start
        nz = np.nonzero(counts)[0]
        if nz.size == 0:
            return _Prepared(usable, 0, 0, 0)
        counts_nz = counts[nz]
        offsets = np.zeros(nz.size + 1, np.int64)
        np.cumsum(counts_nz, out=offsets[1:])
        n_pairs = int(offsets[-1])
        ver_arr = np.asarray(ver_rows, np.int32)
        t_pad = bucket_size(n_pairs, _PAIR_FLOOR, _PAIR_GROWTH)
        # CSR descriptors, padded with empty buckets at the tail
        q_pad = bucket_size(nz.size, 64, _PAIR_GROWTH, align=64)
        q_start = np.zeros(q_pad, np.int32)
        q_start[:nz.size] = start[nz]
        q_count = np.zeros(q_pad, np.int32)
        q_count[:nz.size] = counts_nz
        J.check_csr_descriptors(q_count, int(nz.size))
        q_ver = np.zeros(q_pad, np.int32)
        q_ver[:nz.size] = ver_arr[nz]
        q_obj = np.empty(len(usable), dtype=object)
        q_obj[:] = [q for q, _ in usable]
        return _Prepared(usable, n_pairs, t_pad,
                         _next_pow2(self._ver_count),
                         q_start=q_start, q_count=q_count, q_ver=q_ver,
                         n_queries=int(nz.size), q_offsets=offsets[:-1],
                         q_usable=nz.astype(np.int64),
                         q_name=np.array([q.name for q, _ in usable],
                                         dtype=object),
                         q_source=np.array([q.source for q, _ in usable],
                                           dtype=object),
                         q_exact=np.fromiter((e for _, e in usable), bool,
                                             count=len(usable)),
                         q_obj=q_obj)

    def _hit_capacity(self, t_pad: int,
                      budget: float | None = None) -> int:
        """Hit-buffer rung for a t_pad-pair dispatch: the bucket-ladder
        rung covering t_pad × hit-budget. 0 — dispatch dense — when
        compaction could not beat the dense fetch. While the budget (not
        the geometry) keeps dispatches dense, a streak counter walks it
        back down so compaction is retried. A given `budget` (warmup's
        neighbouring rungs) is read without adapting anything."""
        adapt = budget is None
        if adapt:
            with self._lock:
                budget = self._hit_budget
        cap = bucket_size(max(int(t_pad * budget), _HIT_FLOOR),
                          _HIT_FLOOR, _PAIR_GROWTH, align=_HIT_ALIGN)
        if cap * 8 < t_pad:
            if adapt:
                with self._lock:
                    self._hit_dense_streak = 0
            return cap
        floor_cap = bucket_size(_HIT_FLOOR, _HIT_FLOOR, _PAIR_GROWTH,
                                align=_HIT_ALIGN)
        if adapt and budget > _HIT_BUDGET_MIN and floor_cap * 8 < t_pad:
            adapted = False
            with self._lock:
                self._hit_dense_streak += 1
                if self._hit_dense_streak >= _HIT_LOW_STREAK:
                    self._hit_budget = max(self._hit_budget / 2,
                                           _HIT_BUDGET_MIN)
                    self._hit_dense_streak = 0
                    adapted = True
            if adapted:
                LEDGER.note_budget_adapt("down")
        return 0

    def _note_hits(self, n_hits: int, h_cap: int, site: str = "detect",
                   t_pad: int = 0) -> None:
        """Adapt the hit budget from the observed buffer occupancy; one
        occupancy observation and one ledger fill per compacted
        dispatch."""
        METRICS.observe("trivy_tpu_detect_hit_occupancy", n_hits / h_cap)
        LEDGER.note_hits(site, t_pad, h_cap, n_hits)
        adapted = None
        with self._lock:
            if n_hits > h_cap:
                self._hit_budget = min(self._hit_budget * 2,
                                       _HIT_BUDGET_MAX)
                self._hit_low_streak = 0
                adapted = "up"
            elif n_hits * 4 <= h_cap:
                self._hit_low_streak += 1
                if self._hit_low_streak >= _HIT_LOW_STREAK:
                    self._hit_budget = max(self._hit_budget / 2,
                                           _HIT_BUDGET_MIN)
                    self._hit_low_streak = 0
                    adapted = "down"
            else:
                self._hit_low_streak = 0
        if adapted:
            LEDGER.note_budget_adapt(adapted)

    def _note_shape(self, t_pad: int, h_cap: int) -> bool:
        """→ whether this is the first launch of (t_pad, h_cap) on this
        detector (counted in trivy_tpu_detect_compiles_total)."""
        key = (t_pad, h_cap)
        with self._lock:
            new_shape = key not in self._seen_shapes
            if new_shape:
                self._seen_shapes.add(key)
        if new_shape:
            METRICS.inc("trivy_tpu_detect_compiles_total")
        return new_shape

    @staticmethod
    def _account_traffic(n_pairs: int, t_pad: int, warm: bool) -> None:
        """Per-launch traffic series: one batch and one occupancy
        observation per accepted launch (a merged dispatch is one);
        warmup launches are not traffic."""
        if warm:
            return
        METRICS.inc("trivy_tpu_detect_batches_total")
        SLO.observe_join(True)
        if t_pad:
            METRICS.observe("trivy_tpu_batch_occupancy_ratio",
                            n_pairs / t_pad)

    def _launch(self, q_start: np.ndarray, q_count: np.ndarray,
                q_ver: np.ndarray, n_queries: int, total: int, t_pad: int,
                u_pad: int, h_cap: int | None = None, warm: bool = False,
                site: str = "detect", staged=None, adv=None):
        """Upload the [Q] descriptors and launch the join (asynchronous
        on a GPU). → a _PendingCompact when the hit buffer engages, else
        the dense int8[t_pad] bits tensor.

        `staged` (feed.StagedQueries) carries query columns copied ahead
        on the side stream; without one they are copied here, inline
        (the cold path, ledgered as such). A staging error is raised
        here. `site` attributes the launch in the ledger ("detect" per
        request, "detectd" for merged dispatches, "stream" for a
        streamed slice, "redetect" for any launch under
        resilience.blameless()); `warm` marks warmup
        launches, which are not traffic.

        `adv` (lo_tok, hi_tok, flags, lo_pre, hi_pre) replaces the
        table's resident operands: a streamed table's slice
        (parallel/stream.py), whose walk observes its dispatch's
        traffic once, so a slice launch adds no traffic series.

        The kernel call is `launch_join`, the accounting `_accounted`:
        the mesh (parallel/mesh.py) shares both halves, with one
        accounted region around all of its cells' launches."""
        J.check_csr_descriptors(q_count, n_queries)
        if h_cap is None:
            h_cap = self._hit_capacity(t_pad)
        if blameless_active():
            # redetectd's sweep: its launches stand apart from live ones
            # in the dispatch ledger and the cost ledger
            site = "redetect"
        if staged is not None and staged.error is not None:
            raise staged.error
        t_watch = time.perf_counter()
        resident = adv is None
        if resident:
            adv = self.table.device_arrays(self.device)
        ver_dev = self._ver_device(u_pad)
        if staged is not None:
            qs, qc, qv = staged.take()
        else:
            from . import feed as _feed
            t_up = time.perf_counter()
            qs, qc, qv = _feed.upload_queries(q_start, q_count, q_ver,
                                              self.device)
            LEDGER.note_shard_wait("query_upload",
                                   (time.perf_counter() - t_up) * 1e3,
                                   cold=True)
        return self._accounted(
            lambda: launch_join(adv, ver_dev, qs, qc, qv, total, t_pad,
                                h_cap, site),
            site, total, t_pad, h_cap, t_watch, warm=warm,
            traffic=resident)

    def _accounted(self, run, site: str, real: int, t_pad: int,
                   h_cap: int, t_watch: float, warm: bool = False,
                   traffic: bool = True):
        """The accounting half of a launch around `run()`, which makes
        the launch (or, for the mesh, all its cells' launches) and
        whose value passes through: the first launch of a (t_pad,
        h_cap) shape is the ledger's "compile" (its host wall, the
        kernel library's load or build on the first of all, spanned as
        detect.compile), one dispatch row, one traffic observation when
        `traffic` (not for a streamed slice, whose walk observes its
        dispatch once), and the host wall since `t_watch` charged as
        device ms (obs/cost.py)."""
        new_shape = self._note_shape(t_pad, h_cap)
        if new_shape:
            with span("detect.compile", t_pad=t_pad, h_cap=h_cap,
                      warm=warm):
                t0 = time.perf_counter()
                out = run()
                compile_ms = (time.perf_counter() - t0) * 1e3
            LEDGER.note_compile(site, t_pad, h_cap, compile_ms, warm=warm)
        else:
            out = run()
        if traffic:
            self._account_traffic(real, t_pad, warm)
        LEDGER.note_dispatch(site, real, t_pad, h_cap, warm=warm)
        _cost.charge_device_ms(
            site, (time.perf_counter() - t_watch) * 1e3,
            real_rows=0 if (warm or new_shape) else real)
        return out

    def _fetch_bits(self, dev):
        """Device→host fetch, the launch's sync point: its wall is
        charged as device ms to the launch's site. A _PendingCompact
        fetches only the O(hits) triple, in one transfer; when n_hits
        overflowed the buffer the dense bits follow, so results are the
        same either way."""
        if not isinstance(dev, _PendingCompact):
            t0 = time.perf_counter()
            out = dev.cpu().numpy()
            _cost.charge_device_ms("detect",
                                   (time.perf_counter() - t0) * 1e3)
            METRICS.inc("trivy_tpu_detect_transfer_bytes_total",
                        float(out.nbytes), path="dense")
            _cost.ledgered_transfer("dense", float(out.nbytes))
            return out
        t0 = time.perf_counter()
        packed = torch.cat([dev.n_hits.reshape(1).to(torch.int32),
                            dev.hit_idx,
                            dev.hit_bits.to(torch.int32)]).cpu().numpy()
        _cost.charge_device_ms(dev.site, (time.perf_counter() - t0) * 1e3)
        n = int(packed[0])
        self._note_hits(n, dev.h_cap, site=dev.site, t_pad=dev.t_pad)
        # what the hit buffers hold on the card: int32 indices, int8
        # bits and the int32 count
        compact_bytes = float(dev.h_cap * 5 + 4)
        METRICS.inc("trivy_tpu_detect_transfer_bytes_total",
                    compact_bytes, path="compact")
        _cost.ledgered_transfer("compact", compact_bytes)
        if n > dev.h_cap:
            t0 = time.perf_counter()
            bits = dev.dense.cpu().numpy()
            _cost.charge_device_ms(dev.site,
                                   (time.perf_counter() - t0) * 1e3)
            METRICS.inc("trivy_tpu_detect_transfer_bytes_total",
                        float(bits.nbytes), path="dense")
            _cost.ledgered_transfer("overflow", float(bits.nbytes))
            return bits
        hit_idx = packed[1:1 + dev.h_cap]
        hit_bits = packed[1 + dev.h_cap:].astype(np.int8)
        return CompactBits(hit_idx[:n], hit_bits[:n], dev.t_pad)

    # ---- merged dispatch (detectd) ------------------------------------

    def _merge_descriptors(self, preps: list[_Prepared]):
        """Concatenate several preps' real CSR prefixes into one
        descriptor set → (q_start, q_count, q_ver, offsets, total,
        t_pad, u_pad). Only the real (nonzero-count) prefix of each
        prep is copied: an interior zero count would shift every later
        segment."""
        total = sum(p.n_pairs for p in preps)
        q_n = sum(p.n_queries for p in preps)
        t_pad = bucket_size(total, _PAIR_FLOOR, _PAIR_GROWTH)
        q_pad = bucket_size(q_n, 64, _PAIR_GROWTH, align=64)
        q_start = np.zeros(q_pad, np.int32)
        q_count = np.zeros(q_pad, np.int32)
        q_ver = np.zeros(q_pad, np.int32)
        offsets = []
        pos = off = 0
        for p in preps:
            k = p.n_queries
            q_start[pos:pos + k] = p.q_start[:k]
            q_count[pos:pos + k] = p.q_count[:k]
            q_ver[pos:pos + k] = p.q_ver[:k]
            offsets.append(off)
            pos += k
            off += p.n_pairs
        # the shared pool only grows: the largest of the preps'
        # snapshots and the current count covers every version row
        u_pad = max(_next_pow2(self._ver_count),
                    max(p.u_pad for p in preps))
        return q_start, q_count, q_ver, offsets, total, t_pad, u_pad

    def _launch_args(self, preps: list[_Prepared], plan):
        """The merged descriptor set and what one merged dispatch
        launches: the unique descriptors under a dedup plan, every real
        pair without one (stage_merged and dispatch_merged share it so
        the two never disagree) → (merged, launch)."""
        from . import feed as _feed
        merged = self._merge_descriptors(preps)
        if plan is not None:
            launch = _feed.padded_unique(plan, _PAIR_FLOOR, _PAIR_GROWTH)
        else:
            q_start, q_count, q_ver, _offsets, total, t_pad, _u = merged
            launch = (q_start, q_count, q_ver, total, t_pad)
        return merged, launch

    def stage_merged(self, preps: list[_Prepared], plan=None,
                     dedup: bool | None = None) -> _StagedMerged:
        """Merge, and copy the query columns of a FUTURE dispatch_merged
        ahead (feed.stage_queries): detectd calls this before it parks
        on backpressure, so the copy rides the previous dispatch's
        device time. `dedup` says whether dedup is on (default: a plan
        was given). The result goes back into dispatch_merged(staged=)."""
        from . import feed as _feed
        merged, launch = self._launch_args(preps, plan)
        queries = _feed.stage_queries(launch[0], launch[1], launch[2],
                                      self.device)
        return _StagedMerged(merged, plan, launch,
                             plan is not None if dedup is None else dedup,
                             queries)

    def dispatch_merged(self, preps: list[_Prepared], plan=None,
                        staged: _StagedMerged | None = None):
        """ONE join launch covering several prepared batches, the
        primitive detectd is built on. Each prep's pairs land
        contiguously in the merged bits, so its slice [off, off +
        n_pairs) is what its solo dispatch gives: the predicate is
        elementwise.

        With a dedup `plan` (feed.plan_from_preps of these preps), the
        launch covers the unique query triples only and fetch_merged
        scatters the bits back through the plan's map; without one it
        covers every real pair. `staged` (stage_merged of these preps)
        brings its plan and its staged query columns; without it the
        columns are copied inline. → (pending result, per-prep offsets,
        t_pad), the offsets and t_pad in the full merged pair space
        either way."""
        from . import feed as _feed
        if staged is not None:
            merged, plan, launch = staged.merged, staged.plan, \
                staged.launch
            dedup, queries = staged.dedup, staged.queries
        else:
            merged, launch = self._launch_args(preps, plan)
            dedup, queries = plan is not None, None
        _qs, _qc, _qv, offsets, total, t_pad, u_pad = merged
        ls, lc, lv, l_total, l_tpad = launch
        if dedup:
            _feed.note_dedup_ratio(l_total, total)
        n_q = plan.n_unique if plan is not None \
            else sum(p.n_queries for p in preps)
        with span("detect.dispatch", n_pairs=total, t_pad=t_pad,
                  merged=len(preps), deduped=plan is not None):
            # one ledger row per merged dispatch, so the per-site sums
            # reconcile with the batch counter
            dev = self._launch(ls, lc, lv, n_q, l_total, l_tpad, u_pad,
                               site="detectd", staged=queries)
        note_dispatch(self.device)
        if plan is not None:
            dev = _feed.PendingExpand(dev, plan, launch)
        return dev, offsets, t_pad

    def fetch_merged(self, dev, preps: list[_Prepared], offsets: list,
                     t_pad: int):
        """Fetch a merged dispatch's bits (dense ndarray or
        CompactBits over the full merged pair space); a deduped one is
        scattered back through its plan. A failed fetch raises: every
        request the dispatch carried fails with it."""
        from . import feed as _feed
        if isinstance(dev, _feed.PendingExpand):
            return _feed.expand_bits(dev.plan, self._fetch_bits(dev.dev),
                                     t_pad)
        return self._fetch_bits(dev)

    def warmup(self, max_pairs: int = 1 << 18) -> int:
        """Launch once per rung of the pair ladder with empty
        descriptors, and once more per neighbouring hit-buffer rung (one
        budget doubling up and one halving down), as the JAX package's
        warmup does; nothing is compiled per shape here, so this only
        makes the same launches (ledgered as warmup, not traffic).
        → the rung count."""
        if len(self.table) == 0:
            return 0
        rungs = bucket_ladder(max_pairs, _PAIR_FLOOR, _PAIR_GROWTH)
        u_pad = _next_pow2(max(self._ver_count, 1))
        with self._lock:
            budget = self._hit_budget
        for t_pad in rungs:
            q_pad = bucket_size(max(t_pad // 8, 1), 64, _PAIR_GROWTH,
                                align=64)
            z = np.zeros(q_pad, np.int32)
            self._launch(z, z, z, 0, 0, t_pad, u_pad, warm=True)
            warmed = {self._hit_capacity(t_pad, budget=budget)}
            for adapted in (budget * 2, budget / 2):
                nxt = self._hit_capacity(t_pad, budget=adapted)
                if nxt and nxt not in warmed:
                    warmed.add(nxt)
                    self._launch(z, z, z, 0, 0, t_pad, u_pad, h_cap=nxt,
                                 warm=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(rungs)

    def detect(self, queries: list[PkgQuery]) -> list[Hit]:
        return self.detect_many([queries])[0]

    def _dispatch(self, prep: _Prepared):
        """One batch's launch under its detect.dispatch span, stamping
        the device view /healthz serves."""
        with span("detect.dispatch", n_pairs=prep.n_pairs,
                  t_pad=prep.t_pad):
            dev = self._launch(prep.q_start, prep.q_count, prep.q_ver,
                               prep.n_queries, prep.n_pairs, prep.t_pad,
                               prep.u_pad)
        note_dispatch(self.device)
        return dev

    def detect_many(self, batches: list[list[PkgQuery]]) -> list[list[Hit]]:
        """prep → launch → fetch → assemble, one batch after another.
        Under graftscope recording (`--trace`) a fence after each
        launch puts its device time in detect.device_fence and leaves
        detect.device_wait the transfer; batches still run in the same
        order, so the hit budget routes each launch as it would
        untraced."""
        out: list = [[] for _ in batches]
        if len(self.table) == 0:
            return out
        traced = recording()
        n_pairs = 0
        wait_s = 0.0
        for idx, qs in enumerate(batches):
            prep = self._prepare(qs) if qs else None
            if prep is None or prep.n_pairs == 0:
                continue
            n_pairs += prep.n_pairs
            dev = self._dispatch(prep)
            METRICS.gauge_add("trivy_tpu_dispatch_depth", 1.0)
            try:
                if traced:
                    with span("detect.device_fence", batches=1):
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                    with span("detect.device_wait", n_pairs=prep.n_pairs):
                        t_get = time.perf_counter()
                        bits = self._fetch_bits(dev)
                else:
                    t_get = time.perf_counter()
                    bits = self._fetch_bits(dev)
            finally:
                METRICS.gauge_add("trivy_tpu_dispatch_depth", -1.0)
            t_asm = time.perf_counter()
            METRICS.observe("trivy_tpu_device_get_stall_seconds",
                            t_asm - t_get)
            out[idx] = self._assemble(prep, bits)
            wait_s += time.perf_counter() - t_get
        METRICS.inc("trivy_tpu_detect_queries_total",
                    sum(len(qs) for qs in batches))
        METRICS.inc("trivy_tpu_detect_pairs_total", n_pairs)
        METRICS.inc("trivy_tpu_detect_wait_assemble_seconds_total", wait_s)
        METRICS.inc("trivy_tpu_detect_hits_total", sum(len(h) for h in out))
        return out

    @staticmethod
    def pair_owners(prep: _Prepared, slots: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Pair slots (< n_pairs) → (index into usable, advisory row),
        read off the CSR descriptors at just those slots."""
        slots = np.asarray(slots, np.int64)
        seg = np.searchsorted(prep.q_offsets, slots, side="right") - 1
        rows = prep.q_start[seg] + (slots - prep.q_offsets[seg])
        return prep.q_usable[seg], rows

    def _assemble(self, prep: _Prepared, bits) -> list[Hit]:
        """One graftscope span per batch around _assemble_impl."""
        with span("detect.assemble", n_pairs=prep.n_pairs) as sp:
            hits = self._assemble_impl(prep, bits)
            sp.attrs["hits"] = len(hits)
            return hits

    def _assemble_impl(self, prep: _Prepared, bits) -> list[Hit]:
        t = self.table
        if isinstance(bits, CompactBits):
            keep = bits.pair_idx
            b = bits.bits
        else:
            bits = bits[:prep.n_pairs]
            keep = np.nonzero(bits)[0]
            b = bits[keep]
        if keep.size == 0:
            return []
        qidx, rows = self.pair_owners(prep, keep)
        gids = t.group[rows]
        flags = t.flags[rows]
        sat = (b & J.SATISFIED) != 0
        neg = (flags & J.NEGATIVE) != 0
        inexact = (b & J.NEEDS_RECHECK) != 0

        # group-by (pkg query, advisory group). Pairs come out of the
        # CSR expansion sorted by (query, group) for tables flattened by
        # build_table; a table that broke that order is re-sorted.
        key = qidx.astype(np.int64) * (len(t.groups) + 1) + gids
        if key.size > 1 and not np.all(key[1:] >= key[:-1]):
            order = np.argsort(key, kind="stable")
            key, sat, neg, inexact = \
                key[order], sat[order], neg[order], inexact[order]
        seg_start = np.flatnonzero(
            np.concatenate(([True], key[1:] != key[:-1])))
        uniq = key[seg_start]
        pos_any = np.maximum.reduceat(sat & ~neg, seg_start)
        neg_any = np.maximum.reduceat(sat & neg, seg_start)
        inex_any = np.maximum.reduceat(inexact, seg_start)

        pkg_of = (uniq // (len(t.groups) + 1)).astype(np.int64)
        gid_of = (uniq % (len(t.groups) + 1)).astype(np.int64)

        # collision guard (name + source equality) as two object-array
        # compares; only scoped (arch/CPE) or inexact pairs take the
        # per-item path
        g_name, g_source, g_scoped = self._group_arrays()
        ok = (g_name[gid_of] == prep.q_name[pkg_of]) & \
            (g_source[gid_of] == prep.q_source[pkg_of])
        slow = ok & (g_scoped[gid_of] | inex_any | ~prep.q_exact[pkg_of])
        fast = ok & ~slow & pos_any & ~neg_any

        g_vuln, g_fix, g_status, g_sev, g_ds, g_vids = self._group_cols()
        fsel = np.nonzero(fast)[0]
        gsel = gid_of[fsel]
        psel = pkg_of[fsel]
        hits: list[Hit] = [
            Hit(*row) for row in zip(
                prep.q_obj[psel].tolist(), g_vuln[gsel].tolist(),
                g_fix[gsel].tolist(), g_status[gsel].tolist(),
                g_sev[gsel].tolist(), g_ds[gsel].tolist(),
                g_vids[gsel].tolist())]
        groups = t.groups
        for u in np.nonzero(slow)[0]:
            q, ver_exact = prep.usable[int(pkg_of[u])]
            g = groups[int(gid_of[u])]
            if g.arches and q.arch and q.arch not in g.arches:
                continue  # advisory scoped to other architectures
            if g.cpe_indices and not \
                    q.cpe_indices.intersection(g.cpe_indices):
                continue  # Red Hat: entry's CPEs outside content sets
            if inex_any[u] or not ver_exact:
                pos, negv = self._exact_eval(g, q)
            else:
                pos, negv = bool(pos_any[u]), bool(neg_any[u])
            if pos and not negv:
                hits.append(Hit(
                    query=q, vuln_id=g.vuln_id,
                    fixed_version=g.fixed_version, status=g.status,
                    severity=g.severity, data_source=g.data_source,
                    vendor_ids=g.vendor_ids))
        return hits

    def _group_arrays(self):
        """Per-table verification columns: names, sources, and a scoped
        flag for arch/CPE-gated groups."""
        with self._lock:
            if self._g_arrays is None:
                gs = self.table.groups
                self._g_arrays = (
                    np.array([g.pkg_name for g in gs], dtype=object),
                    np.array([g.source for g in gs], dtype=object),
                    np.fromiter((bool(g.arches or g.cpe_indices)
                                 for g in gs), bool, count=len(gs)),
                )
            return self._g_arrays

    def _group_cols(self):
        """Columnar group attributes for fast-path Hit construction."""
        with self._lock:
            if self._g_cols is None:
                gs = self.table.groups

                def col(attr):
                    a = np.empty(len(gs), dtype=object)
                    a[:] = [getattr(g, attr) for g in gs]
                    return a
                self._g_cols = tuple(
                    col(a) for a in ("vuln_id", "fixed_version", "status",
                                     "severity", "data_source",
                                     "vendor_ids"))
            return self._g_cols

    def _exact_eval(self, g, q: PkgQuery) -> tuple[bool, bool]:
        """Evaluate the group's intervals with the exact comparator (for
        inexact-keyed rows or packages). Groups whose constraint grammar
        was not interval-representable carry raw spec strings and get
        the reference's full IsVulnerable semantics."""
        if g.raw_specs is not None:
            return self._raw_eval(g, q)
        pos = neg = False
        for positive, iv in g.rows:
            ok = True
            try:
                if iv.lo is not None:
                    c = V.compare(q.ecosystem, iv.lo, q.version)
                    ok &= c < 0 or (iv.lo_incl and c == 0)
                if ok and iv.hi is not None:
                    c = V.compare(q.ecosystem, q.version, iv.hi)
                    ok &= c < 0 or (iv.hi_incl and c == 0)
            except (ValueError, KeyError):
                ok = False
            if positive:
                pos = pos or ok
            else:
                neg = neg or ok
        return pos, neg

    def _raw_eval(self, g, q: PkgQuery) -> tuple[bool, bool]:
        """Reference IsVulnerable (compare.go:21-55) over raw constraint
        strings: an empty member in the vulnerable/patched lists always
        detects; constraint errors are a no-match."""
        from ..db.constraints import eval_constraint
        vuln, patched, unaffected = g.raw_specs
        for spec in (vuln, patched):
            if spec and any(not b.strip() for b in spec.split("||")):
                return True, False
        if vuln:
            try:
                if not eval_constraint(q.ecosystem, vuln, q.version):
                    return False, False
            except (ValueError, KeyError):
                return False, False
        secure = " || ".join(s for s in (patched, unaffected) if s)
        if not secure:
            return bool(vuln), False
        try:
            return True, eval_constraint(q.ecosystem, secure, q.version)
        except (ValueError, KeyError):
            return False, False
