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
batches into one launch (dispatch_merged) and fetches it on the
detector's fetch thread (fetch_merged). There is no host join: a
failed launch or fetch raises.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import version as V
from ..db.table import AdvisoryTable
from ..device import resolve_device
from ..ops import bucket_ladder, bucket_size
from ..ops import join as J
from ..ops import next_pow2 as _next_pow2
from ..ops.hashing import fnv1a64_batch

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


class BatchDetector:
    def __init__(self, table: AdvisoryTable,
                 device: str | torch.device | None = None):
        self.table = table
        self.device = resolve_device(device)
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
                self._ver_dev = torch.from_numpy(
                    self._ver_snapshot_locked(u_pad)).to(self.device)
                self._ver_dev_rows = self._ver_count
            return self._ver_dev

    # ---- batch pipeline -----------------------------------------------

    def _prepare(self, queries: list[PkgQuery]) -> Optional[_Prepared]:
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
            with self._lock:
                self._hit_dense_streak += 1
                if self._hit_dense_streak >= _HIT_LOW_STREAK:
                    self._hit_budget = max(self._hit_budget / 2,
                                           _HIT_BUDGET_MIN)
                    self._hit_dense_streak = 0
        return 0

    def _note_hits(self, n_hits: int, h_cap: int) -> None:
        """Adapt the hit budget from the observed buffer occupancy."""
        with self._lock:
            if n_hits > h_cap:
                self._hit_budget = min(self._hit_budget * 2,
                                       _HIT_BUDGET_MAX)
                self._hit_low_streak = 0
            elif n_hits * 4 <= h_cap:
                self._hit_low_streak += 1
                if self._hit_low_streak >= _HIT_LOW_STREAK:
                    self._hit_budget = max(self._hit_budget / 2,
                                           _HIT_BUDGET_MIN)
                    self._hit_low_streak = 0
            else:
                self._hit_low_streak = 0

    def _launch(self, q_start: np.ndarray, q_count: np.ndarray,
                q_ver: np.ndarray, n_queries: int, total: int, t_pad: int,
                u_pad: int, h_cap: int | None = None):
        """Upload the [Q] descriptors and launch the join (asynchronous
        on a GPU). → a _PendingCompact when the hit buffer engages, else
        the dense int8[t_pad] bits tensor."""
        J.check_csr_descriptors(q_count, n_queries)
        if h_cap is None:
            h_cap = self._hit_capacity(t_pad)
        adv_lo, adv_hi, adv_flags, lo_pre, hi_pre = \
            self.table.device_arrays(self.device)
        ver_dev = self._ver_device(u_pad)
        qs, qc, qv = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
                      .to(self.device) for a in (q_start, q_count, q_ver))
        args = (adv_lo, adv_hi, adv_flags, ver_dev, qs, qc, qv, total)
        if h_cap:
            hit_idx, hit_bits, n_hits, dense = J.csr_pair_join_compact(
                *args, t_pad, h_cap, prefix=(lo_pre, hi_pre))
            return _PendingCompact(hit_idx, hit_bits, n_hits, dense,
                                   h_cap, t_pad)
        return J.csr_pair_join(*args, t_pad, prefix=(lo_pre, hi_pre))

    def _fetch_bits(self, dev):
        """Device→host fetch. A _PendingCompact fetches only the O(hits)
        triple, in one transfer; when n_hits overflowed the buffer the
        dense bits follow, so results are the same either way."""
        if not isinstance(dev, _PendingCompact):
            return dev.cpu().numpy()
        packed = torch.cat([dev.n_hits.reshape(1).to(torch.int32),
                            dev.hit_idx,
                            dev.hit_bits.to(torch.int32)]).cpu().numpy()
        n = int(packed[0])
        self._note_hits(n, dev.h_cap)
        if n > dev.h_cap:
            return dev.dense.cpu().numpy()
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

    def dispatch_merged(self, preps: list[_Prepared], plan=None):
        """ONE join launch covering several prepared batches, the
        primitive detectd is built on. Each prep's pairs land
        contiguously in the merged bits, so its slice [off, off +
        n_pairs) is what its solo dispatch gives: the predicate is
        elementwise.

        With a dedup `plan` (feed.plan_from_preps of these preps), the
        launch covers the unique query triples only and fetch_merged
        scatters the bits back through the plan's map; without one it
        covers every real pair. → (pending result, per-prep offsets,
        t_pad), the offsets and t_pad in the full merged pair space
        either way."""
        from . import feed as _feed
        q_start, q_count, q_ver, offsets, total, t_pad, u_pad = \
            self._merge_descriptors(preps)
        n_q = sum(p.n_queries for p in preps)
        if plan is None:
            return self._launch(q_start, q_count, q_ver, n_q, total,
                                t_pad, u_pad), offsets, t_pad
        ls, lc, lv, l_total, l_tpad = _feed.padded_unique(
            plan, _PAIR_FLOOR, _PAIR_GROWTH)
        dev = self._launch(ls, lc, lv, plan.n_unique, l_total, l_tpad,
                           u_pad)
        return _feed.PendingExpand(dev, plan, (ls, lc, lv, l_total,
                                               l_tpad)), offsets, t_pad

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
        makes the same launches. → the rung count."""
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
            self._launch(z, z, z, 0, 0, t_pad, u_pad)
            warmed = {self._hit_capacity(t_pad, budget=budget)}
            for adapted in (budget * 2, budget / 2):
                nxt = self._hit_capacity(t_pad, budget=adapted)
                if nxt and nxt not in warmed:
                    warmed.add(nxt)
                    self._launch(z, z, z, 0, 0, t_pad, u_pad, h_cap=nxt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(rungs)

    def detect(self, queries: list[PkgQuery]) -> list[Hit]:
        return self.detect_many([queries])[0]

    def detect_many(self, batches: list[list[PkgQuery]]) -> list[list[Hit]]:
        """prep → launch → fetch → assemble, one batch after another."""
        out: list = [[] for _ in batches]
        if len(self.table) == 0:
            return out
        for idx, qs in enumerate(batches):
            prep = self._prepare(qs) if qs else None
            if prep is None or prep.n_pairs == 0:
                continue
            dev = self._launch(prep.q_start, prep.q_count, prep.q_ver,
                               prep.n_queries, prep.n_pairs, prep.t_pad,
                               prep.u_pad)
            out[idx] = self._assemble(prep, self._fetch_bits(dev))
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
