"""graftstream in the port (trivy_tpu_torch/parallel/stream.py), on the
CPU: the mirror of tests/test_stream.py and of the stream cases of
tests/test_feed.py, held to the JAX package on the same inputs.

The planning and routing functions (plan_slices, clip_descriptors,
touched_slices, merge_slice_bits) equal the JAX package's exactly, and
the streamed detector's hits equal both the JAX StreamingDetector's
and the port's resident BatchDetector's, for 2, 3, 4 and 7 slices and
for budget-derived plans, small overflowing hit buffers and the dedup
plan included (tolerance 0: hits are discrete). Then the port's own
properties: the upload ledger's double-buffer overlap, the strict
exposition of the upload series, the SliceCache's eviction and
failure rules, detectd over the streamed detector, its prefetch peek,
the wiring into LocalScanner and the server, and the three streaming
flags from argv, TRIVY_* and trivy.yaml.

Not carried: the host-fallback cases of test_stream.py (the port has
no host join: a failed upload, launch or fetch raises), the
stream.prefetch failpoint drill (no failpoints; an upload hook that
raises during a prefetch takes its place), and TestMeshStream (the
mesh is ROADMAP A11)."""

import json
import random
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from trivy_tpu.detect.engine import PkgQuery as RefPkgQuery
from trivy_tpu.parallel import stream as ref_stream
from trivy_tpu.resilience.hostjoin import CompactBits as RefCompactBits
from trivy_tpu.resilience.storm import request_doc, storm_table
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.db.table import AdvisoryTable
from trivy_tpu_torch.detect import engine as DE
from trivy_tpu_torch.detect import feed as _feed
from trivy_tpu_torch.detect.engine import BatchDetector, CompactBits, PkgQuery
from trivy_tpu_torch.detect.sched import DispatchScheduler, SchedOptions
from trivy_tpu_torch.fanal.cache import MemoryCache
from trivy_tpu_torch.metrics import METRICS
from trivy_tpu_torch.obs.exposition import parse_exposition
from trivy_tpu_torch.obs.perf import LEDGER
from trivy_tpu_torch.parallel.stream import (
    SliceCache, StreamingDetector, StreamOptions, clip_descriptors,
    merge_slice_bits, plan_slices, slice_bounds, touched_slices,
)
from trivy_tpu_torch.scanner import LocalScanner
from trivy_tpu_torch.server.listen import serve_background

JOIN_TIMEOUT = 120
# explicit slice counts, and budgets that make the table k× a budget
PLANS = [("slices", 2), ("slices", 3), ("slices", 4), ("slices", 7),
         ("budget", 2), ("budget", 4)]


def carry(ref) -> AdvisoryTable:
    """The JAX package's table as the port's: the same columns, groups
    and details."""
    return AdvisoryTable.from_numpy(ref.hash, ref.lo_tok, ref.hi_tok,
                                    ref.flags, ref.group, ref.groups,
                                    ref.window, ref.details, ref.aux)


@pytest.fixture(scope="module")
def ref_table():
    return storm_table(n_pkgs=96)


@pytest.fixture(scope="module")
def big_table(ref_table):
    return carry(ref_table)


def _opts(kind: str, k, table) -> StreamOptions:
    if kind == "slices":
        return StreamOptions(slices=k)
    return StreamOptions(device_budget_mb=table.device_nbytes() / (k << 20))


def _ref_opts(kind: str, k, table):
    if kind == "slices":
        return ref_stream.StreamOptions(slices=k)
    return ref_stream.StreamOptions(
        device_budget_mb=table.device_nbytes() / (k << 20))


def _quarter(table) -> StreamOptions:
    """A budget the table is 4× of: 8 slices of ≤ budget/2 each."""
    return _opts("budget", 4, table)


def _storm_specs(seed: int, n: int, n_pkgs: int = 96):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        k = rng.randrange(n_pkgs + 8)   # some empty-bucket names
        out.append((f"storm-pkg-{k}",
                    f"{rng.randrange(1, 4)}.{rng.randrange(10)}.0-r0"))
    return out


def _queries(specs, cls=PkgQuery):
    return [cls(source="alpine 3.17", ecosystem="alpine", name=n,
                version=v) for n, v in specs]


def _storm_queries(seed: int, n: int):
    return _queries(_storm_specs(seed, n))


def _dup_queries(seed: int, n: int, pool: int = 8):
    """Duplicate-heavy traffic: a few storm triples repeated, and a
    couple of empty buckets."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        k = rng.randrange(pool + 2)
        out.append(PkgQuery(source="alpine 3.17", ecosystem="alpine",
                            name=f"storm-pkg-{k}",
                            version=f"{1 + k % 3}.{k % 10}.0-r0"))
    return out


def _keys(hits):
    return [(h.query.name, h.query.version, h.vuln_id) for h in hits]


def _streamed(table, opts=None) -> StreamingDetector:
    return StreamingDetector(table, opts or _quarter(table), device="cpu")


# ---------------------------------------------------------------------------
# slice planning and routing, against the JAX package


class TestPlanning:
    @pytest.mark.parametrize("kind,k", PLANS,
                             ids=[f"{a}{b}" for a, b in PLANS])
    def test_bounds_equal_reference(self, ref_table, big_table, kind, k):
        got = plan_slices(big_table, _opts(kind, k, big_table))
        want = ref_stream.plan_slices(ref_table,
                                      _ref_opts(kind, k, ref_table))
        assert got is not None and want is not None
        np.testing.assert_array_equal(got, want)
        assert got[0] == 0 and got[-1] == len(big_table)
        if kind == "budget":
            assert got.size - 1 >= 2 * k   # resident=2 halves the budget

    def test_device_nbytes_is_the_reference_measure(self, ref_table,
                                                    big_table):
        assert big_table.device_nbytes() == ref_table.device_nbytes()
        cols = big_table.nbytes_by_column()
        assert big_table.device_nbytes() == \
            cols["lo_tok"] + cols["hi_tok"] + cols["flags"]

    def test_within_budget_or_no_budget_never_engages(self, big_table):
        huge = big_table.device_nbytes() * 4 / (1 << 20)
        assert plan_slices(big_table,
                           StreamOptions(device_budget_mb=huge)) is None
        # the CPU has no memory view: the auto budget is nothing
        assert plan_slices(big_table, StreamOptions(),
                           device=torch.device("cpu")) is None
        assert plan_slices(big_table, None) is None

    def test_clip_and_touched_equal_reference(self):
        rng = np.random.default_rng(11)
        for _trial in range(30):
            n_rows = int(rng.integers(10, 400))
            bounds = slice_bounds(n_rows, int(rng.integers(2, 9)))
            np.testing.assert_array_equal(
                bounds, ref_stream.slice_bounds(n_rows, bounds.size - 1))
            q = int(rng.integers(1, 30))
            starts = rng.integers(0, n_rows, q)
            counts = np.minimum(rng.integers(0, 12, q), n_rows - starts)
            vers = rng.integers(0, 50, q).astype(np.int32)
            args = (bounds, starts.astype(np.int32),
                    counts.astype(np.int32), vers)
            got = clip_descriptors(*args)
            want = ref_stream.clip_descriptors(*args)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert (g.idx, g.total) == (w.idx, w.total)
                for f in ("q_start", "q_count", "q_ver", "gmap"):
                    np.testing.assert_array_equal(getattr(g, f),
                                                  getattr(w, f))
                    assert getattr(g, f).dtype == getattr(w, f).dtype
            # every global pair lands in exactly one slice
            allg = np.concatenate([p.gmap for p in got]) if got else []
            assert sorted(np.asarray(allg).tolist()) == \
                list(range(int(counts.sum())))
            assert touched_slices(*args[:3]) == \
                ref_stream.touched_slices(*args[:3])

    @pytest.mark.parametrize("shape", ["dense", "compact", "mixed"])
    def test_merge_equal_reference(self, shape):
        rng = np.random.default_rng(5)
        bounds = slice_bounds(60, 3)
        starts = np.array([0, 22, 41, 55], np.int32)
        counts = np.array([10, 25, 10, 5], np.int32)
        vers = np.zeros(4, np.int32)
        total = int(counts.sum())
        dense_global = rng.integers(0, 3, total).astype(np.int8)
        plans = clip_descriptors(bounds, starts, counts, vers)
        ref_plans = ref_stream.clip_descriptors(bounds, starts, counts,
                                                vers)
        got_in, want_in = [], []
        for i, (p, rp) in enumerate(zip(plans, ref_plans)):
            local = dense_global[p.gmap]
            keep = np.nonzero(local)[0].astype(np.int32)
            compact = shape == "compact" or (shape == "mixed" and i % 2)
            if compact:
                got_in.append((p, CompactBits(keep, local[keep], p.total)))
                want_in.append((rp, RefCompactBits(keep, local[keep],
                                                   p.total)))
            else:
                padded = np.concatenate([local, np.zeros(7, np.int8)])
                got_in.append((p, padded))
                want_in.append((rp, padded))
        got = merge_slice_bits(got_in, total)
        want = ref_stream.merge_slice_bits(want_in, total)
        assert isinstance(got, CompactBits) == \
            isinstance(want, RefCompactBits) == (shape == "compact")
        if shape == "compact":
            np.testing.assert_array_equal(got.pair_idx, want.pair_idx)
            np.testing.assert_array_equal(got.bits, want.bits)
            assert got.n_pairs == want.n_pairs
            assert (np.diff(got.pair_idx) > 0).all()
            got = got.dense()
        np.testing.assert_array_equal(got, np.asarray(
            want.dense() if isinstance(want, RefCompactBits) else want))
        np.testing.assert_array_equal(got, dense_global)


# ---------------------------------------------------------------------------
# the streamed detector: hit for hit against the JAX package and the
# port's resident join


class TestStreamedDetector:
    @pytest.mark.parametrize("kind,k", PLANS,
                             ids=[f"{a}{b}" for a, b in PLANS])
    def test_equals_reference_and_resident(self, ref_table, big_table,
                                           kind, k):
        specs = [_storm_specs(s, 48) for s in range(4)]
        sd = StreamingDetector(big_table, _opts(kind, k, big_table),
                               device="cpu")
        bd = BatchDetector(big_table, device="cpu")
        ref = ref_stream.StreamingDetector(ref_table,
                                           _ref_opts(kind, k, ref_table))
        try:
            np.testing.assert_array_equal(sd.bounds, ref.bounds)
            assert sd.rows_pad == ref.rows_pad
            assert sd.slice_nbytes == ref.slice_nbytes
            got = [_keys(h) for h in sd.detect_many(
                [_queries(s) for s in specs])]
            resident = [_keys(h) for h in bd.detect_many(
                [_queries(s) for s in specs])]
            want = [_keys(h) for h in ref.detect_many(
                [_queries(s, RefPkgQuery) for s in specs])]
            assert got == want == resident
            assert sum(map(len, got)) > 0
        finally:
            sd.close()
            bd.close()
            ref.close()

    def test_compact_and_overflow_identity(self, ref_table, big_table,
                                           monkeypatch):
        """Small hit buffers overflow on hit-dense slices and the dense
        re-fetch keeps the hits those of the JAX package's detector
        with the same small buffers."""
        monkeypatch.setattr(DE, "_HIT_FLOOR", 8)
        monkeypatch.setattr(DE, "_HIT_ALIGN", 8)
        sd = _streamed(big_table)
        bd = BatchDetector(big_table, device="cpu")
        ref = ref_stream.StreamingDetector(
            ref_table, _ref_opts("budget", 4, ref_table), hit_floor=8,
            hit_align=8)
        # low installed versions: nearly every pair satisfied, so the
        # tiny buffers overflow
        dense = [("storm-pkg-%d" % k, "1.0.0-r0") for k in range(96)]
        sparse = _storm_specs(9, 64)
        LEDGER.reset_for_tests()
        try:
            for specs in (dense, sparse):
                got = _keys(sd.detect(_queries(specs)))
                assert got == _keys(bd.detect(_queries(specs))) == \
                    _keys(ref.detect(_queries(specs, RefPkgQuery)))
            rows = [r for r in LEDGER.shape_table() if r["site"] == "stream"]
            assert any(r["h_cap"] for r in rows)
            assert sum(r.get("overflows", 0) for r in rows) > 0
        finally:
            sd.close()
            bd.close()
            ref.close()

    def test_dedup_plan_through_dispatch_merged(self, big_table):
        """Duplicate-heavy preps through the merged dispatch: the
        unique descriptors walk the slices and scatter back to the very
        bits the resident detector's dedup-off dispatch gives."""
        sd = _streamed(big_table)
        bd = BatchDetector(big_table, device="cpu")
        try:
            batches = [_dup_queries(500 + b, 20) for b in range(5)]
            # each detector's preps index its own version pool
            preps, bd_preps = ([p for p in map(d._prepare, batches)
                                if p is not None and p.n_pairs]
                               for d in (sd, bd))
            plan = _feed.plan_from_preps(preps)
            assert plan is not None and plan.unique_total < \
                sum(p.n_pairs for p in preps)
            staged = sd.stage_merged(preps, plan=plan, dedup=True)
            assert staged.queries is None   # nothing uploaded ahead
            bits, offsets, t_pad = sd.dispatch_merged(preps, staged=staged)
            bits = sd.fetch_merged(bits, preps, offsets, t_pad)
            dev, off2, tp2 = bd.dispatch_merged(bd_preps)
            want = bd.fetch_merged(dev, bd_preps, off2, tp2)
            assert (offsets, t_pad) == (off2, tp2)
            total = sum(p.n_pairs for p in preps)

            def dense(b):
                return b.dense() if isinstance(b, CompactBits) \
                    else np.asarray(b)
            np.testing.assert_array_equal(dense(bits)[:total],
                                          dense(want)[:total])
            got = [_keys(sd._assemble(p, DE.slice_bits(bits, o, p.n_pairs)))
                   for p, o in zip(preps, offsets)]
            assert got == [_keys(bd._assemble(p, DE.slice_bits(
                want, o, p.n_pairs))) for p, o in zip(bd_preps, off2)]
            assert sum(map(len, got)) > 0
        finally:
            sd.close()
            bd.close()

    def test_double_buffer_overlap_in_upload_ledger(self, big_table):
        """After the first slice pass every wait hits a prefetched
        upload: exactly one cold wait in the whole run, thanks to the
        walk-tail prefetch."""
        LEDGER.reset_for_tests()
        sd = _streamed(big_table)
        try:
            sd.detect_many([_storm_queries(s, 64) for s in range(6)])
            stats = LEDGER.shard_upload_stats()["stream"]
            assert stats["bytes"] > 0
            assert stats["waits"] >= sd.n_slices
            assert stats["cold_waits"] == 1
            assert stats["prefetched"] == stats["uploads"] - 1
            assert stats["stall_ms"] >= stats["cold_stall_ms"] >= 0
            agg = LEDGER.aggregate()
            assert agg["transfer_bytes"]["shard_upload"] == stats["bytes"]
            assert agg["shard_uploads"]["stream"] == stats
            # each upload ships the slice's prefix planes beside it
            assert stats["bytes"] == stats["uploads"] \
                * sd.slice_device_nbytes
        finally:
            sd.close()

    def test_upload_series_under_strict_exposition(self, big_table):
        sd = _streamed(big_table)
        try:
            sd.detect_many([_storm_queries(1, 32)])
        finally:
            sd.close()
        families = parse_exposition(METRICS.render())
        upload = [v for _n, labels, v in
                  families["trivy_tpu_device_transfer_bytes_total"]
                  ["samples"] if labels.get("path") == "shard_upload"]
        assert upload and upload[0] > 0
        counts = [v for n, _labels, v in
                  families["trivy_tpu_device_upload_stall_ms"]["samples"]
                  if n.endswith("_count")]
        assert counts and counts[0] > 0

    def test_warmup_pretouches_resident_pair(self, big_table):
        LEDGER.reset_for_tests()
        sd = _streamed(big_table)
        try:
            assert sd.warmup() == 0
            stats = LEDGER.shard_upload_stats()["stream"]
            assert stats["uploads"] == stats["prefetched"] == 2
            assert sd.status()["resident"] == [0, 1]
        finally:
            sd.close()

    def test_whole_table_never_shipped(self):
        """The streamed path never asks for the table's device arrays:
        a fresh table's device cache stays empty."""
        table = carry(storm_table(n_pkgs=96))
        sd = StreamingDetector(table, StreamOptions(slices=3), device="cpu")
        try:
            assert _keys(sd.detect(_storm_queries(3, 48)))
            sd.warmup()
            assert table._device is None
            st = sd.status()
            assert st["slices"] == 3 and len(st["resident"]) <= 2
            assert st["slice_device_nbytes"] == st["slice_nbytes"] \
                + 2 * st["rows_pad"] * 4 * 4
        finally:
            sd.close()


# ---------------------------------------------------------------------------
# SliceCache


class TestSliceCache:
    def test_lru_eviction_keeps_capacity(self):
        uploads = []

        def up(k):
            uploads.append(k)
            return (np.zeros(4),), 32

        c = SliceCache(up)
        for k in (0, 1, 2, 3):
            c.get(k)
        assert set(c.resident()) == {2, 3}
        assert uploads == [0, 1, 2, 3]
        c.get(2)            # a hit: no new upload
        assert uploads == [0, 1, 2, 3]

    def test_failed_upload_is_not_cached(self):
        calls = []

        def up(k):
            calls.append(k)
            if len(calls) == 1:
                raise RuntimeError("transient")
            return (np.zeros(2),), 16

        c = SliceCache(up)
        c.prefetch(0)            # logged, not raised
        assert c.resident() == []
        c.get(0)                 # uploaded cold
        assert c.resident() == [0]
        assert calls == [0, 0]
        # a cold get whose upload fails raises, and caches nothing
        c2 = SliceCache(lambda k: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            c2.get(1)
        assert c2.resident() == []

    def test_concurrent_get_uploads_once(self):
        n = [0]
        settled = []

        def up(k):
            n[0] += 1
            time.sleep(0.02)
            return (np.zeros(2),), 16

        c = SliceCache(up, settle=lambda a: settled.append(1) or a)
        threads = [threading.Thread(target=c.get, args=(7,))
                   for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_TIMEOUT)
            assert not t.is_alive()
        assert n[0] == 1
        assert len(settled) == 6   # every get hands the slice over


# ---------------------------------------------------------------------------
# detectd over the streamed detector


def _hammer(sched, requests, n_threads: int = 6):
    results: list = [None] * len(requests)
    errors: list = []

    def worker(ids):
        try:
            for i in ids:
                results[i] = [_keys(h) for h in
                              sched.detect_many(requests[i])]
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker,
                                args=(range(k, len(requests), n_threads),))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive()
    return results, errors


class TestDetectdOverStream:
    def test_coalesced_equals_serial_and_walks_once(self, big_table):
        """c=6 through DispatchScheduler(StreamingDetector): hit for hit
        the serial resident results, and a merged chunk walks the
        slices once: upload waits grow with rounds, not requests."""
        requests = [[_storm_queries(100 + r * 3 + b, 24) for b in range(2)]
                    for r in range(12)]
        serial = BatchDetector(big_table, device="cpu")
        expected = [[_keys(h) for h in serial.detect_many(b)]
                    for b in requests]
        serial.close()
        sd = _streamed(big_table)
        LEDGER.reset_for_tests()
        rounds0 = METRICS.get("trivy_tpu_detect_batches_total")
        sched = DispatchScheduler(sd, SchedOptions(coalesce_wait_ms=5.0))
        try:
            results, errors = _hammer(sched, requests)
            rounds = METRICS.get("trivy_tpu_detect_batches_total") - rounds0
        finally:
            sched.close()
            sd.close()
        assert not errors
        assert results == expected
        stats = LEDGER.shard_upload_stats()["stream"]
        assert stats["waits"] <= rounds * sd.n_slices + sd.n_slices
        assert stats["waits"] < len(requests) * sd.n_slices

    def test_prefetch_ranges_warms_touched_slices(self, big_table):
        sd = _streamed(big_table)
        try:
            LEDGER.reset_for_tests()
            prep = sd._prepare(_dup_queries(77, 24))
            assert prep is not None and prep.n_pairs > 0
            issued = sd.prefetch_ranges(prep.q_start[:prep.n_queries],
                                        prep.q_count[:prep.n_queries])
            want = touched_slices(sd.bounds, prep.q_start, prep.q_count)
            assert issued == want[:2] and issued
            stats = LEDGER.shard_upload_stats()["stream"]
            assert stats["uploads"] == stats["prefetched"] == len(issued)
            assert stats["cold_waits"] == 0
        finally:
            sd.close()

    def test_prefetch_upload_fault_costs_only_a_cold_upload(self,
                                                            big_table):
        """An upload hook that raises whenever a prefetch calls it: the
        walks upload cold instead, every result equals the serial one,
        no error escapes, and the admission peek still ran."""
        batches = [_storm_queries(400 + b, 24) for b in range(6)]
        serial = BatchDetector(big_table, device="cpu")
        expected = [_keys(h) for h in serial.detect_many(batches)]
        serial.close()
        sd = _streamed(big_table)
        cache = sd._cache
        upload, prefetch = cache._upload, cache.prefetch
        local = threading.local()
        faults = []

        def faulty_upload(k):
            if getattr(local, "prefetching", False):
                faults.append(k)
                raise RuntimeError("injected prefetch fault")
            return upload(k)

        def marked_prefetch(k):
            local.prefetching = True
            try:
                prefetch(k)
            finally:
                local.prefetching = False
        cache._upload = faulty_upload
        cache.prefetch = marked_prefetch
        LEDGER.reset_for_tests()
        sched = DispatchScheduler(sd, SchedOptions(coalesce_wait_ms=3.0,
                                                   prefetch=True))
        try:
            results, errors = _hammer(
                sched, [batches[3 * k:3 * k + 3] for k in range(2)],
                n_threads=2)
        finally:
            sched.close()
            sd.close()
        assert not errors
        assert results[0] + results[1] == expected
        assert faults
        stats = LEDGER.shard_upload_stats()["stream"]
        assert stats["prefetched"] == 0
        assert stats["cold_waits"] == stats["uploads"] > 0

    def test_pending_peek_issues_slices(self, big_table):
        """detectd's _prefetch_pending hands the queued requests' bucket
        ranges to prefetch_ranges and counts what it issued."""
        sd = _streamed(big_table)
        sched = DispatchScheduler(sd, SchedOptions())
        try:
            sched.close()   # no dispatcher: the queue stays as filled
            prep = sd._prepare(_storm_queries(5, 64))

            class _Req:
                slots = [(0, prep)]
                tenant = "t"
                n_pairs = prep.n_pairs
            with sched._lock:
                sched._fair_put_locked(_Req())
            sched._prefetch_pending()
            want = touched_slices(sd.bounds, prep.q_start, prep.q_count)
            assert sched.stats["prefetched_slices"] == min(len(want), 2) > 0
            assert set(sd._cache.resident()) == set(want[:2])
        finally:
            sd.close()


# ---------------------------------------------------------------------------
# scanner and server wiring


def _put_and_scan(base: str, doc: dict) -> dict:
    def post(path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    post("/twirp/trivy.cache.v1.Cache/PutBlob",
         {"diff_id": doc["DiffID"], "blob_info": doc})
    return post("/twirp/trivy.scanner.v1.Scanner/Scan",
                {"target": "t", "artifact_id": doc["DiffID"],
                 "blob_ids": [doc["DiffID"]]})


def _get(base: str, page: str) -> dict:
    with urllib.request.urlopen(base + page, timeout=30) as r:
        return json.loads(r.read())


class TestWiring:
    def test_local_scanner_picks_streaming_detector(self, big_table):
        s = LocalScanner(MemoryCache(), big_table, device="cpu",
                         stream=StreamOptions(slices=3))
        try:
            assert isinstance(s.detector, StreamingDetector)
            assert s.detector.n_slices == 3
        finally:
            s.close()
        for stream in (StreamOptions(), None):   # no budget on the CPU
            s2 = LocalScanner(MemoryCache(), big_table, device="cpu",
                              stream=stream)
            try:
                assert type(s2.detector) is BatchDetector
            finally:
                s2.close()

    def test_server_streams_like_resident_and_after_a_swap(self, tmp_path):
        """A --device cpu server with --table-stream-slices 3 answers
        what a resident one does, shows the slice plan at /healthz and
        the slice uploads at /debug/perf, and keeps streaming after a
        DB swap."""
        LEDGER.reset_for_tests()
        servers = {}
        for name, opts in (("stream", StreamOptions(slices=3)),
                           ("resident", None)):
            httpd, state = serve_background(
                "127.0.0.1", 0, carry(storm_table(n_pkgs=96)),
                str(tmp_path / name), cache_backend="memory",
                device="cpu", stream_opts=opts)
            servers[name] = (f"http://127.0.0.1:{httpd.server_address[1]}",
                             httpd, state)
        try:
            base, _h, state = servers["stream"]
            assert isinstance(state.scanner.detector, StreamingDetector)
            docs = [request_doc(77, i, n_pkgs=16) for i in range(4)]
            got = [_put_and_scan(base, d) for d in docs]
            want = [_put_and_scan(servers["resident"][0], d) for d in docs]
            assert got == want
            assert any(r.get("Vulnerabilities") for g in got
                       for r in g["results"])
            perf = _get(base, "/debug/perf")
            assert perf["totals"]["shard_uploads"]["stream"]["uploads"] > 0
            health = _get(base, "/healthz")
            assert health["stream"]["slices"] == 3
            assert len(health["stream"]["resident"]) <= 2
            assert "stream" not in _get(servers["resident"][0], "/healthz")
            # a DB swap builds the new scanner with the same options
            state.swap_table(carry(storm_table(n_pkgs=96, seed=605)))
            scanner, _version = state.scanner_with_version()
            assert isinstance(scanner.detector, StreamingDetector)
            assert scanner.detector.table._device is None
            servers["resident"][2].swap_table(
                carry(storm_table(n_pkgs=96, seed=605)))
            assert [_put_and_scan(base, d) for d in docs] == \
                [_put_and_scan(servers["resident"][0], d) for d in docs]
        finally:
            for _base, httpd, st in servers.values():
                httpd.shutdown()
                httpd.server_close()
                st.close()


# ---------------------------------------------------------------------------
# the streaming flags: argv > TRIVY_* > trivy.yaml


@pytest.fixture
def served(monkeypatch, tmp_path):
    """cli.main(["server", ...]) with serve() replaced by a recorder of
    the options the CLI built."""
    from trivy_tpu_torch.server import listen
    seen = {}

    def fake_serve(*a, **kw):
        seen.update(kw)
        return None
    monkeypatch.setattr(listen, "serve", fake_serve)

    def run(*argv):
        seen.clear()
        db = str(tmp_path / "db.npz")
        carry(storm_table(n_pkgs=8)).save(db)
        assert cli.main(["server", "--device", "cpu", "--db", db,
                         "--cache-dir", str(tmp_path), *argv]) == 0
        return seen["stream_opts"], seen["detect_opts"]
    return run


class TestFlags:
    @pytest.mark.parametrize("argv,want", [
        (["--table-stream-slices", "3"], dict(slices=3)),
        (["--table-device-budget-mb", "64"], dict(device_budget_mb=64.0)),
        (["--stream-prefetch"], dict(prefetch=True)),
        (["--no-stream-prefetch"], dict(prefetch=False)),
    ], ids=lambda v: v[0] if isinstance(v, list) else "")
    def test_flag_from_argv(self, served, argv, want):
        stream, sched = served(*argv)
        for k, v in want.items():
            # the prefetch flag gates detectd's peek; the rest plan
            assert getattr(sched if k == "prefetch" else stream, k) == v

    def test_defaults(self, served):
        stream, sched = served()
        assert (stream.slices, stream.device_budget_mb,
                sched.prefetch) == (0, 0.0, True)

    def test_flags_from_env(self, served, monkeypatch):
        monkeypatch.setenv("TRIVY_TABLE_STREAM_SLICES", "5")
        monkeypatch.setenv("TRIVY_TABLE_DEVICE_BUDGET_MB", "12.5")
        monkeypatch.setenv("TRIVY_STREAM_PREFETCH", "false")
        stream, sched = served()
        assert (stream.slices, stream.device_budget_mb,
                sched.prefetch) == (5, 12.5, False)
        # the command line wins over the environment
        stream, _sched = served("--table-stream-slices", "2")
        assert stream.slices == 2

    def test_flags_from_trivy_yaml(self, served, tmp_path, monkeypatch):
        (tmp_path / "trivy.yaml").write_text(
            "mesh:\n  table-stream-slices: 6\n"
            "  table-device-budget-mb: 32\n  stream-prefetch: false\n")
        monkeypatch.chdir(tmp_path)   # the server reads ./trivy.yaml
        stream, sched = served()
        assert (stream.slices, stream.device_budget_mb,
                sched.prefetch) == (6, 32.0, False)

    def test_mesh_flags_still_refuse(self, tmp_path):
        with pytest.raises(SystemExit, match="ROADMAP A11"):
            cli.main(["server", "--device", "cpu", "--db", "x",
                      "--cache-dir", str(tmp_path), "--mesh-devices", "2"])


# ---------------------------------------------------------------------------
# the chip script's phase


def test_chip_stream_phase_at_a_small_size_on_cpu(tmp_path):
    """chip_smoke.py's `stream` walks and servers with device="cpu" on a
    small apps table: both plans' hits equal the resident detector's,
    a cold wait only where a walk starts off the resident pair, the
    streamed server's c=16 reports equal the serial local ones, and
    the table is never shipped."""
    import chip_smoke
    from trivy_tpu_torch import types as T
    from trivy_tpu_torch.fanal.analyzers import (INDIVIDUAL_PKG_ANALYZERS,
                                                 AnalyzerGroup)
    from trivy_tpu_torch.fanal.applier import apply_layers
    from trivy_tpu_torch.fanal.artifact import FilesystemArtifact
    from trivy_tpu_torch.fanal.cache import FSCache
    from trivy_tpu_torch.secret import SecretScanner
    table, _deb, names, _raw = chip_smoke.apps_table(
        np.random.default_rng(7), shrink=10)
    db = str(tmp_path / "apps.npz")
    table.save(db)
    fresh = AdvisoryTable.load(db)
    cache_dir = str(tmp_path / "server-cache")
    cache = FSCache(cache_dir)
    checkouts = chip_smoke.server_checkouts(
        np.random.default_rng(9), names, n_distinct=3, n_repeat=1,
        text=(1 << 10, 2 << 10))
    refs = []
    for i, (files, _secrets) in enumerate(checkouts):
        root = str(tmp_path / f"client{i}")
        chip_smoke._write_tree(root, files)
        refs.append(FilesystemArtifact(
            root, cache, group=AnalyzerGroup(
                disabled=INDIVIDUAL_PKG_ANALYZERS + ("sbom",)),
            scanners=("vuln", "secret"),
            secret_scanner=SecretScanner(device="cpu")).inspect())
    local = LocalScanner(cache, table, device="cpu")
    opts = T.ScanOptions(scanners=("vuln", "secret"))
    serial = []
    for ref in refs:
        results, os_info = local.scan(ref.name, ref.id, ref.blob_ids, opts)
        serial.append((chip_smoke._canon(results),
                       chip_smoke._os_key(os_info)))
    local.close()
    queries = [qs for ref in refs for _n, qs in chip_smoke.scan_batches(
        table, apply_layers([cache.get_blob(b) for b in ref.blob_ids]),
        device="cpu") if qs]
    resident = BatchDetector(table, device="cpu")
    want = resident.detect_many(queries)
    resident.close()
    assert sum(map(len, want)) > 0
    walks = chip_smoke.stream_walks(
        fresh, queries, want, "cpu",
        budget_mb=fresh.device_nbytes() / (2.4 * (1 << 20)))
    assert walks["slices"]["slices"] == 4
    assert walks["budget"]["slices"] == 5
    for w in walks.values():
        assert w["uploads"]["cold_waits"] == w["cold_walks"] >= 1
        assert w["resident_device_bytes"] == 2 * w["slice_device_nbytes"]
    server = chip_smoke.stream_servers(fresh, table,
                                       (cache_dir, refs, serial), "cpu")
    assert server["healthz_stream"]["slices"] == 4
    assert server["detectd"]["dispatches"] > 0
    assert fresh._device is None
