"""The dedup half of graftfeed in the port (trivy_tpu_torch/detect/
feed.py), on the CPU: the mirror of tests/test_feed.py's scatter-back
properties, each plan array equal to the JAX package's on the same
inputs; the merged dispatch with and without dedup, dense and
compacted, giving the same bits over the full merged pair space; a c=8
duplicate-heavy hammer through detectd equal to serial. Where the JAX
package rebuilds a failed fetch on the host, the port fails every
request the dispatch carried and answers nothing from the host.

The staged query uploads: test_feed.py's
test_query_upload_ledger_steady_state against the port (every detectd
dispatch takes columns staged ahead, none cold), a staged merged
dispatch equal to the inline one, the detector's own launches ledgered
as cold, and a staging error failing the requests of its dispatch. The
failpoint drills of test_feed.py (hung and failing uploads degrading to
the host join) have no subject here: the port has no failpoints and no
host join."""

import random
import threading

import numpy as np
import pytest
import torch

from trivy_tpu.detect import feed as ref_feed
from trivy_tpu.resilience.hostjoin import CompactBits as RefCompactBits
from trivy_tpu_torch.detect import engine as DE
from trivy_tpu_torch.detect import feed as _feed
from trivy_tpu_torch.detect.engine import BatchDetector, CompactBits, PkgQuery
from trivy_tpu_torch.detect.sched import DispatchScheduler, SchedOptions
from trivy_tpu_torch.resilience.storm import storm_table

JOIN_TIMEOUT = 120
PLAN_FIELDS = ("u_start", "u_count", "u_ver", "n_unique", "unique_total",
               "ustart", "goff", "counts", "total", "unique_by_prep",
               "collapsed_by_prep")


@pytest.fixture(scope="module")
def big_table():
    # the port's graftstorm table, column for column the JAX package's
    # (tests/test_torch_storm.py test_workload_equals_reference)
    return storm_table(n_pkgs=96)


def _keys(hits):
    return [(h.query.name, h.query.version, h.vuln_id) for h in hits]


def _dense(bits) -> np.ndarray:
    return bits.dense() if isinstance(bits, CompactBits) \
        else np.asarray(bits)


def _dup_queries(seed: int, n: int, pool: int = 8):
    """Duplicate-heavy traffic: a handful of storm triples repeated
    across every request, and a couple of empty buckets."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        k = rng.randrange(pool + 2)
        out.append(PkgQuery(source="alpine 3.17", ecosystem="alpine",
                            name=f"storm-pkg-{k}",
                            version=f"{1 + k % 3}.{k % 10}.0-r0"))
    return out


def _segment(start: int, count: int, ver: int) -> np.ndarray:
    """Deterministic per-triple pair bits: equal triples map to equal
    segments, the invariant the dedup rides on."""
    base = np.arange(count, dtype=np.int64)
    return (((start * 31 + ver * 7 + base) % 3) != 0).astype(np.int8)


def _synthetic(rng: np.random.Generator, nq: int, n_pool: int):
    """nq query triples drawn from n_pool distinct ones, split into
    random prep chunks."""
    pool_start = rng.permutation(4096)[:n_pool].astype(np.int64)
    pool_count = rng.integers(1, 7, n_pool)
    pool_ver = rng.integers(0, 64, n_pool)
    pick = rng.integers(0, n_pool, nq)
    qs = pool_start[pick].astype(np.int32)
    qc = pool_count[pick].astype(np.int32)
    qv = pool_ver[pick].astype(np.int32)
    cuts = np.sort(rng.choice(np.arange(1, nq), size=min(3, nq - 1),
                              replace=False)) if nq > 1 else []
    prep_nq = np.diff(np.concatenate([[0], cuts, [nq]])).tolist()
    return qs, qc, qv, prep_nq


def _plans(qs, qc, qv, prep_nq):
    """The port's plan, held field by field to the JAX package's."""
    plan = _feed.plan_merged(qs, qc, qv, prep_nq)
    ref = ref_feed.plan_merged(qs, qc, qv, prep_nq)
    assert (plan is None) == (ref is None)
    if plan is not None:
        for f in PLAN_FIELDS:
            got, want = getattr(plan, f), getattr(ref, f)
            assert np.asarray(got).dtype == np.asarray(want).dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    return plan, ref


class TestPlanScatterBack:
    @pytest.mark.parametrize("nq,n_pool", [(24, 1), (24, 6), (24, 12),
                                           (7, 3)])
    def test_dense_scatter_is_bit_identical(self, nq, n_pool):
        rng = np.random.default_rng(nq * 100 + n_pool)
        qs, qc, qv, prep_nq = _synthetic(rng, nq, n_pool)
        plan, ref = _plans(qs, qc, qv, prep_nq)
        assert plan is not None
        assert plan.n_unique <= n_pool
        assert plan.total == int(qc.sum())
        assert plan.unique_total == int(plan.u_count.sum())
        assert plan.unique_total < plan.total
        assert int(plan.unique_by_prep.sum()) == plan.unique_total
        assert int(plan.unique_by_prep.sum()
                   + plan.collapsed_by_prep.sum()) == plan.total
        bits_u = np.concatenate(
            [_segment(int(s), int(c), int(v)) for s, c, v in
             zip(plan.u_start, plan.u_count, plan.u_ver)])
        expect = np.concatenate(
            [_segment(int(s), int(c), int(v)) for s, c, v in
             zip(qs, qc, qv)])
        t_pad = plan.total + 13
        out = _feed.expand_bits(plan, bits_u, t_pad)
        assert out.shape == (t_pad,)
        np.testing.assert_array_equal(out[:plan.total], expect)
        assert not out[plan.total:].any()
        np.testing.assert_array_equal(
            out, ref_feed.expand_bits(ref, bits_u, t_pad))
        # the padded launch descriptors equal the JAX package's
        for got, want in zip(_feed.padded_unique(plan, 256, 2.0),
                             ref_feed.padded_unique(ref, 256, 2.0)):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("nq,n_pool", [(24, 1), (24, 6), (9, 4)])
    def test_compact_scatter_is_bit_identical(self, nq, n_pool):
        rng = np.random.default_rng(7000 + nq * 10 + n_pool)
        qs, qc, qv, prep_nq = _synthetic(rng, nq, n_pool)
        plan, ref = _plans(qs, qc, qv, prep_nq)
        bits_u = np.concatenate(
            [_segment(int(s), int(c), int(v)) for s, c, v in
             zip(plan.u_start, plan.u_count, plan.u_ver)])
        t_pad = plan.total + 5
        dense = _feed.expand_bits(plan, bits_u, t_pad)
        nz = np.nonzero(bits_u)[0]
        cb = _feed.expand_bits(plan, CompactBits(
            nz.astype(np.int32), bits_u[nz], len(bits_u)), t_pad)
        assert isinstance(cb, CompactBits)
        assert cb.n_pairs == t_pad
        if cb.pair_idx.size > 1:
            assert (np.diff(cb.pair_idx) > 0).all()
        np.testing.assert_array_equal(cb.dense(), dense)
        want = ref_feed.expand_bits(ref, RefCompactBits(
            nz.astype(np.int32), bits_u[nz], len(bits_u)), t_pad)
        np.testing.assert_array_equal(cb.pair_idx, want.pair_idx)
        np.testing.assert_array_equal(cb.bits, want.bits)
        # a slice of the expanded bits is the dense vector's window
        for off, n in ((0, 3), (2, 7), (plan.total - 4, 4)):
            np.testing.assert_array_equal(
                cb.slice(off, n).dense(), dense[off:off + n])

    def test_compact_scatter_empty_hits(self):
        rng = np.random.default_rng(3)
        qs, qc, qv, prep_nq = _synthetic(rng, 16, 4)
        plan, _ref = _plans(qs, qc, qv, prep_nq)
        cb = _feed.expand_bits(
            plan, CompactBits(np.zeros(0, np.int32), np.zeros(0, np.int8),
                              plan.unique_total), plan.total + 7)
        assert cb.pair_idx.size == 0 and cb.n_pairs == plan.total + 7

    def test_all_unique_returns_none(self):
        rng = np.random.default_rng(11)
        qs, qc, qv, prep_nq = _synthetic(rng, 16, 16)
        qs = np.arange(16, dtype=np.int32)
        assert _plans(qs, qc, qv, prep_nq)[0] is None

    def test_degenerate_sizes_return_none(self):
        one = np.asarray([5], np.int32)
        assert _plans(one, one, one, [1])[0] is None
        z = np.zeros(0, np.int32)
        assert _plans(z, z, z, [])[0] is None


class TestDetectorDedupPaths:
    def _preps(self, det, seed: int, n_batches: int = 5):
        batches = [_dup_queries(seed + b, 20) for b in range(n_batches)]
        return [p for p in (det._prepare(b) for b in batches)
                if p is not None and p.n_pairs > 0]

    @pytest.mark.parametrize("compact", [False, True])
    def test_merged_dispatch_dedup_bits_identical(self, big_table,
                                                  compact, monkeypatch):
        """dispatch_merged with the dedup plan, on the dense and the
        compacted route, gives the bits the undeduped dispatch does over
        the full merged pair space; plan_from_preps equals the plan of
        the merged descriptors."""
        monkeypatch.setattr(DE, "_HIT_FLOOR", 8 if compact else 1 << 30)
        monkeypatch.setattr(DE, "_HIT_ALIGN", 8)
        det = BatchDetector(big_table, device="cpu")
        try:
            preps = self._preps(det, 500)
            total = sum(p.n_pairs for p in preps)
            plan = _feed.plan_from_preps(preps)
            qs, qc, qv = det._merge_descriptors(preps)[:3]
            merged = _feed.plan_merged(qs, qc, qv,
                                       [p.n_queries for p in preps])
            for f in PLAN_FIELDS:
                np.testing.assert_array_equal(getattr(plan, f),
                                              getattr(merged, f))
            dev, off_on, tp_on = det.dispatch_merged(preps, plan=plan)
            assert isinstance(dev, _feed.PendingExpand)
            assert dev.plan.unique_total < total
            assert isinstance(dev.dev, DE._PendingCompact) == compact
            # (a compacted launch whose hits overflow its buffer comes
            # back dense)
            got = det.fetch_merged(dev, preps, off_on, tp_on)
            dev2, off2, tp2 = det.dispatch_merged(preps)
            assert not isinstance(dev2, _feed.PendingExpand)
            want = _dense(det.fetch_merged(dev2, preps, off2, tp2))
            assert (off_on, tp_on) == (off2, tp2)
            np.testing.assert_array_equal(_dense(got)[:total],
                                          want[:total])
        finally:
            det.close()

    def test_failed_fetch_fails_every_merged_request(self, big_table,
                                                     monkeypatch):
        """No host join: a merged dispatch whose fetch raises fails all
        the requests it carried with that error, and none gets an
        answer. The scheduler goes on serving."""
        det = BatchDetector(big_table, device="cpu")
        requests = [[_dup_queries(640 + r, 16)] for r in range(6)]
        serial = BatchDetector(big_table, device="cpu")
        expected = [serial.detect_many(b) for b in requests]
        fetch = det._fetch_bits
        failing = {"on": True}

        def broken(dev):
            if failing["on"]:
                raise RuntimeError("injected fetch failure")
            return fetch(dev)
        monkeypatch.setattr(det, "_fetch_bits", broken)
        sched = DispatchScheduler(det, SchedOptions(coalesce_wait_ms=20.0))
        try:
            futures = [sched.submit(b) for b in requests]
            for f in futures:
                with pytest.raises(RuntimeError, match="injected"):
                    f.result(JOIN_TIMEOUT)
            failing["on"] = False
            assert [sched.detect_many(b) for b in requests] == expected
        finally:
            sched.close()
            det.close()

    def test_failed_launch_fails_the_request(self, big_table, monkeypatch):
        det = BatchDetector(big_table, device="cpu")

        def broken(*a, **k):
            raise RuntimeError("injected launch failure")
        monkeypatch.setattr(det, "_launch", broken)
        sched = DispatchScheduler(det)
        try:
            with pytest.raises(RuntimeError, match="injected launch"):
                sched.detect_many([_dup_queries(7, 16)])
        finally:
            sched.close()
            det.close()


def _hammer(sched, requests, n_threads=8):
    results: list = [None] * len(requests)
    errors: list = []

    def worker(ids):
        try:
            for i in ids:
                results[i] = sched.detect_many(requests[i])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=worker,
                           args=(range(k, len(requests), n_threads),))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive()
    return results, errors


class TestDetectdDedup:
    def _requests(self, n=24):
        return [[_dup_queries(200 + r * 2 + b, 16) for b in range(2)]
                for r in range(n)]

    def test_c8_duplicate_hammer_equals_serial(self, big_table):
        requests = self._requests()
        serial = BatchDetector(big_table, device="cpu")
        expected = [serial.detect_many(b) for b in requests]
        det = BatchDetector(big_table, device="cpu")
        sched = DispatchScheduler(
            det, SchedOptions(coalesce_wait_ms=5.0, dedup=True))
        try:
            results, errors = _hammer(sched, requests)
        finally:
            sched.close()
            det.close()
        assert not errors
        assert results == expected
        # the rounds carried duplicates, and the plan collapsed them
        st = sched.stats
        assert st["deduped"] > 0 and st["launched_pairs"] < st["pairs"]

    def test_dedup_off_is_identical_too(self, big_table):
        requests = self._requests(n=8)
        serial = BatchDetector(big_table, device="cpu")
        expected = [serial.detect_many(b) for b in requests]
        det = BatchDetector(big_table, device="cpu")
        sched = DispatchScheduler(
            det, SchedOptions(coalesce_wait_ms=5.0, dedup=False))
        try:
            results, errors = _hammer(sched, requests, n_threads=4)
        finally:
            sched.close()
            det.close()
        assert not errors
        assert results == expected
        assert sched.stats["deduped"] == 0


class TestStagedUploads:
    @pytest.fixture(autouse=True)
    def _ledger(self):
        from test_torch_obs import reset_port_obs
        reset_port_obs()
        yield
        reset_port_obs()

    def test_query_upload_ledger_steady_state(self, big_table):
        """Every detectd dispatch takes a query upload staged ahead of
        it: prefetched == uploads, no cold wait, and the transfer path
        in the exposition (test_feed.py's case, on the port)."""
        from trivy_tpu_torch.metrics import METRICS
        from trivy_tpu_torch.obs import LEDGER
        from trivy_tpu_torch.obs.exposition import parse_exposition
        det = BatchDetector(big_table, device="cpu")
        sched = DispatchScheduler(det, SchedOptions())
        try:
            for r in range(6):
                sched.detect_many([_dup_queries(300 + r, 16)])
        finally:
            sched.close()
            det.close()
        stats = LEDGER.shard_upload_stats()["query_upload"]
        assert stats["uploads"] >= 6
        assert stats["prefetched"] == stats["uploads"]
        assert stats["cold_waits"] == 0
        assert stats["bytes"] > 0
        assert stats["stall_ms"] >= stats["cold_stall_ms"] == 0
        agg = LEDGER.aggregate()
        assert agg["transfer_bytes"]["query_upload"] == stats["bytes"]
        families = parse_exposition(METRICS.render())
        transfer = families["trivy_tpu_device_transfer_bytes_total"]
        upload = [v for _n, labels, v in transfer["samples"]
                  if labels.get("path") == "query_upload"]
        assert upload and upload[0] > 0

    @pytest.mark.parametrize("dedup", [False, True])
    def test_staged_dispatch_equals_inline(self, big_table, dedup):
        det = BatchDetector(big_table, device="cpu")
        try:
            preps = TestDetectorDedupPaths()._preps(det, 900)
            plan = _feed.plan_from_preps(preps) if dedup else None
            staged = det.stage_merged(preps, plan=plan, dedup=dedup)
            assert staged.queries.error is None
            q = staged.queries.refs
            assert [t.dtype for t in q] == [torch.int32] * 3
            np.testing.assert_array_equal(q[0].numpy(), staged.launch[0])
            np.testing.assert_array_equal(q[2].numpy(), staged.launch[2])
            dev, off, tp = det.dispatch_merged(preps, staged=staged)
            got = det.fetch_merged(dev, preps, off, tp)
            dev2, off2, tp2 = det.dispatch_merged(preps, plan=plan)
            want = det.fetch_merged(dev2, preps, off2, tp2)
            assert (off, tp) == (off2, tp2)
            np.testing.assert_array_equal(_dense(got), _dense(want))
        finally:
            det.close()

    def test_detector_launches_upload_cold(self, big_table):
        """A launch with nothing staged (the per-request path) copies its
        columns inline: ledgered as not prefetched, one cold wait each."""
        from trivy_tpu_torch.obs import LEDGER
        det = BatchDetector(big_table, device="cpu")
        try:
            det.detect_many([_dup_queries(5, 16), _dup_queries(6, 16)])
        finally:
            det.close()
        stats = LEDGER.shard_upload_stats()["query_upload"]
        assert stats["uploads"] == stats["cold_waits"] == 2
        assert stats["prefetched"] == 0

    def test_staging_error_fails_its_requests(self, big_table, monkeypatch):
        """A staging error is recorded on the StagedQueries and the paired
        launch raises it: the requests of that dispatch fail with it, and
        detectd goes on serving."""
        det = BatchDetector(big_table, device="cpu")
        serial = BatchDetector(big_table, device="cpu")
        request = [_dup_queries(77, 16)]
        expected = serial.detect_many(request)
        serial.close()
        columns = _feed._columns
        broken = {"on": True}

        def failing(*a, **kw):
            if broken["on"]:
                raise RuntimeError("injected staging failure")
            return columns(*a, **kw)
        monkeypatch.setattr(_feed, "_columns", failing)
        staged = _feed.stage_queries(np.zeros(4, np.int32),
                                     np.zeros(4, np.int32),
                                     np.zeros(4, np.int32),
                                     torch.device("cpu"))
        assert staged.refs is None
        assert "injected" in str(staged.error)
        sched = DispatchScheduler(det, SchedOptions())
        try:
            with pytest.raises(RuntimeError, match="injected staging"):
                sched.detect_many(request)
            broken["on"] = False
            assert sched.detect_many(request) == expected
        finally:
            sched.close()
            det.close()
