"""detectd in the port (trivy_tpu_torch/detect/sched.py), on the CPU with
the plain join: the mirror of tests/test_sched.py without its metric
series (not ported). Coalesced results must equal serial per-request
detect_many hit for hit (order included), the same seeded batches
through the JAX package's DispatchScheduler and the port's at c=8 must
give equal hits, close() must leave no thread, and a table swap must
wait for the request that straddles it. Also the detector's locking:
16 threads preparing and detecting with overlapping new versions give
a serial run's hits, and the version pool holds each key once."""

import glob
import os
import random
import sys
import threading
import time
from collections import deque

import numpy as np
import pytest

from trivy_tpu.db import build_table as ref_build_table
from trivy_tpu.db.fixtures import load_fixture_files as ref_load_fixtures
from trivy_tpu.detect import BatchDetector as RefDetector
from trivy_tpu.detect import DispatchScheduler as RefScheduler
from trivy_tpu.detect import PkgQuery as RefQuery
from trivy_tpu.detect import SchedOptions as RefOptions
from trivy_tpu.ops import bucket_ladder as ref_bucket_ladder
from trivy_tpu_torch import version as V
from trivy_tpu_torch.db import build_table
from trivy_tpu_torch.db.fixtures import load_fixture_files
from trivy_tpu_torch.detect.engine import BatchDetector, PkgQuery
from trivy_tpu_torch.detect.sched import DispatchScheduler, SchedOptions
from trivy_tpu_torch.ops import bucket_ladder, bucket_size, next_pow2

FIXTURES = sorted(glob.glob(
    os.path.join(os.path.dirname(__file__), "fixtures", "db", "*.yaml")))
JOIN_TIMEOUT = 120


@pytest.fixture(scope="module")
def table():
    advisories, details, _ = load_fixture_files(FIXTURES)
    t = build_table(advisories, details)
    assert len(t) > 0
    return t


def _det(table, **kw):
    return BatchDetector(table, device="cpu", **kw)


# query pool: known-vulnerable, known-clean, unknown-package (empty
# bucket) and unparseable-version shapes
_POOL = [
    ("alpine 3.17", "alpine", "openssl", "3.0.7-r0"),
    ("alpine 3.17", "alpine", "openssl", "3.0.8-r0"),
    ("alpine 3.17", "alpine", "musl", "1.2.3-r4"),
    ("alpine 3.17", "alpine", "zlib", "1.2.12-r2"),
    ("alpine 3.18", "alpine", "openssl", "3.0.8-r0"),
    ("debian 11", "debian", "openssl", "1.1.1n-0+deb11u3"),
    ("debian 11", "debian", "bash", "5.1-2+deb11u1"),
    ("pip::GitHub Security Advisory Pip", "pip", "flask", "2.2.2"),
    ("pip::GitHub Security Advisory Pip", "pip", "flask", "2.3.1"),
    ("pip::GitHub Security Advisory Pip", "pip", "requests", "2.30.0"),
    ("npm::GitHub Security Advisory Npm", "npm", "lodash", "4.17.20"),
    ("debian 11", "debian", "openssl", "not!!a@version"),
]


def _rand_query(rng: random.Random, i: int, cls=PkgQuery):
    # ~60% empty-bucket queries, as in a real image
    if rng.random() < 0.6:
        return cls(source="alpine 3.17", ecosystem="alpine",
                   name=f"no-such-package-{i}", version="1.0.0")
    s, e, n, v = _POOL[rng.randrange(len(_POOL))]
    return cls(source=s, ecosystem=e, name=n, version=v, ref=i)


def _rand_requests(seed: int, n_requests: int, cls=PkgQuery):
    rng = random.Random(seed)
    return [[[_rand_query(rng, rng.randrange(1000), cls)
              for _ in range(rng.randrange(0, 14))]
             for _ in range(rng.randrange(1, 4))]
            for _ in range(n_requests)]


def _hammer(detect, requests, n_threads):
    results: list = [None] * len(requests)
    errors: list = []

    def worker(ids):
        try:
            for i in ids:
                results[i] = detect(requests[i])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(
        target=worker, args=(range(k, len(requests), n_threads),))
        for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive()
    return results, errors


def _keys(hits):
    return [(h.query.name, h.query.version, h.query.ref, h.vuln_id,
             h.fixed_version, h.status, h.severity) for h in hits]


class TestEquivalence:
    def test_hammer_coalesced_equals_serial(self, table):
        requests = _rand_requests(11, 24)
        serial = _det(table)
        expected = [serial.detect_many(b) for b in requests]
        det = _det(table)
        sched = DispatchScheduler(det, SchedOptions(coalesce_wait_ms=5.0))
        try:
            results, errors = _hammer(sched.detect_many, requests, 6)
        finally:
            sched.close()
            det.close()
        assert not errors
        assert results == expected

    def test_hammer_empty_bucket_heavy(self, table):
        rng = random.Random(3)
        requests = [[[PkgQuery(source="alpine 3.17", ecosystem="alpine",
                               name=f"ghost-{rng.randrange(50)}",
                               version="1.0")
                      for _ in range(rng.randrange(0, 6))]]
                    for _ in range(16)]
        serial = _det(table)
        expected = [serial.detect_many(b) for b in requests]
        det = _det(table)
        sched = DispatchScheduler(det, SchedOptions(coalesce_wait_ms=2.0))
        try:
            results, errors = _hammer(sched.detect_many, requests, 4)
        finally:
            sched.close()
            det.close()
        assert not errors
        assert results == expected

    def test_detect_many_equals_per_batch(self, table):
        requests = _rand_requests(7, 10)
        flat = [b for req in requests for b in req]
        serial = _det(table)
        expected = [serial.detect_many([b])[0] for b in flat]
        assert _det(table).detect_many(flat) == expected

    def test_merged_dispatch_bits_identical(self, table):
        """Each prep's slice of a merged dispatch equals its solo
        dispatch, bit for bit."""
        det = _det(table)
        preps = [det._prepare(req[0]) for req in _rand_requests(5, 6)]
        preps = [p for p in preps if p is not None and p.n_pairs]
        assert len(preps) >= 2
        dev, offsets, t_pad = det.dispatch_merged(preps)
        assert t_pad >= sum(p.n_pairs for p in preps)
        bits = det.fetch_merged(dev, preps, offsets, t_pad)
        bits = bits.dense() if hasattr(bits, "dense") else bits
        for p, off in zip(preps, offsets):
            solo = det._fetch_bits(det._launch(
                p.q_start, p.q_count, p.q_ver, p.n_queries, p.n_pairs,
                p.t_pad, p.u_pad, h_cap=0))[:p.n_pairs]
            assert (bits[off:off + p.n_pairs] == solo).all()
        det.close()

    def test_small_pair_budget_still_correct(self, table):
        """A pair budget smaller than one request forces chunked merged
        dispatches and backpressure; results must not change."""
        requests = _rand_requests(13, 8)
        serial = _det(table)
        expected = [serial.detect_many(b) for b in requests]
        det = _det(table)
        sched = DispatchScheduler(det, SchedOptions(
            coalesce_wait_ms=5.0, max_pairs_in_flight=128))
        got = [sched.detect_many(b) for b in requests]
        sched.close()
        det.close()
        assert got == expected

    def test_jax_and_port_schedulers_agree_at_c8(self, table):
        """The same seeded batches through the JAX package's detectd and
        the port's, eight threads each, give equal hits."""
        advisories, details, _ = ref_load_fixtures(FIXTURES)
        ref_det = RefDetector(ref_build_table(advisories, details))
        ref_sched = RefScheduler(ref_det, RefOptions(coalesce_wait_ms=5.0))
        ref_requests = _rand_requests(21, 32, RefQuery)
        port_requests = _rand_requests(21, 32)
        det = _det(table)
        sched = DispatchScheduler(det, SchedOptions(coalesce_wait_ms=5.0))
        try:
            want, ref_err = _hammer(ref_sched.detect_many, ref_requests, 8)
            got, err = _hammer(sched.detect_many, port_requests, 8)
        finally:
            ref_sched.close()
            ref_det.close()
            sched.close()
            det.close()
        assert not ref_err and not err
        assert [[_keys(h) for h in r] for r in got] == \
            [[_keys(h) for h in r] for r in want]
        assert sum(len(h) for r in got for h in r) > 0


class TestLifecycle:
    def test_close_idempotent_and_no_threads_survive(self, table):
        before = set(threading.enumerate())
        det = _det(table)
        sched = DispatchScheduler(det, SchedOptions(coalesce_wait_ms=1.0))
        assert sched.detect([PkgQuery(source="alpine 3.17",
                                      ecosystem="alpine", name="openssl",
                                      version="3.0.7-r0")])
        sched.close()
        sched.close()   # idempotent
        det.close()
        det.close()     # idempotent
        leftover = [t for t in threading.enumerate()
                    if t not in before and t.is_alive()]
        assert leftover == [], [t.name for t in leftover]

    def test_submit_after_close_raises(self, table):
        det = _det(table)
        sched = DispatchScheduler(det)
        sched.close()
        with pytest.raises(RuntimeError):
            sched.submit([[PkgQuery(source="alpine 3.17",
                                    ecosystem="alpine", name="openssl",
                                    version="3.0.7-r0")]])
        det.close()

    def test_swap_waits_for_straddling_request(self, table, tmp_path):
        """A request started before swap_table may hold the old scanner
        for its whole life: the old engine stays usable until that
        request finishes, then closes."""
        from trivy_tpu_torch.server.listen import ServerState
        state = ServerState(table, str(tmp_path), device="cpu")
        old = state.scanner
        gen = state.request_started()     # the straddling request
        state.swap_table(table)
        assert state.scanner is not old
        assert old.sched.detect([PkgQuery(
            source="alpine 3.17", ecosystem="alpine", name="openssl",
            version="3.0.7-r0")])
        assert not old.detector._closed
        state.request_finished(gen)
        for _ in range(200):
            if old.detector._closed:
                break
            time.sleep(0.05)
        assert old.detector._closed
        state.close()

    def test_server_state_swap_and_close_join_workers(self, table,
                                                      tmp_path):
        from trivy_tpu_torch.server.listen import ServerState
        before = set(threading.enumerate())
        state = ServerState(table, str(tmp_path), device="cpu")
        state.scanner.sched.detect([PkgQuery(
            source="alpine 3.17", ecosystem="alpine", name="openssl",
            version="3.0.7-r0")])
        state.swap_table(table)
        state.swap_table(table)
        state.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            after = [t for t in threading.enumerate()
                     if t not in before and t.is_alive()
                     and t.name.startswith(("detectd", "detect-get"))]
            if not after:
                break
            time.sleep(0.05)
        assert after == []


class TestBucketLadder:
    def test_growth_two_matches_next_pow2(self):
        for n in (0, 1, 7, 255, 256, 257, 1000, 4096, 70000):
            assert bucket_size(n, 256, 2.0) == next_pow2(n, 256)
            assert bucket_size(n, 64, 2.0, align=64) == next_pow2(n, 64)

    def test_sub_two_growth_is_monotonic_aligned_and_denser(self):
        prev = 0
        for n in range(1, 50000, 777):
            b = bucket_size(n, 256, 1.5)
            assert b >= n and b >= prev
            assert b % 128 == 0
            prev = b
        assert bucket_size(70000, 256, 1.5) < next_pow2(70000, 256)

    def test_ladder_covers_max_and_matches_bucket_size(self):
        rungs = bucket_ladder(100_000, 256, 2.0)
        assert rungs[0] == 256 and rungs[-1] >= 100_000
        assert rungs == sorted(set(rungs))
        for r in rungs:
            assert bucket_size(r, 256, 2.0) == r

    def test_bad_growth_rejected(self):
        with pytest.raises(ValueError):
            bucket_size(10, 256, 1.0)

    def test_warmup_launches_every_rung_like_reference(self, table,
                                                       monkeypatch):
        """One empty launch per rung plus the neighbouring hit-buffer
        rungs, and the JAX warmup's rung count."""
        det = _det(table)
        launches = []
        launch = det._launch
        monkeypatch.setattr(det, "_launch", lambda *a, **k: launches.append(
            (a[5], k.get("h_cap"))) or launch(*a, **k))
        rungs = det.warmup(max_pairs=1 << 11)
        assert rungs == len(ref_bucket_ladder(1 << 11, 256, 2.0)) == 4
        assert [t for t, _ in launches if _ is None] == \
            bucket_ladder(1 << 11, 256, 2.0)
        assert all(t in bucket_ladder(1 << 11, 256, 2.0)
                   for t, _ in launches)
        det.close()


class _FakeReq:
    """Stand-in for _Request: the fair-queue helpers read only .tenant
    and .n_pairs."""
    __slots__ = ("tenant", "n_pairs")

    def __init__(self, tenant, n_pairs):
        self.tenant = tenant
        self.n_pairs = n_pairs


def _bare_sched(share=1.0):
    """A DispatchScheduler shell with only the fair-queue state: no
    dispatcher thread, no detector."""
    s = DispatchScheduler.__new__(DispatchScheduler)
    s.opts = SchedOptions(tenant_max_share=share)
    s._fair = {}
    s._rr = deque()
    s._deficit = {}
    s._fair_pairs = 0
    return s


class TestFairQueue:
    def test_share_cap_bounds_flooding_tenant(self):
        s = _bare_sched(share=0.5)
        for _ in range(20):
            s._fair_put_locked(_FakeReq("flood", 1))
        for _ in range(2):
            s._fair_put_locked(_FakeReq("victim", 1))
        by = {}
        for r in s._fair_take_locked(10):
            by[r.tenant] = by.get(r.tenant, 0) + r.n_pairs
        assert by["flood"] <= 5
        assert by["victim"] == 2
        assert s._fair_pairs == 22 - sum(by.values())

    def test_solo_tenant_gets_full_budget_despite_share(self):
        s = _bare_sched(share=0.25)
        for _ in range(8):
            s._fair_put_locked(_FakeReq("solo", 1))
        assert len(s._fair_take_locked(8)) == 8
        assert s._fair_pairs == 0

    def test_deficit_carries_across_rounds(self):
        s = _bare_sched()
        s._fair_put_locked(_FakeReq("small", 1))
        s._fair_put_locked(_FakeReq("small", 1))
        s._fair_put_locked(_FakeReq("big", 6))
        r1 = s._fair_take_locked(4)    # quantum = 2 per tenant
        assert [r.tenant for r in r1] == ["small", "small"]
        assert s._deficit["big"] >= 2.0
        r2 = s._fair_take_locked(4)
        assert [r.tenant for r in r2] == ["big"]
        assert s._fair_pairs == 0

    def test_forced_progress_oversize_head(self):
        s = _bare_sched()
        s._fair_put_locked(_FakeReq("whale", 1000))
        s._fair_put_locked(_FakeReq("whale", 1))
        taken = s._fair_take_locked(8)
        assert len(taken) >= 1 and taken[0].n_pairs == 1000
        assert s._fair_pairs <= 1

    def test_rotation_rotates_between_rounds(self):
        s = _bare_sched()
        s._fair_put_locked(_FakeReq("a", 1))
        s._fair_put_locked(_FakeReq("b", 1))
        order0 = list(s._rr)
        s._fair_take_locked(1)
        assert list(s._rr) == order0[1:] + order0[:1]

    def test_peek_interleaves_one_per_tenant_per_lap(self):
        s = _bare_sched()
        for _ in range(3):
            s._fair_put_locked(_FakeReq("a", 1))
            s._fair_put_locked(_FakeReq("b", 1))
        assert [r.tenant for r in s._peek_fair_locked(4)] == \
            ["a", "b", "a", "b"]
        assert len(s._fair["a"]) == 3 and len(s._fair["b"]) == 3
        assert s._fair_pairs == 6
        assert len(s._peek_fair_locked(100)) == 6

    def test_requests_key_on_the_clamped_tenant(self, table):
        """A request's fair-queue key is its tenant's clamped label, and
        "system" outside a request."""
        from trivy_tpu_torch.obs.cost import (TENANTS, normalize_tenant,
                                              request_tenant)
        from trivy_tpu_torch.detect.sched import _Request
        assert _Request(0).tenant == "system"
        with request_tenant(normalize_tenant("team-a")):
            assert _Request(0).tenant == TENANTS.resolve("team-a")
        with request_tenant(normalize_tenant("\x00" * 3)):
            assert _Request(0).tenant == "___"
        with request_tenant(normalize_tenant("")):
            assert _Request(0).tenant == "default"


class TestDetectorThreadSafety:
    """The server's handler threads share one detector: the version
    pool, the hash cache, the hit budget, the group columns and the
    table's device upload are guarded."""

    def test_sixteen_threads_equal_serial_and_pool_holds_keys_once(
            self, table, monkeypatch):
        # overlapping new versions, met in nearly the same order by
        # every thread, so that threads race to add the same key
        versions = [f"3.0.{i}-r{j}" for i in range(12) for j in range(3)]
        batches = []
        for t in range(16):
            qs = []
            for k in range(48):
                v = versions[(k + t % 3) % len(versions)]
                name = ("openssl", "musl", "zlib", f"ghost-{k}")[k % 4]
                qs.append(PkgQuery(source="alpine 3.17", ecosystem="alpine",
                                   name=name, version=v, ref=(t, k)))
            batches.append(qs)
        serial = [_det(table).detect(qs) for qs in batches]
        det = _det(table)
        # widen the window between a key's lookup and its slot: the
        # encode sleeps, so the other threads reach the same key
        encode = V.encode_version

        def slow_encode(eco, ver):
            time.sleep(0.0005)
            return encode(eco, ver)
        monkeypatch.setattr(V, "encode_version", slow_encode)
        barrier = threading.Barrier(16)
        got: list = [None] * 16
        preps: list = [None] * 16
        errors: list = []

        def worker(i):
            try:
                barrier.wait()
                preps[i] = det._prepare(batches[i])
                got[i] = det.detect_many([batches[i]])[0]
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(JOIN_TIMEOUT)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        assert not errors
        assert [_keys(h) for h in got] == [_keys(h) for h in serial]
        # each (ecosystem, version) once, each row its own tokens
        keys = {("alpine", q.version) for qs in batches for q in qs}
        rows = [det._ver_idx[k] for k in keys]
        assert det._ver_count == len(keys) == len(set(rows))
        assert sorted(rows) == list(range(len(keys)))
        for (eco, ver), row in zip(keys, rows):
            assert np.array_equal(det._ver_mat[row],
                                  encode(eco, ver).tokens)
        # every prep's version rows name its own queries' versions
        for i, prep in enumerate(preps):
            for q_ver, (q, _exact) in zip(prep.q_ver[:prep.n_queries],
                                          (prep.usable[j] for j in
                                           prep.q_usable)):
                assert det._ver_idx[("alpine", q.version)] == q_ver

    def test_table_uploads_once_under_threads(self, table, monkeypatch):
        from trivy_tpu_torch.db.table import AdvisoryTable
        from trivy_tpu_torch.ops import join as J
        planes = J.prefix_planes

        def slow_planes(lo, hi):   # widens the first upload's window
            time.sleep(0.001)
            return planes(lo, hi)
        monkeypatch.setattr(J, "prefix_planes", slow_planes)
        fresh = AdvisoryTable.from_numpy(
            table.hash, table.lo_tok, table.hi_tok, table.flags,
            table.group, table.groups, table.window, table.details,
            table.aux)
        barrier = threading.Barrier(16)
        seen: list = [None] * 16

        def worker(i):
            barrier.wait()
            seen[i] = fresh.device_arrays("cpu")

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(JOIN_TIMEOUT)
        finally:
            sys.setswitchinterval(old)
        assert all(s is seen[0] for s in seen)
