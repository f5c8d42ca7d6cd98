"""The port's advisory join (trivy_tpu_torch.ops.join, plain torch on the
CPU) against the JAX package's join and its NumPy host mirror: exact
equality of the dense bits and of the compacted hit buffers, on random
tables, the skewed demo table, total=0 and hit-buffer overflow. Also the
CSR padding invariant the port's detector checks."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _demo_table, _queries
from trivy_tpu.detect.engine import BatchDetector as RefDetector
from trivy_tpu.detect.engine import PkgQuery as RefQuery
from trivy_tpu.ops import join as RJ
from trivy_tpu.resilience.hostjoin import (host_csr_pair_join,
                                           host_csr_pair_join_compact)
from trivy_tpu_torch.db.table import AdvisoryTable
from trivy_tpu_torch.detect import engine as DE
from trivy_tpu_torch.detect.engine import BatchDetector, PkgQuery
from trivy_tpu_torch.ops import join as J

K = 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _prefix(lo, hi):
    return J.prefix_planes(_t(lo), _t(hi))


def _random_case(seed, n_rows=300, n_ver=64, n_q=48, q_pad=64):
    """Random tokens from a tiny alphabet (so ties and first-position
    decisions are common), random flags, CSR descriptors with tail
    padding."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 3, (n_rows, K)).astype(np.int32)
    hi = rng.integers(0, 3, (n_rows, K)).astype(np.int32)
    # long shared prefixes: the decision falls deep in the vector
    lo[:, :30] = 1
    hi[:, :30] = 1
    flags = rng.integers(0, 64, n_rows).astype(np.int32)
    ver = rng.integers(0, 3, (n_ver, K)).astype(np.int32)
    ver[:, :30] = 1
    q_start = np.zeros(q_pad, np.int32)
    q_count = np.zeros(q_pad, np.int32)
    q_ver = np.zeros(q_pad, np.int32)
    q_count[:n_q] = rng.integers(1, 20, n_q)
    # buckets lie inside the table, as the detector's searchsorted
    # makes them (the host mirror does not clamp)
    q_start[:n_q] = rng.integers(0, n_rows - q_count[:n_q])
    q_ver[:n_q] = rng.integers(0, n_ver, n_q)
    total = int(q_count.sum())
    t_pad = 1 << int(np.ceil(np.log2(max(total, 256))))
    return lo, hi, flags, ver, q_start, q_count, q_ver, total, t_pad


def _ref_dense(case):
    lo, hi, flags, ver, qs, qc, qv, total, t_pad = case
    jax_bits = np.asarray(RJ.csr_pair_join(lo, hi, flags, ver, qs, qc, qv,
                                           np.int32(total), t_pad))
    host_bits = host_csr_pair_join(lo, hi, flags, ver, qs, qc, qv, total,
                                   t_pad)
    assert np.array_equal(jax_bits, host_bits)
    return jax_bits


def _port_dense(case):
    lo, hi, flags, ver, qs, qc, qv, total, t_pad = case
    return J.csr_pair_join(_t(lo), _t(hi), _t(flags), _t(ver), _t(qs),
                           _t(qc), _t(qv), total, t_pad,
                           prefix=_prefix(lo, hi)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_tables_dense(seed):
    case = _random_case(seed)
    want = _ref_dense(case)
    got = _port_dense(case)
    assert got.dtype == np.int8
    assert np.array_equal(got, want)
    assert (want & 1).any() and (want & 2).any()


@pytest.mark.parametrize("h_cap", [128, 1024, 4096])
def test_random_tables_compact(h_cap):
    case = _random_case(7, n_q=60)
    lo, hi, flags, ver, qs, qc, qv, total, t_pad = case
    r_idx, r_bits, r_n, r_dense = (np.asarray(x) for x in
                                   RJ.csr_pair_join_compact(
                                       lo, hi, flags, ver, qs, qc, qv,
                                       np.int32(total), t_pad, h_cap))
    h = host_csr_pair_join_compact(lo, hi, flags, ver, qs, qc, qv, total,
                                   t_pad, h_cap)
    got = J.csr_pair_join_compact(_t(lo), _t(hi), _t(flags), _t(ver),
                                  _t(qs), _t(qc), _t(qv), total, t_pad,
                                  h_cap, prefix=_prefix(lo, hi))
    g_idx, g_bits, g_n, g_dense = (x.numpy() for x in got)
    assert int(g_n) == int(r_n) == h[2]
    assert np.array_equal(g_idx, r_idx) and np.array_equal(g_idx, h[0])
    assert np.array_equal(g_bits, r_bits) and np.array_equal(g_bits, h[1])
    assert np.array_equal(g_dense, r_dense)
    n = min(int(g_n), h_cap)
    assert np.all(np.diff(g_idx[:n]) > 0)   # strictly ascending


def test_overflow_keeps_prefix_and_true_count():
    case = _random_case(11, n_q=60)
    lo, hi, flags, ver, qs, qc, qv, total, t_pad = case
    h_cap = 128
    got = J.csr_pair_join_compact(_t(lo), _t(hi), _t(flags), _t(ver),
                                  _t(qs), _t(qc), _t(qv), total, t_pad,
                                  h_cap, prefix=_prefix(lo, hi))
    dense = _ref_dense(case)
    nz = np.nonzero(dense)[0]
    assert int(got[2]) == nz.size > h_cap
    assert np.array_equal(got[0].numpy(), nz[:h_cap])
    assert np.array_equal(got[1].numpy(), dense[nz[:h_cap]])


def test_total_zero():
    case = list(_random_case(5))
    case[5] = np.zeros_like(case[5])   # every count zero
    case[7] = 0
    case = tuple(case)
    assert not _port_dense(case).any()
    assert np.array_equal(_port_dense(case), _ref_dense(case))
    lo, hi, flags, ver, qs, qc, qv, total, t_pad = case
    idx, bits, n, dense = J.csr_pair_join_compact(
        _t(lo), _t(hi), _t(flags), _t(ver), _t(qs), _t(qc), _t(qv), 0,
        t_pad, 128, prefix=_prefix(lo, hi))
    assert int(n) == 0 and not idx.any() and not bits.any()


def _demo_case(skew_rows=96):
    table = _demo_table(skew_pkg_rows=skew_rows)
    det = RefDetector(table)
    prep = det._prepare(_queries(include_skew=True))
    ver = det.ver_snapshot(prep.u_pad)
    return table, (table.lo_tok, table.hi_tok, table.flags, ver,
                   prep.q_start, prep.q_count, prep.q_ver, prep.n_pairs,
                   int(prep.pair_row.shape[0]))


def test_skewed_demo_table():
    _table, case = _demo_case()
    want = _ref_dense(case)
    assert np.array_equal(_port_dense(case), want)
    assert want.any()


def _port_table(ref):
    return AdvisoryTable.from_numpy(ref.hash, ref.lo_tok, ref.hi_tok,
                                    ref.flags, ref.group, ref.groups,
                                    ref.window, ref.details, ref.aux)


def _hit_keys(hits):
    return [(h.query.name, h.query.version, h.vuln_id, h.fixed_version,
             h.status, h.severity) for h in hits]


@pytest.mark.parametrize("compact", [False, True])
def test_detector_hits_match_reference(compact, monkeypatch):
    ref_table = _demo_table(skew_pkg_rows=96)
    qs = _queries(include_skew=True, batch=256)
    want = RefDetector(ref_table, compact=compact, hit_floor=8,
                       hit_align=8).detect(
        [RefQuery(q.source, q.ecosystem, q.name, q.version) for q in qs])
    # the port always compacts when a hit buffer beats the dense fetch:
    # a small floor engages it, a floor past t_pad keeps the batch dense
    floor = 8 if compact else 1 << 30
    monkeypatch.setattr(DE, "_HIT_FLOOR", floor)
    monkeypatch.setattr(DE, "_HIT_ALIGN", 8)
    port = BatchDetector(_port_table(ref_table), device="cpu")
    launched = []
    launch = port._launch

    def record(*args):
        launched.append(launch(*args))
        return launched[-1]
    monkeypatch.setattr(port, "_launch", record)
    got = port.detect([PkgQuery(q.source, q.ecosystem, q.name, q.version)
                       for q in qs])
    assert _hit_keys(got) == _hit_keys(want)
    assert got
    assert isinstance(launched[0], DE._PendingCompact) == compact


def test_prefix_planes_are_first_tokens():
    """The join kernel's derived [A, 4] planes: each bound's first four
    tokens, contiguous, uploaded once with the table, and required by
    both entry points."""
    ref = _demo_table(skew_pkg_rows=96)
    table = _port_table(ref)
    lo, hi, flags, lo_pre, hi_pre = table.device_arrays("cpu")
    assert J.PREFIX_TOKENS == 4
    for pre, full, ref_tok in ((lo_pre, lo, ref.lo_tok),
                               (hi_pre, hi, ref.hi_tok)):
        assert pre.dtype == torch.int32 and pre.is_contiguous()
        assert pre.shape == (len(table), 4)
        assert torch.equal(pre, full[:, :4])
        assert np.array_equal(pre.numpy(), np.asarray(ref_tok)[:, :4])
    assert table.device_arrays(torch.device("cpu"))[3] is lo_pre
    case = _random_case(0)
    with pytest.raises(TypeError, match="prefix"):
        J.csr_pair_join(*(_t(a) for a in case[:7]), *case[7:])
    with pytest.raises(TypeError, match="prefix"):
        J.csr_pair_join_compact(*(_t(a) for a in case[:7]), *case[7:], 128)


def test_pair_owners_equal_reference_pairs():
    """The port keeps only CSR descriptors; the (query, row) it reads off
    them per slot is the reference's dense pair_q/pair_row."""
    ref_table = _demo_table(skew_pkg_rows=96)
    qs = _queries(include_skew=True, batch=256)
    ref = RefDetector(ref_table)._prepare(
        [RefQuery(q.source, q.ecosystem, q.name, q.version) for q in qs])
    port = BatchDetector(_port_table(ref_table), device="cpu")
    prep = port._prepare([PkgQuery(q.source, q.ecosystem, q.name, q.version)
                          for q in qs])
    assert (prep.n_pairs, prep.t_pad) == \
        (ref.n_pairs, int(ref.pair_row.shape[0]))
    qidx, rows = port.pair_owners(prep, np.arange(prep.n_pairs))
    assert np.array_equal(qidx, ref.pair_q)
    assert np.array_equal(rows, ref.pair_row[:ref.n_pairs])


def test_interior_zero_count_raises():
    q_count = np.array([3, 0, 2, 0], np.int32)
    with pytest.raises(ValueError):
        J.check_csr_descriptors(q_count, 3)
    J.check_csr_descriptors(np.array([3, 1, 2, 0], np.int32), 3)
    with pytest.raises(ValueError):   # padding must be zero
        J.check_csr_descriptors(np.array([3, 1, 2, 4], np.int32), 3)
    det = BatchDetector(_port_table(_demo_table()), device="cpu")
    z = np.zeros(4, np.int32)
    with pytest.raises(ValueError):
        det._launch(z, q_count, z, 3, 5, 256, 128)
