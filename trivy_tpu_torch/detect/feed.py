"""Cross-request query dedup for detectd's merged dispatches.

When detectd merges several requests' CSR descriptors, each real query
is fully described by its key triple (bucket start, bucket count,
version-pool row). The advisory table and the version pool belong to
the detector and the join predicate is elementwise, so two queries with
the same triple give the same pair-segment bits. The plan collapses
duplicate triples into one unique-query descriptor, the join runs over
the unique queries only, and a host-side index map scatters the bits
(dense or CompactBits) back into every duplicate's pair range: the same
bits as the full merged dispatch, by construction.

The JAX package's staged query uploads (`StagedQueries`,
`upload_queries`, `stage_queries`) are not ported here (ROADMAP A8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import bucket_size
from .engine import CompactBits


@dataclass(slots=True)
class DedupPlan:
    """Unique-query collapse of one merged descriptor set, plus the
    host-side scatter-back map. All index spaces are pairs unless named
    otherwise; "global" is the merged dispatch's real pair order (the
    order _merge_descriptors concatenates preps in)."""
    # the unique-query CSR descriptor set (unpadded; padded_unique pads)
    u_start: np.ndarray       # int32[U] bucket start per unique query
    u_count: np.ndarray       # int32[U]
    u_ver: np.ndarray         # int32[U] version-pool row
    n_unique: int             # U
    unique_total: int         # pairs the deduped dispatch runs
    # scatter-back map, one row per original real query j:
    ustart: np.ndarray        # int64[Nq] unique-space pair offset of j's
    # segment (all duplicates of one triple share it)
    goff: np.ndarray          # int64[Nq] global pair offset of j
    counts: np.ndarray        # int64[Nq] pair count of j
    total: int                # real global pairs (== sum(counts))
    # per prep (chunk order == preps order): the first occurrence of a
    # triple owns its unique pairs; every later duplicate's pairs are
    # collapsed
    unique_by_prep: np.ndarray     # int64[P]
    collapsed_by_prep: np.ndarray  # int64[P]


def plan_merged(q_start: np.ndarray, q_count: np.ndarray,
                q_ver: np.ndarray,
                prep_nq: list[int]) -> DedupPlan | None:
    """The dedup plan of one merged descriptor set whose first
    sum(prep_nq) rows are the real queries, prep by prep. → None when
    every triple is unique: such a dispatch runs as merged."""
    nq = int(sum(prep_nq))
    if nq <= 1:
        return None
    key = np.stack([q_start[:nq].astype(np.int64),
                    q_count[:nq].astype(np.int64),
                    q_ver[:nq].astype(np.int64)], axis=1)
    uniq, first_idx, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True)
    u = int(uniq.shape[0])
    if u == nq:
        return None
    inv = inv.reshape(-1)
    counts = key[:, 1]
    u_off = np.zeros(u + 1, np.int64)
    np.cumsum(uniq[:, 1], out=u_off[1:])
    goff = np.zeros(nq + 1, np.int64)
    np.cumsum(counts, out=goff[1:])
    n_preps = len(prep_nq)
    prep_of = np.repeat(np.arange(n_preps),
                        np.asarray(prep_nq, np.int64))
    owner = np.zeros(nq, bool)
    owner[first_idx] = True
    unique_by_prep = np.bincount(
        prep_of[owner], weights=counts[owner],
        minlength=n_preps).astype(np.int64)
    collapsed_by_prep = np.bincount(
        prep_of[~owner], weights=counts[~owner],
        minlength=n_preps).astype(np.int64)
    return DedupPlan(
        u_start=uniq[:, 0].astype(np.int32),
        u_count=uniq[:, 1].astype(np.int32),
        u_ver=uniq[:, 2].astype(np.int32),
        n_unique=u, unique_total=int(u_off[-1]),
        ustart=u_off[:-1][inv], goff=goff[:-1],
        counts=counts, total=int(goff[-1]),
        unique_by_prep=unique_by_prep,
        collapsed_by_prep=collapsed_by_prep)


def plan_from_preps(preps) -> DedupPlan | None:
    """plan_merged over a prep list without a prior _merge_descriptors:
    the plan detectd hands dispatch_merged."""
    nq = [p.n_queries for p in preps]
    if sum(nq) <= 1:
        return None
    qs = np.concatenate([p.q_start[:p.n_queries] for p in preps])
    qc = np.concatenate([p.q_count[:p.n_queries] for p in preps])
    qv = np.concatenate([p.q_ver[:p.n_queries] for p in preps])
    return plan_merged(qs, qc, qv, nq)


def padded_unique(plan: DedupPlan, pair_floor: int, pair_growth: float):
    """Pad the plan's unique descriptors to the detector's bucket ladder
    → (q_start, q_count, q_ver, unique_total, t_pad)."""
    q_pad = bucket_size(plan.n_unique, 64, pair_growth, align=64)
    qs = np.zeros(q_pad, np.int32)
    qc = np.zeros(q_pad, np.int32)
    qv = np.zeros(q_pad, np.int32)
    qs[:plan.n_unique] = plan.u_start
    qc[:plan.n_unique] = plan.u_count
    qv[:plan.n_unique] = plan.u_ver
    t_pad = bucket_size(plan.unique_total, pair_floor, pair_growth)
    return qs, qc, qv, plan.unique_total, t_pad


def expand_bits(plan: DedupPlan, bits_u, t_pad: int):
    """Scatter unique-space join results back to the merged dispatch's
    global pair space. `bits_u` is the unique dispatch's dense int8
    vector or CompactBits; the result is of the same kind, sized for
    the full merged dispatch (t_pad)."""
    if isinstance(bits_u, CompactBits):
        hidx = bits_u.pair_idx.astype(np.int64)
        lo = np.searchsorted(hidx, plan.ustart)
        hi = np.searchsorted(hidx, plan.ustart + plan.counts)
        lens = hi - lo
        tot = int(lens.sum())
        if tot == 0:
            return CompactBits(np.zeros(0, np.int32),
                               np.zeros(0, np.int8), t_pad)
        starts = np.zeros(lens.size, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        take = np.repeat(lo - starts, lens) \
            + np.arange(tot, dtype=np.int64)
        # global = hit - ustart_j + goff_j; queries come in ascending
        # global order with disjoint ranges and hits ascend within each,
        # so the result is sorted as CompactBits.slice needs
        out_idx = hidx[take] + np.repeat(plan.goff - plan.ustart, lens)
        return CompactBits(out_idx.astype(np.int32),
                           bits_u.bits[take], t_pad)
    out = np.zeros(t_pad, np.int8)
    if plan.total:
        take = np.repeat(plan.ustart - plan.goff, plan.counts) \
            + np.arange(plan.total, dtype=np.int64)
        out[:plan.total] = bits_u[take]
    return out


class PendingExpand:
    """One launched deduped merged dispatch: the unique-space pending
    result, the plan that scatters it back at fetch time, and the
    padded unique launch arguments."""

    __slots__ = ("dev", "plan", "launch")

    def __init__(self, dev, plan: DedupPlan, launch):
        self.dev = dev
        self.plan = plan
        self.launch = launch   # (q_start, q_count, q_ver, total, t_pad)
