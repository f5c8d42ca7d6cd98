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

Staged query uploads (`stage_queries`, `StagedQueries`,
`upload_queries`): detectd issues the host→device copy of a merged
dispatch's padded CSR query columns before it parks on backpressure,
so the copy of dispatch i+1 runs while dispatch i computes. On the card
the columns go into one pinned host buffer and up with one
`non_blocking` copy on a side CUDA stream, which records an event;
the launch makes its own (current) stream wait on that event, and
marks the device tensor as used by that stream (`record_stream`) so
the caching allocator does not hand its memory to another tensor while
the join still reads it. The pinned buffer comes from PyTorch's caching
host allocator, which does not reuse it before the copy's event has
completed, and the StagedQueries keeps it alive until the launch.
Uploads and waits are ledgered as `query_upload` rows
(obs/perf.py): a staged copy counts as prefetched, the inline copy a
launch makes without one (the cold path) does not. A staging error is
recorded on the StagedQueries and the paired launch raises it, failing
the requests it carried: there is no host join to degrade to.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..log import get as _get_logger
from ..metrics import METRICS
from ..obs.perf import LEDGER
from ..ops import bucket_size
from .engine import CompactBits

_log = _get_logger("feed")


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


def note_dedup_ratio(unique_pairs: int, real_pairs: int) -> None:
    """One merged dispatch's dedup win: unique pairs ÷ real pairs
    (1.0 = nothing collapsed). Observed per merged dispatch whenever
    dedup is on, so the histogram's mass says how duplicated the
    admitted traffic is."""
    if real_pairs > 0:
        METRICS.observe("trivy_tpu_detect_dedup_ratio",
                        unique_pairs / real_pairs)


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


# ---------------------------------------------------------------------------
# staged query uploads


class StagedQueries:
    """One pre-issued host→device copy of a dispatch's CSR query
    columns. `refs` are the three device tensors (views of one [3, Q]
    upload); `event` is the side stream's event after the copy (None on
    the CPU); `error` is a staging failure, which the paired launch
    raises."""

    __slots__ = ("refs", "event", "error", "_host")

    def __init__(self):
        self.refs = None
        self.event = None
        self.error: BaseException | None = None
        self._host = None   # the pinned source buffer, alive until take

    def take(self):
        """The staged columns for a launch on the current stream: the
        stream waits on the copy's event (on the card; the host does
        not block) and each tensor is marked as used by it. The time
        this takes is the dispatch's query-upload stall (≈ 0: the copy
        rode the previous dispatch's compute)."""
        t0 = time.perf_counter()
        if self.error is not None:
            raise self.error
        if self.event is not None:
            stream = torch.cuda.current_stream(self.refs[0].device)
            stream.wait_event(self.event)
            for t in self.refs:
                t.record_stream(stream)
        LEDGER.note_shard_wait("query_upload",
                               (time.perf_counter() - t0) * 1e3,
                               cold=False)
        return self.refs


_streams: dict = {}
_streams_lock = threading.Lock()


def _side_stream(device: torch.device):
    """The staging stream of `device` (one per device, made once)."""
    with _streams_lock:
        st = _streams.get(device)
        if st is None:
            st = _streams[device] = torch.cuda.Stream(device)
        return st


def _columns(q_start, q_count, q_ver, pin: bool) -> torch.Tensor:
    """The three int32 columns as one [3, Q] host tensor."""
    host = torch.empty((3, len(q_start)), dtype=torch.int32,
                       pin_memory=pin)
    view = host.numpy()
    view[0] = q_start
    view[1] = q_count
    view[2] = q_ver
    return host


def upload_queries(q_start: np.ndarray, q_count: np.ndarray,
                   q_ver: np.ndarray, device: torch.device):
    """Copy the CSR query columns to `device` inline, on the current
    stream (the cold path of a launch that had nothing staged), and
    ledger the bytes as a `query_upload` transfer, not prefetched.
    → (q_start, q_count, q_ver) device tensors."""
    host = _columns(q_start, q_count, q_ver, pin=False)
    dev = host.to(device)
    LEDGER.note_shard_upload("query_upload", host.numel() * 4,
                             prefetched=False, path="query_upload")
    return dev[0], dev[1], dev[2]


def stage_queries(q_start: np.ndarray, q_count: np.ndarray,
                  q_ver: np.ndarray,
                  device: torch.device) -> StagedQueries:
    """Issue the query-column copy for a FUTURE launch: on the card a
    pinned buffer, a non_blocking copy on the side stream and an event
    after it; on the CPU the columns as tensors. Never raises: a
    failure is recorded on the result for the paired launch to
    raise."""
    staged = StagedQueries()
    try:
        if device.type == "cuda":
            host = _columns(q_start, q_count, q_ver, pin=True)
            side = _side_stream(device)
            with torch.cuda.stream(side):
                dev = host.to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
            staged._host = host
            staged.event = event
        else:
            dev = _columns(q_start, q_count, q_ver, pin=False)
        staged.refs = (dev[0], dev[1], dev[2])
        LEDGER.note_shard_upload("query_upload", dev.numel() * 4,
                                 prefetched=True, path="query_upload")
    except Exception as exc:  # noqa: BLE001 — raised by the launch
        _log.warning("staged query upload failed; the paired dispatch "
                     "fails the requests it carries", exc_info=True)
        staged.refs = None
        staged.error = exc
    return staged
