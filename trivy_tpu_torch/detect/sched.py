"""detectd: the coalescing dispatch scheduler of the server.

  handler threads   prep their request's query batches (host work runs
                    on the RPC threads) and enqueue the prepared CSR
                    descriptors;
  dispatcher thread wakes on the first pending request, sweeps what is
                    already queued, holds the window open for up to
                    `coalesce_wait_ms` only while a dispatch is in
                    flight, and launches ONE join per gathered chunk
                    (BatchDetector.dispatch_merged, the duplicate
                    query triples collapsed by detect/feed.py) under the
                    `max_pairs_in_flight` bound, on its current CUDA
                    stream;
  fetch thread      the detector's: brings each merged result back
                    (fetch_merged) and hands every request its slice;
  handler threads   wake with their bits and assemble their own hits.

Coalescing happens at the prepared-CSR level, so each batch keeps its
own `_Prepared` and its slice of the merged bits is what a solo
dispatch gives: the join predicate is elementwise, so results are
identical to the per-request path, order included.

Requests wait in per-tenant queues (tenant labels from obs/cost.py),
drained by deficit round-robin on real pair counts; with
`tenant_max_share` < 1 no tenant fills more than that share of a
round's pair budget while another tenant waits.

There is no host join: a launch or fetch that raises fails every
request the dispatch carried.

Before it parks on backpressure, the dispatcher stages the next
chunk's query columns on the card (BatchDetector.stage_merged), so
their copy rides the device time of the dispatch in flight. Each merged
dispatch runs under the first request's captured context, so its
spans (detectd.round, detect.dispatch) join that request's trace and
the round lists every merged trace id; its device ms and transfer
bytes are apportioned to the requests by their real pair shares
(obs/cost.py), and the wait from submit to dispatch is each request's
queue ms.

Follows the JAX package's detect/sched.py, its metrics and cost
charges included. Its slice prefetch (`_prefetch_pending`) waits for
the streamed tables of ROADMAP A10.
"""

from __future__ import annotations

import contextvars
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass

from ..metrics import METRICS
from ..obs import current_trace_id, span
from ..obs import cost as _cost
from . import feed as _feed
from .engine import BatchDetector, Hit, PkgQuery, slice_bits


@dataclass
class SchedOptions:
    """detectd knobs (server flags --detect-coalesce-wait-ms,
    --detect-max-inflight-pairs, --detect-warmup, --detect-dedup,
    --detect-tenant-max-share)."""
    coalesce_wait_ms: float = 2.0     # max wait gathering co-dispatchers
    max_pairs_in_flight: int = 1 << 22  # padded-pair in-flight bound
    warmup: bool = False              # launch the bucket ladder at start
    dedup: bool = True                # collapse duplicate query triples
    tenant_max_share: float = 1.0     # max share of a round's pair
    #                                   budget one tenant may fill while
    #                                   others wait (1.0 = off)


class _Request:
    """One submitted detect_many call. The future resolves to the
    per-slot list once every slot has its bits slice: empty slots hold
    [] and dispatched ones (prep, bits), which the caller assembles."""

    __slots__ = ("future", "results", "slots", "n_pairs", "_lock",
                 "_remaining", "tenant", "ctx", "trace_id", "cost",
                 "t_submit", "queue_charged")

    def __init__(self, n_slots: int):
        self.future: Future = Future()
        self.results: list = [None] * n_slots
        self.slots: list = []       # (slot_idx, _Prepared), n_pairs > 0
        self.n_pairs = 0
        self._lock = threading.Lock()
        self._remaining = 0
        # the submitting request's context (trace id, span parentage):
        # the merged dispatch runs under one request's context, so its
        # spans join a real trace
        self.ctx = contextvars.copy_context()
        self.trace_id = current_trace_id()
        # the request's cost ledger (None outside a request: its share
        # of a merged dispatch is billed to SYSTEM); submit → first
        # dispatch is its queue ms, charged once
        self.cost = _cost.active()
        self.t_submit = time.perf_counter()
        self.queue_charged = False
        # the fair-queue key: the clamped tenant label, "system" outside
        # a request
        self.tenant = _cost.current_label()

    def arm(self) -> None:
        with self._lock:
            self._remaining = len(self.slots)

    def complete(self, slot: int, part) -> None:
        with self._lock:
            self.results[slot] = part
            self._remaining -= 1
            done = self._remaining == 0
        if done:
            try:
                self.future.set_result(self.results)
            except InvalidStateError:
                pass  # lost the race with fail()

    def fail(self, exc: BaseException) -> None:
        try:
            self.future.set_exception(exc)
        except InvalidStateError:
            pass  # first error wins


class DispatchScheduler:
    """detectd over one BatchDetector: merges concurrent requests'
    prepared batches into shared join launches. One instance per
    LocalScanner; the server shares that scanner across its handler
    threads."""

    def __init__(self, detector: BatchDetector,
                 opts: SchedOptions | None = None):
        self.detector = detector
        self.opts = opts or SchedOptions()
        self._queue: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight_pairs = 0
        self._closed = False
        # per-tenant pending queues drained by deficit round-robin on
        # real pair count; submit() registers a request here (under
        # self._lock) before putting its wake token on self._queue
        self._fair: dict[str, deque] = {}
        self._rr: deque[str] = deque()       # tenant rotation order
        self._deficit: dict[str, float] = {}  # DRR deficit counters
        self._fair_pairs = 0                  # total pending pairs
        # what the merged dispatches did (server --debug-launches and
        # /healthz): dispatches, batches and requests they carried, the
        # real pairs and the pairs the launches ran after dedup
        self.stats = {"dispatches": 0, "batches": 0, "requests": 0,
                      "pairs": 0, "launched_pairs": 0, "deduped": 0}
        # `record(dev, preps, bits)` sees every fetched merged dispatch
        # (the server's --debug-launches keeps a few for checking)
        self.record = None
        self._thread = threading.Thread(
            target=self._run, name="detectd-dispatch", daemon=True)
        self._thread.start()

    # ---- submission ---------------------------------------------------

    def submit(self, batches: list[list[PkgQuery]]) -> Future:
        """Prep every batch on the calling thread and enqueue; resolves
        to detect_many-shaped parts."""
        det = self.detector
        req = _Request(len(batches))
        n_queries = sum(map(len, batches)) if len(det.table) else 0
        for i, qs in enumerate(batches):
            prep = det._prepare(qs) if qs and len(det.table) else None
            if prep is None or prep.n_pairs == 0:
                req.results[i] = []
                continue
            req.slots.append((i, prep))
            req.n_pairs += prep.n_pairs
        req.arm()
        METRICS.inc("trivy_tpu_detect_queries_total", n_queries)
        METRICS.inc("trivy_tpu_detect_pairs_total", req.n_pairs)
        if not req.slots:
            req.future.set_result(req.results)
            return req.future
        with self._lock:
            if self._closed:
                raise RuntimeError("DispatchScheduler is closed")
            # under the lock: close() flips _closed before its sentinel,
            # so every accepted request precedes the sentinel
            self._fair_put_locked(req)
            self._queue.put(req)
        return req.future

    def detect_many(self, batches: list[list[PkgQuery]]
                    ) -> list[list[Hit]]:
        parts = self.submit(batches).result()
        # assembly runs here, on the requesting thread, so concurrent
        # requests assemble concurrently while their launches merge
        out = [self.detector._assemble(*part) if isinstance(part, tuple)
               else part for part in parts]
        METRICS.inc("trivy_tpu_detect_hits_total",
                    sum(len(h) for h in out))
        return out

    def detect(self, queries: list[PkgQuery]) -> list[Hit]:
        return self.detect_many([queries])[0]

    # ---- lifecycle ----------------------------------------------------

    def close(self) -> None:
        """Flush pending requests, stop the dispatcher and wait for the
        in-flight fetches. Idempotent; submissions raise afterwards.
        (The detector's fetch thread is the detector's to close.)"""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(None)
        self._thread.join()
        with self._cv:
            self._cv.wait_for(lambda: self._inflight_pairs == 0,
                              timeout=60.0)

    # ---- fair queues (the _locked helpers need self._lock; never call
    # them while also waiting on self._cv, which shares it) -------------

    def _fair_put_locked(self, req: _Request) -> None:
        dq = self._fair.get(req.tenant)
        if dq is None:
            dq = self._fair[req.tenant] = deque()
            self._deficit[req.tenant] = 0.0
            self._rr.append(req.tenant)
        dq.append(req)
        self._fair_pairs += req.n_pairs

    def _fair_take_locked(self, budget: int) -> list[_Request]:
        """One deficit-round-robin sweep over the per-tenant queues →
        the round's requests in drain order. Each tenant's turn banks
        one quantum of pair credit and drains whole requests against
        it; with more than one tenant pending, none may fill more than
        tenant_max_share of the round's budget (a solo tenant gets the
        whole window)."""
        active = [t for t in self._rr if self._fair.get(t)]
        if not active:
            return []
        share = self.opts.tenant_max_share
        cap = (budget if len(active) <= 1 or share >= 1.0
               else max(1, int(budget * share)))
        quantum = max(1, budget // max(1, len(active)))
        taken: list[_Request] = []
        taken_by: dict[str, int] = {}
        total = 0
        progress = True
        while progress and total < budget:
            progress = False
            for label in list(self._rr):
                dq = self._fair.get(label)
                if not dq:
                    self._deficit[label] = 0.0   # idle queues bank nothing
                    continue
                self._deficit[label] += quantum
                while dq and total < budget:
                    head = dq[0]
                    w = max(1, head.n_pairs)
                    if taken_by.get(label, 0) + w > cap and taken:
                        break   # share spent: next tenant
                    if w > self._deficit[label] and taken:
                        break   # credit spent: next tenant
                    dq.popleft()
                    self._fair_pairs -= head.n_pairs
                    self._deficit[label] = max(0.0,
                                               self._deficit[label] - w)
                    taken.append(head)
                    taken_by[label] = taken_by.get(label, 0) + w
                    total += w
                    progress = True
        if not taken:
            # an oversize head larger than any credit this sweep could
            # bank still dispatches, alone
            for label in list(self._rr):
                dq = self._fair.get(label)
                if dq:
                    head = dq.popleft()
                    self._fair_pairs -= head.n_pairs
                    self._deficit[label] = 0.0
                    taken.append(head)
                    break
        # the next round's sweep starts one tenant later
        if self._rr:
            self._rr.rotate(-1)
        return taken

    def _peek_fair_locked(self, k: int) -> list[_Request]:
        """The first ≤k requests in the fair sweep's drain order (one
        per tenant per lap) without popping them."""
        out: list[_Request] = []
        lap = 0
        while len(out) < k:
            advanced = False
            for label in self._rr:
                dq = self._fair.get(label)
                if dq is not None and lap < len(dq):
                    out.append(dq[lap])
                    advanced = True
                    if len(out) >= k:
                        break
            if not advanced:
                break
            lap += 1
        return out

    # ---- dispatcher ---------------------------------------------------

    def _drain_tokens(self) -> bool:
        """Consume the wake tokens already queued. → True when close()'s
        sentinel was among them."""
        saw_stop = False
        while True:
            try:
                tok = self._queue.get_nowait()
            except queue_mod.Empty:
                return saw_stop
            if tok is None:
                saw_stop = True

    def _run(self) -> None:
        opts = self.opts
        stopping = False
        while True:
            with self._lock:
                idle = self._fair_pairs == 0 and not any(
                    self._fair.values())
            if idle:
                if stopping:
                    break
                try:
                    tok = self._queue.get(timeout=0.5)
                except queue_mod.Empty:
                    continue
                if tok is None:
                    # every accepted request precedes the sentinel:
                    # loop once more to flush what is left
                    stopping = True
                    continue
            # sweep what is queued, then hold the window open, but only
            # while a dispatch is in flight: with an idle card waiting
            # buys nothing, with a busy one it costs nothing
            deadline = time.monotonic() + opts.coalesce_wait_ms / 1e3
            while not stopping:
                stopping |= self._drain_tokens()
                with self._lock:
                    pairs = self._fair_pairs
                if stopping or pairs >= opts.max_pairs_in_flight:
                    break
                with self._cv:
                    busy = self._inflight_pairs > 0
                timeout = deadline - time.monotonic()
                if not busy or timeout <= 0:
                    break
                try:
                    tok = self._queue.get(
                        timeout=min(timeout, opts.coalesce_wait_ms / 4e3))
                except queue_mod.Empty:
                    continue
                if tok is None:
                    stopping = True
            with self._lock:
                pending = self._fair_take_locked(opts.max_pairs_in_flight)
            if not pending:
                continue
            METRICS.observe("trivy_tpu_detect_queue_depth",
                            float(len(pending)))
            self._observe_dispatch_share(pending)
            try:
                self._dispatch_round(pending)
            except Exception as e:  # noqa: BLE001 — detectd outlives a
                # round; the requests it carried fail with its error
                for req in pending:
                    req.fail(e)

    @staticmethod
    def _observe_dispatch_share(pending: list[_Request]) -> None:
        """Per merged round: each participating tenant's fraction of
        the round's real pairs."""
        total = sum(r.n_pairs for r in pending)
        if total <= 0:
            return
        by_tenant: dict[str, int] = {}
        for r in pending:
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + r.n_pairs
        for label, pairs in by_tenant.items():
            METRICS.observe("trivy_tpu_tenant_qos_dispatch_share",
                            pairs / total, tenant=label)

    def _dispatch_round(self, pending: list[_Request]) -> None:
        """Chunk the gathered slots under the pair budget and launch one
        merged dispatch per chunk."""
        budget = self.opts.max_pairs_in_flight
        chunk: list = []   # (req, slot_idx, prep)
        chunk_pairs = 0

        def flush():
            if not chunk:
                return
            preps = [p for _, _, p in chunk]
            det = self.detector
            plan = _feed.plan_from_preps(preps) if self.opts.dedup \
                else None
            # merge and stage the query columns BEFORE parking on
            # backpressure: while the dispatch in flight owns the card,
            # its compute hides this chunk's host→device copy
            staged = det.stage_merged(preps, plan=plan,
                                      dedup=self.opts.dedup)
            # backpressure: admit this dispatch only when the in-flight
            # padded pairs leave room (a chunk bigger than the whole
            # budget still goes, alone, once the card drains)
            with self._cv:
                self._cv.wait_for(
                    lambda: self._inflight_pairs == 0
                    or self._inflight_pairs + chunk_pairs <= budget,
                    timeout=30.0)
            n_req = len({id(r) for r, _, _ in chunk})
            # the merged dispatch runs under the FIRST request's captured
            # context (fresh copies: a Context cannot be entered twice at
            # once, and the fetch runs on another thread); the round's
            # span lists every merged trace id
            req0 = chunk[0][0]
            tids = sorted({r.trace_id for r, _, _ in chunk if r.trace_id})
            dispatch_ctx = req0.ctx.run(contextvars.copy_context)
            fetch_ctx = req0.ctx.run(contextvars.copy_context)
            # queue ms: submit → first dispatch, once per request. The
            # launch's device ms and transfer bytes apportion by each
            # request's real pair share — its UNIQUE pairs under a dedup
            # plan, its collapsed duplicates billed as work avoided
            now = time.perf_counter()
            per_req: dict[int, int] = {}
            avoided: dict[int, int] = {}
            for k, (r, _, p) in enumerate(chunk):
                w = (int(plan.unique_by_prep[k]) if plan is not None
                     else p.n_pairs)
                per_req[id(r)] = per_req.get(id(r), 0) + w
                if plan is not None:
                    avoided[id(r)] = (avoided.get(id(r), 0)
                                      + int(plan.collapsed_by_prep[k]))
                if not r.queue_charged:
                    r.queue_charged = True
                    _cost.charge_queue_ms((now - r.t_submit) * 1e3,
                                          ledger=r.cost)
            seen: set[int] = set()
            shares = []
            for r, _, _p in chunk:
                if id(r) not in seen:
                    seen.add(id(r))
                    shares.append((r.cost, per_req[id(r)]))
                    if avoided.get(id(r), 0) > 0:
                        _cost.note_work_avoided(avoided[id(r)],
                                                ledger=r.cost)
            dispatch_ctx.run(_cost.install_shares, shares)
            fetch_ctx.run(_cost.install_shares, shares)

            def _dispatch():
                with span("detectd.round", merged=n_req,
                          trace_ids=",".join(tids[:16])):
                    return det.dispatch_merged(preps, staged=staged)

            dev, offsets, t_pad = dispatch_ctx.run(_dispatch)
            METRICS.observe("trivy_tpu_detect_coalesce_size", float(n_req))
            METRICS.gauge_add("trivy_tpu_dispatch_depth", 1.0)
            with self._cv:
                self._inflight_pairs += t_pad
                st = self.stats
                st["dispatches"] += 1
                st["batches"] += len(chunk)
                st["requests"] += n_req
                st["pairs"] += chunk_pairs
                st["launched_pairs"] += (plan.unique_total
                                         if plan is not None
                                         else chunk_pairs)
                st["deduped"] += plan is not None
            gf = det._get_pool.submit(fetch_ctx.run, det.fetch_merged, dev,
                                      preps, offsets, t_pad)
            items = list(chunk)
            gf.add_done_callback(
                lambda fut: self._on_fetched(fut, dev, items, offsets,
                                             t_pad))

        for req, (slot, prep) in ((r, s) for r in pending
                                  for s in r.slots):
            if chunk and chunk_pairs + prep.n_pairs > budget:
                flush()
                chunk, chunk_pairs = [], 0
            chunk.append((req, slot, prep))
            chunk_pairs += prep.n_pairs
            if chunk_pairs >= budget:
                flush()
                chunk, chunk_pairs = [], 0
        flush()

    # ---- fetch callback (runs on the fetch thread) --------------------

    def _on_fetched(self, fut, dev, items: list, offsets: list,
                    t_pad: int) -> None:
        with self._cv:
            self._inflight_pairs -= t_pad
            self._cv.notify_all()
        METRICS.gauge_add("trivy_tpu_dispatch_depth", -1.0)
        try:
            bits = fut.result()
        except Exception as e:  # noqa: BLE001 — a failed fetch fails
            # every request the dispatch carried
            for req, _, _ in items:
                req.fail(e)
            return
        # each request gets its contiguous slice, dense or recovered
        # from the compacted hit indices with one searchsorted
        for (req, slot, prep), off in zip(items, offsets):
            req.complete(slot, (prep, slice_bits(bits, off, prep.n_pairs)))
        if self.record is not None:
            self.record(dev, [p for _, _, p in items], bits)
