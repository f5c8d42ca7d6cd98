"""Multi-process plumbing and the per-host ingest queue (the JAX package's
parallel/multihost.py).

`maybe_init_distributed` joins this process to a torch.distributed job
when the environment names one. The job's traffic is gloo on host
tensors, on the card as on the CPU: the mesh merges its cells' bits on
the host anyway, and two ranks on one card (the layout a one-card
machine runs) is one NCCL refuses.

`join_job` (collective: every rank calls it once) gathers every rank's
mesh slots (mesh.device_slots: its visible cards, or one CPU slot) in
rank order; `global_mesh` lays the dp×db mesh over the job's slots,
each cell owned by the rank whose slot it is. Rank 0 dispatches: it
ships each follower its cells' operands and, per dispatch, one message
of its cells' descriptors, and gathers their results
(parallel/mesh.py). Ranks > 0 answer in `follower.follow(job)` until
rank 0's `leave_job` sends stop.

A message is a JSON header and numpy arrays in one uint8 buffer, sent
as (lengths, buffer) under a per-peer lock. Rank 0 has one receiving
thread per follower, which hands each reply to the request of its id:
detectd fetches on a pool, so replies are awaited out of order. A reply
carries the follower's results or the error it raised. A follower that
dies (its socket closes), takes in no request within REPLY_TIMEOUT_S or
does not answer one within REPLY_TIMEOUT_S is lost: the request fails,
and so does every later one to that rank at once. Nothing computes its
cells elsewhere.

`IngestQueue` coalesces concurrent small requests into one detect_many
call.

Env contract (all three required to opt in; absent ⇒ single process):
    TRIVY_TPU_DIST_COORDINATOR  host:port of rank 0
    TRIVY_TPU_DIST_NPROC        total process count
    TRIVY_TPU_DIST_PROC_ID      this process's rank
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import torch

from ..log import get as _get_logger

_log = _get_logger("multihost")

# the longest rank 0 waits for a follower to take in a request, and
# again for its reply; a follower that dies closes its socket, which
# fails its requests at once
REPLY_TIMEOUT_S = 60.0
# a gloo op's own wait: an idle follower blocks in recv for as long as
# rank 0 sends nothing
_FOREVER = datetime.timedelta(days=365)
# every array of a message starts at a multiple of this
_ALIGN = 16

_initialized = False
_job: "Job | None" = None
_job_lock = threading.Lock()


class RemoteError(RuntimeError):
    """A follower rank failed a request, is gone, or did not answer in
    time."""


def maybe_init_distributed(env=None) -> bool:
    """Env-guarded torch.distributed.init_process_group (gloo) → True
    when this process joined a multi-process job. Safe to call more than
    once. All three variables are required: a partial set is a config
    error, not a silent single-process run (a worker defaulting to rank
    0 would fight the real coordinator)."""
    global _initialized
    env = env if env is not None else os.environ
    keys = ("TRIVY_TPU_DIST_COORDINATOR", "TRIVY_TPU_DIST_NPROC",
            "TRIVY_TPU_DIST_PROC_ID")
    present = [k for k in keys if env.get(k)]
    if not present:
        return False
    if len(present) != len(keys):
        missing = sorted(set(keys) - set(present))
        raise RuntimeError(
            f"partial multi-host config: {missing} unset "
            f"(all of {keys} are required)")
    if _initialized:
        return True
    import torch.distributed as dist
    dist.init_process_group(
        backend="gloo",
        init_method=f"tcp://{env['TRIVY_TPU_DIST_COORDINATOR']}",
        world_size=int(env["TRIVY_TPU_DIST_NPROC"]),
        rank=int(env["TRIVY_TPU_DIST_PROC_ID"]))
    _initialized = True
    return True


def process_info() -> tuple[int, int]:
    """→ (rank, world size): (0, 1) outside a torch.distributed job."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# ---------------------------------------------------------------------------
# messages

def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _pack(header: dict, arrays=()) -> tuple[int, torch.Tensor]:
    """A header and arrays as one uint8 buffer, each array at an offset
    aligned for its type → (header bytes, buffer)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    meta = json.dumps({"h": header, "a": [[a.dtype.str, list(a.shape)]
                                          for a in arrays]}).encode()
    meta += b" " * (_aligned(len(meta)) - len(meta))
    offsets, off = [], len(meta)
    for a in arrays:
        offsets.append(off)
        off = _aligned(off + a.nbytes)
    buf = np.zeros(off, np.uint8)
    buf[:len(meta)] = np.frombuffer(meta, np.uint8)
    for a, at in zip(arrays, offsets):
        buf[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    return len(meta), torch.from_numpy(buf)


def _unpack(meta_len: int, buf: np.ndarray) -> tuple[dict, list]:
    """_pack's inverse → (header, arrays viewing the buffer)."""
    meta = json.loads(buf[:meta_len].tobytes())
    arrays, off = [], meta_len
    for dtype, shape in meta["a"]:
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) * dt.itemsize
        arrays.append(buf[off:off + n].view(dt).reshape(shape))
        off = _aligned(off + n)
    return meta["h"], arrays


def _send(peer: int, header: dict, arrays=(), timeout=_FOREVER) -> int:
    """One message to `peer`; a send that `peer` has not taken in within
    `timeout` raises RuntimeError."""
    import torch.distributed as dist
    meta_len, buf = _pack(header, arrays)
    dist.isend(torch.tensor([meta_len, buf.numel()], dtype=torch.int64),
               peer).wait(timeout)
    dist.isend(buf, peer).wait(timeout)
    return buf.numel()


def _recv(peer: int) -> tuple[dict, list, int]:
    import torch.distributed as dist
    lens = torch.zeros(2, dtype=torch.int64)
    dist.irecv(lens, peer).wait(_FOREVER)
    buf = torch.empty(int(lens[1]), dtype=torch.uint8)
    dist.irecv(buf, peer).wait(_FOREVER)
    header, arrays = _unpack(int(lens[0]), buf.numpy())
    return header, arrays, buf.numel()


# ---------------------------------------------------------------------------
# the job

class Job:
    """This process's place in a multi-process mesh job: every rank's
    slots in rank order ([(rank, device)]) and, on rank 0, the channel
    to each follower. `stats` counts the exchange (requests, bytes each
    way, and the ms spent waiting for replies)."""

    def __init__(self, rank: int, world: int, slots: list):
        self.rank = rank
        self.world = world
        self.slots = slots
        self.stats = {"requests": 0, "bytes_sent": 0, "bytes_received": 0,
                      "wait_ms": 0.0}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._send_locks = {p: threading.Lock() for p in range(world)}
        self._pending: dict = {p: {} for p in range(world)}
        self._lost: dict = {}
        self._closing = False
        self._threads = []
        if rank == 0:
            for p in self.followers():
                t = threading.Thread(target=self._receive, args=(p,),
                                     name=f"job-recv-{p}", daemon=True)
                t.start()
                self._threads.append(t)

    def followers(self) -> range:
        return range(1, self.world)

    def new_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def lost(self) -> dict:
        """{rank: why} for the followers this job has lost."""
        with self._lock:
            return dict(self._lost)

    # ---- rank 0 ----------------------------------------------------------

    def request(self, peer: int, header: dict, arrays=()) -> tuple:
        """Send one request to follower `peer` → (its id, a Future of
        the reply's (header, arrays)). Raises RemoteError for a lost
        follower."""
        fut: Future = Future()
        with self._lock:
            if peer in self._lost:
                raise RemoteError(f"rank {peer} is lost: "
                                  f"{self._lost[peer]}")
            rid = next(self._ids)
            self._pending[peer][rid] = fut
        try:
            with self._send_locks[peer]:
                # lost while this request waited for the lock
                if peer in self.lost():
                    raise RuntimeError(self.lost()[peer])
                n = _send(peer, {**header, "id": rid}, arrays,
                          timeout=datetime.timedelta(
                              seconds=REPLY_TIMEOUT_S))
        except RuntimeError as e:
            self._lose(peer, e)
            raise RemoteError(f"rank {peer}: sending {header['op']} "
                              f"failed: {e}") from e
        with self._lock:
            self.stats["requests"] += 1
            self.stats["bytes_sent"] += n
        return rid, fut

    def wait(self, peer: int, fut: Future, what: str) -> tuple:
        """A request's reply, within REPLY_TIMEOUT_S → (header, arrays).
        A follower that does not answer in time is lost."""
        t0 = time.perf_counter()
        try:
            return fut.result(timeout=REPLY_TIMEOUT_S)
        except FutureTimeout:
            why = f"did not answer {what} within {REPLY_TIMEOUT_S:g} s"
            self._lose(peer, why)
            raise RemoteError(f"rank {peer} {why}") from None
        finally:
            with self._lock:
                self.stats["wait_ms"] += (time.perf_counter() - t0) * 1e3

    def call(self, peer: int, header: dict, arrays=()) -> tuple:
        """request then wait → (header, arrays)."""
        _rid, fut = self.request(peer, header, arrays)
        return self.wait(peer, fut, header["op"])

    def post(self, peer: int, header: dict, arrays=()) -> None:
        """A request whose reply nobody awaits: a failure is logged."""
        _rid, fut = self.request(peer, header, arrays)

        def done(f):
            if f.exception() is not None:
                _log.warning("%s on rank %d: %s", header["op"], peer,
                             f.exception())
        fut.add_done_callback(done)

    def _receive(self, peer: int) -> None:
        while True:
            try:
                header, arrays, n = _recv(peer)
            except RuntimeError as e:   # its socket closed, or ours
                self._lose(peer, "stopped" if self._closing else e)
                return
            with self._lock:
                self.stats["bytes_received"] += n
                fut = self._pending[peer].pop(header.get("id"), None)
            if fut is None:
                self._lose(peer, f"a reply to request {header.get('id')}, "
                                 "which nothing awaits")
                return
            if "error" in header:
                fut.set_exception(RemoteError(f"rank {peer}: "
                                              f"{header['error']}"))
            else:
                fut.set_result((header, arrays))

    def _lose(self, peer: int, why) -> None:
        with self._lock:
            self._lost.setdefault(peer, str(why))
            waiting, self._pending[peer] = self._pending[peer], {}
        for fut in waiting.values():
            fut.set_exception(RemoteError(f"rank {peer} is lost: {why}"))

    def close(self) -> None:
        """Rank 0: send stop to every follower still there (each
        answers, then leaves its loop) and join the receiving
        threads."""
        self._closing = True
        for p in self.followers():
            try:
                self.call(p, {"op": "stop"})
            except RemoteError as e:
                _log.warning("stopping rank %d: %s", p, e)
        for t in self._threads:
            t.join(REPLY_TIMEOUT_S)

    # ---- ranks > 0 --------------------------------------------------------

    def serve(self, handle) -> None:
        """Answer rank 0's requests in order until stop: `handle(header,
        arrays)` → (reply header, reply arrays); an exception it raises
        is the reply's error. Raises when rank 0 is gone."""
        while True:
            header, arrays, _n = _recv(0)
            reply, out = {}, ()
            if header["op"] != "stop":
                try:
                    reply, out = handle(header, arrays)
                except Exception as e:  # noqa: BLE001 — rank 0's to raise
                    _log.exception("rank %d: %s failed", self.rank,
                                   header["op"])
                    reply, out = {"error": f"{type(e).__name__}: {e}"}, ()
            _send(0, {**reply, "id": header["id"]}, out)
            if header["op"] == "stop":
                return


def join_job(device=None) -> Job:
    """This process's Job, made on the first call by a collective every
    rank must enter: each rank's slots (mesh.device_slots(-1, device))
    gathered in rank order. Later calls return it."""
    global _job
    import torch.distributed as dist

    from .mesh import device_slots
    with _job_lock:
        if _job is not None:
            return _job
        rank, world = process_info()
        if world < 2:
            raise RuntimeError("join_job: this process is in no "
                               "multi-process job")
        mine = [str(d) for d in device_slots(-1, device)]
        everyone: list = [None] * world
        dist.all_gather_object(everyone, mine)
        _job = Job(rank, world, [(r, torch.device(d))
                                 for r, devs in enumerate(everyone)
                                 for d in devs])
        return _job


def leave_job() -> None:
    """Leave the job: rank 0 stops the followers first; every rank then
    destroys its process group, so later calls run single-process."""
    global _job, _initialized
    import torch.distributed as dist
    with _job_lock:
        job, _job = _job, None
    if job is not None and job.rank == 0:
        job.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def host_assignments(devices, synthetic_hosts: int = 0) -> dict:
    """device slot → host fault-domain id. Slots are the devices'
    positions in the list (a list may repeat a device). In a job, slot
    i belongs to the rank whose slot it is (join_job's order); alone,
    every slot is this process's; `synthetic_hosts` > 1 overrides with
    contiguous equal blocks (the reference's drills)."""
    devs = list(devices)
    n = len(devs)
    if synthetic_hosts > 1 and n:
        return {i: i * synthetic_hosts // n for i in range(n)}
    if _job is not None:
        if n > len(_job.slots):
            raise ValueError(f"{n} slots in a job of {len(_job.slots)}")
        return {i: _job.slots[i][0] for i in range(n)}
    rank = process_info()[0]
    return {i: rank for i in range(n)}


def global_mesh(db_shards: int = 1, device=None, n_devices=None):
    """dp×db mesh over every slot of the job, db fitted to the largest
    valid factorization of the slot count (a 12-slot job asking for
    db=8 gets db=6). Alone: mesh.device_slots(n_devices, device) (all
    for None or < 0). In a job: join_job's slots in rank order, the
    first n_devices of them (all for None or < 0), each cell owned by
    the rank whose slot it is; rank 0 must hold the first."""
    from . import mesh
    if process_info()[1] == 1:
        return mesh.mesh_from_devices(
            mesh.device_slots(-1 if n_devices is None else n_devices,
                              device), db_shards=db_shards)
    job = join_job(device)
    slots = job.slots if n_devices is None or n_devices < 0 \
        else job.slots[:n_devices]
    if not slots or slots[0][0] != 0:
        raise RuntimeError("global_mesh: rank 0 holds no slot of the job "
                           f"({[(r, str(d)) for r, d in job.slots]})")
    return mesh.mesh_from_devices([d for _r, d in slots], db_shards,
                                  ranks=[r for r, _d in slots], job=job)


class IngestQueue:
    """Per-host request coalescing in front of a detector.

    submit() returns a Future; a worker thread drains the queue and
    flushes up to `max_batches` pending requests as ONE detect_many
    call after at most `max_wait_s` of accumulation, so many concurrent
    small requests share single large dispatches."""

    def __init__(self, detector, max_batches: int = 64,
                 max_wait_s: float = 0.005):
        self.detector = detector
        self.max_batches = max_batches
        self.max_wait_s = max_wait_s
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, queries: list) -> Future:
        fut: Future = Future()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("ingest queue closed")
            self._q.put((queries, fut))
        return fut

    def close(self):
        with self._close_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=5)
        # nothing can enqueue after the flag flips under the lock, so
        # anything still queued (raced in before close) is failed here
        saw_sentinel = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                saw_sentinel = True
            elif not item[1].cancelled():
                item[1].set_exception(RuntimeError("ingest queue closed"))
        if saw_sentinel and self._worker.is_alive():
            # a long in-flight flush outlived the join timeout and its
            # shutdown signal was consumed here: post it again so the
            # worker exits instead of blocking on an empty queue
            self._q.put(None)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            pending = [item]
            # accumulate briefly so concurrent requests share a dispatch
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < self.max_batches:
                try:
                    nxt = self._q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-post the sentinel, then flush
                    break
                pending.append(nxt)
            batches = [qs for qs, _ in pending]
            try:
                results = self.detector.detect_many(batches)
                for (_qs, fut), hits in zip(pending, results):
                    # a caller may have cancelled while this computed;
                    # never let that poison its flush-mates
                    if not fut.cancelled():
                        fut.set_result(hits)
            except Exception as e:  # noqa: BLE001 — fail the waiters
                for _qs, fut in pending:
                    if not fut.cancelled() and not fut.done():
                        fut.set_exception(e)
