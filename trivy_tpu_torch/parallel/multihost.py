"""Multi-process plumbing and the per-host ingest queue (the JAX package's
parallel/multihost.py).

`maybe_init_distributed` joins this process to a torch.distributed job
when the environment names one; `global_mesh` builds the dp×db mesh
over the job's devices. A mesh over the devices of more than one
process needs launches across processes and a gather of their bits,
which the port does not have yet (ROADMAP A19): in a job of more than
one process `global_mesh` (and `server --mesh-devices`) exit naming
it. `IngestQueue` coalesces concurrent small requests into one
detect_many call.

Env contract (all three required to opt in; absent ⇒ single process):
    TRIVY_TPU_DIST_COORDINATOR  host:port of rank 0
    TRIVY_TPU_DIST_NPROC        total process count
    TRIVY_TPU_DIST_PROC_ID      this process's rank
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future

import torch

_initialized = False

CROSS_PROCESS = ("a mesh over the devices of more than one process is "
                 "not ported yet (ROADMAP A19)")


def maybe_init_distributed(env=None, device=None) -> bool:
    """Env-guarded torch.distributed.init_process_group → True when this
    process joined a multi-process job. Safe to call more than once. All
    three variables are required: a partial set is a config error, not
    a silent single-process run (a worker defaulting to rank 0 would
    fight the real coordinator). The backend is nccl for a caller on
    `cuda` (the default) and gloo on the CPU."""
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
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
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


def host_assignments(devices, synthetic_hosts: int = 0) -> dict:
    """device slot → host fault-domain id. Slots are the devices'
    positions in the list (a list may repeat a device). Every device
    of a mesh belongs to this process, so each maps to its rank;
    `synthetic_hosts` > 1 overrides with contiguous equal blocks (the
    reference's drills)."""
    devs = list(devices)
    n = len(devs)
    if synthetic_hosts > 1 and n:
        return {i: i * synthetic_hosts // n for i in range(n)}
    rank = process_info()[0]
    return {i: rank for i in range(n)}


def global_mesh(db_shards: int = 1, device=None):
    """dp×db mesh over every device of `device`'s type in the job
    (mesh.device_slots), db fitted to the largest valid factorization
    of the device count (a 12-device job asking for db=8 gets db=6).
    Exits naming ROADMAP A19 in a job of more than one process."""
    from . import mesh
    if process_info()[1] > 1:
        raise SystemExit(f"global_mesh: {CROSS_PROCESS}")
    return mesh.mesh_from_devices(mesh.device_slots(-1, device),
                                  db_shards=db_shards)


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
