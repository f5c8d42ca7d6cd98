"""Multi-device detection: the advisory join sharded over a dp×db mesh
of cards (the JAX package's parallel/mesh.py).

  axis "dp"  data parallel over the candidate pairs of a dispatch;
  axis "db"  the advisory table sharded round-robin by row residue.

Table shard s holds global rows r with r % S == s at local index
r // S, so any bucket interval maps to a contiguous LOCAL range on
every shard: a mega bucket spreads its pair volume over the whole db
axis by construction. The host routes per-query CSR descriptor pieces
(≤ S per query) to the cells, splitting oversized pieces so the pair
work LPT-balances across dp (`partition_queries`), and each cell
expands its own pairs on its card.

Where the JAX package runs one jit(shard_map(...)) program over the
mesh, the port makes one launch of the hand-written join per cell
(d, s) (`launch_cells`): `ops/join.csr_pair_join` or
`csr_pair_join_compact` (csrc/csr_join.cu) on shard s's operands and
its own [pad, 4] prefix planes, on the cell's card, under
`torch.cuda.device(cell)` since the kernels launch on the current
device. Every cell launches before any is fetched, so cells on
different cards overlap, and each card's results come back in one
transfer (`fetch_cells`); the host merge is `out[perm[valid]] =
bits[valid]`, or, on the compacted route, the cells' hit positions
mapped through `perm` and stable-sorted into ascending pair order (if
any cell overflowed its hit buffer, the dense bits of the whole
dispatch are fetched instead). Results equal the single-device
BatchDetector's bit for bit. A cell whose partition holds no pair is
not launched: its bits are zero. The secret lane's shift-or shards
its chunk rows over every cell the same way (`sharded_shiftor_scan`).

A `Mesh` is a [dp, db] numpy object array of torch.device. On `cuda`
its devices are `cuda:0..count-1`: the first N, or all of them for
N < 0 (`device_slots`). A device list may repeat a device: that is how
the CPU tests and a one-card chip run lay out a dp×db grid (on `cpu`,
N means N slots of the CPU), as the JAX tests use XLA's virtual host
devices. It stands in for several cards; it is not a feature of its
own, and the server's `--mesh-devices` keeps the reference's rule
(one card gives a 1×1 mesh, whatever N).

`MeshDetector` carries the scheduler surface detectd calls, and with
StreamOptions whose plan engages for its per-device share of the table
it walks the table's hash-range slices (parallel/stream.py), each one
db-sharded over the cells, through the double-buffered SliceCache.
Not ported, by the north star: meshguard (the per-device breakers,
shrink and grow) and the host join; a failed cell launch raises.

A mesh may span the processes of a torch.distributed job
(multihost.global_mesh): `ranks` names the rank owning each cell and
`job` the channel to them. Rank 0 dispatches. Its MeshDetector ships
each follower only its cells' operands once per table (the shards with
their prefix planes, or a streamed table's slice shards), stamped with
the table's content digest, and the version pool whenever it grows. Per
dispatch, `launch_cells` sends each follower one message of its cells'
descriptors before rank 0 launches its own cells, and `fetch_cells`
takes each follower's reply (`RemoteCells`) in the layout one card's
fetch gives, so the host merge is unchanged; on a compacted dispatch
that overflowed, a second request asks each follower for the same
dispatch's dense bits. Followers launch on their own cards
(parallel/follower.py). The sharded shift-or ships its bank once and
each follower's rows per launch. A follower that fails raises on rank
0: no cell is recomputed elsewhere.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..db.table import AdvisoryTable
from ..detect import feed as _feed
from ..detect.engine import (BatchDetector, CompactBits, _StagedMerged,
                             launch_join)
from ..device import resolve_device
from ..log import get as _get_logger
from ..metrics import METRICS
from ..obs import cost as _cost
from ..obs import note_dispatch, span
from ..obs.perf import LEDGER
from ..ops import join as J
from ..ops import next_pow2 as _next_pow2
from ..ops import shiftor as so
from ..resilience import blameless_active
from .stream import (RESIDENT, SliceCache, StreamOptions, clip_descriptors,
                     merge_slice_bits, plan_slices, touched_slices)

_log = _get_logger("mesh")


@dataclass
class Mesh:
    """A dp×db grid of devices: `devices` is a [dp, db] numpy object
    array of torch.device. Across processes, `ranks` [dp, db] names the
    rank owning each cell (its device is that rank's) and `job` is the
    multihost.Job over them; both None when every cell is this
    process's."""
    devices: np.ndarray
    axis_names: tuple = ("dp", "db")
    ranks: np.ndarray | None = None
    job: object = None


def is_local(mesh: Mesh, d: int, s: int) -> bool:
    """Does this process own cell (d, s)?"""
    return mesh.ranks is None or int(mesh.ranks[d, s]) == mesh.job.rank


def local_devices(mesh: Mesh) -> list:
    """The distinct devices of this process's cells, in mesh order."""
    dp, db = mesh.devices.shape
    return list(dict.fromkeys(mesh.devices[d, s] for d in range(dp)
                              for s in range(db) if is_local(mesh, d, s)))


def remote_cells(mesh: Mesh) -> dict:
    """{rank: [(d, s)]} of the cells other ranks own, in mesh order."""
    out: dict = {}
    if mesh.ranks is None:
        return out
    for (d, s), r in np.ndenumerate(mesh.ranks):
        if not is_local(mesh, d, s):
            out.setdefault(int(r), []).append((d, s))
    return out


def device_slots(n: int | None = None, device=None) -> list[torch.device]:
    """The devices of `device`'s type a mesh of N may use: on `cuda`,
    cuda:0..count-1, the first N (all of them for N None or < 0); on
    `cpu`, N slots of the one CPU (one for N None or < 0)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        slots = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        return slots if n is None or n < 0 else slots[:n]
    return [torch.device("cpu")] * (1 if n is None or n < 0 else n)


def make_mesh(n_devices: int | None = None, db_shards: int = 1,
              devices=None, device=None) -> Mesh:
    """A (n ÷ db)×db mesh over `devices` (default: `device_slots(
    n_devices, device)`), cut to the first n_devices."""
    if devices is None:
        devices = device_slots(n_devices, device)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    n = len(devices)
    if n % db_shards != 0:
        raise ValueError(f"{n} devices not divisible by db={db_shards}")
    return Mesh(_grid(devices, n // db_shards, db_shards))


def _grid(devices, dp: int, db: int) -> np.ndarray:
    grid = np.empty((dp, db), dtype=object)
    for i, d in enumerate(devices):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            # the card a bare "cuda" names, as a tensor's device reads
            d = torch.device("cuda", torch.cuda.current_device())
        grid[i // db, i % db] = d
    return grid


def best_db_shards(n_devices: int, db_pref: int) -> int:
    """Largest valid db width for an n-device mesh: the biggest
    divisor of n_devices that is ≤ the preferred shard count (so dp×db
    tiles every device: 3 devices asking for db=2 get 3×1)."""
    if n_devices <= 0:
        raise ValueError("best_db_shards: no devices")
    for db in range(min(max(db_pref, 1), n_devices), 0, -1):
        if n_devices % db == 0:
            return db
    return 1


def mesh_from_devices(devices, db_shards: int = 1, ranks=None,
                      job=None) -> Mesh:
    """dp×db mesh over exactly these devices, with the largest valid
    factorization for the preferred db width; `ranks` (one a device)
    and `job` lay it across processes."""
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("mesh_from_devices: no devices")
    db = best_db_shards(n, db_shards)
    return Mesh(_grid(devices, n // db, db), ranks=None if ranks is None
                else np.asarray(ranks, np.int64).reshape(n // db, db),
                job=job)


# ---------------------------------------------------------------------------
# strided table sharding (host)

@dataclass
class ShardedTable:
    """Advisory arrays with a leading shard axis [S, A_pad, ...]."""
    lo_tok: np.ndarray
    hi_tok: np.ndarray
    flags: np.ndarray
    row_offset: np.ndarray  # int64[S]: shard residue ids (0..S-1)
    row_len: np.ndarray     # int64[S]: real (unpadded) rows per shard


def shard_arrays(lo_tok: np.ndarray, hi_tok: np.ndarray,
                 flags: np.ndarray, n_shards: int,
                 pad: int | None = None) -> ShardedTable:
    """shard_table over raw columns; the streamed mesh shards each
    hash-range slice through here with one `pad` (a uniform local row
    count across every slice, so every slice has one operand shape).
    Padding rows carry lo = hi = 1 and flags = 0; no pair reaches
    them."""
    a = lo_tok.shape[0]
    lens = [max(0, (a - s + n_shards - 1) // n_shards)
            for s in range(n_shards)]
    if pad is None:
        pad = max(lens) if a else 1

    def _piece(arr, s, fill):
        out = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
        part = arr[s::n_shards]
        out[:part.shape[0]] = part
        return out

    return ShardedTable(
        lo_tok=np.stack([_piece(lo_tok, s, 1) for s in range(n_shards)]),
        hi_tok=np.stack([_piece(hi_tok, s, 1) for s in range(n_shards)]),
        flags=np.stack([_piece(flags, s, 0) for s in range(n_shards)]),
        row_offset=np.arange(n_shards, dtype=np.int64),
        row_len=np.asarray(lens, dtype=np.int64))


def shard_table(table: AdvisoryTable, n_shards: int) -> ShardedTable:
    """Round-robin (strided) row sharding: shard s holds global rows r
    with r % S == s at local index r // S, so any contiguous global
    interval (a query's bucket) maps to a contiguous local range on
    every shard and per-query work spreads evenly over the db axis
    however skewed the buckets are."""
    return shard_arrays(table.lo_tok, table.hi_tok, table.flags, n_shards)


def shard_host_columns(st: ShardedTable) -> list:
    """Each shard's join operands as host tensors: (lo_tok, hi_tok,
    flags, lo_pre, hi_pre), the prefix planes of the PADDED shard
    (ops.join.prefix_planes)."""
    out = []
    for s in range(st.lo_tok.shape[0]):
        lo = torch.from_numpy(st.lo_tok[s])
        hi = torch.from_numpy(st.hi_tok[s])
        out.append((lo, hi, torch.from_numpy(st.flags[s]),
                    *J.prefix_planes(lo, hi)))
    return out


def cell_devices(mesh: Mesh) -> dict:
    """{(device, shard): None} in mesh order: the (device, db shard)
    pairs this process's cells need operands for (a device that holds
    one shard for several dp rows needs it once)."""
    return dict.fromkeys((mesh.devices[d, s], s)
                         for d in range(mesh.devices.shape[0])
                         for s in range(mesh.devices.shape[1])
                         if is_local(mesh, d, s))


def place_shards(mesh: Mesh, host: list) -> dict:
    """{(device, s): shard s's operands on that device}, copied once per
    (device, shard) the cells need; on the CPU the host tensors
    themselves."""
    out = {}
    for dev, s in cell_devices(mesh):
        out[(dev, s)] = host[s] if dev.type == "cpu" \
            else tuple(c.to(dev) for c in host[s])
    return out


def _on(dev: torch.device):
    """The context a cell launches in: its card made current (the
    kernels' C entry points launch on the current device)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# CSR query partitioning (host; transfer O(queries), like the single-card
# join)

@dataclass
class QueryPartition:
    """Queries routed to (dp, db) cells as CSR descriptors. Strided
    table sharding gives every db shard a contiguous local slice of
    each query's bucket, so routing emits ≤ S descriptors per query and
    the cells expand their own pair lists."""
    q_start: np.ndarray   # int32[DP, S, Q_loc] shard-LOCAL bucket start
    q_count: np.ndarray   # int32[DP, S, Q_loc]
    q_ver: np.ndarray     # int32[DP, S, Q_loc]
    total: np.ndarray     # int32[DP, S] true pair count per cell
    perm: np.ndarray      # int64[DP, S, T_loc] global pair index
    valid: np.ndarray     # bool [DP, S, T_loc]
    t_loc: int            # per-cell pair capacity


def partition_queries(st: ShardedTable, q_start: np.ndarray,
                      q_count: np.ndarray, q_ver: np.ndarray,
                      dp: int, floor: int = 128,
                      q_floor: int = 64) -> QueryPartition:
    """Route queries (global bucket starts/counts) to their table shard
    and LPT-balance each shard's work across dp by PAIR count. A CSR
    descriptor is (start, count, version), so an oversized bucket
    splits into several descriptors with adjusted starts."""
    nz = q_count > 0
    starts = q_start[nz].astype(np.int64)
    counts = q_count[nz].astype(np.int64)
    vers = q_ver[nz]
    # global pair offsets follow _prepare's expansion order
    g_off = np.zeros(starts.size + 1, np.int64)
    np.cumsum(counts, out=g_off[1:])
    s_count = st.row_offset.shape[0]
    # a query's interval [a, b) lands on shard s as the contiguous local
    # range from r0 // S of ceil((b - r0) / S) rows, r0 the first row
    # ≥ a of residue s; its pairs map back to global offsets
    # base + (r0 - a) + j*S, the stride perm carries
    pieces: list[list] = []
    ends = starts + counts
    bases = g_off[:-1]
    for s in range(s_count):
        r0 = starts + ((s - starts) % s_count)
        m = r0 < ends
        cnt = (ends[m] - r0[m] + s_count - 1) // s_count
        pieces.append(list(zip(
            (r0[m] // s_count).tolist(), cnt.tolist(),
            vers[m].tolist(), (bases[m] + (r0[m] - starts[m]))
            .tolist())))
    # work items: (shard-local start, count, ver, global pair offset);
    # buckets larger than the per-cell fair share split into chunks
    assign: dict[tuple, list] = {}
    for s in range(s_count):
        shard_pairs = sum(p[1] for p in pieces[s])
        cap = max(-(-shard_pairs // dp), 1)
        items = []
        for local_start, cnt, ver, goff in pieces[s]:
            remaining = cnt
            off = 0
            while remaining > 0:
                k = min(remaining, cap)
                items.append((local_start + off, k, ver,
                              goff + off * s_count))
                off += k
                remaining -= k
        # LPT: biggest items first onto the least-loaded dp slot
        items.sort(key=lambda it: -it[1])
        loads = [0] * dp
        cells = [[] for _ in range(dp)]
        for it in items:
            d = loads.index(min(loads))
            cells[d].append(it)
            loads[d] += it[1]
        for d in range(dp):
            assign[(d, s)] = cells[d]
    q_loc = q_floor
    t_loc = floor
    for cell in assign.values():
        q_loc = max(q_loc, _next_pow2(len(cell), q_floor))
        pairs = sum(it[1] for it in cell)
        t_loc = max(t_loc, _next_pow2(pairs, floor))
    qs = np.zeros((dp, s_count, q_loc), np.int32)
    qc = np.zeros((dp, s_count, q_loc), np.int32)
    qv = np.zeros((dp, s_count, q_loc), np.int32)
    total = np.zeros((dp, s_count), np.int32)
    perm = np.zeros((dp, s_count, t_loc), np.int64)
    valid = np.zeros((dp, s_count, t_loc), bool)
    for (d, s), cell in assign.items():
        off = 0
        for i, (lstart, k, ver, goff) in enumerate(cell):
            qs[d, s, i] = lstart
            qc[d, s, i] = k
            qv[d, s, i] = ver
            perm[d, s, off:off + k] = np.arange(
                goff, goff + k * s_count, s_count)
            valid[d, s, off:off + k] = True
            off += k
        total[d, s] = off
    return QueryPartition(qs, qc, qv, total, perm, valid, t_loc)


# ---------------------------------------------------------------------------
# the per-cell launches and their one fetch per card

class PendingCells(NamedTuple):
    """A mesh dispatch's launched cells: this rank's [((d, s), device,
    result)], each result a dense bits tensor or a _PendingCompact, and
    each follower's (`remote`, one RemoteCells a rank); h_cap is the
    per-cell hit buffer (0: dense)."""
    cells: list
    h_cap: int
    remote: tuple = ()


class RemoteCells:
    """One follower's cells of one launch: `coords` (their (d, s) for a
    join, their positions in mesh order for a shift-or) and the request
    that launched them, whose reply the fetch awaits. `results(dense)` →
    one host array a cell in `coords` order, in the layout
    _fetch_per_device gives (dense bits, the packed n_hits | hit_idx |
    hit_bits, or shift-or rows). The follower keeps a compacted
    launch's outputs until `release`, or until dense=True asks for the
    same launch's dense bits (`dense_width` a cell)."""

    def __init__(self, job, rank: int, coords: list, header: dict,
                 arrays: list, width: int, dense_width: int = 0):
        self.job, self.rank, self.coords = job, rank, coords
        self.header = header
        self.width, self.dense_width = width, dense_width
        self.kept = bool(dense_width)
        self.rid, self.fut = job.request(rank, header, arrays)

    def results(self, dense: bool = False) -> list:
        from .multihost import RemoteError
        if dense and self.dense_width:
            # the follower drops the kept outputs as it answers
            self.kept = False
            reply, arrays = self.job.call(self.rank, {
                "op": "dense", "det": self.header["det"], "of": self.rid})
            width = self.dense_width
        else:
            reply, arrays = self.job.wait(self.rank, self.fut,
                                          self.header["op"])
            width = self.width
        flat = arrays[0].reshape(-1) if arrays else np.zeros(0)
        if reply.get("of") != self.rid or \
                flat.size != len(self.coords) * width:
            raise RemoteError(
                f"rank {self.rank}: a reply to {reply.get('of')} with "
                f"{flat.size} values for launch {self.rid} of "
                f"{len(self.coords)}×{width}")
        return list(flat.reshape(len(self.coords), width))

    def release(self) -> None:
        """The follower may drop this launch's kept outputs (once; a lost
        follower holds nothing, and that is logged, not raised)."""
        if not self.kept:
            return
        self.kept = False
        from .multihost import RemoteError
        try:
            self.job.post(self.rank, {"op": "release",
                                      "det": self.header["det"],
                                      "of": self.rid})
        except RemoteError as e:
            _log.warning("mesh: %s", e)


def cell_columns(part: QueryPartition, coords: list) -> np.ndarray:
    """int32[len(coords), 3, Q_loc]: the cells' (start, count, version)
    descriptor columns, one tensor a card or a follower."""
    return np.stack([np.stack([part.q_start[d, s], part.q_count[d, s],
                               part.q_ver[d, s]]) for d, s in coords])


def launch_group(dev, coords: list, cols: np.ndarray, totals: list,
                 t_loc: int, h_cap: int, shards: dict, ver: dict) -> list:
    """One card's cells: their query columns up in one copy, then one
    join launch a cell against shard s's operands (`shards[(dev, s)]`)
    and the card's version pool (`ver[dev]`) → [((d, s), dev,
    result)]. The dispatching rank ledgers the columns' upload."""
    q = torch.from_numpy(cols)
    if dev.type == "cuda":
        q = q.to(dev)
    with _on(dev):
        return [((d, s), dev, launch_join(shards[(dev, s)], ver[dev],
                                          q[i, 0], q[i, 1], q[i, 2],
                                          int(totals[i]), t_loc, h_cap))
                for i, (d, s) in enumerate(coords)]


def launch_cells(mesh: Mesh, shards: dict, ver: dict,
                 part: QueryPartition, h_cap: int = 0,
                 remote=None) -> PendingCells:
    """One join launch per cell (d, s) that holds pairs, on its card,
    against shard s's operands (`shards[(device, s)]`, prefix planes
    included) and that card's version pool (`ver[device]`): the
    compacted join into an h_cap hit buffer when h_cap > 0. Each card's
    query columns go up in one copy. A follower's cells go first, as
    `remote(rank, coords, columns, totals)` → its RemoteCells, so its
    launches overlap this rank's. Nothing is fetched."""
    dp, db = mesh.devices.shape
    by_dev: dict = {}
    by_rank: dict = {}
    for d in range(dp):
        for s in range(db):
            if not part.total[d, s]:
                continue
            if is_local(mesh, d, s):
                by_dev.setdefault(mesh.devices[d, s], []).append((d, s))
            else:
                by_rank.setdefault(int(mesh.ranks[d, s]), []).append((d, s))
    if by_rank and remote is None:
        raise ValueError("launch_cells: cells of other ranks need a "
                         "MeshDetector to send them")
    handles = []
    try:
        for rank, coords in by_rank.items():
            cols = cell_columns(part, coords)
            handles.append(remote(rank, coords, cols,
                                  [int(part.total[d, s])
                                   for d, s in coords]))
            LEDGER.note_shard_upload("query_upload", cols.nbytes,
                                     prefetched=False, path="query_upload")
        cells = []
        for dev, coords in by_dev.items():
            cols = cell_columns(part, coords)
            cells += launch_group(dev, coords, cols,
                                  [part.total[d, s] for d, s in coords],
                                  part.t_loc, h_cap, shards, ver)
            LEDGER.note_shard_upload("query_upload", cols.nbytes,
                                     prefetched=False, path="query_upload")
    except BaseException:
        for h in handles:
            h.release()
        raise
    return PendingCells(cells, h_cap, tuple(handles))


def _fetch_per_device(cells: list, pick) -> list:
    """`pick(result)` (an int32 or int8 tensor) of every cell, brought to
    the host with one transfer per card → host arrays in cell order."""
    by_dev: dict = {}
    for i, (_c, dev, out) in enumerate(cells):
        by_dev.setdefault(dev, []).append((i, pick(out)))
    host: list = [None] * len(cells)
    for items in by_dev.values():
        flat = torch.cat([t.reshape(-1) for _i, t in items]).cpu().numpy()
        off = 0
        for i, t in items:
            host[i] = flat[off:off + t.numel()]
            off += t.numel()
    return host


def _packed(p) -> torch.Tensor:
    """A compacted cell's O(hits) buffers as one int32 vector."""
    return torch.cat([p.n_hits.reshape(1).to(torch.int32), p.hit_idx,
                      p.hit_bits.to(torch.int32)])


def _cell_results(pending: PendingCells, pick, dense: bool) -> tuple:
    """Every cell's host array: this rank's through `pick` with one
    transfer per card, then each follower's reply → (coords, arrays)."""
    coords = [c for c, _dev, _out in pending.cells]
    got = _fetch_per_device(pending.cells, pick)
    for r in pending.remote:
        coords += r.coords
        got += r.results(dense)
    return coords, got


def fetch_cells(pending: PendingCells, part: QueryPartition,
                n_pairs: int) -> tuple:
    """Bring a mesh dispatch's cells back and merge them into the
    caller's pair order → (int8[n_pairs] dense bits or CompactBits,
    the fullest cell's hit count, {transfer path: bytes}). On the
    compacted route the O(hits) buffers come back first; if any cell
    overflowed, the dense bits of every cell follow and the result is
    dense, equal either way. The followers drop what they kept for the
    second round once this returns or raises."""
    try:
        return _merge_cells(pending, part, n_pairs)
    finally:
        for r in pending.remote:
            r.release()


def _merge_cells(pending: PendingCells, part: QueryPartition,
                 n_pairs: int) -> tuple:
    nbytes: dict = {}
    h_cap = pending.h_cap
    if h_cap:
        coords, packed = _cell_results(pending, _packed, dense=False)
        nbytes["compact"] = float(len(coords) * (h_cap * 5 + 4))
        max_hits = max((int(p[0]) for p in packed), default=0)
        if max_hits <= h_cap:
            gidx, gbits = [], []
            for (d, s), p in zip(coords, packed):
                k = int(p[0])
                if k:
                    gidx.append(part.perm[d, s][p[1:1 + k]])
                    gbits.append(p[1 + h_cap:1 + h_cap + k].astype(np.int8))
            if not gidx:
                return (CompactBits(np.zeros(0, np.int32),
                                    np.zeros(0, np.int8), n_pairs),
                        max_hits, nbytes)
            gi = np.concatenate(gidx)
            gb = np.concatenate(gbits)
            # the strided perm interleaves the cells' global indices:
            # restore ascending pair order
            order = np.argsort(gi, kind="stable")
            return (CompactBits(gi[order].astype(np.int32), gb[order],
                                n_pairs), max_hits, nbytes)
        coords, dense = _cell_results(pending, lambda p: p.dense, dense=True)
    else:
        max_hits = 0
        coords, dense = _cell_results(pending, lambda b: b, dense=False)
    nbytes["dense"] = float(sum(b.nbytes for b in dense))
    out = np.zeros(n_pairs, np.int8)
    for (d, s), bits in zip(coords, dense):
        v = part.valid[d, s]
        out[part.perm[d, s][v]] = bits[v]
    return out, max_hits, nbytes


def _replicate(arr, devices) -> dict:
    """{device: arr on it} for each distinct device."""
    t = torch.as_tensor(arr)
    return {dev: t if dev.type == "cpu" else t.to(dev)
            for dev in dict.fromkeys(devices)}


def sharded_csr_join(mesh: Mesh, st: ShardedTable, ver_tok,
                     part: QueryPartition, n_pairs: int) -> np.ndarray:
    """The dense sharded join of a host ShardedTable: its shards placed
    on their cells' devices, one launch per cell, one fetch per card →
    int8[n_pairs] bits in the caller's pair order."""
    shards = place_shards(mesh, shard_host_columns(st))
    ver = _replicate(np.ascontiguousarray(ver_tok, np.int32),
                     local_devices(mesh))
    bits, _max, nbytes = fetch_cells(launch_cells(mesh, shards, ver, part),
                                     part, n_pairs)
    METRICS.inc("trivy_tpu_detect_transfer_bytes_total", nbytes["dense"],
                path="dense")
    return bits


def sharded_csr_join_compact(mesh: Mesh, st: ShardedTable, ver_tok,
                             part: QueryPartition, n_pairs: int,
                             h_cap: int) -> tuple:
    """sharded_csr_join with each cell's hits compacted into an h_cap
    buffer → (CompactBits, or dense int8[n_pairs] when a cell
    overflowed, the fullest cell's hit count)."""
    shards = place_shards(mesh, shard_host_columns(st))
    ver = _replicate(np.ascontiguousarray(ver_tok, np.int32),
                     local_devices(mesh))
    bits, max_hits, nbytes = fetch_cells(
        launch_cells(mesh, shards, ver, part, h_cap), part, n_pairs)
    for path, n in nbytes.items():
        METRICS.inc("trivy_tpu_detect_transfer_bytes_total", n, path=path)
    return bits, max_hits


# ---------------------------------------------------------------------------
# the sharded shift-or (the secret lane)

class MeshBank(NamedTuple):
    """A shift-or bank on the mesh: {device: ((kw_words, kw_masks,
    kw_bits), (bitmap, cand))} for this process's devices, and its
    content key as the followers hold it ("" on a mesh of one
    process)."""
    local: dict
    key: str


class PendingShiftor(NamedTuple):
    """A sharded shift-or's launched cells: this rank's [(position in
    mesh order, device, int32[rows/n, n_words] tensor)], and each
    follower's (`remote`, one RemoteCells a rank)."""
    cells: list
    n_words: int
    remote: tuple = ()


def replicate_bank(mesh: Mesh, kw_words, kw_masks, kw_bits,
                   index=None) -> MeshBank:
    """The kernel's bank and its bigram index (ops.shiftor.bank_index)
    copied once to each distinct device of this process's cells, and
    shipped to every follower that owns a cell."""
    if index is None:
        index = so.bank_index(kw_words, kw_masks, kw_bits)
    parts = (kw_words, kw_masks, kw_bits, *index)
    devs = local_devices(mesh)
    arrays = [_replicate(a, devs) for a in parts]
    local = {dev: (tuple(a[dev] for a in arrays[:3]),
                   tuple(a[dev] for a in arrays[3:])) for dev in devs}
    ranks = remote_cells(mesh)
    if not ranks:
        return MeshBank(local, "")
    host = [torch.as_tensor(a).cpu().numpy() for a in parts]
    h = hashlib.sha256()
    for a in host:
        h.update(f"{a.dtype.str}{a.shape}".encode() + a.tobytes())
    key = h.hexdigest()
    for rank in ranks:
        mesh.job.call(rank, {"op": "bank", "key": key}, host)
    return MeshBank(local, key)


def launch_shiftor_cells(mesh: Mesh, bank: MeshBank, chunks: np.ndarray,
                         n_words: int) -> PendingShiftor:
    """Rows padded to a multiple of the mesh size and split over every
    cell in mesh order; one shift-or launch per cell on its card
    (ops.shiftor.shiftor: csrc/shiftor.cu on a GPU, the plain version
    on the CPU), a follower's cells' rows sent to it in one message
    first. Nothing is fetched."""
    dp, db = mesh.devices.shape
    coords = [(d, s) for d in range(dp) for s in range(db)]
    n = len(coords)
    rows = chunks.shape[0]
    pad_rows = -(-rows // n) * n
    if pad_rows != rows:
        padded = np.zeros((pad_rows, chunks.shape[1]), chunks.dtype)
        padded[:rows] = chunks
        chunks = padded
    per = pad_rows // n
    by_rank: dict = {}
    mine = []
    for i, (d, s) in enumerate(coords):
        if is_local(mesh, d, s):
            mine.append(i)
        else:
            by_rank.setdefault(int(mesh.ranks[d, s]), []).append(i)
    remote = tuple(RemoteCells(mesh.job, rank, idx, {
        "op": "shiftor", "key": bank.key, "n_words": n_words,
        "cells": [[i, str(mesh.devices[coords[i]])] for i in idx]},
        [np.stack([chunks[i * per:(i + 1) * per] for i in idx])],
        width=per * n_words) for rank, idx in by_rank.items())
    cells = []
    for i in mine:
        dev = mesh.devices[coords[i]]
        piece = torch.from_numpy(
            np.ascontiguousarray(chunks[i * per:(i + 1) * per]))
        if dev.type == "cuda":
            piece = piece.to(dev)
        arrays, index = bank.local[dev]
        with _on(dev):
            cells.append((i, dev, so.shiftor(*arrays, piece,
                                              n_words=n_words,
                                              index=index)))
    return PendingShiftor(cells, n_words, remote)


def fetch_shiftor_cells(pending: PendingShiftor, rows: int) -> np.ndarray:
    """The cells' bitmasks with one transfer per card (and a follower's
    from its reply) → int32[rows, n_words] in row order."""
    order = [i for i, _dev, _t in pending.cells]
    got = _fetch_per_device(pending.cells, lambda t: t)
    for r in pending.remote:
        order += r.coords
        got += r.results()
    host = [h for _i, h in sorted(zip(order, got), key=lambda x: x[0])]
    return np.concatenate([h.reshape(-1, pending.n_words)
                           for h in host])[:rows]


def sharded_shiftor_scan(mesh: Mesh, kw_words, kw_masks,
                         chunks: np.ndarray, n_words: int,
                         kw_bits=None, index=None) -> np.ndarray:
    """The secret keyword scan sharded over EVERY cell of the mesh: chunk
    rows split over the flattened dp×db axes, the bank replicated →
    int32[rows, n_words] exact keyword bitmasks in row order. Without
    `kw_bits`, kw_words/kw_masks are a literal bank's raw [W, Nk]
    planes (ops.shiftor.pack_planes lays them out); `index` defaults to
    their bank_index."""
    if kw_bits is None:
        kw_words, kw_masks, kw_bits = so.pack_planes(kw_words, kw_masks)
    bank = replicate_bank(mesh, kw_words, kw_masks, kw_bits, index)
    return fetch_shiftor_cells(
        launch_shiftor_cells(mesh, bank, np.asarray(chunks, np.uint8),
                             n_words), chunks.shape[0])


# ---------------------------------------------------------------------------
# the detector

class _PendingMesh(NamedTuple):
    """One launched resident mesh dispatch, fetched by _fetch."""
    cells: PendingCells
    part: QueryPartition
    total: int
    t_pad: int
    t_total: int
    site: str


class _MeshUploaded(NamedTuple):
    """One streamed slice's shards on the cells' devices ({(device, s):
    operands}) and each card's upload event (none on the CPU)."""
    shards: dict
    events: dict


class CellSlices:
    """A streamed table's slices for this process's cells: each slice's
    padded shards as host tensors (`host[k][s]`: lo_tok, hi_tok, flags
    and the prefix planes, pinned on a card; None for a shard no cell
    here holds), uploaded on each card's side stream when the
    SliceCache (`cache`) asks, and settled onto the launching stream.
    Rank 0's MeshDetector holds one, and so does a follower
    (parallel/follower.py) for its own cells."""

    def __init__(self, host: list, cells: dict):
        self.host = host
        self.cells = cells
        self.devs = list(dict.fromkeys(dev for dev, _s in cells))
        self._streams: dict = {}
        self._lock = threading.Lock()
        self.cache = SliceCache(self.upload, settle=self.settle,
                                site="mesh")

    def _stream(self, dev):
        with self._lock:
            st = self._streams.get(dev)
            if st is None:
                st = self._streams[dev] = torch.cuda.Stream(dev)
            return st

    def upload(self, k: int):
        """The SliceCache upload hook: slice k's shards copied to the
        cells' devices, non_blocking on each card's upload stream with
        an event after them; on the CPU the host tensors are the
        operands."""
        host = self.host[k]
        shards, events, nbytes = {}, {}, 0
        for dev, s in self.cells:
            nbytes += sum(c.numel() * c.element_size() for c in host[s])
            if dev.type != "cuda":
                shards[(dev, s)] = host[s]
                continue
            with torch.cuda.stream(self._stream(dev)):
                shards[(dev, s)] = tuple(c.to(dev, non_blocking=True)
                                         for c in host[s])
        for dev in self.devs:
            if dev.type == "cuda":
                events[dev] = torch.cuda.Event()
                events[dev].record(self._stream(dev))
        return _MeshUploaded(shards, events), nbytes

    def settle(self, up: _MeshUploaded) -> dict:
        """The SliceCache settle hook: per card, wait on the host for the
        copy, make the launching (current) stream wait on it, and mark
        the tensors as used by that stream."""
        for dev, event in up.events.items():
            event.synchronize()
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            for (d, _s), cols in up.shards.items():
                if d == dev:
                    for t in cols:
                        t.record_stream(stream)
        return up.shards


class MeshDetector:
    """A BatchDetector whose join runs sharded over a mesh, one kernel
    launch per cell.

    Exposes the surface detectd and the scanners call (`_prepare`,
    `stage_merged`, `dispatch_merged`, `fetch_merged`, `_assemble`,
    `_get_pool`, `warmup`, `prefetch_ranges`, `detect_many`, `detect`,
    `close`), so detectd routes coalesced dispatches through the mesh
    unchanged and the server's table swap retires it like any other
    detector. With `stream` whose plan engages for the per-device share
    of the table (device_nbytes ÷ db), the table streams through the
    double-buffered slice pair instead of living on the cards whole.

    On a mesh across processes this is rank 0's: it ships each follower
    its cells' operands when made (`ship_s`, `ship_bytes`), the version
    pool when it grows, and its cells' descriptors a dispatch, and
    `close` tells the followers to drop them."""

    def __init__(self, table: AdvisoryTable, mesh: Mesh,
                 db_shards: int | None = None,
                 stream: StreamOptions | None = None):
        self.mesh = mesh
        self.table = table
        self.dp, db = mesh.devices.shape
        if db_shards is not None and db_shards != db:
            raise ValueError(f"db_shards={db_shards} on a mesh of db "
                             f"width {db}")
        self.db = db
        self._devs = local_devices(mesh)
        if not self._devs:
            raise ValueError("MeshDetector: this process owns no cell")
        # the followers' cells, the job that reaches them, this
        # detector's id there and the table's digest every message
        # carries
        self._remote = remote_cells(mesh)
        self._job = mesh.job if self._remote else None
        if self._job is not None and self._job.rank != 0:
            raise ValueError("MeshDetector: rank 0 dispatches a mesh "
                             f"across processes, not rank {self._job.rank}")
        self._det_id = self._job.new_id() if self._job else 0
        self._digest = table.content_digest() if self._job else ""
        self._closed = False
        self.ship_s = 0.0
        self.ship_bytes = 0
        # the prep, assembly, version pool and hit budget are the inner
        # detector's; its device is this process's first
        self._inner = BatchDetector(table, device=self._devs[0])
        self.device = self._inner.device
        self._ver_lock = threading.Lock()
        self._ver_copies: dict = {}
        # the last pool sent to the followers and its generation
        self._ver_sent = None
        self._ver_gen = 0
        self._stream_bounds = None
        self._slice_cache = None
        if stream is not None:
            self._stream_bounds = plan_slices(
                table, stream, device=self.device,
                device_bytes=-(-table.device_nbytes() // db))
        if self._stream_bounds is not None:
            # one shard pad for every slice: one operand shape
            max_rows = int(np.diff(self._stream_bounds).max())
            self._shard_pad = max(1, -(-max_rows // db))
            # partition metadata only (row_offset fixes the db width);
            # the slices' arrays live in the cache
            self.st = ShardedTable(
                lo_tok=None, hi_tok=None, flags=None,
                row_offset=np.arange(db, dtype=np.int64),
                row_len=np.zeros(db, dtype=np.int64))
            self._st_dev = None
            # sharded, padded host copies of every slice and their
            # prefix planes, built once: walks re-upload evicted slices
            # constantly. The followers' shards are shipped, this
            # process's pinned on a card
            b = self._stream_bounds
            host = [shard_host_columns(shard_arrays(
                table.lo_tok[b[k]:b[k + 1]], table.hi_tok[b[k]:b[k + 1]],
                table.flags[b[k]:b[k + 1]], db, pad=self._shard_pad))
                for k in range(b.size - 1)]
            self._ship(host)
            cells = cell_devices(mesh)
            held = {s for _dev, s in cells}
            pin = self.device.type == "cuda"
            host = [[(tuple(c.pin_memory() for c in cols) if pin else cols)
                     if s in held else None for s, cols in enumerate(sl)]
                    for sl in host]
            self._slices = CellSlices(host, cells)
            self._slice_cache = self._slices.cache
            kw = table.lo_tok.shape[1]
            per_slice = self._shard_pad * db * (
                table.lo_tok.dtype.itemsize * (kw + J.PREFIX_TOKENS) * 2
                + table.flags.dtype.itemsize)
            LEDGER.note_resident("advisory_slice_resident",
                                 per_slice * min(RESIDENT, b.size - 1))
            return
        # the table sharded for this mesh's db width and placed on the
        # cells' devices once; every dispatch reuses the placed copies
        self.st = shard_table(table, db)
        host = shard_host_columns(self.st)
        self._ship([host])
        self._st_dev = place_shards(mesh, host)

    def close(self) -> None:
        """Join the inner engine's fetch thread, drop any resident
        stream slices, and tell the followers to drop this table
        (idempotent)."""
        if self._slice_cache is not None:
            self._slice_cache.drop_all()
        if self._job is not None and not self._closed:
            self._closed = True
            from .multihost import RemoteError
            for rank in self._remote:
                try:
                    self._job.post(rank, {"op": "drop",
                                          "det": self._det_id})
                except RemoteError as e:
                    _log.warning("mesh: %s", e)
        self._inner.close()

    # ---- the followers -------------------------------------------------

    def _ship(self, host: list) -> None:
        """Send each follower its cells' operands, `host` being every
        slice's (one: the resident table) host columns a shard: of each
        slice, the shards its cells hold, stamped with the table's
        digest; wait until each holds them."""
        if self._job is None:
            return
        t0 = time.perf_counter()
        sent = []
        for rank, coords in self._remote.items():
            shards = sorted({s for _d, s in coords})
            arrays = [c.numpy() for sl in host for s in shards
                      for c in sl[s]]
            self.ship_bytes += sum(a.nbytes for a in arrays)
            sent.append((rank, self._job.request(rank, {
                "op": "table", "det": self._det_id,
                "digest": self._digest, "shards": shards,
                "slices": len(host) if self._stream_bounds is not None
                else 0,
                "cells": [[d, s, str(self.mesh.devices[d, s])]
                          for d, s in coords]}, arrays)[1]))
        for rank, fut in sent:
            self._job.wait(rank, fut, "table")
        self.ship_s = time.perf_counter() - t0

    def _send_cells(self, t_loc: int, h_cap: int, k: int = -1,
                    nxt: int = -1):
        """launch_cells' `remote`: a follower's cells as one join
        request (slice k of a walk, naming the slice to prefetch next),
        None on a mesh of one process."""
        if self._job is None:
            return None

        def send(rank, coords, cols, totals):
            return RemoteCells(self._job, rank, coords, {
                "op": "join", "det": self._det_id, "digest": self._digest,
                "ver_gen": self._ver_gen, "slice": k, "next": nxt,
                "t_loc": t_loc, "h_cap": h_cap,
                "cells": [[d, s, t] for (d, s), t in zip(coords, totals)]},
                [cols], width=1 + 2 * h_cap if h_cap else t_loc,
                dense_width=t_loc if h_cap else 0)
        return send

    def _prefetch_remote(self, slices: list) -> None:
        """The followers warm the same slices this process does."""
        if self._job is not None and slices:
            for rank in self._remote:
                self._job.post(rank, {"op": "prefetch", "det": self._det_id,
                                      "slices": [int(k) for k in slices]})

    # ---- per-device operands -------------------------------------------

    def _ver_by_device(self, u_pad: int) -> dict:
        """{device: the version pool on it}: the inner detector's copy
        on its own device, and a copy of that on each other device,
        remade whenever the inner one was re-uploaded; a re-uploaded
        pool goes to the followers too, before any dispatch that reads
        it (one lock orders the copies and the sends)."""
        out = {}
        with self._ver_lock:
            base = self._inner._ver_device(u_pad)
            for dev in self._devs:
                if dev == base.device:
                    out[dev] = base
                    continue
                src, copy = self._ver_copies.get(dev, (None, None))
                if src is not base:
                    copy = base.to(dev)
                    self._ver_copies[dev] = (base, copy)
                out[dev] = copy
            if self._job is not None and self._ver_sent is not base:
                pool = base.cpu().numpy()
                for rank in self._remote:
                    self._job.post(rank, {"op": "ver", "det": self._det_id,
                                          "gen": self._ver_gen + 1}, [pool])
                self._ver_sent = base
                self._ver_gen += 1
        return out

    # ---- scheduler surface (detectd routes through these) --------------

    @property
    def _get_pool(self):
        return self._inner._get_pool

    def _prepare(self, queries):
        return self._inner._prepare(queries)

    def _assemble(self, prep, bits):
        return self._inner._assemble(prep, bits)

    def stage_merged(self, preps, plan=None,
                     dedup: bool | None = None) -> _StagedMerged:
        """Merge and plan a future dispatch_merged. Nothing is uploaded:
        the dispatch uploads each card's cell descriptors itself."""
        merged, launch = self._inner._launch_args(preps, plan)
        return _StagedMerged(merged, plan, launch,
                             plan is not None if dedup is None else dedup,
                             None)

    def dispatch_merged(self, preps, plan=None,
                        staged: _StagedMerged | None = None):
        """ONE mesh dispatch covering several prepared batches: the
        merged descriptors (the unique ones under a dedup plan)
        partition over the cells as one bigger batch would, so each
        prep's slice is what its solo dispatch gives. → (pending
        result, per-prep offsets, t_pad), fetched by fetch_merged."""
        if staged is None:
            staged = self.stage_merged(preps, plan)
        plan = staged.plan
        _qs, _qc, _qv, offsets, total, t_pad, u_pad = staged.merged
        ls, lc, lv, l_total, l_tpad = staged.launch
        if staged.dedup:
            _feed.note_dedup_ratio(l_total, total)
        with span("detect.dispatch", n_pairs=total, t_pad=t_pad,
                  merged=len(preps), deduped=plan is not None):
            dev = self._dispatch(ls, lc, lv, l_total, l_tpad, u_pad)
        note_dispatch(self.device)
        if plan is not None:
            dev = _feed.PendingExpand(dev, plan, staged.launch)
        return dev, offsets, t_pad

    def fetch_merged(self, dev, preps, offsets, t_pad):
        """A merged dispatch's bits (dense or CompactBits over the full
        merged pair space); a deduped one is scattered back through its
        plan. A failed fetch raises."""
        if isinstance(dev, _feed.PendingExpand):
            return _feed.expand_bits(dev.plan, self._fetch(dev.dev), t_pad)
        return self._fetch(dev)

    def warmup(self, max_pairs: int = 1 << 18) -> int:
        """The cells' shapes follow each dispatch's partition, so there
        is no ladder to launch; a streamed mesh uploads its first
        resident slices (the followers theirs). → 0 rungs."""
        if self._slice_cache is not None:
            first = list(range(min(RESIDENT, self._stream_bounds.size - 1)))
            for k in first:
                self._slice_cache.prefetch(k)
            self._prefetch_remote(first)
        return 0

    def prefetch_ranges(self, q_start, q_count) -> list[int]:
        """detectd's admission peek: warm the slices the next dispatch's
        bucket ranges will touch (a streamed mesh only; a resident one
        holds the whole table), here and on the followers. → the slice
        indices issued."""
        if self._slice_cache is None:
            return []
        resident = set(self._slice_cache.resident())
        issued: list[int] = []
        for k in touched_slices(self._stream_bounds, q_start, q_count):
            if k in resident:
                continue
            self._slice_cache.prefetch(k)
            issued.append(k)
            if len(issued) >= RESIDENT:
                break
        self._prefetch_remote(issued)
        return issued

    # ---- the mesh launch -----------------------------------------------

    def _dispatch(self, q_start, q_count, q_ver, total: int, t_pad: int,
                  u_pad: int):
        """Partition these descriptors over the cells and launch them →
        a _PendingMesh (resident), or the host bits of the slice walk
        (streamed, which fetches each slice as it goes)."""
        site = "redetect" if blameless_active() else "mesh"
        if self._stream_bounds is not None:
            return self._walk(q_start, q_count, q_ver, total, t_pad,
                              u_pad, site)
        inner = self._inner
        t_watch = time.perf_counter()
        part = partition_queries(self.st, q_start, q_count, q_ver, self.dp)
        # the ledger's padded pairs: the mesh's whole cell capacity, the
        # followers' cells included
        t_total = part.t_loc * self.dp * self.db
        h_loc = inner._hit_capacity(part.t_loc)
        ver = self._ver_by_device(u_pad)
        cells = inner._accounted(
            lambda: launch_cells(self.mesh, self._st_dev, ver, part, h_loc,
                                 self._send_cells(part.t_loc, h_loc)),
            site, total, t_total, h_loc, t_watch)
        return _PendingMesh(cells, part, total, t_pad, t_total, site)

    def _fetch(self, dev):
        """A resident dispatch's bits in the dispatch's pair order
        (dense int8[t_pad] or CompactBits); a walk's host bits pass
        through."""
        if not isinstance(dev, _PendingMesh):
            return dev
        t0 = time.perf_counter()
        bits, max_hits, nbytes = fetch_cells(dev.cells, dev.part, dev.total)
        _cost.charge_device_ms(dev.site, (time.perf_counter() - t0) * 1e3)
        self._note_fetch(nbytes, dev.cells.h_cap, max_hits, dev.site,
                         dev.t_total)
        if isinstance(bits, CompactBits):
            return CompactBits(bits.pair_idx, bits.bits, dev.t_pad)
        out = np.zeros(dev.t_pad, np.int8)
        out[:dev.total] = bits
        return out

    def _note_fetch(self, nbytes: dict, h_cap: int, max_hits: int,
                    site: str, t_total: int) -> None:
        """The transfer series of one fetched launch, and the hit budget
        adapted on its fullest cell (overflow is per cell, a follower's
        cells counted as this process's)."""
        for path, n in nbytes.items():
            METRICS.inc("trivy_tpu_detect_transfer_bytes_total", n,
                        path=path)
            _cost.ledgered_transfer(
                "overflow" if path == "dense" and h_cap else path, n)
        if h_cap:
            self._inner._note_hits(max_hits, h_cap, site=site,
                                   t_pad=t_total)

    def _walk(self, q_start, q_count, q_ver, total: int, t_pad: int,
              u_pad: int, site: str):
        """The streamed walk over the cells: each touched slice's shards
        come off the double-buffered resident set (the next slice's
        upload prefetched before this slice's cells launch, on the
        followers too), the cells launch and are fetched, and the slice
        results merge into one result equal to the resident join's."""
        plans = clip_descriptors(self._stream_bounds, q_start, q_count,
                                 q_ver) if total else []
        if not plans:
            return np.zeros(t_pad, np.int8)
        inner = self._inner
        ver = self._ver_by_device(u_pad)
        results: list = []
        t_total_sum = 0
        for i, plan in enumerate(plans):
            t_watch = time.perf_counter()
            shards = self._slice_cache.get(plan.idx)
            nxt = plans[i + 1].idx if i + 1 < len(plans) else -1
            if nxt >= 0:
                self._slice_cache.prefetch(nxt)
            part = partition_queries(self.st, plan.q_start, plan.q_count,
                                     plan.q_ver, self.dp)
            t_total = part.t_loc * self.dp * self.db
            t_total_sum += t_total
            h_loc = inner._hit_capacity(part.t_loc)

            def run(shards=shards, part=part, plan=plan, h_loc=h_loc,
                    nxt=nxt):
                return fetch_cells(launch_cells(
                    self.mesh, shards, ver, part, h_loc,
                    self._send_cells(part.t_loc, h_loc, plan.idx, nxt)),
                    part, plan.total)
            bits, max_hits, nbytes = inner._accounted(
                run, site, plan.total, t_total, h_loc, t_watch,
                traffic=False)
            self._note_fetch(nbytes, h_loc, max_hits, site, t_total)
            results.append((plan, bits))
        # tail prefetch: the next dispatch over the same hash span starts
        # back at the walk's first slice
        if len(plans) > 1 or \
                plans[0].idx not in self._slice_cache.resident():
            self._slice_cache.prefetch(plans[0].idx)
            self._prefetch_remote([plans[0].idx])
        # one traffic observation per logical dispatch; the ledger
        # carries the per-slice launches
        inner._account_traffic(total, t_total_sum, warm=False)
        return merge_slice_bits(results, t_pad)

    # ---- direct detection ----------------------------------------------

    def detect_many(self, batches) -> list:
        """Per batch: prep → the cells' launches → fetch → assemble."""
        inner = self._inner
        out = []
        n_queries = n_pairs = n_hits = 0
        for qs in batches:
            if not qs or len(inner.table) == 0:
                out.append([])
                continue
            n_queries += len(qs)
            prep = inner._prepare(qs)
            if prep is None or prep.n_pairs == 0:
                out.append([])
                continue
            n_pairs += prep.n_pairs
            with span("detect.dispatch", n_pairs=prep.n_pairs,
                      t_pad=prep.t_pad):
                bits = self._fetch(self._dispatch(
                    prep.q_start, prep.q_count, prep.q_ver, prep.n_pairs,
                    prep.t_pad, prep.u_pad))
            note_dispatch(self.device)
            hits = inner._assemble(prep, bits)
            n_hits += len(hits)
            out.append(hits)
        METRICS.inc("trivy_tpu_detect_queries_total", n_queries)
        METRICS.inc("trivy_tpu_detect_pairs_total", n_pairs)
        METRICS.inc("trivy_tpu_detect_hits_total", n_hits)
        return out

    def detect(self, queries) -> list:
        return self.detect_many([queries])[0]
