"""The follower ranks of a mesh across processes: what a rank > 0 of a
torch.distributed job runs while rank 0 dispatches (parallel/mesh.py,
multihost.py).

`follow(job)` answers rank 0's requests in order until stop:

  table     one MeshDetector's cells on this rank (their devices) and the
            shards they hold: resident, placed on the cards; streamed,
            every slice's shards pinned on a card behind this rank's own
            SliceCache. Stamped with the table's content digest;
  ver       that detector's version pool, copied to each of its cards;
  join      a dispatch (with `slice`, one slice of a walk, whose next
            slice is prefetched): its cells' descriptors launched on
            their cards, fetched with one transfer a card and sent back
            in the layout rank 0's fetch makes. A compacted one keeps its
            outputs until `release`, or until `dense` asks for its dense
            bits;
  prefetch  warm slices, as rank 0's peek does;
  drop      forget a detector;
  bank      a shift-or bank and its bigram index, by content key;
  shiftor   rows of a sharded shift-or, one launch a cell;
  counts    this rank's kernel launches by kernel, the cells it launched,
            the devices it launched on and the requests it answered.

A dispatch naming a table digest this rank does not hold raises, naming
both; so does one whose version pool has not arrived. Every launch runs
on this rank's own card under torch.cuda.device: nothing here falls
back to the CPU or leaves work to rank 0.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import shiftor as so
from .mesh import CellSlices, _fetch_per_device, _on, _packed, launch_group

# a shard's host columns, in the order MeshDetector._ship sends them:
# lo_tok, hi_tok, flags and the two prefix planes
_COLUMNS = 5


class _Held:
    """One MeshDetector's cells on this rank: {(d, s): device}, their
    operands (`shards` resident, or `slices`), the version pool on each
    card and its generation, and the compacted launches kept for
    rank 0's second round ({request id: cells})."""

    def __init__(self, header: dict, arrays: list):
        self.digest = header["digest"]
        self.cells = {(d, s): torch.device(dev)
                      for d, s, dev in header["cells"]}
        need = dict.fromkeys((dev, s) for (_d, s), dev in self.cells.items())
        cols = iter(arrays)
        host = [{s: tuple(torch.from_numpy(next(cols))
                          for _ in range(_COLUMNS))
                 for s in header["shards"]}
                for _k in range(max(header["slices"], 1))]
        self.ver: dict = {}
        self.ver_gen = 0
        self.kept: dict = {}
        self.shards = None
        self.slices = None
        if header["slices"]:
            if any(dev.type == "cuda" for dev, _s in need):
                host = [{s: tuple(c.pin_memory() for c in cols)
                         for s, cols in sl.items()} for sl in host]
            self.slices = CellSlices(host, need)
        else:
            self.shards = {(dev, s): host[0][s] if dev.type == "cpu"
                           else tuple(c.to(dev) for c in host[0][s])
                           for dev, s in need}

    def devices(self) -> list:
        return list(dict.fromkeys(self.cells.values()))


class Follower:
    """A follower rank's state: the tables it holds by detector id, the
    shift-or banks by key, and what it has done (`counts`)."""

    def __init__(self, job):
        self.job = job
        self.held: dict = {}
        self.banks: dict = {}
        self.ops: dict = {}
        self.cells_launched = 0
        self.launched_on: set = set()
        self._handlers = {
            "table": self._table, "ver": self._ver, "join": self._join,
            "dense": self._dense, "release": self._release,
            "prefetch": self._prefetch, "drop": self._drop,
            "bank": self._bank, "shiftor": self._shiftor,
            "counts": self._counts}

    def serve(self) -> None:
        """Answer rank 0 until stop."""
        self.job.serve(self.handle)

    def handle(self, header: dict, arrays: list) -> tuple:
        op = header["op"]
        self.ops[op] = self.ops.get(op, 0) + 1
        if op not in self._handlers:
            raise ValueError(f"unknown request {op!r}")
        return self._handlers[op](header, arrays)

    def _get(self, header: dict, check: bool = True) -> _Held:
        held = self.held.get(header["det"])
        if held is None:
            raise KeyError(f"rank {self.job.rank} holds no table for "
                           f"detector {header['det']}")
        if check and held.digest != header["digest"]:
            raise ValueError(
                f"rank {self.job.rank} holds table {held.digest}, but the "
                f"dispatch names table {header['digest']}")
        return held

    def _table(self, header, arrays):
        self.held[header["det"]] = _Held(header, arrays)
        return {}, ()

    def _ver(self, header, arrays):
        held = self._get(header, check=False)
        pool = torch.from_numpy(arrays[0])
        held.ver = {dev: pool if dev.type == "cpu" else pool.to(dev)
                    for dev in held.devices()}
        held.ver_gen = header["gen"]
        return {}, ()

    def _join(self, header, arrays):
        held = self._get(header)
        if held.ver_gen < header["ver_gen"]:
            raise RuntimeError(
                f"rank {self.job.rank} holds version pool "
                f"{held.ver_gen}, the dispatch needs {header['ver_gen']}")
        if header["slice"] < 0:
            shards = held.shards
        else:
            shards = held.slices.cache.get(header["slice"])
            if header["next"] >= 0:
                held.slices.cache.prefetch(header["next"])
        coords = [(d, s) for d, s, _t in header["cells"]]
        totals = [t for _d, _s, t in header["cells"]]
        cols = arrays[0]
        by_dev: dict = {}
        for i, c in enumerate(coords):
            by_dev.setdefault(held.cells[c], []).append(i)
        launched = {}
        for dev, idx in by_dev.items():
            for c, _dev, out in launch_group(
                    dev, [coords[i] for i in idx],
                    np.ascontiguousarray(cols[idx]),
                    [totals[i] for i in idx], header["t_loc"],
                    header["h_cap"], shards, held.ver):
                launched[c] = out
            self.launched_on.add(str(dev))
        cells = [(c, held.cells[c], launched[c]) for c in coords]
        self.cells_launched += len(cells)
        if header["h_cap"]:
            held.kept[header["id"]] = cells
            got = _fetch_per_device(cells, _packed)
        else:
            got = _fetch_per_device(cells, lambda b: b)
        return {"of": header["id"]}, [np.concatenate(got)]

    def _dense(self, header, arrays):
        held = self._get(header, check=False)
        cells = held.kept.pop(header["of"])
        got = _fetch_per_device(cells, lambda p: p.dense)
        return {"of": header["of"]}, [np.concatenate(got)]

    def _release(self, header, arrays):
        self._get(header, check=False).kept.pop(header["of"], None)
        return {}, ()

    def _prefetch(self, header, arrays):
        held = self._get(header, check=False)
        for k in header["slices"]:
            held.slices.cache.prefetch(k)
        return {}, ()

    def _drop(self, header, arrays):
        held = self.held.pop(header["det"], None)
        if held is not None and held.slices is not None:
            held.slices.cache.drop_all()
        return {}, ()

    def _bank(self, header, arrays):
        self.banks.setdefault(header["key"], (
            [torch.from_numpy(np.array(a)) for a in arrays], {}))
        return {}, ()

    def _shiftor(self, header, arrays):
        host, placed = self.banks[header["key"]]
        rows = arrays[0]
        cells = []
        for j, (_i, name) in enumerate(header["cells"]):
            dev = torch.device(name)
            if dev not in placed:
                on = [t if dev.type == "cpu" else t.to(dev) for t in host]
                placed[dev] = (tuple(on[:3]), tuple(on[3:]))
            bank, index = placed[dev]
            piece = torch.from_numpy(np.ascontiguousarray(rows[j]))
            if dev.type == "cuda":
                piece = piece.to(dev)
            with _on(dev):
                cells.append((None, dev, so.shiftor(
                    *bank, piece, n_words=header["n_words"], index=index)))
            self.launched_on.add(name)
        got = _fetch_per_device(cells, lambda t: t)
        return {"of": header["id"]}, [np.concatenate(
            [g.reshape(-1) for g in got])]

    def _counts(self, header, arrays):
        from ..__main__ import launch_counts
        return {"launches": launch_counts(), "pid": os.getpid(),
                "cells_launched": self.cells_launched,
                "launched_on": sorted(self.launched_on),
                "ops": dict(self.ops), "held": len(self.held)}, ()


def follow(job) -> None:
    """A follower rank's loop: serve rank 0's mesh requests until it
    sends stop. Raises when rank 0 is gone."""
    Follower(job).serve()
