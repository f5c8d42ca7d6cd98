"""graftmemo: content-addressed detection-result memoization.

Images share base layers, and a new trivy-db changes the answer only
for the (blob, db) pairs whose inputs changed. The fanal cache already
dedupes layer analysis; this store dedupes the detect step, the join
launches on the card, the same way:

  key      (blob cache id, advisory-table content digest). The blob id
           is content and analyzer-version addressed (fanal.cache), and
           the db version is AdvisoryTable.content_digest(), so an entry
           is never served across a DB hot swap: old-version entries
           simply stop being addressed.
  value    per scan UNIT (the OS query batch, or one application's
           query batch) the hits it detected, each as (query index,
           advisory-group report fields). Replay rebuilds engine Hit
           tuples against the CURRENT scan's query objects, so layer
           attribution, FillInfo and sorting run exactly as after a live
           join.
  guard    every unit entry carries a digest of its query batch
           (source, ecosystem, name, version, arch, cpe scope, in
           order); replay needs an exact match, so a wrong attribution
           can only cost a miss, never a wrong result.

A unit is memoizable under blob B iff everything that feeds its queries
comes from B alone: for an application, every package's origin layer;
for the OS unit, every package, the OS detection and the repository
hint. Partial (ingest-annotated) blobs are never memoized.

Backends: fs (one JSON file per entry, with the fanal cache's atomic
writes and corrupt-entry quarantine), memory, redis:// (entries under
`memo::`, a corrupt one quarantined to `memo::corrupt::`) and s3://
(objects under `memo/`), the JAX package's keys and documents on each,
and an already-open store object passed through (several servers in one
process share one MemoryMemo). A backend fault (a full disk, an
unreadable entry, a dead Redis) degrades to a miss: the scan detects
live, on the card; it never fails and never serves another version's
entry.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional

from ..log import get as _get_logger
from ..metrics import METRICS

_log = _get_logger("fleet.memo")

MEMO_SCHEMA = 1


def known_backend(backend: str) -> bool:
    """Is `backend` a spelling open_memo accepts? ("" / "off" =
    disabled.)"""
    return backend in ("", "off", "fs", "memory") \
        or backend.startswith(("redis://", "s3://"))


def open_memo(backend, cache_dir: str = ""):
    """The memo store for `backend`: "" or "off" → None (no memo); an
    already-open store object passes through unchanged."""
    if not isinstance(backend, str):
        return backend
    if backend in ("", "off"):
        return None
    if backend.startswith("redis://"):
        return RedisMemo(backend)
    if backend.startswith("s3://"):
        return S3Memo(backend)
    if backend == "memory":
        return MemoryMemo()
    if backend == "fs":
        return FSMemo(cache_dir)
    raise ValueError(f"unknown memo backend {backend!r} "
                     "(off | fs | memory | redis://... | s3://...)")


def entry_key(blob_id: str, db_version: str) -> str:
    """One flat, file-name-safe key per (blob, db_version)."""
    h = hashlib.sha256(f"{blob_id}|{db_version}".encode()).hexdigest()
    return f"memo-{h}"


def query_digest(queries) -> str:
    """Digest of one unit's query batch: everything the join and the
    assembly read from a query, in batch order."""
    doc = [[q.source, q.ecosystem, q.name, q.version, q.arch,
            sorted(q.cpe_indices)] for q in queries]
    return hashlib.sha256(json.dumps(
        doc, separators=(",", ":")).encode()).hexdigest()


def encode_hits(queries, hits) -> Optional[list]:
    """One unit's Hits as [query index, group report fields] → None when
    a hit's query is not in the batch."""
    index = {id(q): i for i, q in enumerate(queries)}
    out = []
    for h in hits:
        qi = index.get(id(h.query))
        if qi is None:
            return None
        out.append([qi, h.vuln_id, h.fixed_version, h.status,
                    h.severity, h.data_source, list(h.vendor_ids)])
    return out


def decode_hits(queries, doc: list):
    """Hit tuples rebuilt against THIS scan's query objects → None when
    the stored document does not line up (the caller's miss)."""
    from ..detect.engine import Hit
    hits = []
    try:
        for qi, vuln_id, fixed, status, severity, ds, vids in doc:
            if not isinstance(qi, int) or qi < 0:
                # a negative index would wrap to the END of the batch
                # and pin the hit on the wrong package: a miss instead
                return None
            hits.append(Hit(
                query=queries[qi], vuln_id=vuln_id,
                fixed_version=fixed, status=status, severity=severity,
                data_source=ds, vendor_ids=tuple(vids)))
    except (IndexError, TypeError, ValueError):
        return None
    return hits


# ---------------------------------------------------------------------------
# unit attribution


def unit_key(unit) -> str:
    """Stable name of one scan unit inside a blob's entry."""
    if unit == "os":
        return "os"
    return f"app:{unit.type}:{unit.file_path}"


def blob_index(blobs, blob_ids) -> dict:
    """diff_id → blob cache id, for the blobs a unit may be memoized
    under: complete, with a diff id, and unambiguous."""
    out: dict = {}
    for blob, bid in zip(blobs, blob_ids):
        if not blob.diff_id or blob.ingest_errors:
            continue
        if blob.diff_id in out:
            out[blob.diff_id] = None   # ambiguous: two blobs, one diff
        else:
            out[blob.diff_id] = bid
    return {k: v for k, v in out.items() if v is not None}


def unit_blob(unit, detail, blobs, index: dict) -> Optional[str]:
    """→ the blob cache id this unit is wholly attributable to, or None
    (the unit detects live, unmemoized)."""
    if unit == "os":
        pkg_diffs = {p.layer.diff_id for p in detail.packages}
        os_diffs = {b.diff_id for b in blobs if b.os.detected}
        repo_diffs = {b.diff_id for b in blobs
                      if b.repository is not None}
        cands = pkg_diffs or os_diffs
        if len(cands) != 1:
            return None
        (diff,) = cands
        if os_diffs != {diff} or not repo_diffs <= {diff}:
            return None
        return index.get(diff)
    diffs = {p.layer.diff_id for p in unit.packages}
    if len(diffs) != 1:
        return None
    (diff,) = diffs
    return index.get(diff)


# ---------------------------------------------------------------------------
# the store


class MemoStore:
    """One KV backend's surface: entry read and merge-write that degrade
    to a miss on a fault, per-key stats, and the known-blob registry
    redetectd sweeps. Subclasses implement `_read`/`_write`. Thread-safe:
    the server's handler threads and the sweep share one store."""

    backend = "memory"

    def __init__(self):
        self._lock = threading.Lock()
        # the blob ids this process stored or served: the sweep's
        # working set (an fs store also re-seeds it from its entries)
        self._known: dict[str, None] = {}
        # per-(blob, db_version) hit and store counts
        self._key_stats: dict[tuple, dict] = {}

    # -- backend contract ------------------------------------------------

    def _read(self, key: str):
        raise NotImplementedError

    def _write(self, key: str, doc: dict) -> None:
        raise NotImplementedError

    # -- degrading IO ----------------------------------------------------

    def get_entry(self, blob_id: str, db_version: str
                  ) -> Optional[dict]:
        """→ the (blob, db_version) entry, or None. A backend fault is a
        miss: the scan detects live."""
        try:
            doc = self._read(entry_key(blob_id, db_version))
        except Exception as e:  # noqa: BLE001 — a miss, never a failure
            _log.warning("memo get degraded to a miss (%s: %s)",
                         type(e).__name__, e)
            return None
        if doc is None:
            return None
        if doc.get("schema") != MEMO_SCHEMA \
                or doc.get("db_version") != db_version:
            return None   # a foreign schema, or a key collision
        with self._lock:
            self._known.setdefault(blob_id, None)
        return doc

    def put_units(self, blob_id: str, db_version: str,
                  units: dict[str, dict]) -> int:
        """Merge `units` into the (blob, db_version) entry (read, merge,
        write; concurrent writers last-win, which is safe because a
        unit's value is a function of its key) → the units written (0
        on a fault)."""
        if not units:
            return 0
        try:
            key = entry_key(blob_id, db_version)
            doc = self._read(key)
            if not isinstance(doc, dict) \
                    or doc.get("schema") != MEMO_SCHEMA \
                    or doc.get("db_version") != db_version:
                doc = {"schema": MEMO_SCHEMA, "blob_id": blob_id,
                       "db_version": db_version, "units": {}}
            fresh = {k: v for k, v in units.items()
                     if doc["units"].get(k) != v}
            if not fresh:
                return 0
            doc["units"].update(fresh)
            self._write(key, doc)
        except Exception as e:  # noqa: BLE001 — dropped, never a failure
            _log.warning("memo put dropped (%s: %s)",
                         type(e).__name__, e)
            return 0
        n = len(fresh)
        with self._lock:
            self._known.setdefault(blob_id, None)
            st = self._key_stats.setdefault(
                (blob_id, db_version), {"hits": 0, "stores": 0})
            st["stores"] += n
        METRICS.inc("trivy_tpu_memo_stores_total", n,
                    backend=self.backend)
        return n

    # -- accounting (MemoSession calls these per unit) -------------------

    def note_hit(self, blob_id: str, db_version: str) -> None:
        with self._lock:
            st = self._key_stats.setdefault(
                (blob_id, db_version), {"hits": 0, "stores": 0})
            st["hits"] += 1
        METRICS.inc("trivy_tpu_memo_hits_total", backend=self.backend)

    def note_miss(self) -> None:
        METRICS.inc("trivy_tpu_memo_misses_total",
                    backend=self.backend)

    def key_stats(self, blob_id: str, db_version: str) -> dict:
        with self._lock:
            return dict(self._key_stats.get(
                (blob_id, db_version)) or {"hits": 0, "stores": 0})

    # -- redetectd surface ----------------------------------------------

    def known_blobs(self) -> list[str]:
        with self._lock:
            return list(self._known)

    def status(self) -> dict:
        with self._lock:
            return {"backend": self.backend,
                    "known_blobs": len(self._known)}


class MemoryMemo(MemoStore):
    """In-process backend: tests, ephemeral servers, and several servers
    of one process sharing one object."""

    backend = "memory"

    def __init__(self):
        super().__init__()
        self._docs: dict[str, str] = {}

    def _read(self, key: str):
        with self._lock:
            raw = self._docs.get(key)
        return None if raw is None else json.loads(raw)

    def _write(self, key: str, doc: dict) -> None:
        raw = json.dumps(doc)
        with self._lock:
            self._docs[key] = raw


class FSMemo(MemoStore):
    """One JSON file per entry under <root>/memo/, through the fanal
    cache's own `_read_json` (a corrupt entry moves to *.corrupt and
    reads as a miss) and `_write_atomic` (a kill mid-put leaves a stray
    temp file, never a truncated entry). The same layout and documents
    as the JAX package's FSMemo, so either package replays the other's
    entries."""

    backend = "fs"

    def __init__(self, root: str):
        super().__init__()
        self.root = os.path.join(root or ".", "memo")
        os.makedirs(self.root, exist_ok=True)
        # the known-blob registry re-seeds LAZILY from the surviving
        # entries, on the first known_blobs() (the first sweep), so a
        # restarted server's sweep covers yesterday's working set
        # without a start-up scan of the whole memo
        self._seeded = False

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def _read(self, key: str):
        from ..fanal.cache import FSCache
        return FSCache._read_json(self._path(key))

    def _write(self, key: str, doc: dict) -> None:
        from ..fanal.cache import FSCache
        FSCache._write_atomic(self._path(key), doc)

    def known_blobs(self) -> list[str]:
        with self._lock:
            seeded, self._seeded = self._seeded, True
        if not seeded:
            from ..fanal.cache import FSCache
            for name in sorted(os.listdir(self.root)):
                if not name.endswith(".json"):
                    continue
                doc = FSCache._read_json(os.path.join(self.root, name))
                if isinstance(doc, dict) and doc.get("blob_id"):
                    with self._lock:
                        self._known.setdefault(doc["blob_id"], None)
        return super().known_blobs()


class RedisMemo(MemoStore):
    """The shared fleet backend over the fanal RespClient. Entries live
    under their own `memo::` prefix, which the fanal cache's clear never
    touches; a corrupt entry is quarantined with the fanal cache's
    read-compare-rename, so a racing re-put keeps its fresh value."""

    backend = "redis"

    def __init__(self, url: str):
        super().__init__()
        from ..fanal.redis_cache import client_for
        self.client = client_for(url)

    def close(self) -> None:
        self.client.close()

    @staticmethod
    def _rkey(key: str) -> str:
        return f"memo::{key}"

    def _read(self, key: str):
        raw = self.client.command("GET", self._rkey(key))
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            from ..fanal.redis_cache import RedisError
            try:
                self.client.rename_if_value(self._rkey(key), raw,
                                            f"memo::corrupt::{key}")
            except RedisError:
                pass
            _log.warning("quarantined corrupt memo entry %s (serving a "
                         "miss)", key)
            return None

    def _write(self, key: str, doc: dict) -> None:
        self.client.command("SET", self._rkey(key), json.dumps(doc))


class S3Memo(MemoStore):
    """The shared fleet backend over the fanal S3 client: entries under
    a `memo/` key prefix beside the fanal cache's."""

    backend = "s3"

    def __init__(self, url: str):
        super().__init__()
        from ..fanal.s3_cache import S3Cache
        self._s3 = S3Cache(url)

    def _read(self, key: str):
        return self._s3._get("memo", key)

    def _write(self, key: str, doc: dict) -> None:
        self._s3._put("memo", key, doc)


# ---------------------------------------------------------------------------
# per-scan session (the scanner drives this)


class MemoSession:
    """One scan_many call's view of the memo: entry reads cached per
    blob, replays resolved per unit, and the stores batched into one
    merge-write per blob at flush()."""

    def __init__(self, memo: MemoStore, db_version: str):
        self.memo = memo
        self.db_version = db_version
        self._entries: dict[str, Optional[dict]] = {}
        self._stores: dict[str, dict[str, dict]] = {}

    def _entry(self, blob_id: str) -> Optional[dict]:
        if blob_id not in self._entries:
            self._entries[blob_id] = self.memo.get_entry(
                blob_id, self.db_version)
        return self._entries[blob_id]

    def consult(self, unit, queries, detail, blobs, blob_ids):
        """→ (hits | None, store token | None). Hits mean the unit
        replays (no launch); a token means the unit is attributable and
        its live hits go to record()."""
        if not queries:
            return None, None
        bid = unit_blob(unit, detail, blobs,
                        blob_index(blobs, blob_ids))
        if bid is None:
            return None, None
        ukey = unit_key(unit)
        qd = query_digest(queries)
        entry = self._entry(bid)
        stored = (entry or {}).get("units", {}).get(ukey)
        if stored is not None and stored.get("q") == qd:
            hits = decode_hits(queries, stored.get("hits") or [])
            if hits is not None:
                self.memo.note_hit(bid, self.db_version)
                return hits, None
        self.memo.note_miss()
        return None, (bid, ukey, qd, queries)

    def record(self, token, hits) -> None:
        """Queue one live unit's hits for the flush."""
        bid, ukey, qd, queries = token
        doc = encode_hits(queries, hits)
        if doc is None:
            return
        self._stores.setdefault(bid, {})[ukey] = {"q": qd,
                                                  "hits": doc}

    def flush(self) -> int:
        n = 0
        for bid, units in self._stores.items():
            n += self.memo.put_units(bid, self.db_version, units)
        self._stores.clear()
        return n
