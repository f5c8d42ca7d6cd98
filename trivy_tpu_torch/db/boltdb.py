"""Read-only BoltDB (bbolt) file parser — the real trivy-db container.

The reference opens trivy.db with the bbolt library and does random
bucket access per package (pkg/db/db.go:96-190; trivy-db nested buckets
source → package → CVE). We never write or do random access: the file is
mmap'd and walked once at flatten time (SURVEY.md §7 step 2 / §3.5 "TPU
equivalent init"), so only the read path of the format is implemented:

  page     = header{id u64, flags u16, count u16, overflow u32} + body
  meta     (flags 0x04, pages 0-1): magic 0xED0CDAED, version 2,
           page_size, flags, root bucket{pgid, seq}, freelist, pgid,
           txid, fnv1a64 checksum — the live meta is the valid one with
           the larger txid
  branch   (flags 0x01): elements{pos u32, ksize u32, pgid u64};
           element pos is relative to the element struct itself
  leaf     (flags 0x02): elements{flags u32, pos u32, ksize u32,
           vsize u32}; element flag bit0 marks a sub-bucket value
  bucket value = {root pgid u64, sequence u64}; root == 0 means the
           bucket is inline: a private page image follows the header
  overflow pages extend a page's body contiguously

No locks, no freelist, no write path — those exist for writers.

The port's copy of the JAX package's db/boltdb.py.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Iterator, Optional

MAGIC = 0xED0CDAED
VERSION = 2

PAGE_HDR = struct.Struct("<QHHI")        # id, flags, count, overflow
META = struct.Struct("<IIIIQQQQQQ")      # magic, version, page_size,
#                                          flags, root pgid, root seq,
#                                          freelist, pgid, txid, checksum
BRANCH_ELEM = struct.Struct("<IIQ")      # pos, ksize, pgid
LEAF_ELEM = struct.Struct("<IIII")       # flags, pos, ksize, vsize
BUCKET_HDR = struct.Struct("<QQ")        # root pgid, sequence

FLAG_BRANCH = 0x01
FLAG_LEAF = 0x02
FLAG_META = 0x04
FLAG_FREELIST = 0x10
LEAF_BUCKET = 0x01

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_M64 = (1 << 64) - 1


def _fnv64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _M64
    return h


class BoltError(RuntimeError):
    pass


class BoltDB:
    """Read-only view over a bbolt file; use as a context manager."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:
            self._f.close()
            raise BoltError(f"cannot map {path}: {e}") from None
        self.page_size, self.root_pgid = self._read_meta()

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- low level ----------------------------------------------------

    def _read_meta(self) -> tuple[int, int]:
        best: Optional[tuple[int, int, int]] = None  # txid, psize, root
        # the page size isn't known before a meta is read: probe page 0
        # at offset 16 for the size field, fall back to common sizes
        sizes = []
        if len(self._mm) >= 16 + META.size:
            probe = META.unpack_from(self._mm, 16)
            if probe[0] == MAGIC:
                sizes.append(probe[2])
        sizes += [4096, 8192, 16384, 32768, 65536]
        seen = set()
        for psize in sizes:
            if psize in seen or psize < 512 or len(self._mm) < psize * 2:
                continue
            seen.add(psize)
            for pgid in (0, 1):
                off = pgid * psize
                if off + 16 + META.size > len(self._mm):
                    continue
                _, flags, _, _ = PAGE_HDR.unpack_from(self._mm, off)
                if not flags & FLAG_META:
                    continue
                m = META.unpack_from(self._mm, off + 16)
                (magic, version, page_size, _mflags, root, _seq,
                 _freelist, _maxpg, txid, checksum) = m
                if magic != MAGIC or version != VERSION:
                    continue
                if page_size != psize:
                    continue
                raw = self._mm[off + 16:off + 16 + 56]
                if _fnv64(raw) != checksum:
                    continue
                if best is None or txid > best[0]:
                    best = (txid, page_size, root)
        if best is None:
            raise BoltError(f"{self.path}: no valid bolt meta page")
        return best[1], best[2]

    def _page(self, pgid: int):
        """→ (flags, count, body memoryview incl. overflow)."""
        off = pgid * self.page_size
        pid, flags, count, overflow = PAGE_HDR.unpack_from(self._mm, off)
        end = off + (1 + overflow) * self.page_size
        return flags, count, memoryview(self._mm)[off:end]

    def _iter_page(self, pgid: int) -> Iterator[tuple[bytes, bytes, bool]]:
        """Depth-first over a B+tree rooted at pgid →
        (key, value, is_bucket)."""
        flags, count, body = self._page(pgid)
        if flags & FLAG_BRANCH:
            for i in range(count):
                _pos, _ks, child = BRANCH_ELEM.unpack_from(
                    body, 16 + i * BRANCH_ELEM.size)
                yield from self._iter_page(child)
        elif flags & FLAG_LEAF:
            yield from self._iter_leaf_body(body, count)
        else:
            raise BoltError(f"page {pgid}: unexpected flags {flags:#x}")

    @staticmethod
    def _iter_leaf_body(body, count) -> Iterator[tuple[bytes, bytes, bool]]:
        for i in range(count):
            elem_off = 16 + i * LEAF_ELEM.size
            eflags, pos, ksize, vsize = LEAF_ELEM.unpack_from(body, elem_off)
            k_off = elem_off + pos
            key = bytes(body[k_off:k_off + ksize])
            val = bytes(body[k_off + ksize:k_off + ksize + vsize])
            yield key, val, bool(eflags & LEAF_BUCKET)

    def _iter_bucket_value(self, val: bytes):
        """A bucket-flagged leaf value → iterator over its entries."""
        root, _seq = BUCKET_HDR.unpack_from(val, 0)
        if root != 0:
            yield from self._iter_page(root)
            return
        # inline bucket: a page image follows the 16-byte header
        body = memoryview(val)[BUCKET_HDR.size:]
        _pid, flags, count, _ov = PAGE_HDR.unpack_from(body, 0)
        if not flags & FLAG_LEAF:
            raise BoltError("inline bucket with non-leaf page")
        yield from self._iter_leaf_body(body, count)

    # ---- walking ------------------------------------------------------

    def buckets(self) -> Iterator[tuple[bytes, bytes]]:
        """Top-level (bucket name, bucket value) pairs."""
        for key, val, is_bucket in self._iter_page(self.root_pgid):
            if is_bucket:
                yield key, val

    def walk_bucket(self, val: bytes) -> Iterator[tuple[bytes, bytes, bool]]:
        """Entries of a bucket value: (key, value, is_subbucket)."""
        yield from self._iter_bucket_value(val)


def to_docs(path: str, decode_json: bool = True) -> list[dict]:
    """Walk a whole bolt file into the bolt-fixtures document shape that
    db.fixtures.load_fixture_docs consumes:
        [{"bucket": name, "pairs": [{"bucket"|"key": ..., ...}]}]
    """
    def _decode(val: bytes):
        if not decode_json:
            return val
        try:
            return json.loads(val.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            return val.decode("utf-8", errors="replace")

    def _convert(db: BoltDB, bucket_val: bytes) -> list[dict]:
        pairs = []
        for key, val, is_bucket in db.walk_bucket(bucket_val):
            name = key.decode("utf-8", errors="replace")
            if is_bucket:
                pairs.append({"bucket": name,
                              "pairs": _convert(db, val)})
            else:
                pairs.append({"key": name, "value": _decode(val)})
        return pairs

    with BoltDB(path) as db:
        return [{"bucket": name.decode("utf-8", errors="replace"),
                 "pairs": _convert(db, val)}
                for name, val in db.buckets()]


def load_boltdb(path: str):
    """trivy.db → (advisories, details, data_sources) — the same triple
    load_fixture_files returns for YAML fixtures."""
    from .fixtures import load_fixture_docs
    return load_fixture_docs(to_docs(path))
