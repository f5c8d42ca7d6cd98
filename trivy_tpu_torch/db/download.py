"""The cached trivy-db: where it lives, whether it will do, and its
flatten memo.

The port's copy of the functions of the JAX package's db/download.py
that need no network. The reference (pkg/db/db.go) keeps `trivy.db` and
`metadata.json` under `<cache-dir>/db`; `needs_update` is its staleness
gate (`NeedsUpdate`, :96). The OCI download itself (`download_db`,
`ensure_db`) is not ported (ROADMAP A5): when the cache holds no DB that
will do, the caller reports the DB unavailable.

`flatten_db` is the step the reference does not need, since it reads
BoltDB by random access: trivy.db → the columnar AdvisoryTable, saved
beside the bolt file as `<db>.npz` and stamped in `<db>.npz.src` with
the bolt file's sha256, so each DB flattens once. The memo is the port's
`AdvisoryTable.save` format; a memo that does not load is moved aside
and the DB flattened again.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import json
import os
import sys
import time
from typing import Optional

DEFAULT_REPO = "ghcr.io/aquasecurity/trivy-db:2"
SCHEMA_VERSION = 2


class DBError(RuntimeError):
    pass


def db_dir(cache_dir: str) -> str:
    return os.path.join(cache_dir, "db")


def db_path(cache_dir: str) -> str:
    return os.path.join(db_dir(cache_dir), "trivy.db")


def metadata_path(cache_dir: str) -> str:
    return os.path.join(db_dir(cache_dir), "metadata.json")


def read_metadata(cache_dir: str) -> Optional[dict]:
    try:
        with open(metadata_path(cache_dir)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def needs_update(cache_dir: str, skip: bool = False,
                 now: Optional[dt.datetime] = None) -> bool:
    """Reference db.Client.NeedsUpdate (:96-150): with `skip`, the
    cached DB must exist and have the current schema (else DBError);
    without it, a missing DB, another schema, or metadata past its
    NextUpdate (and older than an hour) needs an update."""
    meta = read_metadata(cache_dir)
    if skip:
        if meta is None or not os.path.exists(db_path(cache_dir)):
            raise DBError("--skip-db-update requested but no DB in cache")
        if meta.get("Version") != SCHEMA_VERSION:
            raise DBError(f"cached DB schema {meta.get('Version')} != "
                          f"{SCHEMA_VERSION}; update required")
        return False
    if meta is None or not os.path.exists(db_path(cache_dir)):
        return True
    if meta.get("Version") != SCHEMA_VERSION:
        return True
    now = now or dt.datetime.now(dt.timezone.utc)
    nxt = meta.get("NextUpdate")
    if nxt:
        try:
            if now < dt.datetime.fromisoformat(nxt.replace("Z", "+00:00")):
                return False
        except ValueError:
            pass
    # 1h debounce on the metadata file (reference db.go:139-147)
    try:
        if time.time() - os.path.getmtime(metadata_path(cache_dir)) < 3600:
            return False
    except OSError:
        pass
    return True


def cached_db(cache_dir: str, repository: str = DEFAULT_REPO,
              skip_update: bool = False) -> str:
    """→ the path of the cached trivy.db when `needs_update` says it
    will do; DBError otherwise, since the download is not ported."""
    if needs_update(cache_dir, skip=skip_update):
        raise DBError(f"no current DB in {db_dir(cache_dir)}, and the "
                      f"download from {repository} is not ported "
                      f"(ROADMAP A5)")
    return db_path(cache_dir)


def flatten_db(bolt_path: str):
    """trivy.db → (AdvisoryTable, stats), through the `<db>.npz` memo
    keyed by the bolt file's sha256."""
    from .boltdb import load_boltdb
    from .table import AdvisoryTable, build_table

    npz_path = bolt_path + ".npz"
    t0 = time.perf_counter()
    h = hashlib.sha256()
    with open(bolt_path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    digest = h.hexdigest()
    hash_s = time.perf_counter() - t0
    stamp_path = npz_path + ".src"
    if os.path.exists(npz_path) and os.path.exists(stamp_path):
        with open(stamp_path) as f:
            stamp_ok = f.read().strip() == digest
        if stamp_ok:
            t0 = time.perf_counter()
            try:
                table = AdvisoryTable.load(npz_path)
            except Exception as e:
                quarantine = npz_path + ".corrupt"
                try:
                    os.replace(npz_path, quarantine)
                except OSError:
                    pass
                print(f"corrupt flatten memo {npz_path} ({e}); moved to "
                      f"{quarantine}, flattening {bolt_path} again",
                      file=sys.stderr)
            else:
                return table, {"flatten_s": 0.0, "hash_s": hash_s,
                               "load_s": time.perf_counter() - t0,
                               "rows": len(table), "cached": True}
    t0 = time.perf_counter()
    advisories, details, sources = load_boltdb(bolt_path)
    t1 = time.perf_counter()
    table = build_table(advisories, details,
                        aux={"Red Hat CPE": sources["Red Hat CPE"]}
                        if "Red Hat CPE" in sources else None)
    t2 = time.perf_counter()
    # the stamp lands only after the memo's atomic save, so a crash in
    # between never pairs a partial memo with a matching stamp
    table.save(npz_path)
    tmp_stamp = stamp_path + ".tmp"
    with open(tmp_stamp, "w") as f:
        f.write(digest)
    os.replace(tmp_stamp, stamp_path)
    return table, {"walk_s": t1 - t0, "build_s": t2 - t1,
                   "flatten_s": t2 - t0, "save_s": time.perf_counter() - t2,
                   "hash_s": hash_s, "rows": len(table),
                   "advisories": len(advisories), "cached": False}
