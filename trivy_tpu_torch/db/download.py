"""The trivy-db lifecycle: the OCI download, the staleness gate and the
flatten memo. The port's copy of the JAX package's db/download.py.

The reference (pkg/db/db.go) keeps `trivy.db` and `metadata.json` under
`<cache-dir>/db`; `needs_update` is its staleness gate (`NeedsUpdate`,
:96), and `download_db` its `Download` (:153): the OCI artifact of
`--db-repository` (media type
application/vnd.aquasec.trivy.db.layer.v1.tar+gzip), its blob checked
against the manifest's digest, untarred into `<cache-dir>/db`.
`ensure_db` downloads when the gate says so, then flattens.

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


# the retry of the whole pull: a reset mid-blob surfaces as one
# OCIError, beneath which oci.py retries each HTTP call
DOWNLOAD_RETRY = None


def _download_retry():
    global DOWNLOAD_RETRY
    if DOWNLOAD_RETRY is None:
        from ..oci import RetryPolicy
        DOWNLOAD_RETRY = RetryPolicy(attempts=3, base_delay_s=1.0,
                                     max_delay_s=10.0, budget_s=60.0)
    return DOWNLOAD_RETRY


def _quarantine_blob(cache_dir: str, blob: bytes, want: str,
                     got: str) -> None:
    """Keep a body whose digest does not match for inspection, never
    install it."""
    qdir = os.path.join(db_dir(cache_dir), "quarantine")
    path = os.path.join(qdir, f"trivy-db-{got.split(':')[-1][:16]}.blob")
    try:
        os.makedirs(qdir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except OSError:
        path = "(quarantine write failed)"
    print(f"trivy-db blob digest mismatch: manifest says {want}, body is "
          f"{got}; quarantined to {path} and retrying", file=sys.stderr)


def download_db(cache_dir: str, repository: str = DEFAULT_REPO,
                client=None) -> str:
    """Pull the trivy-db OCI artifact into <cache-dir>/db → the trivy.db
    path. The blob's sha256 is checked against the manifest's digest
    before the atomic install; a mismatch is quarantined and the pull
    retried. A client with only `download_artifact_layer` installs
    without the check, as in the JAX package."""
    from ..oci import (MT_TRIVY_DB, OCIError, default_client, parse_ref,
                       retry_on, untar_gz_members)
    client = client or default_client()
    ref = parse_ref(repository)
    verifiable = hasattr(client, "manifest") and hasattr(client, "blob")

    def pull():
        if not verifiable:
            return client.download_artifact_layer(ref, MT_TRIVY_DB)
        man = client.manifest(ref)
        layer = next((ly for ly in man.get("layers", [])
                      if ly.get("mediaType") == MT_TRIVY_DB), None)
        if layer is None:
            raise OCIError(f"{ref}: no layer with media type "
                           f"{MT_TRIVY_DB}")
        digest = str(layer.get("digest") or "")
        # fetched without the client's own check, so a mismatch is
        # quarantined and retried here
        body = client.blob(ref, digest, verify=False)
        if digest.startswith("sha256:"):
            actual = "sha256:" + hashlib.sha256(body).hexdigest()
            if actual != digest:
                _quarantine_blob(cache_dir, body, digest, actual)
                raise OCIError(f"{ref}: blob digest mismatch "
                               f"(manifest {digest}, body {actual})")
        return body

    try:
        blob = _download_retry().call(pull,
                                      should_retry=retry_on(OCIError))
        members = untar_gz_members(blob)
    except OCIError as e:
        raise DBError(f"trivy-db download from {ref} failed: {e}") \
            from None
    if "trivy.db" not in members:
        raise DBError(f"{ref}: layer does not contain trivy.db "
                      f"(members: {sorted(members)})")
    os.makedirs(db_dir(cache_dir), exist_ok=True)
    # the db first and the metadata last, each written then renamed:
    # metadata only ever vouches for a complete db
    tmp_db = db_path(cache_dir) + ".tmp"
    with open(tmp_db, "wb") as f:
        f.write(members["trivy.db"])
    os.replace(tmp_db, db_path(cache_dir))
    tmp_meta = metadata_path(cache_dir) + ".tmp"
    with open(tmp_meta, "wb") as f:
        f.write(members.get("metadata.json", b"{}"))
    os.replace(tmp_meta, metadata_path(cache_dir))
    return db_path(cache_dir)


def ensure_db(cache_dir: str, repository: str = DEFAULT_REPO,
              skip_update: bool = False, client=None):
    """Download when the cached DB will not do, then flatten →
    (AdvisoryTable, stats); stats["downloaded"] says whether it
    pulled."""
    pulled = needs_update(cache_dir, skip=skip_update)
    if pulled:
        download_db(cache_dir, repository, client)
    table, stats = flatten_db(db_path(cache_dir))
    return table, {**stats, "downloaded": pulled}


# the process-lifetime delta-flatten memo (table.FlattenMemo): a second
# flatten in one process (a new DB swapped into a long-lived server)
# re-encodes only the advisories that changed
_FLATTEN_MEMO = None


def _flatten_memo():
    global _FLATTEN_MEMO
    if _FLATTEN_MEMO is None:
        from .table import FlattenMemo
        _FLATTEN_MEMO = FlattenMemo()
    return _FLATTEN_MEMO


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
                        if "Red Hat CPE" in sources else None,
                        memo=_flatten_memo())
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
