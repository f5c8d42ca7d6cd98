"""Java DB — jar sha1 → Maven GAV lookup (reference pkg/javadb), the
port's copy of the JAX package's javadb.py.

The reference downloads `trivy-java-db` (an sqlite database) as an OCI
artifact and queries it from the jar analyzer: SearchBySHA1 resolves a
whole-file digest to group:artifact:version; SearchByArtifactID picks
the most common group_id for an artifact name (client.go:151-180).

Schema (trivy-java-db): table `indices`
(group_id, artifact_id, version, sha1 BLOB, archive_type).

The port never downloads it and has no update gate: `init()` opens a
local file (`--java-db`, or `<cache-dir>/javadb/trivy-java.db` when
present), and `build_db` writes one from entries. Without a file the
jar analyzer identifies jars by pom.properties and file name only.
"""

from __future__ import annotations

import os
import sqlite3

SCHEMA = """
CREATE TABLE IF NOT EXISTS indices (
    group_id TEXT,
    artifact_id TEXT,
    version TEXT,
    sha1 BLOB,
    archive_type TEXT
);
CREATE INDEX IF NOT EXISTS indices_sha1 ON indices (sha1);
CREATE INDEX IF NOT EXISTS indices_artifact
    ON indices (artifact_id, version);
"""


class JavaDB:
    def __init__(self, path: str):
        self.path = path
        self.conn = sqlite3.connect(path, check_same_thread=False)

    def close(self):
        self.conn.close()

    def search_by_sha1(self, sha1_hex: str):
        """→ (group_id, artifact_id, version) or None."""
        cur = self.conn.execute(
            "SELECT group_id, artifact_id, version FROM indices "
            "WHERE sha1 = ? LIMIT 1", (bytes.fromhex(sha1_hex),))
        row = cur.fetchone()
        return tuple(row) if row else None

    def search_by_artifact_id(self, artifact_id: str,
                              version: str) -> str:
        """Most frequent group_id among rows with this artifact id
        (client.go SearchByArtifactID majority vote)."""
        cur = self.conn.execute(
            "SELECT group_id, COUNT(*) AS n FROM indices "
            "WHERE artifact_id = ? AND version = ? "
            "AND archive_type = 'jar' "
            "GROUP BY group_id ORDER BY n DESC, group_id ASC LIMIT 1",
            (artifact_id, version))
        row = cur.fetchone()
        return row[0] if row else ""


def build_db(path: str, entries) -> JavaDB:
    """entries: iterable of (group_id, artifact_id, version, sha1_hex,
    archive_type) — fixture builder (reference pkg/dbtest InitJavaDB)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    conn = sqlite3.connect(path)
    try:
        conn.executescript(SCHEMA)
        conn.executemany(
            "INSERT INTO indices VALUES (?, ?, ?, ?, ?)",
            [(g, a, v, bytes.fromhex(s), t) for g, a, v, s, t in entries])
        conn.commit()
    finally:
        conn.close()
    return JavaDB(path)


_db: JavaDB | None = None


def db_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, "javadb", "trivy-java.db")


def init(cache_dir: str = "", path: str = "") -> JavaDB | None:
    """Open the Java DB at `path`, else at `db_path(cache_dir)`, as the
    one the jar analyzer consults; None, and no DB, when neither file
    exists."""
    global _db
    p = path or (db_path(cache_dir) if cache_dir else "")
    _db = JavaDB(p) if p and os.path.exists(p) else None
    return _db


def set_db(db: JavaDB | None) -> None:
    global _db
    _db = db


def get_db() -> JavaDB | None:
    return _db
