"""Redis cache backend (reference pkg/fanal/cache/redis.go), the port's
copy of the JAX package's fanal/redis_cache.py.

A dependency-free RESP2 client over a TCP socket with the reference's
key scheme (`fanal::artifact::<id>`, `fanal::blob::<id>`, JSON values,
an optional TTL). Every replica of a fleet points at the same URL, so a
layer analyzed by one replica is a cache hit on all of them, and the
JAX package's replicas read the same entries.

  * puts are atomic: a RESP SET lands whole or not at all;
  * a corrupt entry (bad JSON from a buggy writer or a truncating
    proxy) is quarantined on read: the key is RENAMEd under
    `fanal::corrupt::` (kept for forensics) and the read is a miss, so
    the layer is analyzed again;
  * the client runs one command round trip at a time under a lock, so
    the server's handler threads can share one connection.

A dead or unreachable Redis raises (RedisError, OSError), as in the
JAX package; the scan does not go on without its cache.

URL format: redis://[:password@]host:port[/db].
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Optional
from urllib.parse import urlparse

from .. import types as T
from ..log import get as _get_logger
from ..metrics import METRICS
from .cache import blob_from_json

_log = _get_logger("fanal.cache.redis")

PREFIX = "fanal"


class RedisError(Exception):
    pass


class RespClient:
    """Minimal RESP2 client (SET/GET/EXISTS/DEL/RENAME/SCAN/AUTH/SELECT):
    one command in flight at a time, under a lock."""

    def __init__(self, host: str, port: int, password: str = "",
                 db: int = 0, timeout: float = 10.0):
        self._lock = threading.Lock()
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""
        if password:
            self.command("AUTH", password)
        if db:
            self.command("SELECT", str(db))

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def _command_locked(self, *args):
        """One round trip; the caller holds self._lock."""
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        self.sock.sendall(b"".join(out))
        return self._read_reply()

    def command(self, *args):
        with self._lock:
            return self._command_locked(*args)

    def rename_if_value(self, key: str, expected: bytes, dest: str) -> bool:
        """RENAME key → dest only while its value still equals
        `expected`: the GET, the compare and the RENAME in one critical
        section under the client lock, so a re-put from another thread
        on this connection is never renamed away. A writer on another
        connection can still land between the GET and the RENAME; the
        next read then misses and the layer is put again."""
        with self._lock:
            if self._command_locked("GET", key) != expected:
                return False
            self._command_locked("RENAME", key, dest)
            return True

    def _read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply()
                                         for _ in range(n)]
        raise RedisError(f"bad reply {line!r}")


def client_for(url: str) -> RespClient:
    """A RespClient for redis://[:password@]host:port[/db]."""
    u = urlparse(url)
    db = int(u.path.strip("/")) if u.path.strip("/").isdigit() else 0
    return RespClient(u.hostname or "localhost", u.port or 6379,
                      password=u.password or "", db=db)


class RedisCache:
    """The artifact and blob cache over Redis (redis.go:19-120)."""

    def __init__(self, url: str, ttl_seconds: int = 0):
        scheme = urlparse(url).scheme
        if scheme != "redis":
            raise RedisError(f"unsupported scheme {scheme!r}")
        self.client = client_for(url)
        self.ttl = ttl_seconds

    def close(self):
        self.client.close()

    @staticmethod
    def _akey(artifact_id: str) -> str:
        return f"{PREFIX}::artifact::{artifact_id}"

    @staticmethod
    def _bkey(blob_id: str) -> str:
        return f"{PREFIX}::blob::{blob_id}"

    def _set(self, key: str, value: dict):
        data = json.dumps(value)
        if self.ttl > 0:
            self.client.command("SET", key, data, "EX", str(self.ttl))
        else:
            self.client.command("SET", key, data)

    def _get_json(self, key: str) -> Optional[dict]:
        """→ the decoded entry, or None (a miss), after quarantining a
        corrupt one."""
        raw = self.client.command("GET", key)
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            quarantine = key.replace(f"{PREFIX}::", f"{PREFIX}::corrupt::",
                                     1)
            renamed = False
            try:
                renamed = self.client.rename_if_value(key, raw, quarantine)
            except RedisError:
                pass   # a racing reader already quarantined it
            if renamed:
                _log.warning("quarantined corrupt cache entry %s → %s "
                             "(serving a miss)", key, quarantine)
            else:
                _log.warning("corrupt cache entry %s was re-put while "
                             "quarantining; left in place (serving a "
                             "miss)", key)
            return None

    def put_artifact(self, artifact_id: str, info: dict):
        self._set(self._akey(artifact_id), info)

    def put_blob(self, blob_id: str, blob: T.BlobInfo):
        self._set(self._bkey(blob_id), blob.to_json())

    def get_artifact(self, artifact_id: str) -> Optional[dict]:
        return self._get_json(self._akey(artifact_id))

    def get_blob(self, blob_id: str) -> Optional[T.BlobInfo]:
        j = self._get_json(self._bkey(blob_id))
        if j is None:
            return None
        METRICS.inc("trivy_tpu_fleet_cache_hits_total", backend="redis")
        return blob_from_json(j)

    def missing_blobs(self, artifact_id: str, blob_ids: list[str]
                      ) -> tuple[bool, list[str]]:
        missing = [b for b in blob_ids
                   if not self.client.command("EXISTS", self._bkey(b))]
        missing_artifact = not self.client.command(
            "EXISTS", self._akey(artifact_id))
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: list[str]):
        for b in blob_ids:
            self.client.command("DEL", self._bkey(b))

    def clear(self):
        """Only this cache's keys, as redis.go Clear (SCAN and DEL of
        fanal::*)."""
        cursor = "0"
        while True:
            reply = self.client.command("SCAN", cursor, "MATCH",
                                        f"{PREFIX}::*", "COUNT", "100")
            cursor = reply[0].decode() if isinstance(reply[0], bytes) \
                else str(reply[0])
            for key in reply[1] or []:
                self.client.command("DEL", key)
            if cursor == "0":
                break


def open_cache(url: str, ttl_seconds: int = 0) -> RedisCache:
    return RedisCache(url, ttl_seconds)
