"""S3 cache backend (reference pkg/fanal/cache/s3.go), the port's copy
of the JAX package's fanal/s3_cache.py.

The reference's key scheme, `<prefix>/fanal/artifact/<id>` and
`<prefix>/fanal/blob/<id>` objects holding JSON, existence checked with
HEAD, over the S3 REST API through the sigv4-signing client of
cloud/aws.py (no SDK). URL format:

    s3://bucket[/prefix]?region=us-east-1[&endpoint=http://host:9000]

A custom `endpoint` serves MinIO, localstack and the fakes of the tests.

  * puts are atomic: an S3 PUT is a whole-object write, so a key serves
    the previous body or the complete new one, never a truncation;
  * a corrupt entry is quarantined on read: its bytes are copied to
    `fanal/corrupt/...` (forensics), the original is deleted (both best
    effort), and the read is a miss, so the layer is analyzed again.

Any other failure of the store raises S3CacheError, as in the JAX
package.
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Optional

from .. import types as T
from ..cloud.aws import AWSClient, AWSError
from ..log import get as _get_logger
from ..metrics import METRICS
from .cache import blob_from_json

_log = _get_logger("fanal.cache.s3")

ARTIFACT_DIR = "fanal/artifact"
BLOB_DIR = "fanal/blob"
CORRUPT_DIR = "fanal/corrupt"


class S3CacheError(Exception):
    pass


class S3Cache:
    def __init__(self, url: str, access_key: str = "",
                 secret_key: str = ""):
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme != "s3" or not parsed.netloc:
            raise S3CacheError(f"invalid s3 cache url: {url!r}")
        self.bucket = parsed.netloc
        self.prefix = parsed.path.strip("/")
        q = urllib.parse.parse_qs(parsed.query)
        try:
            self.client = AWSClient(
                region=(q.get("region") or ["us-east-1"])[0],
                endpoint=(q.get("endpoint") or [""])[0],
                access_key=access_key, secret_key=secret_key)
        except AWSError as e:
            raise S3CacheError(str(e)) from None

    def _key(self, kind: str, ident: str) -> str:
        # the raw path: the signer canonical-encodes it once (quoting it
        # here too would break the signature); cache ids ("sha256:...")
        # are path-safe as they are
        parts = [p for p in (self.prefix, kind, ident) if p]
        return "/" + self.bucket + "/" + "/".join(parts)

    def _put(self, kind: str, ident: str, doc: dict):
        body = json.dumps(doc, sort_keys=True).encode()
        try:
            self.client.request("s3", "PUT", self._key(kind, ident),
                                body=body)
        except AWSError as e:
            raise S3CacheError(f"put {kind}/{ident}: {e}") from None

    def _get(self, kind: str, ident: str) -> Optional[dict]:
        try:
            raw = self.client.request("s3", "GET", self._key(kind, ident))
        except AWSError as e:
            if "HTTP 404" in str(e):
                return None
            raise S3CacheError(f"get {kind}/{ident}: {e}") from None
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            self._quarantine(kind, ident, raw)
            return None

    def _quarantine(self, kind: str, ident: str, raw: bytes) -> None:
        """Keep a corrupt entry's bytes under fanal/corrupt/ and delete
        the original, so every replica sharing the bucket sees a clean
        miss. A failed move still serves the miss (the next reader tries
        again)."""
        quarantine = self._key(CORRUPT_DIR,
                               f"{kind.rsplit('/', 1)[-1]}/{ident}")
        try:
            self.client.request("s3", "PUT", quarantine, body=raw)
            self.client.request("s3", "DELETE", self._key(kind, ident))
        except AWSError:
            pass
        _log.warning("quarantined corrupt cache entry %s/%s → %s "
                     "(serving a miss)", kind, ident, quarantine)

    def _exists(self, kind: str, ident: str) -> bool:
        try:
            self.client.request("s3", "HEAD", self._key(kind, ident))
            return True
        except AWSError as e:
            if "HTTP 404" in str(e):
                return False
            raise S3CacheError(f"head {kind}/{ident}: {e}") from None

    def put_artifact(self, artifact_id: str, info: dict):
        self._put(ARTIFACT_DIR, artifact_id, info)

    def put_blob(self, blob_id: str, blob: T.BlobInfo):
        self._put(BLOB_DIR, blob_id, blob.to_json())

    def get_artifact(self, artifact_id: str) -> Optional[dict]:
        return self._get(ARTIFACT_DIR, artifact_id)

    def get_blob(self, blob_id: str) -> Optional[T.BlobInfo]:
        doc = self._get(BLOB_DIR, blob_id)
        if doc is None:
            return None
        METRICS.inc("trivy_tpu_fleet_cache_hits_total", backend="s3")
        return blob_from_json(doc)

    def missing_blobs(self, artifact_id: str,
                      blob_ids: list[str]) -> tuple[bool, list[str]]:
        missing = [bid for bid in blob_ids
                   if not self._exists(BLOB_DIR, bid)]
        return not self._exists(ARTIFACT_DIR, artifact_id), missing
