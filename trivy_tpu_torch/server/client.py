"""Remote scan client (reference pkg/rpc/client + pkg/cache/remote.go):
the client analyzes on its side, pushes the blobs into the server's
cache, and asks the server, which holds the advisory table on the card,
to detect.

Transient failures retry through RetryPolicy (full jitter, capped by a
sleep budget); 429 and 503 sheds retry no sooner than their Retry-After.
Each RPC carries its timeout as X-Trivy-Deadline-Ms, so the server
never queues it past that. Speaks the JAX package's wire
(trivy_tpu/server/client.py), JSON-encoded; its list of failover URLs
belongs to the fleet (ROADMAP A12) and is not ported.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from .. import types as T
from ..report.writer import report_from_json
from ..resilience.retry import RetryPolicy, http_should_retry
from . import DEADLINE_HEADER, TENANT_HEADER, TOKEN_HEADER

DEFAULT_RETRY = RetryPolicy(attempts=3, base_delay_s=0.2, max_delay_s=2.0,
                            budget_s=15.0)
# admission sheds retry after the server's Retry-After; other HTTP
# errors are terminal Twirp answers
_SHOULD_RETRY = http_should_retry((429, 503))


class TwirpError(RuntimeError):
    def __init__(self, code: str, msg: str):
        super().__init__(f"{code}: {msg}")
        self.code = code


class _Base:
    def __init__(self, base_url: str, token: str = "", timeout: float = 60,
                 retry: RetryPolicy | None = None, tenant: str = ""):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        self.retry = retry or DEFAULT_RETRY
        # X-Trivy-Tenant on every RPC; empty → the server's "default"
        self.tenant = tenant

    def _call(self, service: str, method: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        headers = {
            "Content-Type": "application/json",
            DEADLINE_HEADER: str(int(self.timeout * 1e3)),
            **({TOKEN_HEADER: self.token} if self.token else {}),
            **({TENANT_HEADER: self.tenant} if self.tenant else {}),
        }
        url = f"{self.base_url}/twirp/{service}/{method}"

        def attempt() -> dict:
            req = urllib.request.Request(url, data=body, method="POST",
                                         headers=headers)
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"{}")

        try:
            return self.retry.call(attempt, should_retry=_SHOULD_RETRY)
        except urllib.error.HTTPError as e:
            # the server answered: a Twirp error
            detail = e.read().decode(errors="replace")
            try:
                j = json.loads(detail)
                if not isinstance(j, dict):
                    raise ValueError("non-object error body")
            except ValueError:
                raise TwirpError(str(e.code), detail) from None
            raise TwirpError(j.get("code", str(e.code)),
                             j.get("msg", detail)) from None
        except urllib.error.URLError as e:
            raise TwirpError("unavailable", str(e)) from None


class RemoteCache(_Base):
    """The artifact cache over the wire: what an artifact's analysis
    writes into, in place of a local cache."""

    SERVICE = "trivy.cache.v1.Cache"

    def missing_blobs(self, artifact_id: str, blob_ids: list):
        r = self._call(self.SERVICE, "MissingBlobs",
                       {"artifact_id": artifact_id, "blob_ids": blob_ids})
        return (bool(r.get("missing_artifact")),
                r.get("missing_blob_ids") or [])

    def put_artifact(self, artifact_id: str, info: dict):
        self._call(self.SERVICE, "PutArtifact",
                   {"artifact_id": artifact_id, "artifact_info": info})

    def put_blob(self, blob_id: str, blob: T.BlobInfo):
        self._call(self.SERVICE, "PutBlob",
                   {"diff_id": blob_id, "blob_info": blob.to_json()})

    def get_blob(self, blob_id: str):
        return None  # the client holds no blobs (run.go:352-353)

    def get_artifact(self, artifact_id: str):
        return None


class RemoteScanner(_Base):
    """The scan driver over the wire (pkg/rpc/client/client.go:67)."""

    SERVICE = "trivy.scanner.v1.Scanner"

    def scan(self, target: str, artifact_id: str, blob_ids: list,
             options: T.ScanOptions | None = None):
        r = self._call(self.SERVICE, "Scan", {
            "target": target,
            "artifact_id": artifact_id,
            "blob_ids": blob_ids,
            "options": self._options_json(options or T.ScanOptions()),
        })
        return self._decode_response(r)

    def scan_sbom(self, target: str, raw: bytes,
                  options: T.ScanOptions | None = None):
        """Ship the raw SBOM; the server decodes it into its own cache.
        The document digest rides as artifact_id and a cheap sniff as
        the kind, as the JAX client sends them."""
        import base64

        from ..sbom.artifact import doc_digest
        kind = ""
        if b'"bomFormat"' in raw and b"CycloneDX" in raw:
            kind = "cyclonedx"
        elif b"spdxVersion" in raw or b"SPDXVersion:" in raw:
            kind = "spdx"
        r = self._call(self.SERVICE, "ScanSBOM", {
            "target": target,
            "artifact_id": doc_digest(raw),
            "kind": kind,
            "document": base64.b64encode(raw).decode(),
            "options": self._options_json(options or T.ScanOptions()),
        })
        return self._decode_response(r)

    @staticmethod
    def _options_json(options: T.ScanOptions) -> dict:
        return {
            "scanners": list(options.scanners),
            "vuln_type": list(options.pkg_types),
            "list_all_packages": options.list_all_packages,
        }

    @staticmethod
    def _decode_response(r: dict):
        os_j = r.get("os") or {}
        os_info = T.OS(family=os_j.get("family", ""),
                       name=os_j.get("name", ""),
                       eosl=bool(os_j.get("eosl")))
        report = report_from_json({"Results": r.get("results") or []})
        return report.results, os_info
