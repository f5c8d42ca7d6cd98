"""The AWS API client, the port's copy of the client half of the JAX
package's cloud/aws.py (reference pkg/cloud/aws): sigv4-signed
requests, credentials from the arguments or the AWS_* environment, an
endpoint that an emulator can take over, and the SDK's retries on
throttling and server errors. The EBS snapshot source of `vm`
(fanal/vm.py EBSDevice) reads through it. The account walkers and the
AVD-AWS checks over them are ROADMAP A13."""

from __future__ import annotations

import os
import time
import urllib.error
import urllib.parse
import urllib.request

from .sigv4 import sign


class AWSError(Exception):
    pass


class AWSClient:
    def __init__(self, region: str = "us-east-1", endpoint: str = "",
                 access_key: str = "", secret_key: str = "",
                 session_token: str = "", timeout: float = 30.0):
        self.region = region or "us-east-1"
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key or os.environ.get(
            "AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get(
            "AWS_SESSION_TOKEN", "")
        self.timeout = timeout
        if not self.access_key or not self.secret_key:
            raise AWSError(
                "AWS credentials not found (AWS_ACCESS_KEY_ID / "
                "AWS_SECRET_ACCESS_KEY)")

    def _service_url(self, service: str) -> str:
        if self.endpoint:
            return self.endpoint
        return f"https://{service}.{self.region}.amazonaws.com"

    def request(self, service: str, method: str = "GET", path: str = "/",
                query: dict | None = None, body: bytes = b"",
                headers: dict | None = None) -> bytes:
        query = query or {}
        url = self._service_url(service)
        parsed = urllib.parse.urlparse(url)
        signed = sign(method, parsed.netloc, path, query,
                      headers or {}, body, service, self.region,
                      self.access_key, self.secret_key,
                      self.session_token)
        qs = urllib.parse.urlencode(sorted(query.items()))
        full = f"{url}{path}" + (f"?{qs}" if qs else "")
        # throttling and transient server errors retry with backoff, as
        # the reference's SDK does
        last: Exception | None = None
        for attempt in range(3):
            req = urllib.request.Request(full, data=body or None,
                                         method=method, headers=signed)
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                detail = e.read()[:200]
                last = AWSError(
                    f"{service} {path}: HTTP {e.code}: {detail!r}")
                last.__cause__ = e
                if e.code not in (429, 500, 502, 503) and \
                        b"Throttling" not in detail:
                    raise last
            except Exception as e:
                raise AWSError(
                    f"{service} request failed: {e}") from e
            if attempt < 2:
                time.sleep(0.2 * (attempt + 1))
        raise last
