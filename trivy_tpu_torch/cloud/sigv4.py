"""AWS Signature Version 4 request signing, the port's copy of the JAX
package's cloud/sigv4.py (the reference relies on aws-sdk-go-v2 for
this; there is no SDK here, so requests are signed by hand).

The standard algorithm: canonical request → string to sign →
HMAC-SHA256 chain keyed on the secret. Its output is the SDK's, so a
request works against AWS or any sigv4-checking emulator."""

from __future__ import annotations

import datetime as dt
import hashlib
import hmac
from urllib.parse import quote


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign(method: str, url_host: str, path: str, query: dict,
         headers: dict, body: bytes, service: str, region: str,
         access_key: str, secret_key: str, session_token: str = "",
         now: dt.datetime | None = None) -> dict:
    """→ the request's headers, Authorization included."""
    t = now or dt.datetime.now(dt.timezone.utc)
    amz_date = t.strftime("%Y%m%dT%H%M%SZ")
    datestamp = t.strftime("%Y%m%d")

    payload_hash = hashlib.sha256(body or b"").hexdigest()
    all_headers = dict(headers)
    all_headers["host"] = url_host
    all_headers["x-amz-date"] = amz_date
    all_headers["x-amz-content-sha256"] = payload_hash
    if session_token:
        all_headers["x-amz-security-token"] = session_token

    canon_headers = "".join(
        f"{k.lower()}:{str(v).strip()}\n"
        for k, v in sorted(all_headers.items(),
                           key=lambda kv: kv[0].lower()))
    signed_headers = ";".join(sorted(k.lower() for k in all_headers))
    canon_query = "&".join(
        f"{quote(str(k), safe='-_.~')}={quote(str(v), safe='-_.~')}"
        for k, v in sorted(query.items()))
    canon_path = quote(path or "/", safe="/-_.~")
    canonical = "\n".join([method, canon_path, canon_query,
                           canon_headers, signed_headers, payload_hash])

    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])

    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()

    all_headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return all_headers
