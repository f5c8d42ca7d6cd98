"""OCI distribution client (registry API v2) on the standard library: the
port's copy of the JAX package's oci.py.

The host I/O of two flows the reference leaves to go-containerregistry:
  - the trivy-db download (pkg/oci/artifact.go:103, pkg/db/db.go:153):
    manifest → the layer blob of a media type;
  - the registry image source (pkg/fanal/image/remote.go): manifest
    (an index → the platform's manifest) → config and layer blobs,
    streamed into the walk (fanal/artifact.py RegistryArtifact) or
    written as an OCI-layout tarball (`pull_to_oci_tar`).

Auth: the Bearer token flow (401 → WWW-Authenticate: Bearer
realm/service/scope → the token endpoint), basic auth from
TRIVY_USERNAME/TRIVY_PASSWORD, and per-host helpers for ECR, GCR/Artifact
Registry and ACR. A reference may name plain http
(`http://host:port/repo:tag`), so tests run against an in-process
registry (fanal/fixtures.py `OCIRegistry`).
"""

from __future__ import annotations

import base64
import datetime as dt
import gzip
import hashlib
import hmac
import io
import json
import os
import random
import re
import tarfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

MT_OCI_INDEX = "application/vnd.oci.image.index.v1+json"
MT_OCI_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
MT_DOCKER_LIST = "application/vnd.docker.distribution.manifest.list.v2+json"
MT_DOCKER_MANIFEST = "application/vnd.docker.distribution.manifest.v2+json"
ACCEPT = ", ".join([MT_OCI_INDEX, MT_OCI_MANIFEST, MT_DOCKER_LIST,
                    MT_DOCKER_MANIFEST])

# the trivy-db layer's media type (pkg/db/db.go:22)
MT_TRIVY_DB = "application/vnd.aquasec.trivy.db.layer.v1.tar+gzip"


class OCIError(RuntimeError):
    pass


@dataclass(frozen=True)
class RetryPolicy:
    """Retries with full jitter: before retry n, sleep ~ U(0,
    min(max_delay, base · 2^n)); the total sleep never passes `budget_s`.
    The JAX package's RetryPolicy, without its injectable clock."""

    attempts: int = 3
    base_delay_s: float = 0.2
    max_delay_s: float = 5.0
    budget_s: float = 30.0

    def call(self, fn, *, should_retry):
        """`should_retry(exc)` → None to re-raise, or a least delay in
        seconds (a server's Retry-After)."""
        spent = 0.0
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                floor = should_retry(e)
                if floor is None or attempt + 1 >= self.attempts:
                    raise
                d = max(float(floor), random.uniform(
                    0.0, min(self.max_delay_s,
                             self.base_delay_s * 2.0 ** attempt)))
                if spent + d > self.budget_s:
                    raise
                time.sleep(d)
                spent += d
                attempt += 1


def retry_on(*exc_types):
    """→ a should_retry that retries on the given types only."""
    def should_retry(e):
        return 0.0 if isinstance(e, exc_types) else None
    return should_retry


_RETRYABLE_HTTP = (429, 500, 502, 503, 504)


def _transient_http(e):
    """Connection errors retry; HTTP 429/5xx retry no sooner than their
    Retry-After; anything else (401 included: the token flow handles
    it) is final."""
    if isinstance(e, urllib.error.HTTPError):
        if e.code in _RETRYABLE_HTTP:
            try:
                return float(e.headers.get("Retry-After") or 0.0)
            except ValueError:
                return 0.0
        return None
    if isinstance(e, urllib.error.URLError):
        return 0.0
    return None


# the retry of each registry HTTP call
_TRANSIENT_RETRY = RetryPolicy(attempts=3, base_delay_s=0.3,
                               max_delay_s=3.0, budget_s=20.0)


@dataclass
class ImageRef:
    host: str
    repository: str
    tag: str = "latest"
    digest: str = ""
    scheme: str = "https"

    @property
    def reference(self) -> str:
        return self.digest or self.tag

    @property
    def base(self) -> str:
        return f"{self.scheme}://{self.host}/v2/{self.repository}"

    def __str__(self):
        s = f"{self.host}/{self.repository}"
        if self.tag:
            s += f":{self.tag}"
        if self.digest:
            s += f"@{self.digest}"
        return s


def parse_ref(ref: str) -> ImageRef:
    """'host/repo:tag', 'host/repo@sha256:..', 'http://host:5000/r:t',
    or a bare 'repo:tag' (Docker Hub, library/ for one component)."""
    scheme = "https"
    if ref.startswith("http://"):
        scheme = "http"
        ref = ref[len("http://"):]
    elif ref.startswith("https://"):
        ref = ref[len("https://"):]
    digest = ""
    if "@" in ref:
        ref, digest = ref.split("@", 1)
    head, sep, rest = ref.partition("/")
    if sep and (("." in head) or (":" in head) or head == "localhost"):
        host, path = head, rest
    else:
        host, path = "registry-1.docker.io", ref
    tag = "latest"
    m = re.match(r"^(.+?):([\w][\w.-]{0,127})$", path)
    if m:
        path, tag = m.group(1), m.group(2)
    if host == "registry-1.docker.io" and "/" not in path:
        path = f"library/{path}"
    return ImageRef(host=host, repository=path, tag=tag, digest=digest,
                    scheme=scheme)


@dataclass
class RegistryClient:
    username: str = ""
    password: str = ""
    timeout: float = 60.0
    _tokens: dict = field(default_factory=dict)
    # host → (user, password, refresh time) from a cloud helper
    _cloud_creds: dict = field(default_factory=dict)

    # ---- http -----------------------------------------------------------

    def _request(self, url: str, headers: dict, ref: ImageRef,
                 _retried: bool = False):
        tok = self._tokens.get((ref.host, ref.repository))
        basic = (self.username, self.password) if self.username else \
            self._cloud_basic(ref.host)

        def attempt():
            # a fresh Request per try: one is not reusable after a
            # failed open
            req = urllib.request.Request(url, headers=headers)
            if tok:
                req.add_header("Authorization", f"Bearer {tok}")
            elif basic is not None:
                cred = base64.b64encode(
                    f"{basic[0]}:{basic[1]}".encode()).decode()
                req.add_header("Authorization", f"Basic {cred}")
            return urllib.request.urlopen(req, timeout=self.timeout)

        try:
            return _TRANSIENT_RETRY.call(attempt,
                                         should_retry=_transient_http)
        except urllib.error.HTTPError as e:
            if e.code == 401 and not _retried:
                # no token yet, or it expired mid-pull: one challenge
                self._tokens.pop((ref.host, ref.repository), None)
                tok = self._fetch_token(e.headers.get("WWW-Authenticate",
                                                      ""))
                if tok:
                    self._tokens[(ref.host, ref.repository)] = tok
                    return self._request(url, headers, ref, _retried=True)
            raise OCIError(f"{url}: HTTP {e.code} "
                           f"{e.read(200).decode(errors='replace')}") \
                from None
        except urllib.error.URLError as e:
            raise OCIError(f"{url}: {e.reason}") from None

    def _cloud_basic(self, host: str):
        """Per-host basic credentials from the ECR, GCR and ACR helpers
        (reference pkg/fanal/image/registry/*), cached for each
        provider's token lifetime; None for other hosts, so static
        credentials never cross hosts."""
        cached = self._cloud_creds.get(host)
        if cached is not None and time.time() < cached[2]:
            return (cached[0], cached[1]) if cached[0] else None
        for fetch, ttl_s in ((ecr_credentials, 11 * 3600),
                             (gcr_credentials, 50 * 60),
                             (acr_credentials, 60 * 60)):
            creds = fetch(host)
            if creds is not None:
                self._cloud_creds[host] = (creds[0], creds[1],
                                           time.time() + ttl_s)
                return creds
        # a miss is remembered briefly: it may have cost token requests
        self._cloud_creds[host] = ("", "", time.time() + 5 * 60)
        return None

    def _fetch_token(self, challenge: str) -> str:
        """WWW-Authenticate: Bearer realm=...,service=...,scope=... →
        an anonymous (or basic-auth'd) token."""
        if not challenge.lower().startswith("bearer "):
            return ""
        fields = dict(re.findall(r'(\w+)="([^"]*)"', challenge))
        realm = fields.get("realm")
        if not realm:
            return ""
        q = {k: v for k, v in fields.items() if k in ("service", "scope")}
        url = realm + ("?" + urllib.parse.urlencode(q) if q else "")
        req = urllib.request.Request(url)
        if self.username:
            cred = base64.b64encode(
                f"{self.username}:{self.password}".encode()).decode()
            req.add_header("Authorization", f"Basic {cred}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                doc = json.loads(r.read())
            return doc.get("token") or doc.get("access_token") or ""
        except (urllib.error.URLError, json.JSONDecodeError):
            return ""

    # ---- manifests / blobs ---------------------------------------------

    def manifest(self, ref: ImageRef, platform: str = "linux/amd64") -> dict:
        """→ the image or artifact manifest, an index resolved to the
        platform's entry."""
        url = f"{ref.base}/manifests/{ref.reference}"
        with self._request(url, {"Accept": ACCEPT}, ref) as r:
            doc = json.loads(r.read())
        mt = doc.get("mediaType", "")
        if mt in (MT_OCI_INDEX, MT_DOCKER_LIST) or "manifests" in doc:
            entry = select_platform(doc.get("manifests", []), platform)
            sub = ImageRef(host=ref.host, repository=ref.repository,
                           tag="", digest=entry["digest"],
                           scheme=ref.scheme)
            return self.manifest(sub, platform)
        return doc

    def blob(self, ref: ImageRef, digest: str, verify: bool = True) -> bytes:
        url = f"{ref.base}/blobs/{digest}"
        with self._request(url, {}, ref) as r:
            data = r.read()
        if verify and digest.startswith("sha256:"):
            actual = hashlib.sha256(data).hexdigest()
            if actual != digest.split(":", 1)[1]:
                raise OCIError(f"blob digest mismatch for {digest}: "
                               f"got sha256:{actual}")
        return data

    def blob_stream(self, ref: ImageRef, digest: str):
        """→ a file-like stream of a blob that hashes as it is read;
        call .verify() when done to enforce the manifest's digest."""
        url = f"{ref.base}/blobs/{digest}"
        return _VerifyingStream(self._request(url, {}, ref), digest)

    # ---- high level ------------------------------------------------------

    def download_artifact_layer(self, ref: ImageRef,
                                media_type: str) -> bytes:
        """The first layer blob of `media_type` (how pkg/oci/artifact.go
        downloads trivy-db)."""
        man = self.manifest(ref)
        for layer in man.get("layers", []):
            if layer.get("mediaType") == media_type:
                return self.blob(ref, layer["digest"])
        raise OCIError(f"{ref}: no layer with media type {media_type}")

    def pull_to_oci_tar(self, ref: ImageRef, dest_path: str,
                        platform: str = "linux/amd64") -> dict:
        """An image into an OCI-layout tarball at dest_path, the format
        ImageArchiveArtifact reads, one blob at a time → the resolved
        manifest."""
        man = self.manifest(ref, platform)
        man_raw = json.dumps(man, separators=(",", ":")).encode()
        man_digest = "sha256:" + hashlib.sha256(man_raw).hexdigest()
        index = {
            "schemaVersion": 2,
            "manifests": [{
                "mediaType": man.get("mediaType", MT_OCI_MANIFEST),
                "digest": man_digest,
                "size": len(man_raw),
                "annotations": {
                    "org.opencontainers.image.ref.name": str(ref)},
            }],
        }
        layout = {"imageLayoutVersion": "1.0.0"}
        digests = [man.get("config", {}).get("digest")] + \
            [layer["digest"] for layer in man.get("layers", [])]
        with tarfile.open(dest_path, "w") as tf:
            def add(name: str, data: bytes):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
            add("oci-layout", json.dumps(layout).encode())
            add("index.json", json.dumps(index).encode())
            algo, hexd = man_digest.split(":", 1)
            add(f"blobs/{algo}/{hexd}", man_raw)
            seen = {man_digest}
            for digest in digests:
                if not digest or digest in seen:
                    continue
                seen.add(digest)
                algo, hexd = digest.split(":", 1)
                add(f"blobs/{algo}/{hexd}", self.blob(ref, digest))
        return man


def select_platform(manifests: list, platform: str) -> dict:
    """An index's entry for `platform` ('os/arch'); an entry without
    platform fields will do; never a silent wrong-platform fallback
    (go-containerregistry: "no child with platform")."""
    want_os, _, want_arch = platform.partition("/")
    for m in manifests:
        p = m.get("platform") or {}
        if p.get("os") == want_os and p.get("architecture") == want_arch:
            return m
    for m in manifests:
        p = m.get("platform") or {}
        if not p.get("os") and not p.get("architecture"):
            return m
    have = ", ".join(
        f"{(m.get('platform') or {}).get('os', '?')}/"
        f"{(m.get('platform') or {}).get('architecture', '?')}"
        for m in manifests) or "none"
    raise OCIError(f"no manifest for platform {platform} "
                   f"(available: {have})")


def untar_gz_members(data: bytes) -> dict[str, bytes]:
    """tar+gzip blob → {member name: bytes} (trivy-db layers carry
    trivy.db and metadata.json)."""
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    out = {}
    with tarfile.open(fileobj=io.BytesIO(data)) as tf:
        for member in tf.getmembers():
            if member.isfile():
                f = tf.extractfile(member)
                name = member.name
                while name.startswith("./"):
                    name = name[2:]
                out[name] = f.read() if f else b""
    return out


class _VerifyingStream:
    """A blob response hashed as it streams; verify() drains the rest
    and raises OCIError on a digest mismatch."""

    def __init__(self, resp, digest: str):
        self._resp = resp
        self._digest = digest
        self._hash = hashlib.sha256()

    def read(self, n: int = -1) -> bytes:
        data = self._resp.read(n)
        if data:
            self._hash.update(data)
        return data

    def verify(self):
        while True:
            chunk = self._resp.read(1 << 20)
            if not chunk:
                break
            self._hash.update(chunk)
        if self._digest.startswith("sha256:"):
            actual = self._hash.hexdigest()
            if actual != self._digest.split(":", 1)[1]:
                raise OCIError(f"blob digest mismatch for {self._digest}: "
                               f"got sha256:{actual}")

    def close(self):
        self._resp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def default_client() -> RegistryClient:
    return RegistryClient(username=os.environ.get("TRIVY_USERNAME", ""),
                          password=os.environ.get("TRIVY_PASSWORD", ""))


# ---- cloud registry helpers -------------------------------------------

# commercial and GovCloud partitions; China (.amazonaws.com.cn) is not
# supported
_ECR_HOST = re.compile(
    r"^\d{12}\.dkr\.ecr(?:-fips)?\.([a-z0-9-]+)\.amazonaws\.com$")


def _sigv4_headers(method: str, host: str, path: str, headers: dict,
                   body: bytes, service: str, region: str,
                   access_key: str, secret_key: str,
                   session_token: str = "") -> dict:
    """AWS Signature Version 4 (no query string) → the request's headers
    with Authorization, as the JAX package's cloud/sigv4.py signs."""
    t = dt.datetime.now(dt.timezone.utc)
    amz_date = t.strftime("%Y%m%dT%H%M%SZ")
    datestamp = t.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(body or b"").hexdigest()
    out = dict(headers)
    out["host"] = host
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    if session_token:
        out["x-amz-security-token"] = session_token
    canon_headers = "".join(
        f"{k.lower()}:{str(v).strip()}\n"
        for k, v in sorted(out.items(), key=lambda kv: kv[0].lower()))
    signed = ";".join(sorted(k.lower() for k in out))
    canonical = "\n".join([method, urllib.parse.quote(path or "/",
                                                      safe="/-_.~"),
                           "", canon_headers, signed, payload_hash])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
    k = ("AWS4" + secret_key).encode()
    for part in (datestamp, region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    return out


def ecr_credentials(host: str) -> "tuple[str, str] | None":
    """Amazon ECR (reference fanal/image/registry/ecr): a host
    <account>.dkr.ecr.<region>.amazonaws.com gets basic credentials from
    ECR GetAuthorizationToken, signed with the AWS env credentials; the
    token decodes to 'AWS:<password>'. None for another host or without
    AWS credentials."""
    m = _ECR_HOST.match(host)
    access = os.environ.get("AWS_ACCESS_KEY_ID", "")
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    if not m or not access or not secret:
        return None
    region = m.group(1)
    url = (os.environ.get("TRIVY_TPU_ECR_ENDPOINT", "").rstrip("/")
           or f"https://ecr.{region}.amazonaws.com")
    body = b"{}"
    headers = _sigv4_headers(
        "POST", urllib.parse.urlparse(url).netloc, "/", {
            "Content-Type": "application/x-amz-json-1.1",
            "X-Amz-Target": "AmazonEC2ContainerRegistry_V20150921"
                            ".GetAuthorizationToken"},
        body, "ecr", region, access, secret,
        os.environ.get("AWS_SESSION_TOKEN", ""))
    req = urllib.request.Request(url + "/", data=body, method="POST",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30.0) as r:
            doc = json.loads(r.read())
        token = doc["authorizationData"][0]["authorizationToken"]
        user, _, password = base64.b64decode(token).decode().partition(":")
        return user, password
    except (OSError, ValueError, KeyError, IndexError):
        return None


def _post_form(url: str, fields: dict, timeout: float = 10.0):
    """POST form-encoded → the decoded JSON, or None on any failure."""
    data = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/x-www-form-urlencoded"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, ValueError, OSError):
        return None


_ON_GCE: "bool | None" = None
_ON_GCE_RETRY_AT = 0.0
_ON_GCE_LOCK = threading.Lock()


def _on_gce() -> bool:
    """Is the GCE metadata host reachable? A yes is kept for the
    process, a no for 5 minutes."""
    global _ON_GCE, _ON_GCE_RETRY_AT
    with _ON_GCE_LOCK:
        if _ON_GCE is True:
            return True
        if _ON_GCE is False and time.monotonic() < _ON_GCE_RETRY_AT:
            return False
    import socket
    try:
        socket.create_connection(("metadata.google.internal", 80),
                                 timeout=2.0).close()
        ok = True
    except OSError:
        ok = False
    with _ON_GCE_LOCK:
        if ok or _ON_GCE is not True:
            _ON_GCE = ok
        if not ok:
            _ON_GCE_RETRY_AT = time.monotonic() + 5 * 60
    return ok


def gcr_credentials(host: str) -> "tuple[str, str] | None":
    """Google Container and Artifact Registry (reference
    fanal/image/registry/google: gcr.io and docker.pkg.dev hosts), in
    order: $CLOUDSDK_AUTH_ACCESS_TOKEN / $GOOGLE_OAUTH_ACCESS_TOKEN;
    application-default credentials with a refresh token; the GCE
    metadata server ($TRIVY_TPU_GCE_METADATA, or the metadata host when
    it answers) → ("oauth2accesstoken", token) or None."""
    if not (host == "gcr.io" or host.endswith(".gcr.io")
            or host.endswith("docker.pkg.dev")):
        return None
    for var in ("CLOUDSDK_AUTH_ACCESS_TOKEN", "GOOGLE_OAUTH_ACCESS_TOKEN"):
        tok = os.environ.get(var, "")
        if tok:
            return "oauth2accesstoken", tok
    # a service_account key needs RS256 signing, which the standard
    # library lacks: only the refresh-token flow is served
    adc = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS", "") or \
        os.path.join(os.path.expanduser("~"), ".config", "gcloud",
                     "application_default_credentials.json")
    if os.path.exists(adc):
        try:
            with open(adc) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
        if doc.get("type") == "authorized_user" and \
                doc.get("refresh_token"):
            out = _post_form(os.environ.get(
                "TRIVY_TPU_GOOGLE_TOKEN_URL",
                "https://oauth2.googleapis.com/token"), {
                "grant_type": "refresh_token",
                "client_id": doc.get("client_id", ""),
                "client_secret": doc.get("client_secret", ""),
                "refresh_token": doc["refresh_token"],
            })
            if out and out.get("access_token"):
                return "oauth2accesstoken", out["access_token"]
    meta = os.environ.get("TRIVY_TPU_GCE_METADATA", "")
    if not meta:
        if not _on_gce():
            return None
        meta = "http://metadata.google.internal"
    req = urllib.request.Request(
        meta + "/computeMetadata/v1/instance/service-accounts/"
               "default/token", headers={"Metadata-Flavor": "Google"})
    try:
        with urllib.request.urlopen(req, timeout=2.0) as resp:
            out = json.loads(resp.read())
        if out.get("access_token"):
            return "oauth2accesstoken", out["access_token"]
    except (urllib.error.URLError, ValueError, OSError):
        pass
    return None


# the fixed OAuth2 client id of every docker login to ACR
_ACR_USER = "00000000-0000-0000-0000-000000000000"


def acr_credentials(host: str) -> "tuple[str, str] | None":
    """Azure Container Registry (reference fanal/image/registry/azure):
    an AAD token ($AZURE_ACCESS_TOKEN, or client credentials from
    $AZURE_CLIENT_ID/$AZURE_CLIENT_SECRET under $AZURE_TENANT_ID) is
    exchanged at the registry's /oauth2/exchange for a refresh token,
    the password under the null-GUID user."""
    if not host.endswith("azurecr.io"):
        return None
    tenant = os.environ.get("AZURE_TENANT_ID", "")
    if not tenant:
        return None
    aad_token = os.environ.get("AZURE_ACCESS_TOKEN", "")
    if not aad_token:
        client_id = os.environ.get("AZURE_CLIENT_ID", "")
        client_secret = os.environ.get("AZURE_CLIENT_SECRET", "")
        if not (client_id and client_secret):
            return None
        login = os.environ.get("TRIVY_TPU_AZURE_LOGIN_ENDPOINT",
                               "https://login.microsoftonline.com")
        out = _post_form(f"{login}/{tenant}/oauth2/v2.0/token", {
            "grant_type": "client_credentials",
            "client_id": client_id,
            "client_secret": client_secret,
            "scope": "https://management.azure.com/.default",
        })
        if not out or not out.get("access_token"):
            return None
        aad_token = out["access_token"]
    exchange = os.environ.get("TRIVY_TPU_ACR_EXCHANGE_ENDPOINT",
                              f"https://{host}") + "/oauth2/exchange"
    out = _post_form(exchange, {
        "grant_type": "access_token",
        "service": host,
        "tenant": tenant,
        "access_token": aad_token,
    })
    if not out or not out.get("refresh_token"):
        return None
    return _ACR_USER, out["refresh_token"]
