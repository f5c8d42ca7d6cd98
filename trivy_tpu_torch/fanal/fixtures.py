"""Deterministic image archive builders: docker-save tarballs and OCI
image layouts, from layer blobs built with `tar_bytes` (and gzipped
with `gz_bytes` where wanted). Zeroed tar/gzip mtimes keep the bytes
reproducible, so the same seed gives the same image ids. Also the bytes
of binaries the analyzers identify: a Go binary with inline build info
(`go_binary_bytes`) and a cargo-auditable Rust binary
(`rust_audit_elf`). And `OCIRegistry`, an in-process OCI distribution
registry on 127.0.0.1 that serves such images and the trivy-db artifact
by name.

The docker-save layout is the JAX package's (fanal/fixtures.py) byte for
byte, so an archive written here scans to the same report in both
packages."""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import struct
import tarfile
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def tar_bytes(files: dict) -> bytes:
    """Deterministic plain tar of {path: bytes}."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name in files:
            ti = tarfile.TarInfo(name)
            ti.size = len(files[name])
            tf.addfile(ti, io.BytesIO(files[name]))
    return buf.getvalue()


def gz_bytes(data: bytes, level: int = 9) -> bytes:
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0,
                       compresslevel=level) as gz:
        gz.write(data)
    return buf.getvalue()


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def image_config(diff_ids: list[str], created_by=None) -> dict:
    """The image config both archive writers record."""
    if created_by is None:
        created_by = [f"fixture-layer-{i}" for i in range(len(diff_ids))]
    return {
        "architecture": "amd64", "os": "linux",
        "rootfs": {"type": "layers", "diff_ids": diff_ids},
        "history": [{"created_by": created_by[i]}
                    for i in range(len(diff_ids))],
    }


def _write_tar(path: str, members: list[tuple[str, bytes]]) -> None:
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))


def write_docker_archive(path: str, layer_blobs: list[bytes],
                         diff_ids: list[str],
                         repo_tag: str = "fixture/img:1",
                         repo_tags=None, created_by=None,
                         config_sort_keys: bool = True) -> None:
    """Write a docker-save tarball from pre-built layer blobs (plain or
    gzipped); `diff_ids` are the sha256 ids of the uncompressed layer
    tars, recorded verbatim. `config_sort_keys=False` keeps the config's
    insertion order, as the test suite's `make_image` writes it."""
    if repo_tags is None:
        repo_tags = (repo_tag,)
    config_bytes = json.dumps(image_config(diff_ids, created_by),
                              sort_keys=config_sort_keys).encode()
    config_name = sha256_hex(config_bytes) + ".json"
    manifest = [{
        "Config": config_name,
        "RepoTags": list(repo_tags),
        "Layers": [f"layer{i}/layer.tar"
                   for i in range(len(layer_blobs))],
    }]
    _write_tar(path, [("manifest.json", json.dumps(manifest).encode()),
                      (config_name, config_bytes)]
               + [(f"layer{i}/layer.tar", b)
                  for i, b in enumerate(layer_blobs)])


def write_oci_layout(path: str, layer_blobs: list[bytes],
                     diff_ids: list[str], created_by=None) -> None:
    """Write an OCI image layout as one tarball (`oci-layout`,
    `index.json`, content-addressed `blobs/sha256/...`) from the same
    layer blobs; a gzipped blob gets the `+gzip` layer media type."""
    config_bytes = json.dumps(image_config(diff_ids, created_by),
                              sort_keys=True).encode()
    blobs = {sha256_hex(config_bytes): config_bytes}
    layers = []
    for b in layer_blobs:
        digest = sha256_hex(b)
        blobs[digest] = b
        gz = b[:2] == b"\x1f\x8b"
        layers.append({
            "mediaType": "application/vnd.oci.image.layer.v1.tar"
                         + ("+gzip" if gz else ""),
            "digest": "sha256:" + digest, "size": len(b)})
    manifest = json.dumps({
        "schemaVersion": 2,
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                   "digest": "sha256:" + sha256_hex(config_bytes),
                   "size": len(config_bytes)},
        "layers": layers}, sort_keys=True).encode()
    blobs[sha256_hex(manifest)] = manifest
    index = {"schemaVersion": 2, "manifests": [{
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "digest": "sha256:" + sha256_hex(manifest),
        "size": len(manifest)}]}
    _write_tar(path, [("oci-layout",
                       b'{"imageLayoutVersion": "1.0.0"}'),
                      ("index.json", json.dumps(index).encode())]
               + [(f"blobs/sha256/{d}", b) for d, b in blobs.items()])


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def go_binary_bytes(deps, main: str = "example.com/app",
                    go_version: str = "go1.21.5") -> bytes:
    """An ELF whose Go >= 1.18 inline build info (the `\\xff Go
    buildinf:` header with flags bit 2, then two varint-prefixed
    strings) lists `deps`, [(module, version)], as `dep` lines."""
    modinfo = "\n".join(
        [f"path\t{main}", f"mod\t{main}\t(devel)\t"]
        + [f"dep\t{name}\t{version}\th1:abc=" for name, version in deps])
    info = (b"\xff Go buildinf:" + b"\x08" + b"\x02" + b"\x00" * 16
            + _varint(len(go_version)) + go_version.encode()
            + _varint(len(modinfo.encode())) + modinfo.encode())
    return b"\x7fELF" + b"\x00" * 100 + info + b"\x00" * 50


def rust_audit_elf(packages) -> bytes:
    """An ELF64 with a `.dep-v0` section holding the zlib-compressed
    cargo-auditable JSON of `packages`, [{name, version, source, kind}]
    (the root crate has source "local")."""
    payload = zlib.compress(json.dumps({"packages": list(packages)})
                            .encode())
    names = b"\x00.shstrtab\x00.dep-v0\x00"
    names_off = 64
    payload_off = names_off + len(names)
    shoff = payload_off + len(payload)
    ehdr = bytearray(64)
    ehdr[:4] = b"\x7fELF"
    ehdr[4] = 2  # 64-bit
    ehdr[5] = 1  # little-endian
    struct.pack_into("<Q", ehdr, 0x28, shoff)
    struct.pack_into("<HHH", ehdr, 0x3A, 64, 3, 1)  # entsize, num, strndx

    def shdr(name, off, size):
        b = bytearray(64)
        struct.pack_into("<IIQQQQ", b, 0, name, 0, 0, 0, off, size)
        return bytes(b)
    return (bytes(ehdr) + names + payload + shdr(0, 0, 0)
            + shdr(1, names_off, len(names))
            + shdr(11, payload_off, len(payload)))


MT_OCI_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
MT_OCI_INDEX = "application/vnd.oci.image.index.v1+json"
MT_OCI_CONFIG = "application/vnd.oci.image.config.v1+json"


class OCIRegistry:
    """An in-process OCI distribution registry (API v2: GET of manifests
    and blobs) on 127.0.0.1, for tests and the chip smoke run. With a
    `token` every request needs `Authorization: Bearer <token>`; a 401
    names the token endpoint (/token) that hands it out. `requests`
    records each path asked for; tamper with a blob by rewriting
    `blobs[digest]`."""

    def __init__(self, token: str = ""):
        self.token = token
        self.blobs: dict[str, bytes] = {}
        # (repo, reference) → (media type, manifest bytes)
        self.manifests: dict[tuple[str, str], tuple[str, bytes]] = {}
        self.requests: list[str] = []
        self._srv = None
        self.port = 0

    # ---- content -------------------------------------------------------

    def put_blob(self, data: bytes) -> str:
        digest = "sha256:" + sha256_hex(data)
        self.blobs[digest] = data
        return digest

    def put_manifest(self, repo: str, reference: str, doc: dict,
                     media_type: str = MT_OCI_MANIFEST) -> str:
        raw = json.dumps(doc, sort_keys=True).encode()
        digest = "sha256:" + sha256_hex(raw)
        self.manifests[(repo, digest)] = (media_type, raw)
        if reference:
            self.manifests[(repo, reference)] = (media_type, raw)
        return digest

    def put_artifact(self, repo: str, tag: str, layers: list,
                     config: bytes = b"{}") -> str:
        """layers: [(media type, bytes)] → the manifest's digest."""
        return self.put_manifest(repo, tag, {
            "schemaVersion": 2, "mediaType": MT_OCI_MANIFEST,
            "config": {"mediaType": MT_OCI_CONFIG,
                       "digest": self.put_blob(config),
                       "size": len(config)},
            "layers": [{"mediaType": mt, "digest": self.put_blob(data),
                        "size": len(data)} for mt, data in layers]})

    def put_image(self, repo: str, tag: str, layer_blobs: list[bytes],
                  diff_ids: list[str], created_by=None) -> str:
        """An image of pre-built layer blobs (plain or gzip, by magic)
        with the config the archive writers record → its manifest's
        digest."""
        config = json.dumps(image_config(diff_ids, created_by),
                            sort_keys=True).encode()
        return self.put_artifact(repo, tag, [
            ("application/vnd.oci.image.layer.v1.tar"
             + ("+gzip" if b[:2] == b"\x1f\x8b" else ""), b)
            for b in layer_blobs], config=config)

    def put_index(self, repo: str, tag: str, platforms: dict) -> str:
        """An index over {"os/arch": manifest digest} → its digest."""
        entries = []
        for plat, digest in platforms.items():
            os_, _, arch = plat.partition("/")
            mt, raw = self.manifests[(repo, digest)]
            entries.append({"mediaType": mt, "digest": digest,
                            "size": len(raw),
                            "platform": {"os": os_, "architecture": arch}})
        return self.put_manifest(repo, tag, {
            "schemaVersion": 2, "mediaType": MT_OCI_INDEX,
            "manifests": entries}, media_type=MT_OCI_INDEX)

    # ---- serving -------------------------------------------------------

    def _lookup(self, path: str):
        """A request path → (content type, body), or None."""
        parts = path.split("?", 1)[0].split("/")
        if len(parts) < 5 or parts[1] != "v2":
            return None
        if parts[-2] == "manifests":
            return self.manifests.get(("/".join(parts[2:-2]), parts[-1]))
        if parts[-2] == "blobs" and parts[-1] in self.blobs:
            return "application/octet-stream", self.blobs[parts[-1]]
        return None

    def start(self) -> str:
        """Serve on a free port → the base URL (http://127.0.0.1:PORT)."""
        reg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes = b"",
                      ctype: str = "application/json", extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                reg.requests.append(self.path)
                if self.path.startswith("/token"):
                    self._send(200, json.dumps(
                        {"token": reg.token}).encode())
                    return
                if reg.token and self.headers.get("Authorization") != \
                        f"Bearer {reg.token}":
                    self._send(401, extra=[(
                        "WWW-Authenticate",
                        f'Bearer realm="http://127.0.0.1:{reg.port}/token"'
                        f',service="fixture",scope="repository:pull"')])
                    return
                found = reg._lookup(self.path)
                if found is None:
                    self._send(404, b'{"errors":[{"code":"UNKNOWN"}]}')
                    return
                self._send(200, found[1], ctype=found[0])

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         name="oci-registry", daemon=True).start()
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
