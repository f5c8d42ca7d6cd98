"""Deterministic image archive builders: docker-save tarballs and OCI
image layouts, from layer blobs built with `tar_bytes` (and gzipped
with `gz_bytes` where wanted). Zeroed tar/gzip mtimes keep the bytes
reproducible, so the same seed gives the same image ids. Also the bytes
of binaries the analyzers identify: a Go binary with inline build info
(`go_binary_bytes`) and a cargo-auditable Rust binary
(`rust_audit_elf`). Disk images for `vm`: a bare ext4 filesystem from a
{path: bytes} tree (`ext4_image`), and the disks that wrap one in an MBR
or GPT partition table or a sparse VMDK (`mbr_disk`, `gpt_disk`,
`vmdk_sparse`), all written here in Python. And `OCIRegistry`, an
in-process OCI distribution registry on 127.0.0.1 that serves such
images and the trivy-db artifact by name, with the other loopback fakes
of the shared backends: `FakeRedis` (RESP2), `FakeS3` (the S3 REST API,
sigv4-signed) and `FakeRekor` (the two Rekor endpoints the scans ask).

The docker-save layout is the JAX package's (fanal/fixtures.py) byte for
byte, so an archive written here scans to the same report in both
packages."""

from __future__ import annotations

import base64
import fnmatch
import gzip
import hashlib
import io
import json
import socket
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


# ---- disk images: a small ext4 writer and the MBR, GPT and VMDK wrappers

SECTOR = 512
_INODE_SIZE = 256
_FIRST_INO = 11            # inodes 1-10 are reserved; 2 is the root
# one less than the longest initialized extent (32768 blocks): vm.py's
# reader, as the JAX package's, takes the length's low 15 bits
_EXTENT_MAX_BLOCKS = 32767
_S_IFDIR, _S_IFREG = 0x4000, 0x8000
_EXTENTS_FL = 0x80000
_INCOMPAT_FILETYPE, _INCOMPAT_EXTENTS = 0x2, 0x40


def ext4_image(tree: dict, size_mb: int, block_size: int = 4096) -> bytes:
    """A bare ext4 filesystem of `size_mb` MiB holding {path: bytes}
    (directories are implied by the paths), written for readers that
    walk a disk without mounting it (fanal/vm.py): no journal, no
    checksums and no allocation bitmaps; linear directories; each file
    in contiguous blocks, mapped by at most four extents in its inode.
    As many block groups as the size needs (8 × block_size blocks
    each), with the inodes spread over their tables. The same tree gives
    the same bytes."""
    if block_size not in (1024, 2048, 4096):
        raise ValueError(f"block size {block_size}: 1024, 2048 or 4096")
    bs = block_size
    files, dirs = {}, {"": {}}          # dirs: path → {name: child}
    for path, content in tree.items():
        parts = [p for p in path.split("/") if p not in ("", ".")]
        if not parts or ".." in parts:
            raise ValueError(f"{path!r}: not a relative file path")
        for i in range(1, len(parts)):
            dirs.setdefault("/".join(parts[:i]), {})
            dirs["/".join(parts[:i - 1])][parts[i - 1]] = \
                "/".join(parts[:i])
        rel = "/".join(parts)
        files[rel] = bytes(content)
        dirs["/".join(parts[:-1])][parts[-1]] = rel
    clash = sorted(set(files) & set(dirs))
    if clash:
        raise ValueError(f"{clash[0]!r} is both a file and a directory")
    ino = {"": 2}
    for rel in sorted(dirs)[1:] + sorted(files):
        ino[rel] = _FIRST_INO + len(ino) - 1
    max_ino = _FIRST_INO + len(ino) - 2

    n_blocks = (size_mb << 20) // bs
    first_data = 1 if bs == 1024 else 0
    per_group = 8 * bs
    n_groups = -(-(n_blocks - first_data) // per_group)
    step = max(8, bs // _INODE_SIZE)
    ipg = -(-max_ino // n_groups // step) * step
    gdt = first_data + 1
    itable = gdt + -(-n_groups * 32 // bs)
    itable_blocks = ipg * _INODE_SIZE // bs
    next_free = itable + n_groups * itable_blocks
    img = bytearray(n_blocks * bs)

    def alloc(data: bytes) -> tuple:
        nonlocal next_free
        start, count = next_free, -(-len(data) // bs)
        if start + count > n_blocks:
            raise ValueError(f"the tree does not fit {size_mb} MiB")
        img[start * bs:start * bs + len(data)] = data
        next_free += count
        return start, count

    def put_inode(n: int, mode: int, size: int, start: int, count: int,
                  links: int) -> None:
        extents = [(lb, min(count - lb, _EXTENT_MAX_BLOCKS))
                   for lb in range(0, count, _EXTENT_MAX_BLOCKS)]
        if len(extents) > 4:
            raise ValueError(f"inode {n}: more than four extents")
        group, index = divmod(n - 1, ipg)
        off = (itable + group * itable_blocks) * bs + index * _INODE_SIZE
        struct.pack_into("<HHIIIIIHHII", img, off, mode, 0,
                         size & 0xFFFFFFFF, 0, 0, 0, 0, 0, links,
                         count * bs // SECTOR, _EXTENTS_FL)
        struct.pack_into("<HHHHI", img, off + 40, 0xF30A, len(extents),
                         4, 0, 0)
        for k, (lb, ln) in enumerate(extents):
            struct.pack_into("<IHHI", img, off + 52 + 12 * k, lb, ln,
                             (start + lb) >> 32, (start + lb) & 0xFFFFFFFF)
        struct.pack_into("<I", img, off + 108, size >> 32)
        struct.pack_into("<H", img, off + 128, 32)   # i_extra_isize

    def dir_bytes(rel: str, parent: str) -> bytes:
        entries = [(ino[rel], 2, b"."), (ino[parent], 2, b"..")] + [
            (ino[child], 2 if child in dirs else 1, name.encode())
            for name, child in sorted(dirs[rel].items())]
        out, block = bytearray(), bytearray()
        last = 0   # offset in `block` of its last entry
        for n, ftype, name in entries:
            rec = (8 + len(name) + 3) & ~3
            if len(block) + rec > bs:
                # the block's last entry takes its slack
                struct.pack_into("<H", block, last + 4, bs - last)
                out += block.ljust(bs, b"\0")
                block = bytearray()
            last = len(block)
            block += struct.pack("<IHBB", n, rec, len(name), ftype) + \
                name + b"\0" * (rec - 8 - len(name))
        struct.pack_into("<H", block, last + 4, bs - last)
        return bytes(out + block.ljust(bs, b"\0"))

    for rel in sorted(dirs):
        parent = rel.rpartition("/")[0] if rel else ""
        data = dir_bytes(rel, parent)
        start, count = alloc(data)
        subdirs = sum(1 for c in dirs[rel].values() if c in dirs)
        put_inode(ino[rel], _S_IFDIR | 0o755, len(data), start, count,
                  2 + subdirs)
    for rel in sorted(files):
        start, count = alloc(files[rel])
        put_inode(ino[rel], _S_IFREG | 0o644, len(files[rel]), start,
                  count, 1)
    for g in range(n_groups):
        struct.pack_into("<III", img, gdt * bs + 32 * g, 0, 0,
                         itable + g * itable_blocks)
    sb = 1024
    struct.pack_into(
        "<IIIIIIIIIIIIIHHHHHH", img, sb, ipg * n_groups, n_blocks, 0,
        n_blocks - next_free, ipg * n_groups - max_ino, first_data,
        bs.bit_length() - 11, bs.bit_length() - 11, per_group, per_group,
        ipg, 0, 0, 0, 0xFFFF, 0xEF53, 1, 1, 0)
    struct.pack_into("<IIIIHHIHHII", img, sb + 64, 0, 0, 0, 1, 0, 0,
                     _FIRST_INO, _INODE_SIZE, 0, 0,
                     _INCOMPAT_FILETYPE | _INCOMPAT_EXTENTS)
    return bytes(img)


def mbr_disk(fs: bytes, start_lba: int = 2048) -> bytes:
    """A disk with an MBR partition table whose one Linux partition,
    from `start_lba`, holds `fs`."""
    head = bytearray(start_lba * SECTOR)
    head[446:462] = struct.pack("<8BII", 0, 0, 0, 0, 0x83, 0, 0, 0,
                                start_lba, -(-len(fs) // SECTOR))
    head[510:512] = b"\x55\xaa"
    return bytes(head) + fs


def gpt_disk(fs: bytes, first_lba: int = 2048) -> bytes:
    """A disk with a GPT (protective MBR, header and entry CRCs) whose
    one partition, from `first_lba`, holds `fs`."""
    entry = bytearray(128)
    entry[0:16] = b"\x01" * 16            # partition type GUID
    entry[16:32] = b"\x02" * 16           # unique GUID
    struct.pack_into("<QQ", entry, 32, first_lba,
                     first_lba + -(-len(fs) // SECTOR) - 1)
    entries = bytes(entry) + b"\0" * (127 * 128)
    hdr = bytearray(92)
    hdr[0:8] = b"EFI PART"
    struct.pack_into("<IIIIQ", hdr, 8, 0x00010000, 92, 0, 0, 1)
    struct.pack_into("<QII", hdr, 72, 2, 128, 128)
    struct.pack_into("<I", hdr, 88, zlib.crc32(entries) & 0xFFFFFFFF)
    struct.pack_into("<I", hdr, 16, zlib.crc32(bytes(hdr)) & 0xFFFFFFFF)
    disk = bytearray(first_lba * SECTOR)
    disk[446 + 4] = 0xEE                  # the protective MBR's partition
    disk[510:512] = b"\x55\xaa"
    disk[SECTOR:SECTOR + 92] = hdr
    disk[2 * SECTOR:2 * SECTOR + len(entries)] = entries
    return bytes(disk) + fs


def vmdk_sparse(disk: bytes, grain_sectors: int = 128,
                num_gtes: int = 512) -> bytes:
    """`disk` as a VMware monolithic-sparse VMDK extent: header, grain
    directory, grain tables, then the grains that are not all zeros
    (a zero grain is left unallocated, as VMware leaves it)."""
    grain = grain_sectors * SECTOR
    capacity = -(-len(disk) // SECTOR)
    n_grains = -(-capacity // grain_sectors)
    n_gts = -(-n_grains // num_gtes)
    gd_off = 1
    gd_sectors = -(-4 * n_gts // SECTOR)
    gt_off = gd_off + gd_sectors
    gt_sectors = 4 * num_gtes // SECTOR
    data_off = gt_off + n_gts * gt_sectors
    gts = [[0] * num_gtes for _ in range(n_gts)]
    grains, sector = [], data_off
    for g in range(n_grains):
        chunk = disk[g * grain:(g + 1) * grain]
        if not chunk.strip(b"\0"):
            continue
        gts[g // num_gtes][g % num_gtes] = sector
        grains.append(chunk.ljust(grain, b"\0"))
        sector += grain_sectors
    hdr = b"KDMV" + struct.pack("<IIQQQQIQQQ", 1, 3, capacity,
                                grain_sectors, 0, 0, num_gtes, 0, gd_off,
                                data_off)
    gd = struct.pack(f"<{n_gts}I", *(gt_off + i * gt_sectors
                                     for i in range(n_gts)))
    return b"".join([hdr.ljust(SECTOR, b"\0"),
                     gd.ljust(gd_sectors * SECTOR, b"\0"),
                     *(struct.pack(f"<{num_gtes}I", *gt) for gt in gts),
                     *grains])


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


class _LoopbackServer:
    """A ThreadingHTTPServer on 127.0.0.1 in a daemon thread, started
    by start() (→ its base URL) or a with block."""

    _handler: type = BaseHTTPRequestHandler
    _srv = None

    def start(self) -> str:
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), self._handler)
        self._srv.daemon_threads = True
        self._srv.fake = self
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         name=type(self).__name__, daemon=True).start()
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


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, code: int, body: bytes = b"",
               ctype: str = "application/octet-stream", extra=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)


class _OCIHandler(_Handler):
    def do_GET(self):
        reg = self.server.fake
        reg.requests.append(self.path)
        if self.path.startswith("/token"):
            return self._reply(200, json.dumps(
                {"token": reg.token}).encode(), "application/json")
        if reg.token and self.headers.get("Authorization") != \
                f"Bearer {reg.token}":
            return self._reply(401, b"", "application/json", extra=[(
                "WWW-Authenticate",
                f'Bearer realm="http://127.0.0.1:{reg.port}/token"'
                f',service="fixture",scope="repository:pull"')])
        found = reg._lookup(self.path)
        if found is None:
            return self._reply(404, b'{"errors":[{"code":"UNKNOWN"}]}',
                               "application/json")
        self._reply(200, found[1], found[0])


class OCIRegistry(_LoopbackServer):
    """An in-process OCI distribution registry (API v2: GET of manifests
    and blobs) on 127.0.0.1, for tests and the chip smoke run. With a
    `token` every request needs `Authorization: Bearer <token>`; a 401
    names the token endpoint (/token) that hands it out. `requests`
    records each path asked for; tamper with a blob by rewriting
    `blobs[digest]`."""

    _handler = _OCIHandler

    def __init__(self, token: str = ""):
        self.token = token
        self.blobs: dict[str, bytes] = {}
        # (repo, reference) → (media type, manifest bytes)
        self.manifests: dict[tuple[str, str], tuple[str, bytes]] = {}
        self.requests: list[str] = []
        self.port = 0

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

class FakeRedis:
    """A tiny RESP2 server on 127.0.0.1 (SET, GET, EXISTS, DEL, RENAME,
    SCAN, AUTH, SELECT): enough of Redis for fanal.redis_cache and the
    Redis memo. It serves from construction; `data` holds the keys as
    bytes; drop_connections() closes every connection it accepted, as
    a Redis that went away would."""

    def __init__(self, password: str = ""):
        self.data: dict[bytes, bytes] = {}
        self.password = password
        self._conns: list = []
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.url = f"redis://127.0.0.1:{self.port}"
        threading.Thread(target=self._serve, name="fake-redis",
                         daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        buf = b""
        authed = not self.password
        while True:
            try:
                chunk = conn.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while True:
                cmd, rest = self._parse(buf)
                if cmd is None:
                    break
                buf = rest
                reply, authed = self._dispatch(cmd, authed)
                try:
                    conn.sendall(reply)
                except OSError:
                    return

    @staticmethod
    def _parse(buf: bytes):
        """One whole command off the front of `buf` → (its arguments,
        the rest), or (None, buf) until more bytes arrive."""
        if not buf.startswith(b"*"):
            return None, buf
        try:
            head, rest = buf.split(b"\r\n", 1)
            args = []
            for _ in range(int(head[1:])):
                if not rest.startswith(b"$"):
                    return None, buf
                lhead, rest2 = rest.split(b"\r\n", 1)
                n = int(lhead[1:])
                if len(rest2) < n + 2:
                    return None, buf
                args.append(rest2[:n])
                rest = rest2[n + 2:]
            return args, rest
        except (ValueError, IndexError):
            return None, buf

    def _dispatch(self, args: list, authed: bool) -> tuple:
        cmd = args[0].decode().upper()
        if cmd == "AUTH":
            if args[1].decode() == self.password:
                return b"+OK\r\n", True
            return b"-ERR invalid password\r\n", authed
        if not authed:
            return b"-NOAUTH Authentication required.\r\n", authed
        if cmd == "SELECT":
            return b"+OK\r\n", authed
        if cmd == "SET":
            self.data[args[1]] = args[2]
            return b"+OK\r\n", authed
        if cmd == "GET":
            v = self.data.get(args[1])
            if v is None:
                return b"$-1\r\n", authed
            return b"$%d\r\n%s\r\n" % (len(v), v), authed
        if cmd == "EXISTS":
            return b":%d\r\n" % (args[1] in self.data), authed
        if cmd == "DEL":
            return b":%d\r\n" % (self.data.pop(args[1], None)
                                  is not None), authed
        if cmd == "RENAME":
            v = self.data.pop(args[1], None)
            if v is None:
                return b"-ERR no such key\r\n", authed
            self.data[args[2]] = v
            return b"+OK\r\n", authed
        if cmd == "SCAN":
            pat = b"*"
            for i, a in enumerate(args):
                if a.upper() == b"MATCH":
                    pat = args[i + 1]
            keys = [k for k in self.data
                    if fnmatch.fnmatch(k.decode(), pat.decode())]
            out = b"*2\r\n$1\r\n0\r\n*%d\r\n" % len(keys)
            for k in keys:
                out += b"$%d\r\n%s\r\n" % (len(k), k)
            return out, authed
        return b"-ERR unknown command\r\n", authed

    def drop_connections(self) -> None:
        for conn in self._conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
                conn.close()
            except OSError:
                pass
        self._conns.clear()

    def close(self) -> None:
        self.sock.close()
        self.drop_connections()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _S3Handler(_Handler):
    def _refused(self) -> bool:
        fake = self.server.fake
        if fake.fail:
            self._reply(fake.fail, b"InternalError")
            return True
        if not (self.headers.get("Authorization") or "").startswith(
                "AWS4-HMAC-SHA256"):
            fake.unsigned += 1
            self._reply(403, b"AccessDenied")
            return True
        return False

    def do_PUT(self):
        if self._refused():
            return
        n = int(self.headers.get("Content-Length", "0"))
        self.server.fake.objects[self.path] = self.rfile.read(n)
        self._reply(200)

    def do_GET(self):
        if self._refused():
            return
        body = self.server.fake.objects.get(self.path)
        if body is None:
            self._reply(404, b"NoSuchKey")
        else:
            self._reply(200, body)

    def do_HEAD(self):
        if self._refused():
            return
        self._reply(200 if self.path in self.server.fake.objects else 404)

    def do_DELETE(self):
        if self._refused():
            return
        self.server.fake.objects.pop(self.path, None)
        self._reply(204)


class FakeS3(_LoopbackServer):
    """An S3 endpoint on 127.0.0.1 (PUT, GET, HEAD, DELETE of objects
    by path, `/bucket/key`) that refuses, 403, any request not signed
    with AWS4-HMAC-SHA256 (counted in `unsigned`); with `fail` set to
    a status code it answers every request with it. Give its base URL
    as the `endpoint` of an s3:// cache URL."""

    _handler = _S3Handler

    def __init__(self):
        self.objects: dict[str, bytes] = {}
        self.fail = 0
        self.unsigned = 0

    def url(self, bucket: str, prefix: str = "",
            region: str = "us-east-1") -> str:
        """The s3:// cache URL of `bucket`/`prefix` on this endpoint."""
        path = f"/{prefix}" if prefix else ""
        return (f"s3://{bucket}{path}?region={region}"
                f"&endpoint=http://127.0.0.1:{self.port}")


class _RekorHandler(_Handler):
    def do_POST(self):
        fake = self.server.fake
        req = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length", 0))) or b"{}")
        if fake.fail:
            return self._reply(fake.fail, b'{"message":"internal"}',
                               "application/json")
        if self.path == "/api/v1/index/retrieve":
            digest = req.get("hash", "")
            fake.searches.append(digest)
            if fake.attestation(digest) is None:
                body = []
            else:
                eid = FakeRekor.entry_id(digest)
                fake.entries[eid] = digest
                body = [eid]
        elif self.path == "/api/v1/log/entries/retrieve":
            body = [{eid: {"attestation": {"data": base64.b64encode(
                json.dumps(fake.attestation(fake.entries[eid])).encode()
            ).decode()}, "body": ""}}
                for eid in req.get("entryUUIDs", []) if eid in fake.entries]
        else:
            return self._reply(404, b"{}", "application/json")
        self._reply(200, json.dumps(body).encode(), "application/json")


class FakeRekor(_LoopbackServer):
    """The two Rekor endpoints the scans ask (index/retrieve and
    log/entries/retrieve) on 127.0.0.1, over `attestations`, a map from
    a digest ("sha256:...") to the attestation (a DSSE envelope or an
    in-toto statement, as JSON) logged for it, and `default`, when
    given, logged for every other digest. `searches` records each
    digest asked for; with `fail` set to a status code every request
    gets it."""

    _handler = _RekorHandler

    def __init__(self, attestations: dict | None = None,
                 default: dict | None = None):
        self.attestations = dict(attestations or {})
        self.default = default
        self.searches: list[str] = []
        self.entries: dict[str, str] = {}   # entry id → digest
        self.fail = 0

    def attestation(self, digest: str):
        return self.attestations.get(digest, self.default)

    @staticmethod
    def entry_id(digest: str) -> str:
        """A digest's entry id: a fixed tree id and a UUID from the
        digest."""
        return "24296fb24b8ad77a" + hashlib.sha256(
            digest.encode()).hexdigest()


def intoto_envelope(predicate: dict,
                    predicate_type: str = "https://cyclonedx.org/bom",
                    subject_digest: str = "") -> dict:
    """A DSSE envelope around an in-toto statement of `predicate` (an
    SBOM document), as cosign attests one."""
    statement = {
        "_type": "https://in-toto.io/Statement/v0.1",
        "predicateType": predicate_type,
        "subject": [{"name": "artifact", "digest": {
            "sha256": subject_digest.removeprefix("sha256:")}}]
        if subject_digest else [],
        "predicate": predicate}
    return {"payloadType": "application/vnd.in-toto+json",
            "payload": base64.b64encode(
                json.dumps(statement).encode()).decode(),
            "signatures": [{"keyid": "", "sig": "ZmFrZQ=="}]}
