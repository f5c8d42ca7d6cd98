"""RPM installed-package analyzers.

Mirrors pkg/fanal/analyzer/pkg/rpm:
- rpm.go — the rpmdb proper. Modern rpm keeps an SQLite database
  (var/lib/rpm/rpmdb.sqlite or usr/lib/sysimage/rpm/rpmdb.sqlite) whose
  Packages table stores one binary header blob per package; the blob is
  the classic rpm "header image": int32 index-count + data-size, then
  16-byte (tag, type, offset, count) entries over a data store. We parse
  the tags the reference consumes (NAME/VERSION/RELEASE/EPOCH/ARCH/
  SOURCERPM/LICENSE/VENDOR/MODULARITYLABEL). BerkeleyDB ("Packages")
  databases predate 2020 images and are skipped with a warning.
- rpmqa.go — the CBL-Mariner distroless manifest
  (var/lib/rpmmanifest/container-manifest-2), tab-separated `rpm -qa`
  output.
"""

from __future__ import annotations

import sqlite3
import struct
import tempfile
from typing import Optional

from ... import types as T
from . import AnalysisResult, Analyzer, register

RPMDB_PATHS = (
    "usr/lib/sysimage/rpm/rpmdb.sqlite",
    "var/lib/rpm/rpmdb.sqlite",
)
BDB_PATHS = (
    "usr/lib/sysimage/rpm/Packages",
    "var/lib/rpm/Packages",
    "usr/lib/sysimage/rpm/Packages.db",
    "var/lib/rpm/Packages.db",
)

# rpm header tags (rpmtag.h)
TAG_NAME = 1000
TAG_VERSION = 1001
TAG_RELEASE = 1002
TAG_EPOCH = 1003
TAG_LICENSE = 1014
TAG_VENDOR = 1011
TAG_ARCH = 1022
TAG_SOURCERPM = 1044
TAG_MODULARITYLABEL = 5096
TAG_DIRINDEXES = 1116
TAG_BASENAMES = 1117
TAG_DIRNAMES = 1118

_T_CHAR, _T_INT8, _T_INT16, _T_INT32, _T_INT64 = 1, 2, 3, 4, 5
_T_STRING, _T_BIN, _T_STRING_ARRAY, _T_I18NSTRING = 6, 7, 8, 9


def parse_header_blob(blob: bytes) -> dict:
    """rpm header image → {tag: value}."""
    if len(blob) < 8:
        return {}
    il, dl = struct.unpack(">ii", blob[:8])
    if il < 0 or dl < 0 or 8 + 16 * il + dl > len(blob) + 8:
        return {}
    store_off = 8 + 16 * il
    store = blob[store_off:store_off + dl]
    out = {}
    for i in range(il):
        tag, typ, off, cnt = struct.unpack(
            ">iiii", blob[8 + 16 * i:8 + 16 * (i + 1)])
        if off < 0 or off > len(store):
            continue
        try:
            out[tag] = _read_value(store, typ, off, cnt)
        except (struct.error, UnicodeDecodeError, IndexError):
            continue
    return out


def _read_value(store: bytes, typ: int, off: int, cnt: int):
    if typ in (_T_STRING, _T_I18NSTRING):
        end = store.index(b"\x00", off)
        return store[off:end].decode(errors="replace")
    if typ == _T_STRING_ARRAY:
        vals, p = [], off
        for _ in range(cnt):
            end = store.index(b"\x00", p)
            vals.append(store[p:end].decode(errors="replace"))
            p = end + 1
        return vals
    if typ == _T_INT32:
        return list(struct.unpack_from(f">{cnt}i", store, off)) \
            if cnt > 1 else struct.unpack_from(">i", store, off)[0]
    if typ == _T_INT16:
        return struct.unpack_from(">h", store, off)[0]
    if typ == _T_INT64:
        return struct.unpack_from(">q", store, off)[0]
    if typ in (_T_CHAR, _T_INT8):
        return store[off]
    if typ == _T_BIN:
        return store[off:off + cnt]
    return None


def split_source_rpm(source_rpm: str):
    """"bash-5.1.8-4.el9.src.rpm" → (name, version, release)
    (reference rpm/rpm.go splitFileName)."""
    s = source_rpm
    if s.endswith(".rpm"):
        s = s[:-4]
    for suffix in (".src", ".nosrc"):
        if s.endswith(suffix):
            s = s[:-len(suffix)]
    try:
        rest, release = s.rsplit("-", 1)
        name, version = rest.rsplit("-", 1)
    except ValueError:
        return "", "", ""
    return name, version, release


def _header_to_pkg(h: dict) -> Optional[T.Package]:
    name = h.get(TAG_NAME, "")
    version = h.get(TAG_VERSION, "")
    release = h.get(TAG_RELEASE, "")
    if not name or not version:
        return None
    epoch = h.get(TAG_EPOCH) or 0
    if isinstance(epoch, list):
        epoch = epoch[0] if epoch else 0
    src_name = src_ver = src_rel = ""
    src = h.get(TAG_SOURCERPM, "")
    if src and src != "(none)":
        src_name, src_ver, src_rel = split_source_rpm(src)
    pkg = T.Package(
        id=f"{name}@{version}-{release}",
        name=name, version=version, release=release, epoch=int(epoch),
        arch=h.get(TAG_ARCH, "") or "",
        src_name=src_name or name,
        src_version=src_ver or version,
        src_release=src_rel or release,
        src_epoch=int(epoch),
        maintainer=h.get(TAG_VENDOR, "") or "",
        modularitylabel=h.get(TAG_MODULARITYLABEL, "") or "",
    )
    lic = h.get(TAG_LICENSE, "")
    if lic:
        pkg.licenses = [lic]
    pkg.installed_files = _header_files(h)
    return pkg


def _header_files(h: dict) -> list:
    """Reassemble installed file paths from the dirnames/basenames/
    dirindexes triple (rpm.go:188-200 via go-rpmdb InstalledFiles)."""
    basenames = h.get(TAG_BASENAMES) or []
    dirnames = h.get(TAG_DIRNAMES) or []
    dirindexes = h.get(TAG_DIRINDEXES)
    if isinstance(dirindexes, int):
        dirindexes = [dirindexes]
    dirindexes = dirindexes or []
    if not (basenames and dirnames) or len(dirindexes) != len(basenames):
        return []
    out = []
    for base, di in zip(basenames, dirindexes):
        if 0 <= di < len(dirnames):
            out.append(dirnames[di] + base)
    return out


@register
class RpmDBAnalyzer(Analyzer):
    name = "rpm"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path in RPMDB_PATHS or path in BDB_PATHS

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        if path in BDB_PATHS:
            # BerkeleyDB/ndb rpm databases: unsupported backend, skipped
            # (matches go-rpmdb error path behavior for unknown formats)
            return None
        if not content.startswith(b"SQLite format 3"):
            return None
        pkgs = []
        with tempfile.NamedTemporaryFile(suffix=".sqlite") as f:
            f.write(content)
            f.flush()
            try:
                conn = sqlite3.connect(f.name)
                rows = conn.execute("SELECT blob FROM Packages").fetchall()
                conn.close()
            except sqlite3.Error:
                return None
            for (blob,) in rows:
                pkg = _header_to_pkg(parse_header_blob(blob))
                if pkg is not None:
                    pkgs.append(pkg)
        if not pkgs:
            return None
        pkgs.sort(key=lambda p: p.name)
        sysfiles = [f for p in pkgs for f in p.installed_files]
        return AnalysisResult(
            package_infos=[T.PackageInfo(file_path=path, packages=pkgs)],
            system_installed_files=sysfiles)


@register
class RpmqaAnalyzer(Analyzer):
    name = "rpmqa"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path == "var/lib/rpmmanifest/container-manifest-2"

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        pkgs = []
        for line in content.decode(errors="replace").splitlines():
            s = line.split("\t")
            if len(s) != 10:
                continue
            ver_rel = s[1].split("-")
            if len(ver_rel) != 2:
                continue
            src_name, src_ver, src_rel = split_source_rpm(s[9])
            pkgs.append(T.Package(
                id=f"{s[0]}@{ver_rel[0]}-{ver_rel[1]}",
                name=s[0], version=ver_rel[0], release=ver_rel[1],
                arch=s[7],
                src_name=src_name or s[0],
                src_version=src_ver or ver_rel[0],
                src_release=src_rel or ver_rel[1],
            ))
        if not pkgs:
            return None
        return AnalysisResult(package_infos=[
            T.PackageInfo(file_path=path, packages=pkgs)])
