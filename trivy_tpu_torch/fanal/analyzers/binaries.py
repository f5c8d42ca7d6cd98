"""Installed/binary package analyzers, the port's copy of the JAX
package's fanal/analyzers/binaries.py: Go binaries, JARs, node_modules
package.json, gemspecs.

Mirrors pkg/fanal/analyzer/language/{golang/binary, java/jar,
nodejs/pkg, ruby/gemspec}. These are "individual package" analyzers —
their applications aggregate into one result per type ("Node.js",
"Java", ...) like the reference's PkgTargets (pkg/scanner/langpkg/
scan.go:15-23)."""

from __future__ import annotations

import hashlib
import io
import json
import re
import zipfile
from typing import Optional

from ... import types as T
from ...javadb import get_db
from . import AnalysisResult, Analyzer, register
from .lockfiles import dep_id

_GO_MAGIC = b"\xff Go buildinf:"


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_go_buildinfo(content: bytes):
    """Go ≥1.18 inline buildinfo: magic, ptrSize, flags; flags&2 → two
    varint-prefixed strings (go version, module info). Module info lines:
    'dep\\t<module>\\t<version>\\t<hash>' (+ 'mod' line for the main
    module). Pre-1.18 pointer-style buildinfo is skipped."""
    idx = content.find(_GO_MAGIC)
    if idx < 0 or idx + 32 > len(content):
        return None, []
    flags = content[idx + 15]
    if not flags & 0x2:
        return None, []  # pointer-based (pre-1.18): not supported
    pos = idx + 32
    try:
        n, pos = _read_varint(content, pos)
        go_version = content[pos:pos + n].decode(errors="replace")
        pos += n
        n, pos = _read_varint(content, pos)
        modinfo = content[pos:pos + n].decode(errors="replace")
    except IndexError:
        return None, []
    pkgs = []
    for line in modinfo.split("\n"):
        parts = line.split("\t")
        if len(parts) >= 3 and parts[0] in ("dep", "=>"):
            name, version = parts[1], parts[2]
            if version.startswith("v"):
                version = version[1:]
            if version == "(devel)":
                continue
            pkgs.append((name, version))
    return go_version, pkgs


def executable_candidate(path: str) -> bool:
    """Extension-less-executable heuristic shared by the Go and Rust
    binary analyzers (the reference gates on the file mode's exec bit,
    which tar walking does surface but directory walking may not)."""
    base = path.rsplit("/", 1)[-1]
    if "." in base and not base.endswith((".bin", ".exe")):
        return False
    return any(seg in path for seg in
               ("bin/", "sbin/", "usr/local/", "app/", "opt/")) or \
        "/" not in path


@register
class GoBinaryAnalyzer(Analyzer):
    name = "gobinary"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        # executables without extension; ELF magic is sniffed in analyze
        return executable_candidate(path)

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        if content[:4] not in (b"\x7fELF", b"MZ\x90\x00") and \
                content[:4] != b"\xcf\xfa\xed\xfe":
            return None
        _, deps = parse_go_buildinfo(content)
        if not deps:
            return None
        pkgs = [T.Package(id=dep_id("gobinary", n, v), name=n, version=v,
                          file_path=path)
                for n, v in sorted(set(deps))]
        return AnalysisResult(applications=[
            T.Application(type="gobinary", file_path=path, packages=pkgs)])


_JAR_NAME = re.compile(r"^(?P<name>[A-Za-z0-9._-]+?)-"
                       r"(?P<version>\d[A-Za-z0-9._-]*?)"
                       r"(?:-(?:sources|javadoc|tests))?\.(jar|war|ear|par)$")


@register
class JarAnalyzer(Analyzer):
    """JAR/WAR/EAR identification mirrors the reference jar parser
    (pkg/dependency/parser/java/jar parseArtifact/traverseZip): nested
    pom.properties packages are always collected; if one of them matches
    the filename-derived (artifactId, version) it already names the outer
    jar, otherwise the outer jar is identified by Java-DB sha1 → GAV
    (appended to, not replacing, the nested set) and finally by filename
    heuristic with Java-DB group_id lookup; duplicates are removed at the
    end (removeLibraryDuplicates)."""
    name = "jar"
    version = 3

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith((".jar", ".war", ".ear", ".par"))

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        pkgs = []
        try:
            zf = zipfile.ZipFile(io.BytesIO(content))
        except (zipfile.BadZipFile, OSError):
            return None
        base = path.rsplit("/", 1)[-1]
        m = _JAR_NAME.match(base)
        fname_aid, fname_ver = (m.group("name"), m.group("version")) \
            if m else ("", "")
        found_pom_props = False
        props = [n for n in zf.namelist()
                 if n.endswith("pom.properties")]
        for name in props:
            try:
                kv = dict(
                    line.split("=", 1)
                    for line in zf.read(name).decode(
                        errors="replace").splitlines()
                    if "=" in line and not line.startswith("#"))
            except (KeyError, OSError):
                continue
            gid, aid, ver = (kv.get("groupId", "").strip(),
                             kv.get("artifactId", "").strip(),
                             kv.get("version", "").strip())
            if gid and aid and ver:
                full = f"{gid}:{aid}"
                pkgs.append(T.Package(id=f"{full}:{ver}", name=full,
                                      version=ver, file_path=path))
                if aid == fname_aid and ver == fname_ver:
                    found_pom_props = True
        jdb = get_db()
        if not found_pom_props:
            hit = None
            if jdb is not None:
                digest = hashlib.sha1(content).hexdigest()  # noqa: S324
                hit = jdb.search_by_sha1(digest)
            if hit:
                gid, aid, ver = hit
                full = f"{gid}:{aid}"
                pkgs.append(T.Package(id=f"{full}:{ver}", name=full,
                                      version=ver, file_path=path))
            elif fname_aid and fname_ver:
                name, version = fname_aid, fname_ver
                if jdb is not None:
                    gid = jdb.search_by_artifact_id(name, version)
                    if gid:
                        name = f"{gid}:{name}"
                pkgs.append(T.Package(
                    id=f"{name}:{version}",
                    name=name, version=version,
                    file_path=path))
        seen = set()
        pkgs = [p for p in pkgs
                if p.id not in seen and not seen.add(p.id)]
        if not pkgs:
            return None
        return AnalysisResult(applications=[
            T.Application(type="jar", file_path=path, packages=pkgs)])


@register
class NodePkgAnalyzer(Analyzer):
    """Installed node packages (node_modules/*/package.json)."""
    name = "node-pkg"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return "node_modules/" in path and path.endswith("/package.json")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            doc = json.loads(content)
        except json.JSONDecodeError:
            return None
        name, version = doc.get("name"), doc.get("version")
        if (not name or not version or not isinstance(name, str)
                or not isinstance(version, str)):
            return None
        lic = doc.get("license")
        if isinstance(lic, dict):
            lic = lic.get("type", "")
        pkg = T.Package(id=f"{name}@{version}", name=name, version=version,
                        file_path=path,
                        licenses=[lic] if isinstance(lic, str) and lic
                        else [])
        return AnalysisResult(applications=[
            T.Application(type="node-pkg", file_path=path, packages=[pkg])])


_GEMSPEC_ATTR = re.compile(
    r"\.\s*(?P<key>name|version)\s*=\s*"
    r"(?:\"(?P<dq>[^\"]+)\"|'(?P<sq>[^']+)')")


@register
class GemspecAnalyzer(Analyzer):
    """Installed gems (specifications/*.gemspec)."""
    name = "gemspec"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith(".gemspec") and "specifications/" in path

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        name = version = ""
        for line in content.decode(errors="replace").splitlines():
            m = _GEMSPEC_ATTR.search(line)
            if not m:
                continue
            val = (m.group("dq") or m.group("sq") or "").removesuffix(
                ".freeze")
            if m.group("key") == "name" and not name:
                name = val
            elif m.group("key") == "version" and not version:
                version = val
        if not name or not version:
            return None
        pkg = T.Package(id=f"{name}@{version}", name=name, version=version,
                        file_path=path)
        return AnalysisResult(applications=[
            T.Application(type="gemspec", file_path=path, packages=[pkg])])
