"""Debian/Ubuntu dpkg status parser.

Mirrors pkg/fanal/analyzer/pkg/dpkg/dpkg.go: RFC822-ish stanzas from
var/lib/dpkg/status or var/lib/dpkg/status.d/*; only packages whose
Status contains "installed" are kept; Source may carry "name (version)";
epoch/revision are split out of the version string afterwards
(dpkg.go:212-276)."""

from __future__ import annotations

import re
from typing import Optional

from ... import types as T
from ...version import deb as debver
from . import AnalysisResult, Analyzer, register

STATUS_FILE = "var/lib/dpkg/status"
STATUS_DIR = "var/lib/dpkg/status.d/"
INFO_DIR = "var/lib/dpkg/info/"

_SRC_RE = re.compile(r"^(?P<name>[^\s(]+)(?:\s+\((?P<version>.+)\))?$")


@register
class DpkgAnalyzer(Analyzer):
    name = "dpkg"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        if path == STATUS_FILE:
            return True
        if path.startswith(INFO_DIR) and path.endswith(".list"):
            return True
        return path.startswith(STATUS_DIR) and not path.endswith(".md5sums")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        if path.startswith(INFO_DIR) and path.endswith(".list"):
            # package file list (dpkg.go parseDpkgInfoList): every line
            # except the "/." root entry is a file owned by dpkg
            files = [ln for ln in content.decode(errors="replace")
                     .splitlines() if ln and ln != "/."]
            return AnalysisResult(system_installed_files=files) \
                if files else None
        pkgs = []
        for stanza in re.split(r"\n\s*\n",
                               content.decode(errors="replace")):
            pkg = self._parse_stanza(stanza)
            if pkg is not None:
                pkgs.append(pkg)
        if not pkgs:
            return None
        pkgs.sort(key=lambda p: p.name)
        return AnalysisResult(package_infos=[
            T.PackageInfo(file_path=path, packages=pkgs)])

    def _parse_stanza(self, stanza: str) -> Optional[T.Package]:
        fields: dict[str, str] = {}
        key = None
        for line in stanza.splitlines():
            if not line or line.startswith("#"):
                continue
            if line[0] in " \t":
                if key:
                    fields[key] += "\n" + line.strip()
                continue
            if ":" not in line:
                continue
            key, _, val = line.partition(":")
            key = key.strip().lower()
            fields[key] = val.strip()
        if not fields:
            return None
        status = fields.get("status", "")
        # status.d files (distroless) have no Status line: treat installed
        if "status" in fields and "installed" not in status.split():
            return None
        name, version = fields.get("package", ""), fields.get("version", "")
        if not name or not version:
            return None
        pkg = T.Package(name=name,
                        maintainer=fields.get("maintainer", ""),
                        arch=fields.get("architecture", ""))
        pkg.depends_on = _parse_depends(fields.get("depends", ""))
        src_name, src_version = name, version
        if fields.get("source"):
            m = _SRC_RE.match(fields["source"])
            if m:
                src_name = m.group("name")
                if m.group("version"):
                    src_version = m.group("version").strip()
        pkg.id = f"{name}@{version}"
        try:
            e, up, rev = debver._split(version)
        except ValueError:
            return None  # invalid version: reference drops the package
        pkg.epoch, pkg.version, pkg.release = e, up, rev
        try:
            e, up, rev = debver._split(src_version)
        except ValueError:
            return None
        pkg.src_name = src_name
        pkg.src_epoch, pkg.src_version, pkg.src_release = e, up, rev
        return pkg


def _parse_depends(val: str) -> list[str]:
    out = []
    for part in val.split(","):
        part = part.strip()
        if not part:
            continue
        # "libc6 (>= 2.34) | alt" → first alternative's bare name
        name = part.split("|")[0].split("(")[0].strip()
        if name:
            out.append(name)
    return out
