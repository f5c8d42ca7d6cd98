"""Python installed-package analyzers.

Mirrors pkg/fanal/analyzer/language/python/packaging (egg/wheel METADATA →
Application type "python-pkg") and the pip lockfile analyzer
(requirements.txt → type "pip")."""

from __future__ import annotations

import re
from typing import Optional

from ... import types as T
from . import AnalysisResult, Analyzer, register

_DIST_INFO = re.compile(r"\.(dist-info|egg-info)/(METADATA|PKG-INFO)$")


@register
class PythonPackagingAnalyzer(Analyzer):
    name = "python-pkg"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return bool(_DIST_INFO.search(path)) or path.endswith(".egg-info")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        name = version = license_ = ""
        for line in content.decode(errors="replace").splitlines():
            if line == "":
                break  # headers end at first blank line
            if line.startswith("Name:"):
                name = line[5:].strip()
            elif line.startswith("Version:"):
                version = line[8:].strip()
            elif line.startswith("License:"):
                license_ = line[8:].strip()
        if not name or not version:
            return None
        pkg = T.Package(id=f"{name}@{version}", name=name, version=version,
                        file_path=path,
                        licenses=[license_] if license_ and
                        license_ != "UNKNOWN" else [])
        return AnalysisResult(applications=[
            T.Application(type="python-pkg", file_path=path, packages=[pkg])])


_REQ_LINE = re.compile(r"^([A-Za-z0-9._-]+)\s*==\s*([A-Za-z0-9._!+-]+)")


@register
class PipRequirementsAnalyzer(Analyzer):
    name = "pip"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith("requirements.txt")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        pkgs = []
        for line in content.decode(errors="replace").splitlines():
            m = _REQ_LINE.match(line.strip())
            if m:
                # requirements.txt entries carry no lockfile identity:
                # the reference pip parser leaves ID empty
                # (pip.json.golden packages have no "ID")
                pkgs.append(T.Package(name=m.group(1), version=m.group(2)))
        if not pkgs:
            return None
        return AnalysisResult(applications=[
            T.Application(type="pip", file_path=path, packages=pkgs)])
