"""In-image SBOM analyzer (reference pkg/fanal/analyzer/sbom/sbom.go):
CycloneDX/SPDX documents shipped inside an artifact (e.g. bitnami's
/opt/bitnami/<comp>/.spdx-<comp>.spdx) feed their packages straight
into the scan, skipping re-analysis."""

from __future__ import annotations

import json
import os
from typing import Optional

from ... import types as T
from . import AnalysisResult, Analyzer, register

_SUFFIXES = (".cdx", ".cdx.json", ".spdx", ".spdx.json")


@register
class SbomAnalyzer(Analyzer):
    name = "sbom"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith(_SUFFIXES)

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        from ...sbom.cyclonedx import decode_cyclonedx
        from ...sbom.io import detect_format
        from ...sbom.spdx import decode_spdx
        try:
            doc = json.loads(content)
            fmt = detect_format(doc)
            detail = decode_cyclonedx(doc) if fmt == "cyclonedx" \
                else decode_spdx(doc)
        except Exception:
            # malformed in-image SBOMs are skipped like any other
            # analyzer parse failure, never abort the scan
            return None
        apps = detail.applications
        # bitnami SPDX files describe the component dir they sit in
        # (sbom.go:44-51): point file paths there
        if path.startswith("opt/bitnami/"):
            comp_dir = os.path.dirname(path)
            for app in apps:
                app.file_path = comp_dir
                for pkg in app.packages:
                    if pkg.file_path:
                        pkg.file_path = os.path.join(
                            comp_dir, os.path.basename(pkg.file_path))
        pkg_infos = ([T.PackageInfo(packages=detail.packages)]
                     if detail.packages else [])
        return AnalysisResult(package_infos=pkg_infos, applications=apps)
