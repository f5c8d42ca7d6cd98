"""Full-text license file classification (reference
pkg/fanal/analyzer/licensing/license.go, --license-full): LICENSE /
COPYING / NOTICE files are classified by distinctive-phrase scoring
(licensing.classify_text) into DetectedLicense findings.

Disabled by default like the reference (license scanning is opt-in via
--license-full, which adds it to the group's enabled set)."""

from __future__ import annotations

from typing import Optional

from ... import types as T
from ...licensing import LICENSE_FILE_NAMES, classify_license_file
from . import AnalysisResult, Analyzer, register


@register
class LicenseFileAnalyzer(Analyzer):
    name = "license-file"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.rsplit("/", 1)[-1].lower() in LICENSE_FILE_NAMES

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        findings = classify_license_file(path, content)
        if not findings:
            return None
        return AnalysisResult(licenses=findings)
