"""Unpackaged-executable digests (reference
pkg/fanal/analyzer/executable/executable.go): the SHA-256 of every ELF,
Mach-O or PE file, so the unpackaged post-handler can look its SBOM
attestation up in Rekor. Opt-in as in the reference: the CLI enables it
only under --sbom-sources rekor (run.go:464-523 disables TypeExecutable
otherwise)."""

from __future__ import annotations

import hashlib
from typing import Optional

from . import AnalysisResult, Analyzer, register

_MAGIC = (b"\x7fELF", b"MZ\x90\x00", b"\xfe\xed\xfa\xce",
          b"\xfe\xed\xfa\xcf", b"\xcf\xfa\xed\xfe")


@register
class ExecutableAnalyzer(Analyzer):
    name = "executable"
    version = 1

    # extensions that are never native executables; every other name
    # (dotted ones such as python3.11 too) has its magic read
    _SKIP_EXT = frozenset((
        "txt", "md", "json", "yaml", "yml", "xml", "html", "css",
        "js", "ts", "py", "rb", "sh", "pl", "php", "go", "rs", "c",
        "h", "cpp", "java", "conf", "cfg", "toml", "ini", "env",
        "pem", "crt", "key", "pub", "png", "jpg", "jpeg", "gif",
        "svg", "ico", "gz", "bz2", "xz", "zip", "tar", "tgz", "jar",
        "log", "lock", "sum", "mod", "sql", "csv", "proto"))

    def required(self, path: str, size: int = -1) -> bool:
        # a cheap name filter: the magic check in analyze() is the gate
        # (the reference reads the executable mode bit, which tar and fs
        # walks do not always keep)
        base = path.rsplit("/", 1)[-1]
        ext = base.rsplit(".", 1)[-1].lower() if "." in base else ""
        return size != 0 and ext not in self._SKIP_EXT

    def analyze(self, path: str,
                content: bytes) -> Optional[AnalysisResult]:
        if content[:4] not in _MAGIC:
            return None
        digest = "sha256:" + hashlib.sha256(content).hexdigest()
        return AnalysisResult(digests={path: digest})
