"""Red Hat family OS analyzers.

Mirrors pkg/fanal/analyzer/os/{redhatbase,amazonlinux,mariner}:
- etc/redhat-release: "<distro> release <version>" → centos/rocky/alma/
  oracle/fedora/redhat family;
- etc/system-release + usr/lib/system-release: Amazon Linux;
- etc/mariner-release: CBL-Mariner.
"""

from __future__ import annotations

import re
from typing import Optional

from ... import types as T
from . import AnalysisResult, Analyzer, register

_REDHAT_RE = re.compile(r"(.*) release (\d[\d.]*)")

_FAMILY = {
    "centos": T.OSFamily.CENTOS, "centos linux": T.OSFamily.CENTOS,
    "centos stream": T.OSFamily.CENTOS,
    "rocky": T.OSFamily.ROCKY, "rocky linux": T.OSFamily.ROCKY,
    "alma": T.OSFamily.ALMA, "almalinux": T.OSFamily.ALMA,
    "alma linux": T.OSFamily.ALMA,
    "oracle": T.OSFamily.ORACLE, "oracle linux": T.OSFamily.ORACLE,
    "oracle linux server": T.OSFamily.ORACLE,
    "fedora": T.OSFamily.FEDORA, "fedora linux": T.OSFamily.FEDORA,
}


@register
class RedHatBaseAnalyzer(Analyzer):
    """One analyzer for the whole redhat-base family: the reference
    registers a separate analyzer per release file (redhatbase/
    {redhatbase,centos,alma,rocky,oracle,fedora}.go) but all share the
    same "<distro> release <version>" parse; the distro word in the
    file decides the family either way."""
    name = "redhatbase"
    version = 2  # v2: centos/alma/rocky/oracle/fedora release files
    paths = ("etc/redhat-release", "etc/centos-release",
             "etc/almalinux-release", "etc/rocky-release",
             "etc/oracle-release", "etc/fedora-release")

    def required(self, path: str, size: int = -1) -> bool:
        return path in self.paths

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        for line in content.decode(errors="replace").splitlines():
            m = _REDHAT_RE.search(line.strip())
            if not m:
                continue
            distro = m.group(1).lower()
            for key, family in _FAMILY.items():
                if distro.startswith(key):
                    return AnalysisResult(os=T.OS(family=family,
                                                  name=m.group(2)))
            return AnalysisResult(os=T.OS(family=T.OSFamily.REDHAT,
                                          name=m.group(2)))
        return None


@register
class AmazonLinuxAnalyzer(Analyzer):
    name = "amazonlinux"
    version = 1
    paths = ("etc/system-release", "usr/lib/system-release")

    def required(self, path: str, size: int = -1) -> bool:
        return path in self.paths

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        for line in content.decode(errors="replace").splitlines():
            fields = line.split()
            if line.startswith("Amazon Linux release 2"):
                if len(fields) < 5:
                    continue
                return AnalysisResult(os=T.OS(
                    family=T.OSFamily.AMAZON,
                    name=" ".join(fields[3:])))
            if line.startswith("Amazon Linux"):
                return AnalysisResult(os=T.OS(
                    family=T.OSFamily.AMAZON,
                    name=" ".join(fields[2:])))
        return None


@register
class MarinerAnalyzer(Analyzer):
    name = "mariner"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path == "etc/mariner-release"

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        # "CBL-Mariner 2.0.20220226"
        for line in content.decode(errors="replace").splitlines():
            if "CBL-Mariner" in line:
                ver = line.split("CBL-Mariner")[-1].strip()
                if ver:
                    return AnalysisResult(os=T.OS(
                        family=T.OSFamily.MARINER, name=ver))
        return None


# --- Red Hat build metadata (pkg/fanal/analyzer/buildinfo) ---

_LABEL_RE = re.compile(
    r'^\s*LABEL\s+(.*)$', re.IGNORECASE)
_KV_RE = re.compile(
    r'([\w.\-]+)\s*=\s*(?:"((?:[^"\\]|\\.)*)"|(\S+))')


@register
class ContentManifestAnalyzer(Analyzer):
    """root/buildinfo/content_manifests/*.json → content sets that scope
    Red Hat OVAL v2 advisories (buildinfo/content_manifest.go)."""
    name = "redhat-content-manifest"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return (path.startswith("root/buildinfo/content_manifests/")
                and path.endswith(".json"))

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        import json as _json
        try:
            doc = _json.loads(content)
        except _json.JSONDecodeError:
            return None
        sets = doc.get("content_sets") or []
        if not sets:
            return None
        return AnalysisResult(build_info=T.BuildInfo(content_sets=sets))


@register
class BuildInfoDockerfileAnalyzer(Analyzer):
    """root/buildinfo/Dockerfile-<name>-<ver>-<rel>: LABEL
    com.redhat.component + architecture → NVR-arch for advisory scoping
    (buildinfo/dockerfile.go; literal-label subset of the buildkit
    parse)."""
    name = "redhat-dockerfile"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        dirname, _, base = path.rpartition("/")
        return dirname == "root/buildinfo" and base.startswith("Dockerfile")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        component = arch = ""
        text = content.decode(errors="replace")
        # join line continuations
        text = re.sub(r"\\\r?\n", " ", text)
        for line in text.splitlines():
            m = _LABEL_RE.match(line)
            if not m:
                continue
            for key, dq, bare in _KV_RE.findall(m.group(1)):
                val = dq if dq else bare
                k = key.lower().strip('"')
                if k in ("com.redhat.component", "bzcomponent"):
                    component = val
                elif k == "architecture":
                    arch = val
        if not component or not arch:
            return None
        base = path.rpartition("/")[2]
        # version-release comes from the file name's last two dashes
        # (dockerfile.go parseVersion)
        nvr_tail = base.split("Dockerfile-", 1)[-1]
        ri = nvr_tail.rfind("-")
        vi = nvr_tail[:ri].rfind("-") if ri > 0 else -1
        version = nvr_tail[vi + 1:] if ri > 0 else ""
        return AnalysisResult(build_info=T.BuildInfo(
            nvr=f"{component}-{version}" if version else component,
            arch=arch))
