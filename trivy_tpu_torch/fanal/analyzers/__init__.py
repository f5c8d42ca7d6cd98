"""Analyzer registry & dispatch.

Mirrors pkg/fanal/analyzer/analyzer.go: each analyzer declares the paths
it needs (`required`) and produces a partial AnalysisResult; the group
merges results. Analyzer versions participate in cache keys so cached
blobs invalidate when an analyzer changes (pkg/fanal/cache/key.go:18-60).
The port registers the OS-release, apk, dpkg, rpm and Red Hat analyzers,
the language lockfile analyzers (lockfiles.py, lockfiles_extra.py, pip)
and the installed-package ones (python-pkg, conda-pkg, gobinary, jar,
node-pkg, gemspec, rustbinary), the in-image `sbom` analyzer and the
opt-in `license-file` one. executable (ROADMAP A5) and misconf (A4) are
not ported."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ... import types as T


@dataclass
class AnalysisResult:
    os: Optional[T.OS] = None
    repository: Optional[T.Repository] = None
    package_infos: list = field(default_factory=list)
    applications: list = field(default_factory=list)
    licenses: list = field(default_factory=list)   # [DetectedLicense]
    # files owned by the OS package manager; consumed by the system-file
    # filter post-handler (reference analyzer.AnalysisResult
    # SystemInstalledFiles)
    system_installed_files: list = field(default_factory=list)
    build_info: Optional[T.BuildInfo] = None  # Red Hat content sets, nvr

    def merge(self, other: "AnalysisResult"):
        if other is None:
            return
        if other.os is not None:
            if self.os is None:
                self.os = other.os
            else:
                self.os.merge(other.os)
        if other.repository is not None:
            self.repository = other.repository
        self.package_infos.extend(other.package_infos)
        self.applications.extend(other.applications)
        self.licenses.extend(other.licenses)
        self.system_installed_files.extend(other.system_installed_files)
        if other.build_info is not None:
            if self.build_info is None:
                self.build_info = other.build_info
            else:  # merge content sets with nvr/arch (analyzer.go Merge)
                bi, obi = self.build_info, other.build_info
                bi.content_sets = bi.content_sets or obi.content_sets
                bi.nvr = bi.nvr or obi.nvr
                bi.arch = bi.arch or obi.arch


class Analyzer:
    """Base: subclasses set `name` and `version` and implement
    required(path) / analyze(path, content)."""
    name = "base"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        raise NotImplementedError

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        raise NotImplementedError


class PostAnalyzer:
    """Multi-file analyzer run after the walk over all collected files
    (reference pkg/fanal/analyzer PostAnalyzer over a composite FS), for
    results that need several files at once."""
    name = "base-post"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        raise NotImplementedError

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        raise NotImplementedError


_REGISTRY: dict[str, type] = {}
_POST_REGISTRY: dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


def register_post(cls):
    _POST_REGISTRY[cls.name] = cls
    return cls


def _ensure_loaded():
    from . import (apk, binaries, dpkg, license_file,  # noqa: F401
                   lockfiles, lockfiles_extra, os_release, python,
                   redhat, rpm, sbom)


# analyzers that are opt-in everywhere (reference: license scanning is
# behind --license-full); excluded from every AnalyzerGroup unless the
# caller lists them in `enabled`
OPTIN_ANALYZERS = ("license-file", "executable")

# analyzer groups disabled per target kind (reference run.go:167-224:
# image disables lockfiles; fs disables individual-package + SBOM;
# rootfs disables lockfiles; repo disables OS + individual + SBOM;
# const.go TypeIndividualPkgs / TypeLockfiles / TypeOSes)
INDIVIDUAL_PKG_ANALYZERS = ("gemspec", "node-pkg", "conda-pkg",
                            "python-pkg", "gobinary", "jar", "rustbinary")
LOCKFILE_ANALYZERS = ("bundler", "npm", "yarn", "pnpm", "pip", "pipenv",
                      "poetry", "gomod", "pom", "conan",
                      "gradle-lockfile", "cocoapods", "swift", "pub",
                      "mix-lock")
OS_ANALYZERS = ("os-release", "alpine", "amazonlinux", "mariner",
                "debian", "redhatbase", "ubuntu", "apk", "dpkg", "rpm",
                "rpmqa", "apk-repo", "redhat-content-manifest",
                "redhat-dockerfile")


class AnalyzerGroup:
    def __init__(self, disabled: tuple = (), enabled: tuple = ()):
        _ensure_loaded()
        off = set(disabled) | (set(OPTIN_ANALYZERS) - set(enabled))
        self.analyzers = [cls() for name, cls in sorted(_REGISTRY.items())
                          if name not in off]
        self.post_analyzers = [
            cls() for name, cls in sorted(_POST_REGISTRY.items())
            if name not in off]

    def versions(self) -> dict[str, int]:
        """name → version, for cache keys."""
        out = {a.name: a.version for a in self.analyzers}
        out.update({a.name: a.version for a in self.post_analyzers})
        return out

    def required(self, path: str, size: int = -1) -> bool:
        return any(a.required(path, size) for a in self.analyzers)

    def post_required(self, path: str, size: int = -1) -> bool:
        return any(a.required(path, size) for a in self.post_analyzers)

    def analyze_file(self, path: str, content: bytes,
                     result: AnalysisResult) -> None:
        for a in self.analyzers:
            if a.required(path, len(content)):
                r = a.analyze(path, content)
                if r is not None:
                    result.merge(r)

    def post_analyze(self, files: dict, result: AnalysisResult) -> None:
        for a in self.post_analyzers:
            subset = {p: c for p, c in files.items() if a.required(p, -1)}
            if subset:
                r = a.post_analyze(subset)
                if r is not None:
                    result.merge(r)
