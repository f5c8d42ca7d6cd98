"""Analyzer registry & dispatch.

Mirrors pkg/fanal/analyzer/analyzer.go: each analyzer declares the paths
it needs (`required`) and produces a partial AnalysisResult; the group
merges results. Analyzer versions participate in cache keys so cached
blobs invalidate when an analyzer changes (pkg/fanal/cache/key.go:18-60).
The port registers the OS-release, apk, dpkg, rpm and Red Hat analyzers,
the language lockfile analyzers (lockfiles.py, lockfiles_extra.py, pip)
and the installed-package ones (python-pkg, conda-pkg, gobinary, jar,
node-pkg, gemspec, rustbinary), the in-image `sbom` analyzer, the
opt-in `license-file` one, and the config analyzers `misconf`
(dockerfile, kubernetes, CloudFormation, Terraform plans, Azure ARM,
user rego checks), `helm` and `terraform`, and the opt-in `executable`
one (the digests of unpackaged binaries, for the Rekor post-handler).
`file_patterns` ("analyzer:regex", --file-patterns)
routes more paths to an analyzer, and `misconf` (misconf.MisconfSettings)
carries the scan's user checks, helm overrides and rego trace to the
config analyzers. The loaded extension modules (module.py) join the
dispatch, `required()` and the versions through set_module_analyzers."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from ... import types as T


@dataclass
class AnalysisResult:
    os: Optional[T.OS] = None
    repository: Optional[T.Repository] = None
    package_infos: list = field(default_factory=list)
    applications: list = field(default_factory=list)
    misconfigurations: list = field(default_factory=list)
    licenses: list = field(default_factory=list)   # [DetectedLicense]
    # files owned by the OS package manager; consumed by the system-file
    # filter post-handler (reference analyzer.AnalysisResult
    # SystemInstalledFiles)
    system_installed_files: list = field(default_factory=list)
    build_info: Optional[T.BuildInfo] = None  # Red Hat content sets, nvr
    custom_resources: list = field(default_factory=list)  # module output
    # path → sha256 digest of each unpackaged executable; consumed by the
    # unpackaged (Rekor) post-handler (reference AnalysisResult.Digests)
    digests: dict = field(default_factory=dict)

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
        self.misconfigurations.extend(other.misconfigurations)
        self.licenses.extend(other.licenses)
        self.system_installed_files.extend(other.system_installed_files)
        self.custom_resources.extend(other.custom_resources)
        self.digests.update(other.digests)
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
    required(path) / analyze(path, content). `misconf` is the group's
    misconf.MisconfSettings, set when the group is built."""
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


# extension modules (module.py): the loaded set takes part in dispatch
# and in the cache-key versions like a built-in analyzer (reference
# pkg/module Register hooks into the analyzer registry)
_MODULE_ANALYZERS: list = []


def set_module_analyzers(mods: list) -> None:
    global _MODULE_ANALYZERS
    _MODULE_ANALYZERS = list(mods)


def _ensure_loaded():
    from . import (apk, binaries, dpkg, executable,  # noqa: F401
                   license_file, lockfiles, lockfiles_extra, misconf,
                   os_release, python, redhat, rpm, sbom)


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
    def __init__(self, disabled: tuple = (), enabled: tuple = (),
                 file_patterns: tuple = (), misconf=None):
        """misconf: the scan's misconf.MisconfSettings; None takes the
        process default as the misconf.set_* functions left it."""
        from ...misconf import current_settings
        _ensure_loaded()
        self.misconf = current_settings() if misconf is None else misconf
        off = set(disabled) | (set(OPTIN_ANALYZERS) - set(enabled))
        self.analyzers = [cls() for name, cls in sorted(_REGISTRY.items())
                          if name not in off]
        self.post_analyzers = [
            cls() for name, cls in sorted(_POST_REGISTRY.items())
            if name not in off]
        for a in self.analyzers + self.post_analyzers:
            a.misconf = self.misconf
        # --file-patterns "analyzer:regex": a matching path goes to that
        # analyzer even when its own required() declines (reference
        # analyzer.go:321-341, filePatternMatch:508-515)
        self._patterns: dict[str, list] = {}
        for raw in file_patterns:
            name, sep, pattern = str(raw).partition(":")
            if not sep:
                raise ValueError(
                    f"invalid file pattern {raw!r} "
                    '(expected "analyzerType:regex")')
            try:
                rx = re.compile(pattern)
            except re.error as e:
                raise ValueError(
                    f"invalid file pattern regex {pattern!r}: {e}") \
                    from e
            self._patterns.setdefault(name, []).append(rx)

    def _wants(self, a, path: str, size: int) -> bool:
        if any(rx.search(path) for rx in self._patterns.get(a.name, ())):
            return True
        return a.required(path, size)

    def versions(self) -> dict[str, int]:
        """name → version, for cache keys."""
        out = {a.name: a.version for a in self.analyzers}
        out.update({a.name: a.version for a in self.post_analyzers})
        out.update({f"module:{m.name}": m.version
                    for m in _MODULE_ANALYZERS})
        return out

    def required(self, path: str, size: int = -1) -> bool:
        return any(self._wants(a, path, size) for a in self.analyzers) \
            or any(m.required(path) for m in _MODULE_ANALYZERS)

    def post_required(self, path: str, size: int = -1) -> bool:
        return any(self._wants(a, path, size) for a in self.post_analyzers)

    def analyze_file(self, path: str, content: bytes,
                     result: AnalysisResult) -> None:
        # one span per analyzer that actually ran on the file
        from ...obs import span
        for a in self.analyzers:
            if self._wants(a, path, len(content)):
                with span("fanal.analyze", analyzer=a.name, path=path,
                          bytes=len(content)):
                    r = a.analyze(path, content)
                if r is not None:
                    result.merge(r)
        # a module's failure is the user's code: the file goes on
        # without its resource, as in the reference
        for m in _MODULE_ANALYZERS:
            if m.required(path):
                try:
                    with span("fanal.analyze",
                              analyzer=f"module:{m.name}", path=path):
                        data = m.analyze(path, content)
                except Exception:  # noqa: BLE001 — user module code
                    continue
                if data:
                    result.custom_resources.append({
                        "Type": m.name, "FilePath": path, "Data": data})

    def analyze_batch(self, files: list, on_error=None) -> list:
        """The ingest pipeline's batched dispatch: one pass per analyzer
        over many files. `files` is [(path, content)]; → one
        AnalysisResult (or None) per file, each merged in analyzer
        order, so merging the list in file order equals analyze_file
        per file in that order. `on_error(analyzer, path, exc)` takes
        an analyzer's failure on hostile content and the batch goes on;
        without it the failure propagates, as in analyze_file."""
        from ...obs import span
        results: list = [None] * len(files)
        for a in self.analyzers:
            wanted = [(i, p, c) for i, (p, c) in enumerate(files)
                      if self._wants(a, p, len(c))]
            if not wanted:
                continue
            with span("fanal.analyze", analyzer=a.name, batched=True,
                      files=len(wanted),
                      bytes=sum(len(c) for _, _, c in wanted)):
                for i, path, content in wanted:
                    try:
                        r = a.analyze(path, content)
                    except Exception as e:  # noqa: BLE001 — contained
                        if on_error is None:
                            raise
                        on_error(a.name, path, e)
                        continue
                    if r is not None:
                        if results[i] is None:
                            results[i] = AnalysisResult()
                        results[i].merge(r)
        for m in _MODULE_ANALYZERS:
            wanted = [(i, p, c) for i, (p, c) in enumerate(files)
                      if m.required(p)]
            if not wanted:
                continue
            with span("fanal.analyze", analyzer=f"module:{m.name}",
                      batched=True, files=len(wanted)):
                for i, path, content in wanted:
                    try:
                        data = m.analyze(path, content)
                    except Exception:  # noqa: BLE001 — user module code
                        continue
                    if data:
                        if results[i] is None:
                            results[i] = AnalysisResult()
                        results[i].custom_resources.append({
                            "Type": m.name, "FilePath": path,
                            "Data": data})
        return results

    def post_analyze(self, files: dict, result: AnalysisResult) -> None:
        from ...obs import span
        for a in self.post_analyzers:
            subset = {p: c for p, c in files.items()
                      if self._wants(a, p, -1)}
            if subset:
                with span("fanal.analyze", analyzer=a.name, post=True,
                          files=len(subset)):
                    r = a.post_analyze(subset)
                if r is not None:
                    result.merge(r)
