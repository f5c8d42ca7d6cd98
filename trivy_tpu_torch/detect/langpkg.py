"""Language-package vulnerability detection.

Mirrors pkg/detector/library (driver.go ecosystem table + detect.go loop)
and pkg/scanner/langpkg/scan.go: each Application's packages are joined
against every advisory bucket of its ecosystem prefix ("pip::...",
"npm::...")."""

from __future__ import annotations

from .. import types as T
from .engine import BatchDetector, Hit, PkgQuery

# Application type (pkg/fanal/types/const.go LangType) → advisory bucket
# ecosystem prefix (pkg/detector/library/driver.go:25-95)
APP_ECOSYSTEM = {
    "bundler": "rubygems", "gemspec": "rubygems",
    "rustbinary": "cargo", "cargo": "cargo",
    "composer": "composer", "composer-vendor": "composer",
    "jar": "maven", "pom": "maven", "gradle": "maven",
    "sbt-lockfile": "maven",
    "npm": "npm", "node-pkg": "npm", "yarn": "npm", "pnpm": "npm",
    "javascript": "npm",
    "nuget": "nuget", "dotnet-core": "nuget", "packages-props": "nuget",
    "python-pkg": "pip", "pip": "pip", "pipenv": "pip", "poetry": "pip",
    "gobinary": "go", "gomod": "go",
    "conan": "conan",
    "hex": "erlang",
    "swift": "swift", "cocoapods": "cocoapods",
    "pub": "pub",
    "julia": "julia",
    "k8s": "k8s", "kubernetes": "k8s",
    # conda-pkg intentionally absent: SBOM-only, no vuln scanning
    # (driver.go:77-79)
}

# Application types whose results keep per-package file paths
PKG_PATH_TYPES = {"python-pkg", "node-pkg", "gemspec", "jar", "rustbinary"}


class LangpkgScanner:
    def __init__(self, detector: BatchDetector):
        self.detector = detector

    def prepare_app(self, app: T.Application):
        """→ (queries, finish) with finish(hits) → vulns; see
        OspkgScanner.prepare for why the two halves are split."""
        eco = APP_ECOSYSTEM.get(app.type)
        if eco is None:
            return [], lambda hits: []
        scheme = eco  # version scheme resolves via ECOSYSTEM_SCHEME
        buckets = self.detector.table.sources_for_prefix(f"{eco}::")
        queries = []
        for pkg in app.packages:
            if not pkg.version:
                continue
            for bucket in buckets:
                queries.append(PkgQuery(
                    source=bucket, ecosystem=scheme,
                    name=normalize_pkg_name(eco, pkg.name),
                    version=pkg.version, ref=pkg))

        def finish(hits):
            uniq: dict[tuple, Hit] = {}
            for h in hits:
                uniq.setdefault((id(h.query.ref), h.vuln_id), h)
            return [self._to_vuln(h, app) for h in uniq.values()]

        return queries, finish

    @staticmethod
    def _to_vuln(h: Hit, app: T.Application) -> T.DetectedVulnerability:
        pkg: T.Package = h.query.ref
        return T.DetectedVulnerability(
            vulnerability_id=h.vuln_id,
            vendor_ids=list(h.vendor_ids),
            pkg_id=pkg.id,
            pkg_name=pkg.name,
            pkg_path=pkg.file_path if app.type in PKG_PATH_TYPES else "",
            pkg_identifier=pkg.identifier,
            installed_version=pkg.version,
            fixed_version=h.fixed_version,
            status=h.status,
            layer=pkg.layer,
            data_source=T.DataSource(**h.data_source) if h.data_source else None,
        )


def normalize_pkg_name(eco: str, name: str) -> str:
    """Ecosystem-specific name normalization (reference: python PEP 503
    lowercase/dash, maven group:artifact)."""
    if eco == "pip":
        return name.lower().replace("_", "-").replace(".", "-")
    if eco == "npm":
        return name  # npm names are case-sensitive as-is
    return name
