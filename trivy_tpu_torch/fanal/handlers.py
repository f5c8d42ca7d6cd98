"""Post-handlers: mutate a BlobInfo after analysis, priority-ordered.

Mirrors pkg/fanal/handler/handler.go (registry, priority-sorted
PostHandle at :72) and the system-file filter
pkg/fanal/handler/sysfile/filter.go: language packages whose file path
is owned by the OS package manager are dropped — their version would
come from the distro, not the ecosystem, and produce false positives.
And the unpackaged-binary handler (pkg/fanal/handler/unpackaged), which
asks Rekor for an SBOM attestation of each binary the executable
analyzer found.
"""

from __future__ import annotations

from .. import types as T
from .analyzers import AnalysisResult

_POST_HANDLERS: list = []


def register_post_handler(cls):
    _POST_HANDLERS.append(cls())
    _POST_HANDLERS.sort(key=lambda h: -h.priority)
    return cls


def post_handle(result: AnalysisResult, blob: T.BlobInfo) -> None:
    for h in _POST_HANDLERS:
        h.handle(result, blob)


# Distroless images delete /var/lib/dpkg/info/*.list, so these python
# egg-infos can't be attributed to dpkg by file list
# (sysfile/filter.go:22-28).
DEFAULT_SYSTEM_FILES = (
    "/usr/lib/python2.7/argparse.egg-info",
    "/usr/lib/python2.7/lib-dynload/Python-2.7.egg-info",
    "/usr/lib/python2.7/wsgiref.egg-info",
)

# app types subject to the filter (sysfile/filter.go:30-46)
_AFFECTED_TYPES = {"gemspec", "python-pkg", "conda-pkg", "node-pkg",
                   "gobinary"}


@register_post_handler
class SystemFileFilterHandler:
    name = "system-file-filter"
    version = 1
    priority = 100

    def handle(self, result: AnalysisResult, blob: T.BlobInfo) -> None:
        sysfiles = set()
        for f in list(result.system_installed_files) + \
                list(DEFAULT_SYSTEM_FILES):
            f = f.lstrip("/")
            if f:
                sysfiles.add(f)
        if not sysfiles:
            return
        apps = []
        for app in blob.applications:
            if app.file_path in sysfiles and app.type in _AFFECTED_TYPES:
                continue
            app.packages = [p for p in app.packages
                            if p.file_path not in sysfiles]
            if not app.packages:
                continue
            apps.append(app)
        blob.applications = apps


@register_post_handler
class UnpackagedHandler:
    """Rekor SBOM lookup for unpackaged executables (reference
    pkg/fanal/handler/unpackaged/unpackaged.go): each binary digest the
    executable analyzer collected, but for files the OS package manager
    owns, is searched in the transparency log, and a found SBOM
    attestation adds its first application under the binary's path.
    Inert until configure_post_handlers() sets a Rekor URL, which the
    CLI does only under --sbom-sources rekor. A Rekor failure is logged
    and the binary skipped, as in the reference."""

    name = "unpackaged"
    version = 1
    priority = 50
    rekor_url = ""

    def handle(self, result: AnalysisResult, blob: T.BlobInfo) -> None:
        if not self.rekor_url or not result.digests:
            return
        from ..log import logger
        from ..rekor import RekorError, fetch_sbom_statement
        from ..sbom.io import decode_cyclonedx, decode_spdx, detect_format
        system = set(result.system_installed_files)
        for path in sorted(result.digests):
            if path in system or "/" + path in system:
                continue
            try:
                st = fetch_sbom_statement(self.rekor_url,
                                          result.digests[path])
            except RekorError as e:
                logger.warning("rekor lookup for %s: %s", path, e)
                continue
            if st is None:
                continue
            doc = st.sbom_document()
            if not isinstance(doc, dict):
                continue
            try:
                detail = decode_cyclonedx(doc) \
                    if detect_format(doc) == "cyclonedx" \
                    else decode_spdx(doc)
            except (ValueError, KeyError):
                continue
            if detail.applications:
                logger.info("found SBOM attestation in Rekor: %s", path)
                app = detail.applications[0]
                app.file_path = path
                blob.applications.append(app)


def configure_post_handlers(rekor_url: str = "") -> None:
    """The process-wide handler options, set by the CLI for each scan
    (the reference builds its handlers from artifact.Option,
    handler.go PostHandlerInit)."""
    UnpackagedHandler.rekor_url = rekor_url
