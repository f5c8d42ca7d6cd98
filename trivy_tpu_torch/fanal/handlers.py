"""Post-handlers: mutate a BlobInfo after analysis, priority-ordered.

Mirrors pkg/fanal/handler/handler.go (registry, priority-sorted
PostHandle at :72) and the system-file filter
pkg/fanal/handler/sysfile/filter.go: language packages whose file path
is owned by the OS package manager are dropped — their version would
come from the distro, not the ecosystem, and produce false positives.
The unpackaged-binary handler, which asks Rekor over the network, is
not ported.
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
