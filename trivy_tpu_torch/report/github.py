"""GitHub Dependency Snapshot writer (`--format github`).

Mirrors pkg/report/github/github.go: one manifest per result that
carries packages, keyed by target, with purl-resolved package entries
and direct/indirect relationships from the dependency graph.
"""

from __future__ import annotations

import json
import os

from .. import types as T
from ..purl import purl_for_package


def _metadata(report: T.Report) -> dict:
    md = {}
    if report.metadata and report.metadata.repo_tags:
        md["aliases"] = report.metadata.repo_tags
    if report.metadata and report.metadata.repo_digests:
        md["digests"] = report.metadata.repo_digests
    return md


def to_github(report: T.Report, version: str = "dev",
              scanned: str = "") -> dict:
    snapshot = {
        "version": 0,
        "detector": {
            "name": "trivy",
            "version": version,
            "url": "https://github.com/aquasecurity/trivy",
        },
        "scanned": scanned or report.created_at,
    }
    md = _metadata(report)
    if md:
        snapshot["metadata"] = md
    ref = os.environ.get("GITHUB_REF")
    if ref:
        snapshot["ref"] = ref
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        snapshot["sha"] = sha
    correlator = "{}_{}".format(os.environ.get("GITHUB_WORKFLOW", ""),
                                os.environ.get("GITHUB_JOB", ""))
    snapshot["job"] = {
        "correlator": correlator,
        "id": os.environ.get("GITHUB_RUN_ID", ""),
    }

    manifests = {}
    for result in report.results:
        if not result.packages:
            continue
        manifest = {"name": result.type}
        # path shown for language-specific packages only
        # (github.go:104-131)
        if result.clazz == T.ResultClass.LANG_PKGS:
            if report.artifact_type == T.ArtifactType.CONTAINER_IMAGE:
                image_ref = ", ".join(report.metadata.repo_tags or [])
                with_hash = ", ".join(report.metadata.repo_digests or [])
                if "@" in with_hash:
                    image_ref += "@" + with_hash.split("@", 1)[1]
                manifest["file"] = {"source_location": image_ref}
            else:
                manifest["file"] = {"source_location": result.target}

        resolved = {}
        for pkg in result.packages:
            p = pkg.identifier.purl or \
                purl_for_package(result.type, pkg)
            entry = {}
            if p:
                entry["package_url"] = p
            entry["relationship"] = ("indirect" if pkg.indirect
                                     else "direct")
            entry["scope"] = "development" if pkg.dev else "runtime"
            if pkg.depends_on:
                entry["dependencies"] = list(pkg.depends_on)
            resolved[pkg.name] = entry
        manifest["resolved"] = resolved
        manifests[result.target] = manifest
    snapshot["manifests"] = manifests
    return snapshot


def write_github(report: T.Report, out, version: str = "dev") -> None:
    json.dump(to_github(report, version=version), out, indent=2,
              ensure_ascii=False)
    out.write("\n")
