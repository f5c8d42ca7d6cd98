"""Layer squashing — overlay semantics over per-layer BlobInfos.

Mirrors pkg/fanal/applier/docker.go ApplyLayers:91: iterate layers in
order; whiteout files delete the shadowed path, opaque dirs wipe the
accumulated subtree (docker.go:96-104); later OS detections win; package
and application files replace by path; every final element is attributed
to its origin layer — the FIRST layer that contained the same package
(lookupOriginLayerForPkg, docker.go:40) — and PURLs are attached from
the detected OS (docker.go:219-244). Loose-file licenses and ingest
annotations are carried from every blob in layer order, and each path's
misconfiguration record is the top layer's. A filesystem tree is one
blob."""

from __future__ import annotations

from .. import types as T
from ..purl import purl_for_package


def _delete_path(store: dict, path: str):
    for key in [k for k in store
                if k == path or k.startswith(path + "/")]:
        del store[key]


def _layer(blob: T.BlobInfo) -> T.Layer:
    return T.Layer(digest=blob.digest, diff_id=blob.diff_id,
                   created_by=blob.created_by)


def apply_layers(blobs: list[T.BlobInfo]) -> T.ArtifactDetail:
    """_apply_layers_impl under its `fanal.apply_layers` span."""
    from ..obs import span
    with span("fanal.apply_layers", blobs=len(blobs)) as sp:
        detail = _apply_layers_impl(blobs)
        sp.attrs.update(packages=len(detail.packages),
                        applications=len(detail.applications))
        return detail


def _apply_layers_impl(blobs: list[T.BlobInfo]) -> T.ArtifactDetail:
    detail = T.ArtifactDetail()
    pkg_files: dict[str, tuple[T.PackageInfo, T.Layer]] = {}
    app_files: dict[str, tuple[T.Application, T.Layer]] = {}
    secret_files: dict[str, tuple[T.Secret, T.Layer]] = {}
    misconf_files: dict[str, tuple[T.Misconfiguration, T.Layer]] = {}

    for blob in blobs:
        layer = _layer(blob)
        for path in blob.whiteout_files + blob.opaque_dirs:
            for store in (pkg_files, app_files, secret_files,
                          misconf_files):
                _delete_path(store, path)
        if blob.os.detected:
            detail.os.merge(blob.os)
        if blob.repository is not None:
            detail.repository = blob.repository
        for pi in blob.package_infos:
            pkg_files[pi.file_path] = (pi, layer)
        for app in blob.applications:
            app_files[app.file_path] = (app, layer)
        for sec in blob.secrets:
            secret_files[sec.file_path] = (sec, layer)
        for mc in blob.misconfigurations:
            misconf_files[mc.file_path] = (mc, layer)

    origin = _origin_index(blobs)
    diff_index = {b.diff_id: i for i, b in enumerate(blobs) if b.diff_id}
    for path in sorted(pkg_files):
        pi, layer = pkg_files[path]
        for pkg in pi.packages:
            pkg.layer = origin.get((pkg.name, pkg.version, pkg.release),
                                   layer)
            li = diff_index.get(pkg.layer.diff_id, len(blobs) - 1)
            pkg.build_info = _lookup_build_info(li, blobs)
            detail.packages.append(pkg)
    for path in sorted(app_files):
        app, layer = app_files[path]
        for pkg in app.packages:
            pkg.layer = origin.get((pkg.name, pkg.version, pkg.release),
                                   layer)
        detail.applications.append(app)
    for path in sorted(secret_files):
        sec, layer = secret_files[path]
        for finding in sec.findings:
            finding.layer = layer
        detail.secrets.append(sec)
    for path in sorted(misconf_files):
        mc, layer = misconf_files[path]
        mc.layer = layer
        for f in mc.failures:
            f.layer = layer
        detail.misconfigurations.append(mc)
    for blob in blobs:
        detail.custom_resources.extend(blob.custom_resources)
        detail.licenses.extend(blob.licenses)
        # degradation annotations squash additively in layer order: a
        # later complete layer cannot mask an earlier degraded one
        detail.ingest_errors.extend(blob.ingest_errors)

    detail.packages.sort(key=lambda p: (p.name, p.version, p.file_path))
    _fill_identifiers(detail)
    _aggregate_individual_apps(detail)
    return detail


def _fill_identifiers(detail: T.ArtifactDetail) -> None:
    """PURL attachment (docker.go:219-244: OS packages get the distro
    qualifier from the detected OS, app packages their ecosystem
    type)."""
    if detail.os.detected:
        for pkg in detail.packages:
            if not pkg.identifier.purl:
                pkg.identifier.purl = purl_for_package(
                    detail.os.family, pkg, os_info=detail.os)
    for app in detail.applications:
        for pkg in app.packages:
            if not pkg.identifier.purl:
                pkg.identifier.purl = purl_for_package(app.type, pkg)


# "individual package" app types merge into one application per type,
# reported under a friendly target (reference pkg/scanner/langpkg/scan.go
# PkgTargets + fanal aggregation, analyzer.go:185-242)
INDIVIDUAL_TYPES = ("python-pkg", "conda-pkg", "gemspec", "node-pkg",
                    "jar")  # ftypes.AggregatingTypes (const.go:84-90)


def _aggregate_individual_apps(detail: T.ArtifactDetail) -> None:
    merged: dict[str, T.Application] = {}
    keep = []
    for app in detail.applications:
        if app.type in INDIVIDUAL_TYPES:
            agg = merged.setdefault(app.type, T.Application(type=app.type))
            agg.packages.extend(app.packages)
        else:
            keep.append(app)
    for app in merged.values():
        app.packages.sort(key=lambda p: (p.name, p.version, p.file_path))
    detail.applications = keep + [merged[t] for t in sorted(merged)]


def _lookup_build_info(index: int, blobs) -> T.BuildInfo | None:
    """Red Hat content sets for the layer a package came from
    (docker.go:52-75): the base layer (0) and customer layers inherit
    the nearest Red Hat layer's build info."""
    if index < len(blobs) and blobs[index].build_info is not None:
        return blobs[index].build_info
    if index == 0:
        return blobs[1].build_info if len(blobs) > 1 else None
    for i in range(min(index, len(blobs)) - 1, 0, -1):
        if blobs[i].build_info is not None:
            return blobs[i].build_info
    return None


def _origin_index(blobs) -> dict:
    """(name, version, release) → first layer containing that package."""
    origin: dict = {}
    for blob in blobs:
        layer = _layer(blob)
        for pi in blob.package_infos:
            for p in pi.packages:
                origin.setdefault((p.name, p.version, p.release), layer)
        for app in blob.applications:
            for p in app.packages:
                origin.setdefault((p.name, p.version, p.release), layer)
    return origin
