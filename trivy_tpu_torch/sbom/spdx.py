"""SPDX 2.3 JSON encode + minimal decode (reference pkg/sbom/spdx)."""

from __future__ import annotations

import hashlib

from .. import types as T
from ..license_expr import normalize_pkg_licenses
from ..purl import purl_for_package


def _spdx_id(kind: str, name: str) -> str:
    h = hashlib.sha1(name.encode()).hexdigest()[:16]
    return f"SPDXRef-{kind}-{h}"


ARTIFACT_KIND = {
    "container_image": ("ContainerImage", "CONTAINER"),
    "filesystem": ("Filesystem", "SOURCE"),
    "repository": ("Repository", "SOURCE"),
    "vm": ("VM", "SOURCE"),
}


def encode_spdx(report: T.Report, app_version: str = "dev") -> dict:
    """Report → SPDX 2.3 JSON in the reference's shape
    (pkg/sbom/spdx/marshal.go): root artifact package, per-package
    entries with purl externalRefs and PkgType attribution, File
    entries with SHA1 checksums when file digests were recorded
    (--format spdx-json turns them on in the walker), and
    packageVerificationCode = SHA1 over the files' hex digests."""
    packages = []
    files = []
    relationships = []
    doc_id = "SPDXRef-DOCUMENT"
    kind, purpose = ARTIFACT_KIND.get(report.artifact_type,
                                      ("Artifact", "APPLICATION"))
    art_id = _spdx_id(kind, report.artifact_name)
    packages.append({
        "name": report.artifact_name,
        "SPDXID": art_id,
        "downloadLocation": "NONE",
        "filesAnalyzed": False,
        "attributionTexts": [f"SchemaVersion: {report.schema_version}"],
        "primaryPackagePurpose": purpose,
    })
    relationships.append({
        "spdxElementId": doc_id,
        "relatedSpdxElement": art_id,
        "relationshipType": "DESCRIBES",
    })
    for res in report.results:
        for pkg in res.packages:
            pid = _spdx_id(
                "Package", f"{res.target}/{pkg.name}@{pkg.version}")
            lic = normalize_pkg_licenses(pkg.licenses) or "NOASSERTION"
            entry = {
                "name": pkg.name,
                "SPDXID": pid,
                "versionInfo": pkg.format_version() or pkg.version,
                "supplier": "NOASSERTION",
                "downloadLocation": "NONE",
                "filesAnalyzed": False,
                "licenseConcluded": lic,
                "licenseDeclared": lic,
            }
            purl = pkg.identifier.purl or purl_for_package(res.type, pkg)
            if purl:
                entry["externalRefs"] = [{
                    "referenceCategory": "PACKAGE-MANAGER",
                    "referenceType": "purl",
                    "referenceLocator": purl,
                }]
            entry["attributionTexts"] = [f"PkgType: {res.type}"]
            entry["primaryPackagePurpose"] = "LIBRARY"
            if pkg.file_path and pkg.digest.startswith("sha1:"):
                sha1 = pkg.digest[len("sha1:"):]
                fid = _spdx_id("File", f"{res.target}/{pkg.file_path}")
                files.append({
                    "fileName": pkg.file_path,
                    "SPDXID": fid,
                    "checksums": [{"algorithm": "SHA1",
                                   "checksumValue": sha1}],
                    "copyrightText": "",
                })
                relationships.append({
                    "spdxElementId": pid,
                    "relatedSpdxElement": fid,
                    "relationshipType": "CONTAINS",
                })
                entry["filesAnalyzed"] = True
                entry["packageVerificationCode"] = {
                    "packageVerificationCodeValue":
                        hashlib.sha1(sha1.encode()).hexdigest(),
                }
            packages.append(entry)
            relationships.append({
                "spdxElementId": art_id,
                "relatedSpdxElement": pid,
                "relationshipType": "CONTAINS",
            })

    # root artifact package sorts last (marshal.go output order)
    packages.sort(key=lambda p: (p["SPDXID"] == art_id, p["name"],
                                 p.get("versionInfo", "")))
    files.sort(key=lambda f: f["SPDXID"])
    relationships.sort(key=lambda r: (r["spdxElementId"],
                                      r["relatedSpdxElement"]))
    from .cyclonedx import _next_uuid
    prefix = report.artifact_type or "artifact"
    return {
        "spdxVersion": "SPDX-2.3",
        "dataLicense": "CC0-1.0",
        "SPDXID": doc_id,
        "name": report.artifact_name,
        "documentNamespace":
            f"http://aquasecurity.github.io/trivy/{prefix}/"
            f"{report.artifact_name}-{_next_uuid()}",
        "creationInfo": {
            "creators": ["Organization: aquasecurity",
                         f"Tool: trivy-tpu-{app_version}"],
            "created": report.created_at.replace("+00:00", "Z")
            if report.created_at else "",
        },
        "packages": packages,
        "files": files,
        "relationships": relationships,
    }


def _attrs(p: dict) -> dict:
    out = {}
    for t in p.get("attributionTexts") or []:
        key, _, val = t.partition(": ")
        if key:
            out[key] = val
    return out


def _purl_package(purl: str) -> tuple[str, T.Package, dict]:
    """purl → (purl type, Package with name/version/epoch/arch, quals).

    The trivy SPDX flavor carries package identity in the purl
    external ref (pkg/sbom/spdx/unmarshal.go), not in versionInfo."""
    import urllib.parse
    body = purl[len("pkg:"):]
    path, _, qs = body.partition("?")
    quals = dict(q.split("=", 1) for q in qs.split("&") if "=" in q)
    ptype, _, rest = path.partition("/")
    ver = ""
    if "@" in rest:
        rest, _, ver = rest.rpartition("@")
    segs = [urllib.parse.unquote(x) for x in rest.split("/")]
    if ptype in ("deb", "rpm", "apk"):
        name = segs[-1]
    elif ptype == "maven":
        name = ":".join(segs[-2:]) if len(segs) >= 2 else segs[-1]
    else:
        # golang/k8s names span namespace+name (full module path)
        name = "/".join(segs) if ptype in ("golang", "k8s") and \
            len(segs) > 1 else segs[-1]
    ver = urllib.parse.unquote(ver)
    from .cyclonedx import _canonical_purl
    pkg = T.Package(name=name, version=ver,
                    arch=quals.get("arch", ""),
                    epoch=int(quals.get("epoch", "0") or 0),
                    identifier=T.PkgIdentifier(
                        purl=_canonical_purl(purl)))
    return ptype, pkg, quals


def decode_spdx(doc: dict) -> T.ArtifactDetail:
    """Trivy-flavored SPDX decode (pkg/sbom/spdx/unmarshal.go):
    OperatingSystem package → OS, Application packages → app
    groupings via CONTAINS relationships, library packages built from
    their purl external refs with PkgID attribution."""
    from .cyclonedx import _OS_TYPE_CLASS, _PURL_TO_TYPE, OS_PKG_TYPES

    detail = T.ArtifactDetail()
    apps: dict[str, T.Application] = {}
    owner: dict[str, str] = {}  # package SPDXID → application SPDXID
    for rel in doc.get("relationships") or []:
        if rel.get("relationshipType") == "CONTAINS" and \
                str(rel.get("spdxElementId", "")).startswith(
                    "SPDXRef-Application"):
            owner[rel["relatedSpdxElement"]] = rel["spdxElementId"]

    os_pkgs: list[T.Package] = []
    for p in doc.get("packages") or []:
        sid = str(p.get("SPDXID", ""))
        attrs = _attrs(p)
        if sid.startswith("SPDXRef-OperatingSystem"):
            detail.os = T.OS(family=p.get("name", ""),
                             name=p.get("versionInfo", ""))
            continue
        if sid.startswith("SPDXRef-Application"):
            apps[sid] = T.Application(
                type=attrs.get("Type", ""), file_path=p.get("name", ""))
            continue
        if not sid.startswith("SPDXRef-Package"):
            continue  # root artifact / files
        purl = ""
        for ref in p.get("externalRefs") or []:
            if ref.get("referenceType") == "purl":
                purl = ref.get("referenceLocator", "")
        if not purl or not purl.startswith("pkg:"):
            continue
        ptype, pkg, _quals = _purl_package(purl)
        lic = p.get("licenseDeclared") or p.get("licenseConcluded")
        if lic and lic != "NOASSERTION":
            pkg.licenses = [lic]
        if ptype in OS_PKG_TYPES:
            pkg.id = attrs.get("PkgID") or f"{pkg.name}@{pkg.version}"
            # analyzer field schema per package class (see cyclonedx
            # _OS_TYPE_CLASS): rpm/deb purl versions are
            # version-release joined and must split back into fields;
            # apk keeps the full "ver-rN" string with release empty
            if _OS_TYPE_CLASS.get(ptype) in ("rpm", "deb") and \
                    "-" in pkg.version and not pkg.release:
                pkg.version, pkg.release = pkg.version.rsplit("-", 1)
            pkg.src_name = pkg.src_name or pkg.name
            os_pkgs.append(pkg)
        else:
            app_type = _PURL_TO_TYPE.get(ptype, ptype)
            pkg.id = attrs.get("PkgID") or f"{pkg.name}@{pkg.version}"
            if sid in owner and owner[sid] in apps:
                apps[owner[sid]].packages.append(pkg)
            else:
                key = f"type:{app_type}"
                app = apps.setdefault(
                    key, T.Application(type=app_type))
                app.packages.append(pkg)

    detail.packages = os_pkgs
    detail.applications = [a for a in apps.values() if a.packages]
    return detail


def parse_tag_value(text: str) -> dict:
    """SPDX tag-value → the JSON-document shape decode_spdx consumes
    (reference supports FormatSPDXTV, sbom.go:111)."""
    packages: list[dict] = []
    rels: list[dict] = []
    cur: dict = {}
    doc_info: dict = {}

    def flush():
        nonlocal cur
        if cur:
            packages.append(cur)
            cur = {}

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.partition(":")
        val = val.strip()
        if key == "PackageName":
            flush()
            cur = {"name": val}
        elif key in ("FileName", "DocumentName", "LicenseID"):
            # a new non-package section starts: stop attributing tags
            # (its SPDXID etc.) to the previous package
            flush()
        elif key == "SPDXID":
            if cur:
                cur["SPDXID"] = val
            else:
                doc_info["SPDXID"] = val
        elif key == "SPDXVersion":
            doc_info["spdxVersion"] = val
        elif key == "PackageVersion":
            cur["versionInfo"] = val
        elif key == "ExternalRef":
            parts = val.split()
            if len(parts) == 3 and parts[1] == "purl":
                cur.setdefault("externalRefs", []).append({
                    "referenceCategory": parts[0],
                    "referenceType": "purl",
                    "referenceLocator": parts[2],
                })
        elif key == "PackageAttributionText":
            if val.startswith("<text>"):
                val = val.removeprefix("<text>").removesuffix("</text>")
            cur.setdefault("attributionTexts", []).append(val)
        elif key == "Relationship":
            parts = val.split()
            if len(parts) == 3:
                rels.append({"spdxElementId": parts[0],
                             "relationshipType": parts[1],
                             "relatedSpdxElement": parts[2]})
    flush()
    return {"spdxVersion": doc_info.get("spdxVersion", "SPDX-2.3"),
            "packages": packages, "relationships": rels}


