"""CycloneDX JSON encode/decode.

Mirrors pkg/sbom/cyclonedx: Trivy-flavored CycloneDX marks each
component with `aquasecurity:trivy:*` properties (Type, SrcName,
SrcVersion, PkgID, PkgType...) and an operating_system component for the
OS; decode reverses that into OS + Packages + Applications."""

from __future__ import annotations

import uuid

from .. import types as T
from ..purl import purl_for_package

PROP_PREFIX = "aquasecurity:trivy:"


def _props(component: dict) -> dict:
    out = {}
    for p in component.get("properties", []):
        name = p.get("name", "")
        if name.startswith(PROP_PREFIX):
            out[name[len(PROP_PREFIX):]] = p.get("value", "")
    return out


def _int0(v) -> int:
    """Lying-data tolerance: a non-numeric epoch property degrades to
    0 instead of sinking the whole document decode."""
    try:
        return int(v or 0)
    except (TypeError, ValueError):
        return 0


def _split_epoch(version: str) -> tuple[int, str]:
    """'1:2.3-4' → (1, '2.3-4'): rpm/deb full version strings (what
    format_version() emits) carry the epoch as an 'N:' prefix."""
    head, sep, rest = version.partition(":")
    if sep and head.isdigit():
        return int(head), rest
    return 0, version


def decode_cyclonedx(doc: dict) -> T.ArtifactDetail:
    detail = T.ArtifactDetail()
    apps: dict[str, T.Application] = {}
    explicit_apps: list[T.Application] = []
    os_pkgs: list[T.Package] = []
    os_type = ""
    seen_refs: set[str] = set()

    components = list(doc.get("components", []))
    meta_comp = (doc.get("metadata") or {}).get("component")
    if meta_comp:
        components.append(meta_comp)

    # pre-create application entries and dependency edges BEFORE the
    # component loop: CycloneDX imposes no component ordering, so a
    # library may precede (or be the metadata.component's sibling of)
    # the application that owns it via the dependency graph
    # (reference unmarshal.go walks the BOM graph; libraries reached
    # from an application belong to it, not to a purl-class aggregate)
    for comp in components:
        if comp.get("type") == "application" and not comp.get("purl"):
            app_type = _props(comp).get("Type", "")
            if app_type:
                app = T.Application(type=app_type,
                                    file_path=comp.get("name", ""))
                apps[comp.get("bom-ref", comp.get("name", ""))] = app
                explicit_apps.append(app)
    # transitive closure: libraries reached through other libraries
    # still belong to the application at the root of their chain
    edges: dict[str, list] = {}
    for dep in doc.get("dependencies") or []:
        edges[dep.get("ref")] = list(dep.get("dependsOn") or [])
    owner_of: dict[str, str] = {}
    for root in (r for r in apps if r in edges):
        stack = list(edges[root])
        while stack:
            child = stack.pop()
            if child in owner_of or child in apps:
                continue
            owner_of[child] = root
            stack.extend(edges.get(child, []))

    for comp in components:
        ctype = comp.get("type", "")
        props = _props(comp)
        if ctype in ("operating_system", "operating-system"):
            # CycloneDX JSON spells the type with a hyphen
            detail.os = T.OS(family=comp.get("name", ""),
                             name=comp.get("version", ""))
            continue
        if ctype == "application" and not comp.get("purl"):
            continue  # already created in the prescan
        if ctype not in ("library", "application", "platform"):
            continue
        if ctype == "platform" and not comp.get("purl"):
            continue  # KBOM nodes/groupings without package identity
        purl = comp.get("purl", "")
        # duplicate BOM refs decode ONCE (bom-refs must be unique per
        # spec; hostile or sloppy generators repeat them — the first
        # occurrence wins, deterministically, instead of double-
        # counting the package)
        dkey = comp.get("bom-ref") or \
            f"{purl}|{comp.get('name', '')}|{comp.get('version', '')}"
        if dkey in seen_refs:
            continue
        seen_refs.add(dkey)
        purl_type, purl_quals = _purl_parts(purl)
        pkg = T.Package(
            name=comp.get("name", ""),
            version=comp.get("version", ""),
            src_name=props.get("SrcName", ""),
            src_version=props.get("SrcVersion", ""),
            src_release=props.get("SrcRelease", ""),
            src_epoch=_int0(props.get("SrcEpoch")),
            release=props.get("PkgRelease", ""),
            file_path=props.get("FilePath", ""),
            arch=purl_quals.get("arch", ""),
            epoch=_int0(purl_quals.get("epoch")),
            identifier=T.PkgIdentifier(purl=_canonical_purl(purl),
                                       bom_ref=comp.get("bom-ref", "")),
        )
        for lic in comp.get("licenses") or []:
            name = (lic.get("license") or {}).get("name") or \
                (lic.get("license") or {}).get("id") or \
                lic.get("expression") or ""
            if name:
                pkg.licenses.append(name)
        ptype = props.get("PkgType", "")
        if not ptype:
            # trivy BOMs for OS packages carry no PkgType property — the
            # purl type + the operating-system component determine it
            # (reference pkg/sbom/cyclonedx/unmarshal.go pkgType via
            # purl; apps fall back to the purl's lang type)
            ptype = _PURL_TO_TYPE.get(purl_type, purl_type)
        if comp.get("group"):
            pkg.name = f"{comp['group']}/{pkg.name}" \
                if ptype in ("npm", "composer", "gomod", "node-pkg",
                             "gobinary") \
                else f"{comp['group']}:{pkg.name}"
        if ptype in OS_PKG_TYPES:
            # PkgID carries the FULL version string (before any
            # version-release split)
            pkg.id = props.get("PkgID") or f"{pkg.name}@{pkg.version}"
            # reconstruct the ANALYZER field schema per package class,
            # not per literal purl type: trivy-encoded BOMs stamp
            # PkgType with the distro family ("alpine", "centos", ...)
            # and their component versions are format_version() output
            # — epoch:version-release joined. apk-class packages keep
            # the full "ver-rN" string in `version` with an empty
            # release, exactly like fanal/analyzers/apk.py
            cls = _OS_TYPE_CLASS.get(ptype, "")
            if cls in ("rpm", "deb"):
                epoch, pkg.version = _split_epoch(pkg.version)
                pkg.epoch = pkg.epoch or epoch
                if pkg.release and pkg.version.endswith(
                        "-" + pkg.release):
                    # PkgRelease property + format_version() joined
                    # component version: strip the duplicate
                    pkg.version = \
                        pkg.version[:-len(pkg.release) - 1]
                elif "-" in pkg.version and not pkg.release:
                    pkg.version, pkg.release = \
                        pkg.version.rsplit("-", 1)
                s_epoch, pkg.src_version = \
                    _split_epoch(pkg.src_version)
                pkg.src_epoch = pkg.src_epoch or s_epoch
                if "-" in pkg.src_version and not pkg.src_release:
                    pkg.src_version, pkg.src_release = \
                        pkg.src_version.rsplit("-", 1)
            os_type = os_type or ptype
            os_pkgs.append(pkg)
        else:
            pkg.id = props.get("PkgID") or f"{pkg.name}@{pkg.version}"
            path = props.get("FilePath", "")
            app_type = ptype or "unknown"
            owner = owner_of.get(comp.get("bom-ref"))
            if owner is not None and owner in apps and not path:
                apps[owner].packages.append(pkg)
                continue
            if not path and purl:
                # a library with no file path and no application link
                # aggregates by its PURL class, not its PkgType prop
                # (unmarshal.go: orphan maven components → Jar → the
                # "Java" aggregated target)
                app_type = _PURL_TO_TYPE.get(purl_type, ptype) \
                    or "unknown"
            app = apps.setdefault(path or app_type, T.Application(
                type=app_type, file_path=path))
            app.packages.append(pkg)

    detail.packages = os_pkgs
    # explicit application components survive even when empty — the
    # reference emits their (empty) license groups (scan.go:332-336)
    detail.applications = [a for a in apps.values()
                           if a.packages or a in explicit_apps]
    return detail


def _canonical_purl(purl: str) -> str:
    """Re-emit a purl with qualifiers in canonical (sorted) order — the
    reference parses BOM purls into packageurl structs and re-marshals
    them, which sorts qualifiers (packageurl-go ToString)."""
    if "?" not in purl:
        return purl
    body, q = purl.split("?", 1)
    quals = sorted(kv.partition("=")[::2] for kv in q.split("&") if kv)
    return body + "?" + "&".join(f"{k}={v}" for k, v in quals)


def _purl_parts(purl: str) -> tuple[str, dict]:
    """→ (purl type, qualifiers dict)."""
    if not purl.startswith("pkg:"):
        return "", {}
    body = purl[4:]
    quals: dict = {}
    if "?" in body:
        body, q = body.split("?", 1)
        for kv in q.split("&"):
            k, _, v = kv.partition("=")
            quals[k] = v
    return body.split("/", 1)[0], quals


# purl type → package type when no explicit property exists; OS purls
# (rpm/deb/apk) resolve to the concrete distro via the purl namespace
# handled by OS_PKG_TYPES membership, lang purls to individual-package
# analyzers (reference pkg/purl/purl.go Class + LangType)
_PURL_TO_TYPE = {
    "pypi": "python-pkg", "npm": "node-pkg", "gem": "gemspec",
    "golang": "gobinary", "maven": "jar", "cargo": "rustbinary",
    "conda": "conda-pkg", "nuget": "nuget", "composer": "composer",
    # KBOM core components (unmarshal.go: purl k8s → K8sUpstream)
    "k8s": "kubernetes",
}


OS_PKG_TYPES = {"alpine", "apk", "deb", "debian", "ubuntu", "redhat",
                "centos", "rocky", "alma", "amazon", "oracle", "fedora",
                "suse", "opensuse", "photon", "wolfi", "chainguard",
                "cbl-mariner", "dpkg", "rpm"}

# OS package type → analyzer field class: which version-string schema
# the decoded Package must be reconstructed into so the detect queries
# come out bit-identical to the archive path's analyzer output
# (rpm/deb analyzers split epoch/version/release into fields; the apk
# analyzer keeps the full "ver-rN" string with release empty)
_OS_TYPE_CLASS = {
    "apk": "apk", "alpine": "apk", "wolfi": "apk", "chainguard": "apk",
    "deb": "deb", "dpkg": "deb", "debian": "deb", "ubuntu": "deb",
    "rpm": "rpm", "redhat": "rpm", "centos": "rpm", "rocky": "rpm",
    "alma": "rpm", "amazon": "rpm", "oracle": "rpm", "fedora": "rpm",
    "suse": "rpm", "opensuse": "rpm", "photon": "rpm",
    "cbl-mariner": "rpm",
}


def _fake_uuid_counter():
    return {"n": 0}


_UUID_STATE = _fake_uuid_counter()


def _next_uuid() -> str:
    """uuid4, or the deterministic TRIVY_TPU_FAKE_UUID pattern (e.g.
    "3ff14136-e09f-4df9-80ea-%012d") — the reference's uuid.SetFakeUUID
    test knob, needed for byte-identical SBOM goldens."""
    import os
    pat = os.environ.get("TRIVY_TPU_FAKE_UUID", "")
    if pat:
        _UUID_STATE["n"] += 1
        return pat % _UUID_STATE["n"]
    return str(uuid.uuid4())


def _reset_uuid_counter():
    _UUID_STATE["n"] = 0


# aggregated individual-package result types attach their libraries
# directly under the root component (reference pkg/sbom/core/bom.go —
# no file-path application component exists for them)
_AGGREGATED_TYPES = {"python-pkg", "conda-pkg", "gemspec", "node-pkg",
                     "jar", "k8s"}


def _cvss_severity(score: float) -> str:
    if score >= 9.0:
        return "critical"
    if score >= 7.0:
        return "high"
    if score >= 4.0:
        return "medium"
    if score > 0.0:
        return "low"
    return "none"


def _iso_tz(ts: str) -> str:
    return ts.replace("Z", "+00:00") if ts else ""


def _maven_split(pkg: T.Package) -> tuple[str, str]:
    """maven names are group:artifact — CycloneDX wants them split
    (marshal.go Component Group/Name)."""
    if ":" in pkg.name:
        group, _, name = pkg.name.partition(":")
        return group, name
    return "", pkg.name


def encode_cyclonedx(report: T.Report, app_version: str = "dev") -> dict:
    """Report → CycloneDX 1.5 JSON in the reference's core-BOM shape
    (pkg/sbom/cyclonedx/marshal.go): root component + per-lockfile
    application components + purl-ref'd libraries, a full dependency
    graph, and enriched vulnerability entries."""
    _reset_uuid_counter()
    root_ref = _next_uuid()
    components: list = []
    deps: dict[str, list] = {root_ref: []}
    vulnerabilities: dict[str, dict] = {}
    pkg_refs: dict[tuple, str] = {}  # (result idx, pkg id/name@ver) → ref

    os_info = report.metadata.os
    os_ref = ""
    if os_info and os_info.detected:
        os_ref = _next_uuid()
        components.append({
            "bom-ref": os_ref,
            "type": "operating_system",
            "name": os_info.family,
            "version": os_info.name,
            "properties": [
                {"name": PROP_PREFIX + "Class", "value": "os-pkgs"},
                {"name": PROP_PREFIX + "Type", "value": os_info.family},
            ],
        })
        deps[root_ref].append(os_ref)
        deps[os_ref] = []

    for ri, res in enumerate(report.results):
        if not res.packages and not res.vulnerabilities:
            continue
        if res.clazz == T.ResultClass.OS_PKGS and os_ref:
            parent = os_ref
        elif res.clazz == T.ResultClass.LANG_PKGS and \
                res.type not in _AGGREGATED_TYPES:
            parent = _next_uuid()
            components.append({
                "bom-ref": parent,
                "type": "application",
                "name": res.target,
                "properties": [
                    {"name": PROP_PREFIX + "Class", "value": res.clazz},
                    {"name": PROP_PREFIX + "Type", "value": res.type},
                ],
            })
            deps[root_ref].append(parent)
            deps[parent] = []
        else:
            parent = root_ref

        id_to_ref: dict[str, str] = {}
        for pkg in res.packages:
            purl = pkg.identifier.purl or purl_for_package(res.type, pkg)
            ref = purl or f"{pkg.name}@{pkg.version}"
            id_to_ref[pkg.id or f"{pkg.name}@{pkg.version}"] = ref
            # vulnerabilities carry installed_version =
            # format_version() (epoch/release included) — key both
            pkg_refs[(ri, pkg.name, pkg.version)] = ref
            pkg_refs[(ri, pkg.name,
                      pkg.format_version() or pkg.version)] = ref
        for pkg in res.packages:
            purl = pkg.identifier.purl or purl_for_package(res.type, pkg)
            ref = purl or f"{pkg.name}@{pkg.version}"
            # the reference's core BOM allocates an internal uuid per
            # component even when the bom-ref is the purl — consume one
            # so fake-uuid sequences (and thus serial numbers) align
            _next_uuid()
            comp = {"bom-ref": ref, "type": "library"}
            if res.type in ("pom", "jar", "gradle"):
                group, name = _maven_split(pkg)
                if group:
                    comp["group"] = group
                comp["name"] = name
            else:
                comp["name"] = pkg.name
            comp["version"] = pkg.format_version() or pkg.version
            if pkg.licenses:
                comp["licenses"] = [{"license": {"name": li}}
                                    for li in pkg.licenses]
            if purl:
                comp["purl"] = purl
            props = []
            if pkg.file_path:
                props.append({"name": PROP_PREFIX + "FilePath",
                              "value": pkg.file_path})
            if pkg.id:
                props.append({"name": PROP_PREFIX + "PkgID",
                              "value": pkg.id})
            props.append({"name": PROP_PREFIX + "PkgType",
                          "value": res.type})
            if pkg.release:
                props.append({"name": PROP_PREFIX + "PkgRelease",
                              "value": pkg.release})
            if pkg.src_name:
                props.append({"name": PROP_PREFIX + "SrcName",
                              "value": pkg.src_name})
            if pkg.src_version:
                props.append({"name": PROP_PREFIX + "SrcVersion",
                              "value": pkg.src_version})
            if pkg.src_release:
                props.append({"name": PROP_PREFIX + "SrcRelease",
                              "value": pkg.src_release})
            if pkg.src_epoch:
                props.append({"name": PROP_PREFIX + "SrcEpoch",
                              "value": str(pkg.src_epoch)})
            comp["properties"] = sorted(props, key=lambda p: p["name"])
            deps[parent].append(ref)
            edges = sorted(
                id_to_ref[d] for d in pkg.depends_on if d in id_to_ref)
            if ref in deps:
                # same purl seen in another result: one component,
                # merged dependency edges (bom-refs must be unique)
                deps[ref] = sorted(set(deps[ref]) | set(edges))
            else:
                components.append(comp)
                deps[ref] = edges

        for v in res.vulnerabilities:
            entry = vulnerabilities.get(v.vulnerability_id)
            if entry is None:
                entry = _vuln_entry(v)
                vulnerabilities[v.vulnerability_id] = entry
            ref = pkg_refs.get((ri, v.pkg_name, v.installed_version),
                               f"{v.pkg_name}@{v.installed_version}")
            aff = {"ref": ref,
                   "versions": [{"version": v.installed_version,
                                 "status": "affected"}]}
            if aff not in entry["affects"]:
                entry["affects"].append(aff)

    dependencies = [{"ref": ref, "dependsOn": sorted(set(d))}
                    for ref, d in deps.items()]
    dependencies.sort(key=lambda d: d["ref"])
    return {
        "$schema": "http://cyclonedx.org/schema/bom-1.5.schema.json",
        "bomFormat": "CycloneDX",
        "specVersion": "1.5",
        "serialNumber": f"urn:uuid:{_next_uuid()}",
        "version": 1,
        "metadata": {
            "timestamp": _iso_tz(report.created_at),
            "tools": {"components": [{
                "type": "application",
                "group": "aquasecurity",
                "name": "trivy",
                "version": app_version,
            }]},
            "component": {
                "bom-ref": root_ref,
                "type": "container"
                if report.artifact_type == T.ArtifactType.CONTAINER_IMAGE
                else "application",
                "name": report.artifact_name,
                "properties": [{
                    "name": PROP_PREFIX + "SchemaVersion",
                    "value": str(report.schema_version),
                }],
            },
        },
        "components": components,
        "dependencies": dependencies,
        "vulnerabilities": sorted(vulnerabilities.values(),
                                  key=lambda v: v["id"]),
    }


def _vuln_entry(v: T.DetectedVulnerability) -> dict:
    detail = v.vulnerability
    ratings = []
    sources = sorted(set(detail.vendor_severity) | set(detail.cvss))
    for src in sources:
        c = detail.cvss.get(src)
        emitted = False
        if c is not None:
            if getattr(c, "v2_score", 0):
                ratings.append({
                    "source": {"name": src},
                    "score": c.v2_score,
                    "severity": _cvss_severity(c.v2_score),
                    "method": "CVSSv2",
                    "vector": c.v2_vector,
                })
                emitted = True
            if getattr(c, "v3_score", 0):
                method = "CVSSv31" if str(c.v3_vector).startswith(
                    "CVSS:3.1") else "CVSSv3"
                ratings.append({
                    "source": {"name": src},
                    "score": c.v3_score,
                    "severity": _cvss_severity(c.v3_score),
                    "method": method,
                    "vector": c.v3_vector,
                })
                emitted = True
        if not emitted and src in detail.vendor_severity:
            sev = detail.vendor_severity[src]
            sev_name = T.SEVERITIES[sev].lower() \
                if isinstance(sev, int) and sev < len(T.SEVERITIES) \
                else str(sev).lower()
            ratings.append({"source": {"name": src},
                            "severity": sev_name})
    entry = {
        "id": v.vulnerability_id,
        "source": ({"name": v.data_source.id, "url": v.data_source.url}
                   if v.data_source else {}),
        "ratings": ratings,
    }
    cwes = []
    for cw in detail.cwe_ids:
        m = str(cw).rsplit("-", 1)[-1]
        if m.isdigit():
            cwes.append(int(m))
    if cwes:
        entry["cwes"] = cwes
    if detail.description:
        entry["description"] = detail.description
    if v.fixed_version:
        entry["recommendation"] = (f"Upgrade {v.pkg_name} to version "
                                   f"{v.fixed_version}")
    advisories = []
    if v.primary_url:
        advisories.append({"url": v.primary_url})
    for r in detail.references:
        if r and r != v.primary_url:
            advisories.append({"url": r})
    if advisories:
        entry["advisories"] = advisories
    if detail.published_date:
        entry["published"] = _iso_tz(detail.published_date)
    if detail.last_modified_date:
        entry["updated"] = _iso_tz(detail.last_modified_date)
    entry["affects"] = []
    return entry
