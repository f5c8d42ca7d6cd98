"""struct ⇄ proto-dict converters (reference pkg/rpc/convert.go).

Two directions are needed for wire compat with binary Twirp clients:
- incoming `PutBlobRequest.blob_info` proto dicts → the Go-JSON shape
  our cache layer stores (ConvertFromRPC* family);
- outgoing scan results (our dataclasses) → `ScanResponse` proto dicts
  (ConvertToRPC* family).
"""

from __future__ import annotations

from .. import types as T
from .protowire import SEVERITY_NAMES


def _sev_enum(name: str) -> int:
    try:
        return SEVERITY_NAMES.index((name or "UNKNOWN").upper())
    except ValueError:
        return 0


# ---- incoming: proto BlobInfo → Go-JSON (cache shape) -----------------

def _pkg_json(p: dict) -> dict:
    out = {
        "ID": p.get("id", ""), "Name": p.get("name", ""),
        "Version": p.get("version", ""), "Release": p.get("release", ""),
        "Epoch": p.get("epoch", 0), "Arch": p.get("arch", ""),
        "SrcName": p.get("src_name", ""),
        "SrcVersion": p.get("src_version", ""),
        "SrcRelease": p.get("src_release", ""),
        "SrcEpoch": p.get("src_epoch", 0),
        "Licenses": p.get("licenses", []),
        "FilePath": p.get("file_path", ""),
        "DependsOn": p.get("depends_on", []),
        "Digest": p.get("digest", ""),
        "Dev": p.get("dev", False),
        "Indirect": p.get("indirect", False),
    }
    ident = p.get("identifier")
    if ident:
        # reference pkg/rpc/convert.go:239 maps BomRef<->BOMRef; UID is not
        # carried on the wire (proto PkgIdentifier has only purl+bom_ref)
        out["Identifier"] = {"PURL": ident.get("purl", ""),
                             "BOMRef": ident.get("bom_ref", "")}
    locs = p.get("locations")
    if locs:
        out["Locations"] = [{"StartLine": l.get("start_line", 0),
                             "EndLine": l.get("end_line", 0)}
                            for l in locs]
    layer = p.get("layer")
    if layer:
        out["Layer"] = _layer_json(layer)
    return out


def _layer_json(l: dict) -> dict:
    return {"Digest": l.get("digest", ""),
            "DiffID": l.get("diff_id", ""),
            "CreatedBy": l.get("created_by", "")}


def _cause_json(c: dict) -> dict:
    out = {"Resource": c.get("resource", ""),
           "Provider": c.get("provider", ""),
           "Service": c.get("service", ""),
           "StartLine": c.get("start_line", 0),
           "EndLine": c.get("end_line", 0)}
    code = c.get("code")
    if code:
        out["Code"] = {"Lines": [{
            "Number": ln.get("number", 0),
            "Content": ln.get("content", ""),
            "IsCause": ln.get("is_cause", False),
            "Annotation": ln.get("annotation", ""),
            "Truncated": ln.get("truncated", False),
            "Highlighted": ln.get("highlighted", ""),
            "FirstCause": ln.get("first_cause", False),
            "LastCause": ln.get("last_cause", False),
        } for ln in code.get("lines", [])]}
    return out


def proto_blob_to_json(b: dict) -> dict:
    """proto BlobInfo dict → the Go-JSON dict blob_from_json reads."""
    os_p = b.get("os") or {}
    out = {
        "SchemaVersion": b.get("schema_version", 2),
        "Digest": b.get("digest", ""),
        "DiffID": b.get("diff_id", ""),
        "OpaqueDirs": b.get("opaque_dirs", []),
        "WhiteoutFiles": b.get("whiteout_files", []),
        "OS": {"Family": os_p.get("family", ""),
               "Name": os_p.get("name", ""),
               "EOSL": os_p.get("eosl", False),
               "extended": os_p.get("extended", False)},
    }
    repo = b.get("repository")
    if repo:
        out["Repository"] = {"Family": repo.get("family", ""),
                             "Release": repo.get("release", "")}
    out["PackageInfos"] = [{
        "FilePath": pi.get("file_path", ""),
        "Packages": [_pkg_json(p) for p in pi.get("packages", [])],
    } for pi in b.get("package_infos", [])]
    out["Applications"] = [{
        "Type": a.get("type", ""),
        "FilePath": a.get("file_path", ""),
        "Packages": [_pkg_json(p) for p in a.get("libraries", [])],
    } for a in b.get("applications", [])]
    out["Misconfigurations"] = [{
        "FileType": m.get("file_type", ""),
        "FilePath": m.get("file_path", ""),
        "Successes": len(m.get("successes", [])),
        "Exceptions": len(m.get("exceptions", [])),
        "Failures": [_misconf_result_json(m, r)
                     for r in m.get("failures", [])],
    } for m in b.get("misconfigurations", [])]
    out["Secrets"] = [{
        "FilePath": s.get("filepath", ""),
        "Findings": [{
            "RuleID": f.get("rule_id", ""),
            "Category": f.get("category", ""),
            "Severity": f.get("severity", ""),
            "Title": f.get("title", ""),
            "StartLine": f.get("start_line", 0),
            "EndLine": f.get("end_line", 0),
            "Match": f.get("match", ""),
        } for f in s.get("findings", [])],
    } for s in b.get("secrets", [])]
    # the extension modules' output (absent without modules, so such a
    # blob converts as the JAX converter does)
    if b.get("custom_resources"):
        out["CustomResources"] = [{
            "Type": c.get("type", ""),
            "FilePath": c.get("file_path", ""),
            "Data": c.get("data"),
        } for c in b["custom_resources"]]
    return out


def _misconf_result_json(m: dict, r: dict) -> dict:
    pm = r.get("policy_metadata") or {}
    return {
        "Type": pm.get("type", m.get("file_type", "")),
        "ID": pm.get("id", ""),
        "AVDID": pm.get("adv_id", ""),
        "Title": pm.get("title", ""),
        "Description": pm.get("description", ""),
        "Message": r.get("message", ""),
        "Namespace": r.get("namespace", ""),
        "Resolution": pm.get("recommended_actions", ""),
        "Severity": pm.get("severity", "UNKNOWN"),
        "References": pm.get("references", []),
        "Status": "FAIL",
        "CauseMetadata": _cause_json(r.get("cause_metadata") or {}),
    }


# ---- outgoing: our dataclasses → proto ScanResponse -------------------

def _layer_proto(layer) -> dict:
    if layer is None:
        return {}
    return {"digest": layer.digest, "diff_id": layer.diff_id,
            "created_by": layer.created_by}


def _vuln_proto(v: T.DetectedVulnerability) -> dict:
    det = v.vulnerability  # embedded details (FillInfo)
    out = {
        "vulnerability_id": v.vulnerability_id,
        "vendor_ids": list(v.vendor_ids or []),
        "pkg_name": v.pkg_name,
        "pkg_id": v.pkg_id,
        "pkg_path": v.pkg_path,
        "installed_version": v.installed_version,
        "fixed_version": v.fixed_version,
        "title": det.title,
        "description": det.description,
        "severity": _sev_enum(v.severity),
        "severity_source": v.severity_source,
        "primary_url": v.primary_url,
        "references": list(det.references or []),
        "cwe_ids": list(det.cwe_ids or []),
        "layer": _layer_proto(v.layer),
    }
    if v.pkg_identifier and (v.pkg_identifier.purl
                             or v.pkg_identifier.bom_ref):
        out["pkg_identifier"] = {"purl": v.pkg_identifier.purl,
                                 "bom_ref": v.pkg_identifier.bom_ref}
    if det.cvss:
        cvss = {}
        for src, c in det.cvss.items():
            cvss[src] = {
                "v2_vector": getattr(c, "v2_vector", "") or
                (c.get("V2Vector", "") if isinstance(c, dict) else ""),
                "v3_vector": getattr(c, "v3_vector", "") or
                (c.get("V3Vector", "") if isinstance(c, dict) else ""),
                "v2_score": getattr(c, "v2_score", 0) or
                (c.get("V2Score", 0) if isinstance(c, dict) else 0),
                "v3_score": getattr(c, "v3_score", 0) or
                (c.get("V3Score", 0) if isinstance(c, dict) else 0),
            }
        out["cvss"] = cvss
    if det.vendor_severity:
        out["vendor_severity"] = {
            src: (_sev_enum(sev) if isinstance(sev, str)
                  else int(sev))
            for src, sev in det.vendor_severity.items()}
    if v.data_source is not None:
        ds = v.data_source
        out["data_source"] = {"id": ds.id, "name": ds.name,
                              "url": ds.url}
    if det.published_date:
        out["published_date"] = det.published_date
    if det.last_modified_date:
        out["last_modified_date"] = det.last_modified_date
    return out


def _misconf_proto(m) -> dict:
    cm = m.cause_metadata
    cause = {}
    if cm is not None:
        cause = {
            "resource": getattr(cm, "resource", ""),
            "provider": cm.provider, "service": cm.service,
            "start_line": cm.start_line, "end_line": cm.end_line,
        }
        if cm.code and cm.code.lines:
            cause["code"] = {"lines": [{
                "number": ln.number, "content": ln.content,
                "is_cause": ln.is_cause, "annotation": ln.annotation,
                "truncated": ln.truncated,
                "highlighted": ln.highlighted,
                "first_cause": ln.first_cause,
                "last_cause": ln.last_cause,
            } for ln in cm.code.lines]}
    return {
        "type": m.type, "id": m.id, "avd_id": m.avd_id,
        "title": m.title, "description": m.description,
        "message": m.message, "namespace": m.namespace,
        "query": m.query, "resolution": m.resolution,
        "severity": _sev_enum(m.severity),
        "primary_url": m.primary_url,
        "references": list(m.references or []),
        "status": m.status, "layer": _layer_proto(m.layer),
        "cause_metadata": cause,
    }


def _secret_proto(s) -> dict:
    return {
        "rule_id": s.rule_id, "category": s.category,
        "severity": s.severity, "title": s.title,
        "start_line": s.start_line, "end_line": s.end_line,
        "match": s.match, "layer": _layer_proto(s.layer),
    }


def _pkg_proto(p: T.Package) -> dict:
    return {
        "id": p.id, "name": p.name, "version": p.version,
        "release": p.release, "epoch": p.epoch, "arch": p.arch,
        "src_name": p.src_name, "src_version": p.src_version,
        "src_release": p.src_release, "src_epoch": p.src_epoch,
        "licenses": list(p.licenses or []),
        "file_path": p.file_path,
        "depends_on": list(p.depends_on or []),
        "digest": p.digest, "dev": p.dev, "indirect": p.indirect,
        "layer": _layer_proto(p.layer),
        "identifier": {"purl": p.identifier.purl,
                       "bom_ref": p.identifier.bom_ref}
        if p.identifier and (p.identifier.purl or p.identifier.bom_ref)
        else None,
    }


def results_to_proto(results: list[T.Result], os_info: T.OS) -> dict:
    out_results = []
    for r in results:
        pr = {
            "target": r.target, "class": r.clazz, "type": r.type,
            "vulnerabilities": [_vuln_proto(v)
                                for v in r.vulnerabilities],
            "misconfigurations": [_misconf_proto(m)
                                  for m in r.misconfigurations],
            "secrets": [_secret_proto(s) for s in r.secrets],
            "packages": [_pkg_proto(p) for p in r.packages],
            "custom_resources": [{
                "type": c.get("Type", ""),
                "file_path": c.get("FilePath", ""),
                "data": c.get("Data"),
            } for c in r.custom_resources],
        }
        out_results.append(pr)
    return {
        "os": {"family": os_info.family, "name": os_info.name,
               "eosl": os_info.eosl},
        "results": out_results,
    }
