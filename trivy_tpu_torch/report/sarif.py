"""SARIF 2.1.0 writer (reference pkg/report/sarif.go): class-based
rule names, CVSS-derived security-severity, the reference's help/
markdown/message templates, and per-package locations — CI systems
that consume the reference's SARIF read this output unchanged."""

from __future__ import annotations

import html
import re

from .. import types as T

_LEVEL = {"CRITICAL": "error", "HIGH": "error", "MEDIUM": "warning",
          "LOW": "note", "UNKNOWN": "note"}

_RULE_NAME = {
    T.ResultClass.OS_PKGS: "OsPackageVulnerability",
    T.ResultClass.LANG_PKGS: "LanguageSpecificPackageVulnerability",
    T.ResultClass.CONFIG: "Misconfiguration",
    T.ResultClass.SECRET: "Secret",
    T.ResultClass.LICENSE: "License",
    T.ResultClass.LICENSE_FILE: "License",
}

_SEVERITY_SCORE = {"CRITICAL": "9.5", "HIGH": "8.0", "MEDIUM": "5.5",
                   "LOW": "2.0"}

_BUILTIN_RULES_URL = ("https://github.com/aquasecurity/trivy/blob/"
                      "main/pkg/fanal/secret/builtin-rules.go")

# strips the " (distro:version)" suffix from OS targets (sarif.go
# pathRegex)
_PATH_RE = re.compile(r"(?P<path>.+?)(?:\s*\((?:.*?)\).*?)?$")


def _level(severity: str) -> str:
    return _LEVEL.get(severity, "none")


def _severity_score(severity: str) -> str:
    return _SEVERITY_SCORE.get(severity, "0.0")


def _cvss_score(v: T.DetectedVulnerability) -> str:
    """Vendor V3 score when present, else the severity → score table
    (sarif.go getCVSSScore)."""
    cvss = v.vulnerability.cvss or {}
    src = cvss.get(v.severity_source)
    score = getattr(src, "v3_score", None) if src is not None else None
    if isinstance(src, dict):
        score = src.get("V3Score")
    if score:
        return f"{float(score):.1f}"
    return _severity_score(v.severity)


def _to_path_uri(target: str, clazz: str) -> str:
    """Image refs / OS targets → repository-style path (sarif.go
    ToPathUri + clearURI)."""
    if clazz != T.ResultClass.OS_PKGS:
        return _clear_uri(target)
    m = _PATH_RE.match(target)
    if m:
        target = m.group("path")
    # registry refs: drop the host and tag/digest, keep the repository
    ref = target.split("@", 1)[0]
    if "/" in ref:
        head, rest = ref.split("/", 1)
        if "." in head or ":" in head or head == "localhost":
            ref = rest
    if ":" in ref.rsplit("/", 1)[-1]:
        ref = ref.rsplit(":", 1)[0]
    return _clear_uri(ref)


def _line_span(loc) -> tuple:
    """A package location → (start line, end line). The lockfile
    analyzers keep locations in their report shape, {"StartLine": ..,
    "EndLine": ..}; the JAX package's writer reads only Location
    objects and fails on those (ROADMAP §C)."""
    if isinstance(loc, dict):
        return loc.get("StartLine", 0), loc.get("EndLine", 0)
    return loc.start_line, loc.end_line


def _clear_uri(s: str) -> str:
    return s.replace("\\", "/").replace("git::https:/", "")


def to_sarif(report: T.Report) -> dict:
    rules: list[dict] = []
    rule_index: dict[str, int] = {}
    results = []

    def add(*, rule_id: str, clazz: str, tag: str, severity: str,
            score: str, short: str, full: str, help_text: str,
            help_md: str, message: str, artifact: str,
            loc_message: str, locations: list, url: str = ""):
        # re-adding an existing rule OVERWRITES its content (go-sarif
        # AddRule returns the existing rule and the With* setters
        # mutate it, so the reference's last result wins)
        rule = {
            "id": rule_id,
            "name": _RULE_NAME.get(clazz, "UnknownIssue"),
            "shortDescription": {
                "text": html.escape(short, quote=False)},
            "fullDescription": {
                "text": html.escape(full, quote=False)},
            "defaultConfiguration": {"level": _level(severity)},
            "help": {"text": help_text, "markdown": help_md},
            "properties": {
                "precision": "very-high",
                "security-severity": score,
                "tags": [tag, "security", severity],
            },
        }
        if url:
            rule["helpUri"] = url
        if rule_id not in rule_index:
            rule_index[rule_id] = len(rules)
            rules.append(rule)
        else:
            rules[rule_index[rule_id]] = rule
        locs = locations or [(1, 1)]
        results.append({
            "ruleId": rule_id,
            "ruleIndex": rule_index[rule_id],
            "level": _level(severity),
            "message": {"text": message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": artifact,
                        "uriBaseId": "ROOTPATH",
                    },
                    "region": {
                        "startLine": max(s, 1), "startColumn": 1,
                        "endLine": max(e, 1), "endColumn": 1,
                    },
                },
                "message": {"text": loc_message},
            } for s, e in locs],
        })

    for res in report.results:
        target = _to_path_uri(res.target, res.clazz)
        loc_index: dict = {}
        for p in (res.packages or []):
            loc_index.setdefault((p.name, p.version), []).extend(
                _line_span(loc) for loc in (p.locations or []))
        for v in res.vulnerabilities:
            path = target
            if getattr(v, "pkg_path", ""):
                path = _to_path_uri(v.pkg_path, res.clazz)
            desc = v.vulnerability.description or \
                v.vulnerability.title or ""
            pkg_locs = loc_index.get(
                (v.pkg_name, v.installed_version), [])
            add(rule_id=v.vulnerability_id, clazz=res.clazz,
                tag="vulnerability", severity=v.severity,
                score=_cvss_score(v),
                short=v.vulnerability.title or v.vulnerability_id,
                full=desc,
                help_text=(
                    f"Vulnerability {v.vulnerability_id}\n"
                    f"Severity: {v.severity}\n"
                    f"Package: {v.pkg_name}\n"
                    f"Fixed Version: {v.fixed_version}\n"
                    f"Link: [{v.vulnerability_id}]({v.primary_url})\n"
                    f"{v.vulnerability.description or ''}"),
                help_md=(
                    f"**Vulnerability {v.vulnerability_id}**\n"
                    f"| Severity | Package | Fixed Version | Link |\n"
                    f"| --- | --- | --- | --- |\n"
                    f"|{v.severity}|{v.pkg_name}|{v.fixed_version}|"
                    f"[{v.vulnerability_id}]({v.primary_url})|\n\n"
                    f"{v.vulnerability.description or ''}"),
                message=(
                    f"Package: {v.pkg_name}\n"
                    f"Installed Version: {v.installed_version}\n"
                    f"Vulnerability {v.vulnerability_id}\n"
                    f"Severity: {v.severity}\n"
                    f"Fixed Version: {v.fixed_version}\n"
                    f"Link: [{v.vulnerability_id}]({v.primary_url})"),
                artifact=path,
                loc_message=f"{path}: {v.pkg_name}@"
                            f"{v.installed_version}",
                locations=pkg_locs, url=v.primary_url)
        for m in res.misconfigurations:
            uri = _clear_uri(res.target)
            add(rule_id=m.id, clazz=res.clazz,
                tag="misconfiguration", severity=m.severity,
                score=_severity_score(m.severity),
                short=m.title, full=m.description,
                help_text=(
                    f"Misconfiguration {m.id}\nType: {m.type}\n"
                    f"Severity: {m.severity}\nCheck: {m.title}\n"
                    f"Message: {m.message}\n"
                    f"Link: [{m.id}]({m.primary_url})\n"
                    f"{m.description}"),
                help_md=(
                    f"**Misconfiguration {m.id}**\n"
                    f"| Type | Severity | Check | Message | Link |\n"
                    f"| --- | --- | --- | --- | --- |\n"
                    f"|{m.type}|{m.severity}|{m.title}|{m.message}|"
                    f"[{m.id}]({m.primary_url})|\n\n{m.description}"),
                message=(
                    f"Artifact: {uri}\nType: {res.type}\n"
                    f"Vulnerability {m.id}\nSeverity: {m.severity}\n"
                    f"Message: {m.message}\n"
                    f"Link: [{m.id}]({m.primary_url})"),
                artifact=uri, loc_message=uri,
                locations=[(m.cause_metadata.start_line,
                            m.cause_metadata.end_line)],
                url=m.primary_url)
        for f in res.secrets:
            add(rule_id=f.rule_id, clazz=res.clazz, tag="secret",
                severity=f.severity,
                score=_severity_score(f.severity),
                short=f.title, full=f.match,
                help_text=(f"Secret {f.title}\n"
                           f"Severity: {f.severity}\n"
                           f"Match: {f.match}"),
                help_md=(f"**Secret {f.title}**\n"
                         f"| Severity | Match |\n| --- | --- |\n"
                         f"|{f.severity}|{f.match}|"),
                message=(f"Artifact: {res.target}\n"
                         f"Type: {res.type}\n"
                         f"Secret {f.title}\n"
                         f"Severity: {f.severity}\n"
                         f"Match: {f.match}"),
                artifact=target, loc_message=target,
                locations=[(f.start_line, f.end_line)],
                url=_BUILTIN_RULES_URL)

    doc = {
        "version": "2.1.0",
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "runs": [{
            "tool": {
                "driver": {
                    "fullName": "trivy-tpu Vulnerability Scanner",
                    "informationUri": "https://github.com/trivy-tpu",
                    "name": "trivy-tpu",
                    "rules": rules,
                },
            },
            "results": results,
            "columnKind": "utf16CodeUnits",
            "originalUriBaseIds": {
                "ROOTPATH": {"uri": "file:///"},
            },
        }],
    }
    if report.artifact_type == T.ArtifactType.CONTAINER_IMAGE:
        md = report.metadata
        doc["runs"][0]["properties"] = {
            "imageName": report.artifact_name,
            "repoTags": getattr(md, "repo_tags", []) or [],
            "repoDigests": getattr(md, "repo_digests", []) or [],
        }
    return doc
