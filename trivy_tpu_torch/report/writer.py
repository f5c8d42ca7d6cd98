"""Report assembly and writers (reference pkg/report/writer.go).

JSON matches the reference schema (pkg/types/report.go SchemaVersion 2,
Go PascalCase field names with omitempty), byte for byte what the JAX
package writes for the same results; so do the table, SARIF, template,
GitHub and cosign-vuln writers, which are the port's copies of the JAX
package's, and the SBOM formats (`sbom/io.write_sbom`: CycloneDX, and
SPDX JSON for both `spdx-json` and `spdx`). `report_from_json` decodes a
saved JSON report for `convert`, the same subset of fields the JAX
package decodes."""

from __future__ import annotations

import json
import sys
from collections import Counter

from .. import types as T


def build_report(artifact_name: str, artifact_type: str,
                 results: list[T.Result], os_info=None,
                 metadata: T.Metadata | None = None,
                 created_at: str = "") -> T.Report:
    metadata = metadata or T.Metadata()
    if os_info is not None and os_info.detected:
        metadata.os = os_info
    if not metadata.image_config:
        # non-image artifacts still carry the zero v1.ConfigFile
        # (Go struct marshal; see types.ZERO_IMAGE_CONFIG)
        metadata.image_config = dict(T.ZERO_IMAGE_CONFIG)
    return T.Report(
        schema_version=2,
        created_at=created_at,
        artifact_name=artifact_name,
        artifact_type=artifact_type,
        metadata=metadata,
        results=results,
    )


def to_json(report: T.Report) -> str:
    return json.dumps(report.to_json(), indent=2, ensure_ascii=False)


_SEV_ORDER = {s: i for i, s in enumerate(T.SEVERITIES)}

SBOM_FORMATS = ("cyclonedx", "spdx-json", "spdx")


def to_table(report: T.Report) -> str:
    lines = []
    for res in report.results:
        if res.misconfigurations or res.misconf_summary is not None:
            _misconf_table(res, lines)
        if res.licenses:
            _license_table(res, lines)
        if not (res.vulnerabilities or res.secrets):
            continue
        counts = Counter(v.severity for v in res.vulnerabilities)
        total = sum(counts.values())
        summary = ", ".join(
            f"{s}: {counts.get(s, 0)}"
            for s in reversed(T.SEVERITIES) if counts.get(s))
        lines.append("")
        lines.append(res.target)
        lines.append("=" * len(res.target))
        lines.append(f"Total: {total}" + (f" ({summary})" if summary else ""))
        lines.append("")
        if res.vulnerabilities:
            rows = [("Library", "Vulnerability", "Severity", "Installed",
                     "Fixed In", "Title")]
            for v in sorted(res.vulnerabilities,
                            key=lambda v: -_SEV_ORDER.get(v.severity, 0)):
                rows.append((v.pkg_name, v.vulnerability_id, v.severity,
                             v.installed_version, v.fixed_version,
                             (v.vulnerability.title or "")[:60]))
            widths = [max(len(r[i]) for r in rows) for i in range(6)]
            for r in rows:
                lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        for finding in res.secrets:
            lines.append(f"{finding.severity}: {finding.title} "
                         f"(line {finding.start_line})")
    return "\n".join(lines) + "\n"


def _misconf_table(res: T.Result, lines: list) -> None:
    """Misconfiguration section (reference pkg/report/table/
    misconfig.go:55-65): the Tests summary line, then one block per
    failure."""
    s = res.misconf_summary or T.MisconfSummary()
    title = f"{res.target} ({res.type})"
    lines.append("")
    lines.append(title)
    lines.append("=" * len(title))
    lines.append(f"Tests: {s.successes + s.failures + s.exceptions} "
                 f"(SUCCESSES: {s.successes}, FAILURES: {s.failures}, "
                 f"EXCEPTIONS: {s.exceptions})")
    counts = Counter(m.severity for m in res.misconfigurations)
    summary = ", ".join(f"{sev}: {counts.get(sev, 0)}"
                        for sev in reversed(T.SEVERITIES)
                        if counts.get(sev))
    lines.append(f"Failures: {len(res.misconfigurations)}"
                 + (f" ({summary})" if summary else ""))
    lines.append("")
    for m in sorted(res.misconfigurations,
                    key=lambda m: -_SEV_ORDER.get(m.severity, 0)):
        head = f"{m.severity}: {m.title} ({m.id})"
        lines.append(head)
        lines.append("-" * len(head))
        if m.message:
            lines.append(m.message)
        if m.primary_url:
            lines.append(f"See {m.primary_url}")
        cm = m.cause_metadata
        if cm is not None and cm.start_line:
            lines.append(f" {res.target}:{cm.start_line}"
                         + (f"-{cm.end_line}"
                            if cm.end_line and cm.end_line != cm.start_line
                            else ""))
            for cl in (cm.code.lines if cm.code else [])[:10]:
                lines.append(f"  {cl.number:>4} {cl.content}")
        lines.append("")


def _license_table(res: T.Result, lines: list) -> None:
    title = f"{res.target} (license)"
    lines.append("")
    lines.append(title)
    lines.append("=" * len(title))
    for lic in res.licenses:
        name = getattr(lic, "name", "")
        sev = getattr(lic, "severity", "")
        pkg = getattr(lic, "pkg_name", "") or \
            getattr(lic, "file_path", "")
        lines.append(f"{sev}: {pkg}: {name}")
    lines.append("")


def report_from_json(j: dict) -> T.Report:
    """Decode a saved JSON report (for `convert`,
    reference pkg/commands/convert/run.go)."""
    results = []
    for rj in j.get("Results", []):
        res = T.Result(
            target=rj.get("Target", ""),
            clazz=rj.get("Class", ""),
            type=rj.get("Type", ""),
        )
        for vj in rj.get("Vulnerabilities", []):
            v = T.DetectedVulnerability(
                vulnerability_id=vj.get("VulnerabilityID", ""),
                pkg_name=vj.get("PkgName", ""),
                pkg_path=vj.get("PkgPath", ""),
                installed_version=vj.get("InstalledVersion", ""),
                fixed_version=vj.get("FixedVersion", ""),
                status=vj.get("Status", ""),
                primary_url=vj.get("PrimaryURL", ""),
            )
            v.vulnerability.severity = vj.get("Severity", "UNKNOWN")
            v.vulnerability.title = vj.get("Title", "")
            lj = vj.get("Layer") or {}
            v.layer = T.Layer(digest=lj.get("Digest", ""),
                              diff_id=lj.get("DiffID", ""))
            res.vulnerabilities.append(v)
        for sj in rj.get("Secrets", []):
            res.secrets.append(T.SecretFinding(
                rule_id=sj.get("RuleID", ""), category=sj.get("Category", ""),
                severity=sj.get("Severity", ""), title=sj.get("Title", ""),
                start_line=sj.get("StartLine", 0),
                end_line=sj.get("EndLine", 0), match=sj.get("Match", "")))
        ms = rj.get("MisconfSummary")
        if isinstance(ms, dict):
            res.misconf_summary = T.MisconfSummary(
                successes=ms.get("Successes", 0),
                failures=ms.get("Failures", 0),
                exceptions=ms.get("Exceptions", 0))
        for mj in rj.get("Misconfigurations", []):
            m = T.DetectedMisconfiguration(
                type=mj.get("Type", ""), id=mj.get("ID", ""),
                avd_id=mj.get("AVDID", ""), title=mj.get("Title", ""),
                description=mj.get("Description", ""),
                message=mj.get("Message", ""),
                namespace=mj.get("Namespace", ""),
                resolution=mj.get("Resolution", ""),
                severity=mj.get("Severity", "UNKNOWN"),
                primary_url=mj.get("PrimaryURL", ""),
                status=mj.get("Status", ""))
            cm = mj.get("CauseMetadata")
            if isinstance(cm, dict):
                code = cm.get("Code") or {}
                m.cause_metadata = T.CauseMetadata(
                    provider=cm.get("Provider", ""),
                    service=cm.get("Service", ""),
                    start_line=cm.get("StartLine", 0),
                    end_line=cm.get("EndLine", 0),
                    code=T.Code(lines=[
                        T.CodeLine(number=cl.get("Number", 0),
                                   content=cl.get("Content", ""))
                        for cl in code.get("Lines") or []]))
            res.misconfigurations.append(m)
        for lj in rj.get("Licenses", []):
            res.licenses.append(T.DetectedLicense(
                severity=lj.get("Severity", ""),
                category=lj.get("Category", ""),
                pkg_name=lj.get("PkgName", ""),
                file_path=lj.get("FilePath", ""),
                name=lj.get("Name", ""),
                confidence=lj.get("Confidence", 0)))
        res.custom_resources = list(rj.get("CustomResources") or [])
        results.append(res)
    meta = j.get("Metadata") or {}
    os_j = meta.get("OS") or {}
    return T.Report(
        schema_version=j.get("SchemaVersion", 2),
        created_at=j.get("CreatedAt", ""),
        artifact_name=j.get("ArtifactName", ""),
        artifact_type=j.get("ArtifactType", ""),
        metadata=T.Metadata(
            os=T.OS(family=os_j.get("Family", ""),
                    name=os_j.get("Name", "")) if os_j else None,
            image_id=meta.get("ImageID", ""),
            repo_tags=meta.get("RepoTags", []),
        ),
        results=results,
    )


def render_json_report(path: str, fmt: str, out, template: str = "") -> None:
    with open(path) as f:
        report = report_from_json(json.load(f))
    write_report(report, fmt, out, template=template)


def write_report(report: T.Report, fmt: str = "json", output=None,
                 template: str = "", app_version: str = "dev") -> None:
    out = output or sys.stdout
    if fmt == "json":
        out.write(to_json(report) + "\n")
    elif fmt == "table":
        out.write(to_table(report))
    elif fmt == "sarif":
        from .sarif import to_sarif
        json.dump(to_sarif(report), out, indent=2)
        out.write("\n")
    elif fmt == "template":
        from .template import write_template
        if not template:
            raise ValueError("--format template requires --template")
        write_template(report, template, out, app_version=app_version)
    elif fmt == "github":
        from .github import write_github
        write_github(report, out, version=app_version)
    elif fmt == "cosign-vuln":
        from .predicate import write_cosign_vuln
        write_cosign_vuln(report, out, version=app_version)
    elif fmt in SBOM_FORMATS:
        from ..sbom.io import write_sbom
        write_sbom(report, fmt, out, app_version=app_version)
    else:
        raise ValueError(f"unsupported format {fmt!r}")
