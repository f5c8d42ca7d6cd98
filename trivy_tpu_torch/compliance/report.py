"""Compliance report assembly + writers (reference
pkg/compliance/report/report.go — BuildComplianceReport, summary and
all writers).

A control PASSes when the scan produced no matching failure, FAILs on
any matching misconfiguration failure / vulnerability / secret, and is
MANUAL when it has no automated checks."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .. import types as T
from .spec import Control, Spec

_SEV_ORDER = {s: i for i, s in enumerate(T.SEVERITIES)}


@dataclass
class ControlResult:
    control: Control
    status: str = "PASS"     # PASS | FAIL | MANUAL
    failures: list = field(default_factory=list)  # misconf/vuln/secret


@dataclass
class ComplianceReport:
    spec: Spec
    results: list = field(default_factory=list)   # [ControlResult]


def _check_index(results):
    """check-id → [(result, finding)] over misconfigurations, plus
    severity buckets for VULN-*/SECRET-* pseudo-checks."""
    by_check: dict[str, list] = {}
    for res in results:
        for m in res.misconfigurations:
            if m.status != "FAIL":
                continue
            for key in (m.id, m.avd_id):
                if key:
                    by_check.setdefault(key.upper(), []).append((res, m))
        for v in res.vulnerabilities:
            sev = (v.vulnerability.severity or "UNKNOWN").upper()
            by_check.setdefault(f"VULN-{sev}", []).append((res, v))
        for s in res.secrets:
            sev = (s.severity or "UNKNOWN").upper()
            by_check.setdefault(f"SECRET-{sev}", []).append((res, s))
    return by_check


def build_compliance_report(spec: Spec,
                            results: list) -> ComplianceReport:
    by_check = _check_index(results)
    out = ComplianceReport(spec=spec)
    for control in spec.controls:
        cr = ControlResult(control=control)
        if not control.checks:
            cr.status = control.default_status or "MANUAL"
        else:
            for check_id in control.checks:
                for _res, finding in by_check.get(check_id.upper(), []):
                    cr.failures.append(finding)
            cr.status = "FAIL" if cr.failures else "PASS"
        out.results.append(cr)
    return out


def to_summary_table(report: ComplianceReport) -> str:
    from ..report.tables import render_table
    head = ["ID", "Name", "Status", "Issues"]
    rows = [[cr.control.id, cr.control.name[:60], cr.status,
             str(len(cr.failures))] for cr in report.results]
    return render_table(
        "Summary Report for compliance: " + report.spec.title,
        head, rows)


def _finding_json(f):
    if isinstance(f, T.DetectedMisconfiguration):
        return {"Type": "misconfiguration", "ID": f.id,
                "AVDID": f.avd_id, "Title": f.title,
                "Severity": f.severity, "Message": f.message}
    if isinstance(f, T.DetectedVulnerability):
        return {"Type": "vulnerability",
                "VulnerabilityID": f.vulnerability_id,
                "PkgName": f.pkg_name,
                "InstalledVersion": f.installed_version,
                "Severity": f.vulnerability.severity}
    if isinstance(f, T.SecretFinding):
        return {"Type": "secret", "RuleID": f.rule_id,
                "Severity": f.severity, "Title": f.title}
    return {"Type": "unknown"}


def to_json_report(report: ComplianceReport) -> str:
    doc = {
        "ID": report.spec.id,
        "Title": report.spec.title,
        "Description": report.spec.description,
        "Version": report.spec.version,
        "RelatedResources": report.spec.related_resources,
        "SummaryControls": [
            {"ID": cr.control.id, "Name": cr.control.name,
             "Severity": cr.control.severity,
             "Status": cr.status, "TotalFail": len(cr.failures)}
            for cr in report.results],
        "Results": [
            {"ID": cr.control.id, "Name": cr.control.name,
             "Description": cr.control.description,
             "Severity": cr.control.severity, "Status": cr.status,
             "Findings": sorted(
                 (_finding_json(f) for f in cr.failures),
                 key=lambda d: (-_SEV_ORDER.get(
                     d.get("Severity") or "UNKNOWN", 0), str(d)))}
            for cr in report.results],
    }
    return json.dumps(doc, indent=2)


def write_compliance(report: ComplianceReport, mode: str = "summary",
                     fmt: str = "table", output=None) -> None:
    import sys
    out = output or sys.stdout
    if fmt == "json" or mode == "all":
        out.write(to_json_report(report) + "\n")
    else:
        out.write(to_summary_table(report))
