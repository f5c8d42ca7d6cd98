"""Cosign vulnerability-scan attestation predicate
(`--format cosign-vuln`), mirroring pkg/report/predicate/vuln.go:
the full report embedded under scanner.result, scanner URI as a
github purl, scan timestamps in metadata.
"""

from __future__ import annotations

import json

from .. import types as T


def to_cosign_vuln(report: T.Report, version: str = "dev",
                   now: str = "") -> dict:
    now = now or report.created_at
    return {
        "invocation": {
            "parameters": None,
            "uri": "",
            "event_id": "",
            "builder.id": "",
        },
        "scanner": {
            "uri": f"pkg:github/aquasecurity/trivy@{version}",
            "version": version,
            "db": {"uri": "", "version": ""},
            "result": report.to_json(),
        },
        "metadata": {
            "scanStartedOn": now,
            "scanFinishedOn": now,
        },
    }


def write_cosign_vuln(report: T.Report, out, version: str = "dev") -> None:
    json.dump(to_cosign_vuln(report, version=version), out, indent=2,
              ensure_ascii=False)
    out.write("\n")
