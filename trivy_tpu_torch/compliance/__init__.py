"""Compliance reports (reference pkg/compliance).

The reference embeds compliance specs (docker-cis-1.6.0, k8s-cis,
k8s-nsa, k8s-pss-*, aws-cis — pkg/compliance/spec/compliance.go) that
map framework controls to individual check IDs, filters scan results
down to the checks a spec references, and renders either a summary
table (per-control pass/fail counts) or a full per-control report
(pkg/compliance/report).  Same model here: specs are data, controls
match results by check ID (AVD ID or scanner-local ID), and the report
builder consumes the standard types.Report."""

from .report import (ComplianceReport, build_compliance_report,  # noqa: F401
                     write_compliance)
from .spec import SPECS, Control, Spec, get_spec  # noqa: F401
