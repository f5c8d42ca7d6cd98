"""`--format template --template <tpl|@file>` writer.

Mirrors pkg/report/template.go: the template executes over
report.Results (here: the JSON-shaped list of result dicts), with the
trivy function additions (escapeXML, escapeString, endWithPeriod,
sourceID, appVersion) plus the sprig subset the shipped contrib
templates use. `@path` loads the template from a file, as the
reference does (template.go:34-39).
"""

from __future__ import annotations

from .gotemplate import Template
from .. import types as T


def load_template(spec: str) -> str:
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return f.read()
    return spec


def write_template(report: T.Report, template_spec: str, out,
                   app_version: str = "dev", now=None) -> None:
    text = load_template(template_spec)
    funcs = {"appVersion": lambda: app_version}
    if now is not None:
        funcs["now"] = lambda: now
    tmpl = Template(text, funcs=funcs)
    results = report.to_json().get("Results") or []
    out.write(tmpl.render(results))
