"""The port's result filtering, ignore files and VEX held against the JAX
package's on the same seeded inputs: `result/ignore.py` (plain and YAML
forms, expiry dates, path globs), `result/filter.py` (severity, unfixed,
status and ignore-file filters) and `vex.py` (OpenVEX, CycloneDX VEX,
CSAF). Each case runs through both packages and must give the same
findings; the VEX cases mirror tests/test_license_vex_sarif.py."""

import dataclasses
import datetime as dt
import json

import numpy as np
import pytest

from trivy_tpu import types as RT
from trivy_tpu import vex as ref_vex
from trivy_tpu.result import FilterOptions as RefFilterOptions
from trivy_tpu.result import filter_results as ref_filter
from trivy_tpu.result import parse_ignore_file as ref_parse
from trivy_tpu_torch import types as PT
from trivy_tpu_torch import vex as port_vex
from trivy_tpu_torch.result import FilterOptions as PortFilterOptions
from trivy_tpu_torch.result import filter_results as port_filter
from trivy_tpu_torch.result import parse_ignore_file as port_parse

SEVERITIES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]
STATUSES = ["", "fixed", "affected", "will_not_fix", "fix_deferred",
            "end_of_life"]
TARGETS = ["app/package-lock.json", "srv (alpine 3.17.3)",
           "usr/lib/python3/site-packages", "Java"]
IDS = [f"CVE-2024-{i:04d}" for i in range(12)] + \
    [f"GHSA-aaaa-bbbb-{i:04d}" for i in range(4)]
RULES = ["aws-access-key-id", "github-pat", "private-key", "slack-token"]

PLAIN_IGNORE = f"""\
# comment line
{IDS[0]}
{IDS[1]}  exp:2019-01-01    # expired: ignores nothing
{IDS[2]} exp:2999-12-31 app/*
{IDS[3]} srv*
github-pat
   {IDS[4]}   usr/lib/*   Java
"""

YAML_IGNORE = f"""\
vulnerabilities:
  - id: {IDS[5]}
  - id: {IDS[6]}
    expired_at: 2019-06-01
  - id: {IDS[7]}
    paths: ["app/*"]
    statement: not reachable
  - id: {IDS[8]}
    expired_at: 2999-01-01
    paths: ["Java", "usr/*"]
secrets:
  - id: aws-access-key-id
    paths: ["app/*"]
  - id: private-key
misconfigurations:
  - id: DS002
licenses:
  - id: GPL-3.0
"""


def _build(T, spec: list):
    """Result specs (plain dicts) → Results of the types module T."""
    out = []
    for r in spec:
        res = T.Result(target=r["target"], clazz=r["clazz"],
                       type=r.get("type", ""))
        for v in r.get("vulns", []):
            dv = T.DetectedVulnerability(
                vulnerability_id=v["id"], pkg_name=v["pkg"],
                pkg_path=v.get("path", ""), installed_version="1.0.0",
                fixed_version=v.get("fixed", ""), status=v.get("status", ""),
                pkg_identifier=T.PkgIdentifier(purl=v.get("purl", "")))
            dv.vulnerability.severity = v["severity"]
            res.vulnerabilities.append(dv)
        for s in r.get("secrets", []):
            res.secrets.append(T.SecretFinding(
                rule_id=s["rule"], severity=s["severity"], title=s["rule"],
                start_line=s["line"], end_line=s["line"], match="****"))
        for m in r.get("misconfs", []):
            res.misconfigurations.append(T.DetectedMisconfiguration(
                id=m["id"], severity=m["severity"], title=m["id"]))
        out.append(res)
    return out


def _seeded_spec(seed: int) -> list:
    rng = np.random.default_rng(seed)
    spec = []
    for i, target in enumerate(TARGETS):
        clazz = ("lang-pkgs", "os-pkgs", "lang-pkgs", "lang-pkgs")[i]
        vulns = [{"id": IDS[int(rng.integers(len(IDS)))],
                  "pkg": f"pkg{int(rng.integers(5))}",
                  "path": "usr/lib/python3/x" if rng.random() < 0.2 else "",
                  "fixed": "2.0.0" if rng.random() < 0.6 else "",
                  "status": STATUSES[int(rng.integers(len(STATUSES)))],
                  "severity": SEVERITIES[int(rng.integers(5))]}
                 for _ in range(int(rng.integers(0, 14)))]
        spec.append({"target": target, "clazz": clazz, "vulns": vulns})
    spec.append({"target": "app/config.env", "clazz": "secret", "secrets": [
        {"rule": RULES[int(rng.integers(len(RULES)))],
         "severity": SEVERITIES[int(rng.integers(1, 5))],
         "line": int(rng.integers(1, 50))} for _ in range(5)]})
    spec.append({"target": "Dockerfile", "clazz": "config", "misconfs": [
        {"id": f"DS00{int(rng.integers(1, 4))}",
         "severity": SEVERITIES[int(rng.integers(1, 5))]}
        for _ in range(3)]})
    spec.append({"target": "empty.txt", "clazz": "secret"})
    return spec


def _json(results) -> str:
    return json.dumps([r.to_json() for r in results], sort_keys=True)


@pytest.mark.parametrize("text,name", [(PLAIN_IGNORE, ".trivyignore"),
                                       (YAML_IGNORE, ".trivyignore.yaml")])
def test_ignore_file_parses_and_matches_like_reference(text, name,
                                                       tmp_path):
    p = tmp_path / name
    p.write_text(text)
    port, ref = port_parse(str(p)), ref_parse(str(p))
    for section in ("vulnerabilities", "misconfigurations", "secrets",
                    "licenses"):
        assert [dataclasses.asdict(e) for e in getattr(port, section)] == \
            [dataclasses.asdict(e) for e in getattr(ref, section)]
        for fid in IDS + RULES + ["DS002", "GPL-3.0"]:
            for path in TARGETS + ["app/x", "usr/lib/a", ""]:
                assert port.match(section, fid, path) == \
                    ref.match(section, fid, path), (section, fid, path)


def test_expiry_and_paths():
    from trivy_tpu_torch.result.ignore import IgnoreEntry
    e = IgnoreEntry(id="CVE-1", paths=["app/*"],
                    expired_at=dt.date(2026, 1, 1))
    assert e.matches("CVE-1", "app/a", today=dt.date(2026, 1, 1))
    assert not e.matches("CVE-1", "app/a", today=dt.date(2026, 1, 2))
    assert not e.matches("CVE-1", "srv/a", today=dt.date(2025, 1, 1))
    assert not e.matches("CVE-2", "app/a", today=dt.date(2025, 1, 1))


FILTERS = [
    {},
    {"severities": ["HIGH", "CRITICAL"]},
    {"severities": ["CRITICAL"], "ignore_unfixed": True},
    {"ignore_unfixed": True, "ignore_statuses": ["will_not_fix",
                                                 "end_of_life"]},
    {"ignore_file": "plain"},
    {"ignore_file": "yaml", "severities": ["MEDIUM", "HIGH", "CRITICAL"]},
    {"ignore_file": "yaml", "ignore_unfixed": True,
     "ignore_statuses": ["fix_deferred"], "severities": ["LOW", "HIGH"]},
]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("opts", FILTERS,
                         ids=[f"f{i}" for i in range(len(FILTERS))])
def test_filter_results_like_reference(seed, opts, tmp_path):
    kw = dict(opts)
    files = {"plain": (".trivyignore", PLAIN_IGNORE),
             "yaml": (".trivyignore.yaml", YAML_IGNORE)}
    which = kw.pop("ignore_file", None)
    port_kw, ref_kw = dict(kw), dict(kw)
    if which:
        name, text = files[which]
        p = tmp_path / name
        p.write_text(text)
        port_kw["ignore_file"] = port_parse(str(p))
        ref_kw["ignore_file"] = ref_parse(str(p))
    spec = _seeded_spec(seed)
    port = port_filter(_build(PT, spec), PortFilterOptions(**port_kw))
    ref = ref_filter(_build(RT, spec), RefFilterOptions(**ref_kw))
    assert _json(port) == _json(ref)
    assert [r.target for r in port] == [r.target for r in ref]


def _vuln_spec(vid, purl="", pkg="openssl"):
    return {"id": vid, "pkg": pkg, "purl": purl, "severity": "HIGH"}


OPENVEX = {
    "@context": "https://openvex.dev/ns/v0.2.0",
    "statements": [
        {"vulnerability": {"name": "CVE-2023-0286"},
         "products": [{"@id": "pkg:apk/alpine/openssl@3.0.7-r0"}],
         "status": "not_affected",
         "justification": "vulnerable_code_not_in_execute_path"},
        {"vulnerability": {"name": "CVE-2023-9999"}, "status": "affected"},
        {"vulnerability": "CVE-2023-7777", "status": "fixed",
         "products": ["pkg:npm/lodash@4.17.20",
                      {"identifiers": {"purl": "pkg:npm/left-pad@1.0.0"}}]},
    ],
}
CYCLONEDX_VEX = {
    "bomFormat": "CycloneDX", "specVersion": "1.5",
    "vulnerabilities": [
        {"id": "CVE-2023-0286", "analysis": {"state": "not_affected"},
         "affects": [{"ref": "pkg:apk/alpine/openssl@3.0.7-r0"}]},
        {"id": "CVE-2023-7777", "analysis": {"state": "resolved"},
         "affects": [{"ref": "lodash@4.17.20"}]},
        {"id": "CVE-2023-9999", "analysis": {"state": "exploitable"}},
    ],
}
CSAF = {
    "document": {"category": "csaf_vex", "csaf_version": "2.0"},
    "product_tree": {
        "branches": [{"branches": [{"product": {
            "product_id": "PKG-1",
            "product_identification_helper": {
                "purl": "pkg:pypi/werkzeug@0.11"}}}]}],
        # parent listed before the relationship that defines its
        # reference: needs the fixed-point resolution
        "relationships": [
            {"product_reference": "APP-PKG-1",
             "full_product_name": {"product_id": "HOST-APP"}},
            {"product_reference": "PKG-1",
             "full_product_name": {"product_id": "APP-PKG-1"}}]},
    "vulnerabilities": [
        {"cve": "CVE-2019-14806",
         "product_status": {"known_not_affected": ["HOST-APP"]}},
        {"cve": "CVE-2019-0001",
         "product_status": {"known_not_affected": ["UNRESOLVED"]}},
        {"cve": "CVE-2019-0002", "product_status": {"fixed": ["PKG-1"]}},
    ],
}
VEX_RESULTS = [{"target": "t", "clazz": "os-pkgs", "vulns": [
    _vuln_spec("CVE-2023-0286", "pkg:apk/alpine/openssl@3.0.7-r0?arch=x86"),
    _vuln_spec("CVE-2023-0286", "pkg:apk/alpine/openssl@3.0.8-r0"),
    _vuln_spec("CVE-2023-9999"),
    _vuln_spec("CVE-2023-7777", "pkg:npm/lodash@4.17.20", "lodash"),
    _vuln_spec("CVE-2023-7777", "pkg:npm/left-pad@1.0.0", "left-pad"),
    _vuln_spec("CVE-2023-7777", "", "lodash"),
    _vuln_spec("CVE-2019-14806", "pkg:pypi/werkzeug@0.11", "werkzeug"),
    _vuln_spec("CVE-2019-14806", "pkg:pypi/flask@2.0", "flask"),
    _vuln_spec("CVE-2019-0001", "pkg:pypi/werkzeug@0.11", "werkzeug"),
    _vuln_spec("CVE-2019-0002", "pkg:pypi/werkzeug@0.11", "werkzeug"),
]}]


@pytest.mark.parametrize("doc", [OPENVEX, CYCLONEDX_VEX, CSAF],
                         ids=["openvex", "cyclonedx", "csaf"])
def test_vex_like_reference(doc, tmp_path):
    p = tmp_path / "vex.json"
    p.write_text(json.dumps(doc))
    port_st, ref_st = port_vex.load_vex_file(str(p)), \
        ref_vex.load_vex_file(str(p))
    assert [dataclasses.asdict(s) for s in port_st] == \
        [dataclasses.asdict(s) for s in ref_st]
    port, ref = _build(PT, VEX_RESULTS), _build(RT, VEX_RESULTS)
    port_vex.apply_vex(port, port_st)
    ref_vex.apply_vex(ref, ref_st)
    assert _json(port) == _json(ref)
    assert len(port[0].vulnerabilities) < len(VEX_RESULTS[0]["vulns"])


def test_openvex_suppression_by_purl_and_wildcard():
    res = _build(PT, [{"target": "t", "clazz": "os-pkgs", "vulns": [
        _vuln_spec("CVE-1", "pkg:apk/alpine/openssl@3.0.7-r0?arch=x86"),
        _vuln_spec("CVE-2")]}])
    port_vex.apply_vex(res, [
        port_vex.VexStatement("CVE-1", "not_affected",
                              products=("pkg:apk/alpine/openssl@3.0.7-r0",)),
        port_vex.VexStatement("CVE-2", "affected")])
    assert [v.vulnerability_id for v in res[0].vulnerabilities] == ["CVE-2"]
    port_vex.apply_vex(res, [port_vex.VexStatement("CVE-2", "fixed")])
    assert res[0].vulnerabilities == []


def test_unknown_vex_format_raises(tmp_path):
    p = tmp_path / "vex.json"
    p.write_text("{}")
    with pytest.raises(ValueError, match="unrecognized VEX format"):
        port_vex.load_vex_file(str(p))
