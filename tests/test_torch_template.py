"""The port's Go-template engine (`report/gotemplate.py`) and its
template, GitHub and cosign-vuln writers held against the JAX package's:
the engine cases of tests/test_template.py, each rendered by both
engines on the same data, and the writers on one seeded report built in
both packages' types, compared byte for byte."""

import datetime as dt
import io
import json

import pytest

from trivy_tpu import types as RT
from trivy_tpu.report import build_report as ref_build_report
from trivy_tpu.report import gotemplate as ref_gt
from trivy_tpu.report.github import to_github as ref_github
from trivy_tpu.report.predicate import to_cosign_vuln as ref_cosign
from trivy_tpu.report.template import write_template as ref_write_template
from trivy_tpu_torch import types as PT
from trivy_tpu_torch.report import build_report
from trivy_tpu_torch.report import gotemplate as gt
from trivy_tpu_torch.report.github import to_github
from trivy_tpu_torch.report.predicate import to_cosign_vuln
from trivy_tpu_torch.report.template import write_template

NOW = dt.datetime(2026, 7, 29, 13, 5, 9, tzinfo=dt.timezone.utc)

# (template, data, expected output): tests/test_template.py's engine cases
CASES = [
    ("hello {{ .Name }}!", {"Name": "world"}, "hello world!"),
    ("{{ .A.B.C }}", {"A": {"B": {"C": 7}}}, "7"),
    ("{{ . }}", "x", "x"),
    ("a  {{- /* c */ -}}  b", {}, "ab"),
    ("x\n{{- .V }}", {"V": 1}, "x1"),
    ("{{ if .A }}a{{ else if .B }}b{{ else }}c{{ end }}", {"A": True}, "a"),
    ("{{ if .A }}a{{ else if .B }}b{{ else }}c{{ end }}",
     {"A": False, "B": 1}, "b"),
    ("{{ if .A }}a{{ else if .B }}b{{ else }}c{{ end }}", {}, "c"),
    ("{{ range . }}[{{ . }}]{{ end }}", [1, 2], "[1][2]"),
    ("{{ range . }}x{{ else }}empty{{ end }}", [], "empty"),
    ("{{ range $i, $v := . }}{{ $i }}={{ $v }};{{ end }}", ["a", "b"],
     "0=a;1=b;"),
    ("{{ $first := true }}{{ range . }}{{ if $first }}{{ $first = false }}"
     "{{ else }},{{ end }}{{ . }}{{ end }}", [1, 2, 3], "1,2,3"),
    ("{{ with .A }}<{{ .B }}>{{ end }}", {"A": {"B": 5}}, "<5>"),
    ("{{ with .Z }}x{{ else }}none{{ end }}", {}, "none"),
    ('{{ .N | printf "%03d" }}', {"N": 7}, "007"),
    ("{{ (index . 1) }}", ["a", "b"], "b"),
    ('{{ if not (eq .T "") }}y{{ end }}', {"T": "x"}, "y"),
    ("{{ range .L }}{{ $.Tag }}{{ . }}{{ end }}", {"Tag": "#", "L": [1, 2]},
     "#1#2"),
    ('{{ if eq .S "a" "b" }}y{{ end }}', {"S": "b"}, "y"),
    ("{{ if gt .N 3 }}big{{ end }}", {"N": 5}, "big"),
    ('{{ printf "%s=%d" "x" 3 }}', {}, "x=3"),
    ('{{ printf "%q" .S }}', {"S": 'a"b'}, '"a\\"b"'),
    ('{{ printf "%v" true }}', {}, "true"),
    ("{{ escapeXML .S }}", {"S": '<&"'}, "&lt;&amp;&#34;"),
    ("{{ escapeString .S }}", {"S": "<b>"}, "&lt;b&gt;"),
    ("{{ endWithPeriod .S }}", {"S": "hi"}, "hi."),
    ("{{ endWithPeriod .S }}", {"S": "hi."}, "hi."),
    ('{{ list "a" "b" | join "," }}', {}, "a,b"),
    ("{{ add 1 2 3 }}", {}, "6"),
    ("{{ len .L }}", {"L": [1, 2]}, "2"),
    ('{{ regexFind "[0-9]+" "ab12cd" }}', {}, "12"),
    ('{{ if regexMatch "^a" "abc" }}m{{ end }}', {}, "m"),
    ('{{ "ABC" | lower }}', {}, "abc"),
    ('{{ sha1sum "abc" }}', {}, "a9993e364706816aba3e25717850c26c9cd0d89d"),
    ('{{ now | date "2006-01-02T15:04:05Z07:00" }}', {},
     "2026-07-29T13:05:09Z"),
    ('{{ now | date "2006-01-02 15:04:05 -07:00" }}', {},
     "2026-07-29 13:05:09 +00:00"),
    ("{{ .Vulnerability.Severity }}",
     {"VulnerabilityID": "CVE-1", "Severity": "HIGH"}, "HIGH"),
    ('{{ range . }}{{ .Target | upper | trunc 5 }}{{ "|" }}{{ end }}',
     [{"Target": "alpine"}, {"Target": "go.mod"}], "ALPIN|GO.MO|"),
]


@pytest.mark.parametrize("tpl,data,want", CASES,
                         ids=[f"case{i}" for i in range(len(CASES))])
def test_engine_like_reference(tpl, data, want):
    funcs = {"now": lambda: NOW}
    port = gt.Template(tpl, funcs=funcs).render(data)
    ref = ref_gt.Template(tpl, funcs=funcs).render(data)
    assert port == ref == want


def test_env_function(monkeypatch):
    monkeypatch.setenv("AWS_REGION", "eu-west-1")
    tpl = '{{ env "AWS_REGION" }}'
    assert gt.Template(tpl).render({}) == \
        ref_gt.Template(tpl).render({}) == "eu-west-1"


@pytest.mark.parametrize("tpl", ["{{ nosuchfn . }}", "{{ if .A }}x",
                                 "{{ range . }}"])
def test_template_errors_like_reference(tpl):
    for mod in (gt, ref_gt):
        with pytest.raises(mod.TemplateError):
            mod.Template(tpl).render({})


def _report(T, build):
    v = T.DetectedVulnerability(
        vulnerability_id="CVE-2023-1111", pkg_name="musl",
        installed_version="1.2.2-r0", fixed_version="1.2.2-r1",
        primary_url="https://avd.aquasec.com/nvd/cve-2023-1111")
    v.vulnerability.severity = "CRITICAL"
    v.vulnerability.title = "musl: oob write"
    v.vulnerability.description = "Bad <thing> happened"
    res = T.Result(target="img (alpine 3.19)", clazz="os-pkgs",
                   type="alpine", vulnerabilities=[v])
    res.packages = [T.Package(id="musl@1.2.2-r0", name="musl",
                              version="1.2.2", release="r0"),
                    T.Package(id="zlib@1.3-r0", name="zlib", version="1.3",
                              release="r0", indirect=True,
                              depends_on=["musl@1.2.2-r0"])]
    lang = T.Result(target="app/package-lock.json", clazz="lang-pkgs",
                    type="npm", packages=[T.Package(
                        name="lodash", version="4.17.20", dev=True)])
    return build("img", "container_image", [res, lang],
                 metadata=T.Metadata(repo_tags=["img:1"],
                                     repo_digests=["img@sha256:ab"]),
                 created_at="2026-07-29T00:00:00Z")


TEMPLATES = [
    "{{ range . }}{{ range .Vulnerabilities }}{{ .VulnerabilityID }}:"
    "{{ .Vulnerability.Severity }}{{ end }}{{ end }}",
    "{{ range $r := . }}{{ $r.Target }} ({{ len $r.Packages }})\n"
    "{{ range $r.Vulnerabilities }}- {{ .PkgName }} {{ .Title | "
    "escapeXML }} {{ appVersion }}\n{{ end }}{{ end }}",
]


@pytest.mark.parametrize("tpl", TEMPLATES, ids=["inline", "vars"])
def test_write_template_like_reference(tpl, tmp_path):
    outs = []
    p = tmp_path / "t.tpl"
    p.write_text(tpl)
    for T, build, write in ((PT, build_report, write_template),
                            (RT, ref_build_report, ref_write_template)):
        for spec in (tpl, f"@{p}"):
            buf = io.StringIO()
            write(_report(T, build), spec, buf, app_version="0.1.0")
            outs.append(buf.getvalue())
    assert len(set(outs)) == 1 and outs[0]


def test_github_snapshot_like_reference(monkeypatch):
    monkeypatch.setenv("GITHUB_REF", "refs/heads/main")
    monkeypatch.setenv("GITHUB_SHA", "abc")
    port = to_github(_report(PT, build_report), version="0.1.0")
    ref = ref_github(_report(RT, ref_build_report), version="0.1.0")
    assert json.dumps(port) == json.dumps(ref)
    entry = port["manifests"]["img (alpine 3.19)"]["resolved"]["musl"]
    assert entry["package_url"].startswith("pkg:apk/alpine/musl@1.2.2-r0")
    assert entry["relationship"] == "direct"
    assert port["manifests"]["app/package-lock.json"]["file"] == \
        {"source_location": "img:1@sha256:ab"}


def test_cosign_vuln_like_reference():
    port = to_cosign_vuln(_report(PT, build_report), version="0.1.0")
    ref = ref_cosign(_report(RT, ref_build_report), version="0.1.0")
    assert json.dumps(port) == json.dumps(ref)
    assert port["scanner"]["uri"] == "pkg:github/aquasecurity/trivy@0.1.0"
    assert port["metadata"]["scanStartedOn"] == "2026-07-29T00:00:00Z"
