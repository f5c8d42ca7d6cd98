"""Helm charts through the port (trivy_tpu_torch.iac.helm over its own
report/gotemplate.py) held against the JAX package with tolerance 0: the
chart loaders, the rendered manifests, the misconfiguration records, the
helm post-analyzer and the value overrides; the four Helm goldens with
the assertions of tests/test_golden_helm.py; and `--helm-set` /
`--helm-values` through both CLIs, byte for byte."""

import io
import json
import os
import tarfile

import pytest

import chip_smoke
from test_torch_misconf import INPUTS, GOLDEN, run_both, write_tree
from test_torch_misconf import _misconf_state, work  # noqa: F401
from trivy_tpu.fanal import analyzers as ref_an
from trivy_tpu.iac import helm as ref_helm
from trivy_tpu.report import gotemplate as ref_gotemplate
from trivy_tpu_torch.fanal import analyzers as port_an
from trivy_tpu_torch.iac import helm as port_helm
from trivy_tpu_torch.report import gotemplate as port_gotemplate


def chart_files(root) -> dict:
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root).replace(os.sep, "/")] = f.read()
    return out


def golden_failures(name) -> dict:
    with open(os.path.join(GOLDEN, name)) as f:
        doc = json.load(f)
    return {r["Target"]: sorted(m["ID"] for m in
                                r.get("Misconfigurations") or [])
            for r in doc.get("Results", [])}


def our_failures(records, target_map=None) -> dict:
    out = {}
    for rec in records:
        target = target_map(rec.file_path) if target_map else rec.file_path
        out.setdefault(target, [])
        out[target] += [m.id for m in rec.failures]
    return {t: sorted(ids) for t, ids in out.items()}


def assert_failure_parity(golden, ours):
    assert set(ours) <= set(golden), f"extra targets: {set(ours) - set(golden)}"
    for target, want_ids in golden.items():
        assert ours.get(target, []) == want_ids, target


# --- the four goldens -------------------------------------------------

def test_golden_helm_testchart():
    chart = port_helm.load_chart_dir(
        chart_files(os.path.join(INPUTS, "helm_testchart")))
    assert_failure_parity(golden_failures("helm_testchart.json.golden"),
                          our_failures(port_helm.scan_rendered_chart(chart)))


def test_golden_helm_testchart_overridden_set():
    chart = port_helm.load_chart_dir(
        chart_files(os.path.join(INPUTS, "helm_testchart")))
    records = port_helm.scan_rendered_chart(
        chart, values_override={"securityContext": {"runAsUser": 0}})
    assert_failure_parity(
        golden_failures("helm_testchart.overridden.json.golden"),
        our_failures(records))


def test_golden_helm_testchart_overridden_values_file():
    chart = port_helm.load_chart_dir(
        chart_files(os.path.join(INPUTS, "helm_testchart")))
    port_helm.set_helm_overrides(values_files=[
        os.path.join(INPUTS, "helm_values", "values.yaml")])
    records = port_helm.scan_rendered_chart(chart)
    assert_failure_parity(
        golden_failures("helm_testchart.overridden.json.golden"),
        our_failures(records))


def test_golden_helm_tgz():
    with open(os.path.join(INPUTS, "helm", "testchart.tar.gz"), "rb") as f:
        chart = port_helm.load_chart_tgz(f.read())
    assert_failure_parity(
        golden_failures("helm.json.golden"),
        our_failures(port_helm.scan_rendered_chart(chart),
                     target_map=lambda t: f"testchart.tar.gz:{t}"))


def test_golden_helm_badname():
    chart = port_helm.load_chart_dir(
        chart_files(os.path.join(INPUTS, "helm_badname")))
    assert_failure_parity(golden_failures("helm_badname.json.golden"),
                          our_failures(port_helm.scan_rendered_chart(chart)))


# --- render and scan against the JAX package --------------------------

def _charts() -> dict:
    out = {name: chart_files(os.path.join(INPUTS, name))
           for name in ("helm_testchart", "helm_badname")}
    for name, (override, _ids) in chip_smoke.HELM_CHARTS.items():
        out[name] = chip_smoke.helm_chart(name, override)
    return out


CHARTS = _charts()
OVERRIDES = [None, {"securityContext": {"runAsUser": 0}},
             {"replicaCount": 5, "image": {"tag": "latest"},
              "hostNetwork": True}]


@pytest.mark.parametrize("name", sorted(CHARTS))
@pytest.mark.parametrize("override", range(len(OVERRIDES)))
def test_render_and_scan_like_reference(name, override):
    files = CHARTS[name]
    values = OVERRIDES[override]
    port_chart = port_helm.load_chart_dir(files)
    ref_chart = ref_helm.load_chart_dir(files)
    assert (port_chart.name, port_chart.metadata, port_chart.values) == \
        (ref_chart.name, ref_chart.metadata, ref_chart.values)
    rendered = port_helm.render_chart(port_chart, values_override=values)
    assert rendered == ref_helm.render_chart(ref_chart,
                                             values_override=values)
    port = [r.to_json() for r in port_helm.scan_chart_files(
        files, values_override=values)]
    ref = [r.to_json() for r in ref_helm.scan_chart_files(
        files, values_override=values)]
    assert port == ref
    # helm_badname is a Chart.yaml alone: nothing renders
    assert bool(port) == bool(rendered) == (name != "helm_badname")


def test_chart_tgz_like_reference():
    for name, files in CHARTS.items():
        data = chip_smoke._tgz(files, name)
        port = port_helm.load_chart_tgz(data)
        ref = ref_helm.load_chart_tgz(data)
        assert port_helm.render_chart(port) == ref_helm.render_chart(ref)
        assert [r.to_json() for r in port_helm.scan_rendered_chart(
            port, prefix="c.tgz:")] == [r.to_json() for r in
                                        ref_helm.scan_rendered_chart(
                                            ref, prefix="c.tgz:")]


@pytest.mark.parametrize("sets,values", [
    (["securityContext.runAsUser=0"], None),
    (["replicaCount=3", "image.tag=latest", "podSecurityContext=null"], None),
    ([], {"securityContext": {"privileged": True}, "hostNetwork": True}),
    (["service.port=81"], {"resources": {}})])
def test_overrides_like_reference(sets, values, tmp_path):
    vf = []
    if values is not None:
        (tmp_path / "v.yaml").write_text(json.dumps(values))
        vf = [str(tmp_path / "v.yaml")]
    out = []
    for helm in (port_helm, ref_helm):
        helm.set_helm_overrides(sets=sets, values_files=vf)
        out.append([r.to_json() for name in sorted(CHARTS)
                    for r in helm.scan_chart_files(CHARTS[name])])
        helm.set_helm_overrides()
    assert out[0] == out[1]


def test_bad_values_file_like_reference(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("a: [unclosed\n")
    errs = []
    for helm in (port_helm, ref_helm):
        with pytest.raises(helm.HelmRenderError) as e:
            helm.set_helm_overrides(values_files=[str(bad)])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_find_charts_like_reference():
    paths = ["a/Chart.yaml", "a/templates/x.yaml", "a/charts/sub/Chart.yaml",
             "a/charts/sub/templates/y.yaml", "b/Chart.yaml", "c/x.yaml",
             "Chart.yaml", "templates/z.yaml"]
    for cut in (paths, paths[:-2]):
        assert port_helm.find_charts(cut) == ref_helm.find_charts(cut)


def test_gotemplate_is_the_reference_copy():
    """Helm renders through report/gotemplate.py: the port's file equals
    the JAX package's, so a rendered manifest cannot differ by it."""
    with open(port_gotemplate.__file__, "rb") as a, \
            open(ref_gotemplate.__file__, "rb") as b:
        assert a.read() == b.read()


def test_helm_post_analyzer_like_reference(tmp_path):
    files = {}
    for name, chart in CHARTS.items():
        files.update({f"deploy/{name}/{rel}": data
                      for rel, data in chart.items()})
    files["deploy/pkg/ledger-0.1.0.tgz"] = chip_smoke._tgz(
        CHARTS["ledger"], "ledger")
    files["deploy/pkg/broken.tgz"] = b"not a tarball"
    port = next(a for a in port_an.AnalyzerGroup().post_analyzers
                if a.name == "helm")
    ref = next(a for a in ref_an.AnalyzerGroup().post_analyzers
               if a.name == "helm")
    assert (port.name, port.version) == (ref.name, ref.version) == ("helm", 1)
    wanted = {p: d for p, d in files.items() if port.required(p)}
    assert wanted == {p: d for p, d in files.items() if ref.required(p)}
    got = port.post_analyze(wanted)
    want = ref.post_analyze(wanted)
    assert [m.to_json() for m in got.misconfigurations] == \
        [m.to_json() for m in want.misconfigurations]
    assert any(m.file_path.startswith("deploy/pkg/ledger-0.1.0.tgz:")
               for m in got.misconfigurations)


# --- both CLIs --------------------------------------------------------

HELM_FLAGS = {
    "none": [],
    "set": ["--helm-set", "securityContext.runAsUser=0"],
    "sets": ["--helm-set", "securityContext.privileged=true",
             "--helm-set", "hostNetwork=true"],
    "values": ["--helm-values", os.path.join(INPUTS, "helm_values",
                                             "values.yaml")],
}


@pytest.mark.parametrize("fmt", ["json", "table", "sarif"])
@pytest.mark.parametrize("flags", sorted(HELM_FLAGS))
def test_cli_helm_like_reference(flags, fmt, tmp_path, work):  # noqa: F811
    files = {f"charts/testchart/{rel}": data for rel, data in
             CHARTS["helm_testchart"].items()}
    files["pkg/gateway-0.1.0.tgz"] = chip_smoke._tgz(CHARTS["gateway"],
                                                     "gateway")
    root = write_tree(tmp_path / "t", files)
    port, ref = run_both(["fs", root, "--scanners", "misconfig", "--format",
                          fmt, *HELM_FLAGS[flags]], work)
    assert port == ref
    if fmt == "json":
        targets = {r["Target"] for r in json.loads(port)["Results"]}
        assert "templates/deployment.yaml" in targets
        assert "pkg/gateway-0.1.0.tgz:templates/deployment.yaml" \
            in targets


def test_cli_bad_values_file_like_reference(tmp_path, work):  # noqa: F811
    from trivy_tpu.cli import main as ref_main
    from trivy_tpu_torch.__main__ import main as port_main
    bad = tmp_path / "bad.yaml"
    bad.write_text("a: [unclosed\n")
    msgs = []
    for main, extra in ((port_main, ["--device", "cpu"]), (ref_main, [])):
        with pytest.raises(SystemExit) as e:
            main(["fs", str(tmp_path), "--scanners", "misconfig",
                  "--helm-values", str(bad), "--cache-dir",
                  str(tmp_path / "c"), *extra])
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and "--helm-values" in msgs[0]


def test_tgz_members_read_in_order():
    """A packaged chart whose members are out of order still loads."""
    files = CHARTS["reports"]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for rel in sorted(files, reverse=True):
            ti = tarfile.TarInfo(f"reports/{rel}")
            ti.size = len(files[rel])
            tf.addfile(ti, io.BytesIO(files[rel]))
    port = port_helm.load_chart_tgz(buf.getvalue())
    ref = ref_helm.load_chart_tgz(buf.getvalue())
    assert port_helm.render_chart(port) == ref_helm.render_chart(ref)


def test_two_charts_keep_one_record_like_reference(tmp_path, work):  # noqa: F811
    """A fault of the reference the port copies: Helm targets are
    chart-relative, so two charts rendering templates/deployment.yaml
    keep one record in the applier's per-path store."""
    files = {}
    for top in ("a", "b"):
        files.update({f"{top}/{rel}": data for rel, data in
                      CHARTS["helm_testchart"].items()})
    files["b/Chart.yaml"] = files["b/Chart.yaml"].replace(
        b"name: testchart", b"name: other")
    root = write_tree(tmp_path / "t", files)
    port, ref = run_both(["fs", root, "--scanners", "misconfig"], work)
    assert port == ref
    targets = [r["Target"] for r in json.loads(port)["Results"]]
    assert targets.count("templates/deployment.yaml") == 1
