"""The port's SBOM paths held to the reference's own golden reports, on
the CPU: the 10 SBOM-input and SBOM-output cases of tests/test_golden.py
(`sbom` of CycloneDX, in-toto, SPDX JSON and tag-value documents, a KBOM
and a license scan; `rootfs|fs --format cyclonedx|spdx-json`) through
`python -m trivy_tpu_torch ... --device cpu` must give zero diff against
their `.golden` files under the reference harness's normalization
(`normalize`, `strip_sbom_layers`, `_norm_cdx`, `_norm_spdx`,
`_sbom_compare`, copied here from tests/test_golden.py, not imported),
and must equal the JAX CLI's output on the same argv byte for byte, with
the clock (TRIVY_TPU_FAKE_NOW) and the serial numbers
(TRIVY_TPU_FAKE_UUID) fixed.

The round trip: a small application image (Debian with dpkg, node_modules,
jars, a Go and a Rust binary, gems, conda: chip_smoke's `image_apps`
layers over a tenth of its table) through `image --format cyclonedx`,
then that document through `sbom`, in both CLIs, recording for each
result type whether the JAX package keeps the vulnerability keys
(VulnerabilityID, PkgName, InstalledVersion) of the image's own JSON
scan. chip_smoke's `sbom` phase asserts equality on exactly those types
(`ROUND_TRIP_TYPES`)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import chip_smoke
import trivy_tpu.cli as ref_cli
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.fanal.fixtures import gz_bytes, write_docker_archive

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")
DB_GLOB = os.path.join(GOLD, "db", "*.yaml")
FAKE_NOW = "2021-08-25T12:20:30Z"
FAKE_UUID = "3ff14136-e09f-4df9-80ea-%012d"

ZERO_IMAGE_CONFIG = {
    "architecture": "", "created": "0001-01-01T00:00:00Z", "os": "",
    "rootfs": {"type": "", "diff_ids": None}, "config": {},
}


def read_golden(name):
    with open(os.path.join(GOLD, "reports", name)) as f:
        return json.load(f)


def normalize(report):
    """The reference readReport normalization + harness-level fields."""
    r = json.loads(json.dumps(report))
    r.pop("CreatedAt", None)
    r.pop("ArtifactName", None)
    md = r.get("Metadata") or {}
    (md.get("ImageConfig") or {}).pop("history", None)
    md.pop("RepoTags", None)
    md.pop("RepoDigests", None)
    for res in r.get("Results", []):
        for v in res.get("Vulnerabilities", []) or []:
            (v.get("Layer") or {}).pop("Digest", None)
    return r


def strip_sbom_layers(report):
    """SBOM scans stamp the document digest as Layer.DiffID, where the
    reference carries none; clear it from the got side as
    compareSBOMReports clears it from want."""
    for res in report.get("Results", []):
        for v in res.get("Vulnerabilities") or []:
            (v.get("Layer") or {}).pop("DiffID", None)
    return report


def _norm_cdx(doc):
    """The reference's readCycloneDX normalization (integration_test.go:
    140-167) plus tool identity and root name."""
    d = json.loads(json.dumps(doc))
    for c in d.get("components") or []:
        c["bom-ref"] = ""
        if c.get("properties"):
            c["properties"] = sorted(c["properties"],
                                     key=lambda p: p["name"])
    if d.get("components"):
        d["components"] = sorted(d["components"],
                                 key=lambda c: c.get("name", ""))
    if d.get("vulnerabilities"):
        d["vulnerabilities"] = sorted(d["vulnerabilities"],
                                      key=lambda v: v["id"])
    md = d.get("metadata") or {}
    md.pop("tools", None)
    (md.get("component") or {}).pop("name", None)
    return d


def _norm_spdx(doc):
    """readSpdxJson normalization (integration_test.go:169-193) plus
    content-based SPDXIDs and creator identity."""
    d = json.loads(json.dumps(doc))
    mapping = {}
    for p in d.get("packages") or []:
        canon = "id:ROOT" if p["name"] == d.get("name") \
            else f"id:{p['name']}@{p.get('versionInfo', '')}"
        mapping[p["SPDXID"]] = canon
        p["SPDXID"] = canon
        if canon == "id:ROOT":
            p["name"] = "ROOT"
    for f in d.get("files") or []:
        canon = f"id:{f['fileName']}"
        mapping[f["SPDXID"]] = canon
        f["SPDXID"] = canon
    for r in d.get("relationships") or []:
        r["spdxElementId"] = mapping.get(r["spdxElementId"],
                                         r["spdxElementId"])
        r["relatedSpdxElement"] = mapping.get(r["relatedSpdxElement"],
                                              r["relatedSpdxElement"])
    d["relationships"] = sorted(
        d.get("relationships") or [],
        key=lambda r: (r["spdxElementId"], r["relatedSpdxElement"]))
    d["files"] = sorted(d.get("files") or [], key=lambda f: f["SPDXID"])
    d["packages"] = sorted(d.get("packages") or [],
                           key=lambda p: p["SPDXID"])
    d.pop("documentNamespace", None)
    (d.get("creationInfo") or {}).pop("created", None)
    (d.get("creationInfo") or {}).pop("creators", None)
    d.pop("name", None)
    return d


def _sbom_want(golden, input_path, artifact_type=None, name=False,
               target=None, bomrefs=None, keep_bomref=True):
    """compareSBOMReports (sbom_test.go:213-250) on the want side:
    artifact name/type, zero image metadata, Target overrides, vuln
    Layer.DiffID cleared, BOMRef overrides."""
    want = read_golden(golden)
    if name:
        want["ArtifactName"] = input_path
    if artifact_type:
        want["ArtifactType"] = artifact_type
    md = want.get("Metadata", {})
    md.pop("ImageID", None)
    md.pop("DiffIDs", None)
    md["ImageConfig"] = dict(ZERO_IMAGE_CONFIG)
    for i, res in enumerate(want.get("Results", [])):
        if target and (i == 0 or target.get("all")):
            res["Target"] = target["value"]
        for v in res.get("Vulnerabilities") or []:
            (v.get("Layer") or {}).pop("DiffID", None)
            if bomrefs:
                v.setdefault("PkgIdentifier", {})["BOMRef"] = \
                    bomrefs[v["VulnerabilityID"]]
            elif not keep_bomref:
                v.get("PkgIdentifier", {}).pop("BOMRef", None)
    return want


def _input(name):
    return os.path.join(GOLD, "inputs", name)


CENTOS_BOMREFS = {
    "CVE-2019-18276": "pkg:rpm/centos/bash@4.2.46-31.el7"
                      "?arch=x86_64&distro=centos-7.6.1810",
    "CVE-2019-1559": "pkg:rpm/centos/openssl-libs@1.0.2k-16.el7"
                     "?arch=x86_64&epoch=1&distro=centos-7.6.1810",
    "CVE-2018-0734": "pkg:rpm/centos/openssl-libs@1.0.2k-16.el7"
                     "?arch=x86_64&epoch=1&distro=centos-7.6.1810",
}


def _centos(fixture, atype, bomrefs):
    path = _input(fixture)
    return _sbom_want("centos-7.json.golden", path, artifact_type=atype,
                      target={"value": f"{path} (centos 7.6.1810)",
                              "all": True},
                      bomrefs=bomrefs, keep_bomref=bomrefs is not None)


# (id, argv, how the report is compared, the want side)
SBOM_SCANS = {
    "sbom_cyclonedx": lambda: (
        ["sbom", _input("centos-7-cyclonedx.json")],
        _centos("centos-7-cyclonedx.json", "cyclonedx", CENTOS_BOMREFS)),
    "sbom_intoto_attestation": lambda: (
        ["sbom", _input("centos-7-cyclonedx.intoto.jsonl")],
        _centos("centos-7-cyclonedx.intoto.jsonl", "cyclonedx",
                CENTOS_BOMREFS)),
    "sbom_spdx_json": lambda: (
        ["sbom", _input("centos-7-spdx.json")],
        _centos("centos-7-spdx.json", "spdx", None)),
    "sbom_spdx_tag_value": lambda: (
        ["sbom", _input("centos-7-spdx.txt")],
        _centos("centos-7-spdx.txt", "spdx", None)),
    "sbom_fluentd_cyclonedx": lambda: (
        ["sbom", _input("fluentd-multiple-lockfiles-cyclonedx.json")],
        _sbom_want("fluentd-multiple-lockfiles.json.golden",
                   _input("fluentd-multiple-lockfiles-cyclonedx.json"),
                   name=True, target={"value": _input(
                       "fluentd-multiple-lockfiles-cyclonedx.json")
                       + " (debian 10.2)"})),
    "sbom_minikube_kbom": lambda: (
        ["sbom", _input("minikube-kbom.json")],
        _sbom_want("minikube-kbom.json.golden", _input("minikube-kbom.json"),
                   name=True, target={"value": _input("minikube-kbom.json")
                                      + " (ubuntu 22.04.2)"})),
    "sbom_license_check": lambda: (
        ["sbom", _input("license-cyclonedx.json"), "--scanners", "license"],
        _sbom_want("license-cyclonedx.json.golden",
                   _input("license-cyclonedx.json"), name=True)),
}

SBOM_OUTPUTS = {
    "conda_cyclonedx": (["rootfs", _input("conda"), "--format", "cyclonedx"],
                        "conda-cyclonedx.json.golden", _norm_cdx),
    "pom_cyclonedx": (["fs", _input("pom"), "--format", "cyclonedx"],
                      "pom-cyclonedx.json.golden", _norm_cdx),
    "conda_spdx": (["rootfs", _input("conda"), "--format", "spdx-json"],
                   "conda-spdx.json.golden", _norm_spdx),
}


@pytest.fixture
def fixed(tmp_path, monkeypatch):
    """An empty working directory, the clock and the UUIDs fixed."""
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", FAKE_NOW)
    monkeypatch.setenv("TRIVY_TPU_FAKE_UUID", FAKE_UUID)
    return tmp_path


def run(main, argv, tmp_path, who) -> bytes:
    out = str(tmp_path / f"{who}.out")
    extra = ["--output", out, "--cache-dir", str(tmp_path / f"{who}-cache")]
    if main is cli.main:
        extra += ["--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv + extra) == 0
    with open(out, "rb") as f:
        return f.read()


def run_both(argv, tmp_path) -> bytes:
    port = run(cli.main, argv, tmp_path, "port")
    assert port == run(ref_cli.main, argv, tmp_path, "ref")
    return port


@pytest.mark.parametrize("name", list(SBOM_SCANS))
def test_sbom_scan_golden_and_reference(name, fixed):
    argv, want = SBOM_SCANS[name]()
    got = json.loads(run_both(argv + ["--db", DB_GLOB], fixed))
    assert normalize(strip_sbom_layers(got)) == normalize(want)


@pytest.mark.parametrize("name", list(SBOM_OUTPUTS))
def test_sbom_output_golden_and_reference(name, fixed):
    argv, golden, norm = SBOM_OUTPUTS[name]
    got = json.loads(run_both(argv + ["--db", DB_GLOB], fixed))
    assert norm(got) == norm(read_golden(golden))


@pytest.mark.parametrize("argv", [
    ["repo", _input("npm"), "--format", "spdx-json"],
    ["fs", _input("gomod"), "--format", "spdx-json", "--list-all-pkgs"],
    ["repo", _input("pip"), "--format", "cyclonedx"],
    ["fs", _input("npm"), "--format", "cyclonedx", "--scanners",
     "vuln,license"]], ids=["npm-spdx", "gomod-spdx", "pip-cdx",
                            "npm-cdx-license"])
def test_sbom_formats_identical_to_reference(argv, fixed):
    out = run_both(argv + ["--db", DB_GLOB], fixed)
    assert json.loads(out)


def test_in_image_sbom_analyzer_identical_to_reference(fixed):
    """A rootfs that ships an SPDX document (bitnami's layout) and one in
    an fs scan, where the analyzer is off: both reports equal the JAX
    CLI's."""
    root = fixed / "rootfs"
    comp = root / "opt" / "bitnami" / "redis"
    comp.mkdir(parents=True)
    with open(_input("centos-7-spdx.json"), "rb") as f:
        (comp / ".spdx-redis.spdx").write_bytes(f.read())
    with open(_input("fluentd-multiple-lockfiles-cyclonedx.json"),
              "rb") as f:
        (root / "app.cdx.json").write_bytes(f.read())
    (root / "broken.spdx.json").write_bytes(b"{not json")
    for cmd in ("rootfs", "fs"):
        got = json.loads(run_both([cmd, str(root), "--db", DB_GLOB,
                                   "--list-all-pkgs"], fixed))
        pkgs = [p for r in got.get("Results", [])
                for p in r.get("Packages", [])]
        assert bool(pkgs) == (cmd == "rootfs")


# ---- the round trip: image → CycloneDX → sbom --------------------------

def vuln_keys_by_type(report: bytes) -> dict:
    out: dict = {}
    for r in json.loads(report).get("Results", []):
        for v in r.get("Vulnerabilities") or []:
            out.setdefault(r.get("Type", ""), set()).add(
                (v["VulnerabilityID"], v["PkgName"], v["InstalledVersion"]))
    return out


def test_image_cyclonedx_round_trip(fixed):
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    table, deb, names, _raw = chip_smoke.apps_table(rng, shrink=10)
    db = str(fixed / "apps.npz")
    table.save(db)
    layers = chip_smoke.image_apps_layers(
        np.random.default_rng(chip_smoke.SEED + 5), deb, names, text_mib=0)
    image = str(fixed / "apps.tar")
    write_docker_archive(image, [gz_bytes(b, 1) for b in layers],
                         chip_smoke._diff_ids(layers),
                         repo_tags=("synthetic/apps:1",))
    scan = ["image", "--input", image, "--db", db]
    direct = run_both(scan, fixed)
    doc = fixed / "apps.cdx.json"
    doc.write_bytes(run_both(scan + ["--format", "cyclonedx"], fixed))
    via_sbom = run_both(["sbom", str(doc), "--db", db], fixed)
    want, got = vuln_keys_by_type(direct), vuln_keys_by_type(via_sbom)
    kept = {t for t in want if got.get(t) == want[t]}
    assert all(want.values())
    assert kept == set(want) == set(chip_smoke.ROUND_TRIP_TYPES)
