"""The port's CI command line held against the JAX CLI, both run from a
working directory that holds the file at issue and with the clock fixed
by TRIVY_TPU_FAKE_NOW, so the reports are equal byte for byte, CreatedAt
included:

- the four faults the port had (ROADMAP §C, each with its smallest
  failing input): the working directory's `.trivyignore` (C1),
  `trivy.yaml`, `TRIVY_*` env and the fake clock (C2), the Java DB in
  `--cache-dir` (C3), and `image` with `trivy-secret.yaml` (C4);
- every report format (json, table, sarif, template, github,
  cosign-vuln) on a rootfs, an image archive and golden repo inputs,
  and `convert` of the JAX CLI's JSON report into each of them;
- the filter and exit flags (`--severity`, `--ignore-unfixed`,
  `--ignore-status`, `--ignorefile`, `--vex`, `--exit-code`, `--output`,
  `--config`, `TRIVY_*` env): the same report and the same exit code;
- `--ignore-policy` (a rego ignore policy): the same report, and the
  findings it names gone;
- what the port refuses: `--sbom-sources rekor`."""

import contextlib
import hashlib
import io
import json
import os

import pytest

import chip_smoke
import trivy_tpu.cli as ref_cli
from test_torch_binaries import _java_db_entries, make_jar
from test_torch_image import _write
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import javadb

HERE = os.path.dirname(os.path.abspath(__file__))
DB = os.path.join(HERE, "fixtures", "db", "*.yaml")
GOLD = os.path.join(HERE, "golden")
GOLD_DB = os.path.join(GOLD, "db", "*.yaml")
NOW = "2026-10-17T00:00:00Z"

TEMPLATE = """\
{{- range . }}{{ .Target }} [{{ .Class }}/{{ .Type }}]
{{- range .Vulnerabilities }}
  {{ .VulnerabilityID }} {{ .PkgName }}@{{ .InstalledVersion }} -> \
{{ .FixedVersion }} {{ .Severity }} {{ .Title | escapeXML }}
{{- end }}
{{- range .Secrets }}
  {{ .RuleID }} {{ .Severity }} line {{ .StartLine }}
{{- end }}
{{ end }}"""


@pytest.fixture
def ci_dir(tmp_path, monkeypatch):
    """The working directory of both CLIs, with the clock fixed."""
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", NOW)
    for k in [k for k in os.environ if k.startswith("TRIVY_")
              and k != "TRIVY_TPU_FAKE_NOW"]:
        monkeypatch.delenv(k)
    return tmp_path


def run_both(argv, tmp_path, rc=0, cache_tag="") -> tuple:
    """Both CLIs in this process, each with its own cache dir and output
    file → (port bytes, reference bytes)."""
    outs = {}
    scan = argv[0] != "convert"
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        out = str(tmp_path / f"{who}.out")
        extra = ["--cache-dir", str(tmp_path / f"{who}-cache{cache_tag}")] \
            if scan else []
        if scan and who == "port":
            extra += ["--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            got = main(argv + ["--output", out] + extra)
        assert got == rc, (who, got)
        with open(out, "rb") as f:
            outs[who] = f.read()
    return outs["port"], outs["ref"]


def _rootfs(tmp_path) -> str:
    root = str(tmp_path / "rootfs")
    if not os.path.exists(root):
        chip_smoke.make_rootfs(root, filler_mib=0)
    return root


def _vulns(report: bytes) -> list:
    return [(v["PkgName"], v["VulnerabilityID"])
            for r in json.loads(report).get("Results", [])
            for v in r.get("Vulnerabilities", [])]


# --- C1-C4 -----------------------------------------------------------

def test_c1_trivyignore_in_working_directory(ci_dir):
    (ci_dir / "work" / ".trivyignore").write_text("CVE-2023-0286\n")
    port, ref = run_both(["rootfs", _rootfs(ci_dir), "--db", DB,
                          "--scanners", "vuln"], ci_dir)
    assert port == ref
    assert len(_vulns(port)) == 3
    assert "CVE-2023-0286" not in {v for _p, v in _vulns(port)}


@pytest.mark.parametrize("source", ["env", "trivy.yaml"])
def test_c2_env_and_config_file(source, ci_dir, monkeypatch):
    if source == "env":
        monkeypatch.setenv("TRIVY_SEVERITY", "CRITICAL")
    else:
        (ci_dir / "work" / "trivy.yaml").write_text("severity: CRITICAL\n")
    port, ref = run_both(["rootfs", _rootfs(ci_dir), "--db", DB,
                          "--scanners", "vuln"], ci_dir)
    assert port == ref
    assert _vulns(port) == []


@pytest.mark.parametrize("now,eosl", [("2023-06-01T00:00:00Z", False),
                                      ("2026-10-17T00:00:00Z", True)])
def test_c2_fake_clock_moves_eosl(now, eosl, ci_dir, monkeypatch):
    """Alpine 3.17 reached its end of life on 2024-11-22: the clock of
    TRIVY_TPU_FAKE_NOW decides EOSL in both CLIs, and CreatedAt."""
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", now)
    port, ref = run_both(["rootfs", _rootfs(ci_dir), "--db", DB,
                          "--scanners", "vuln"], ci_dir)
    assert port == ref
    report = json.loads(port)
    assert report["Metadata"]["OS"].get("EOSL", False) is eosl
    assert report["CreatedAt"].startswith(now[:10])


def test_c3_java_db_in_cache_dir(ci_dir):
    root = ci_dir / "jarfs"
    (root / "app").mkdir(parents=True)
    jar = make_jar()
    (root / "app" / "lib.jar").write_bytes(jar)
    rows, _ = _java_db_entries()
    rows[0] = rows[0][:3] + (hashlib.sha1(jar).hexdigest(), "jar")
    for who in ("port", "ref"):
        javadb.build_db(str(ci_dir / f"{who}-cache" / "javadb" /
                            "trivy-java.db"), rows).close()
    try:
        port, ref = run_both(["rootfs", str(root), "--db", DB,
                              "--list-all-pkgs"], ci_dir)
    finally:
        javadb.set_db(None)
    assert port == ref
    jars = [p for r in json.loads(port)["Results"] if r["Type"] == "jar"
            for p in r.get("Packages", [])]
    assert [(p["Name"], p["Version"]) for p in jars] == \
        [("com.example:lib", "2.0.1")]


def test_c4_image_reads_trivy_secret_yaml(ci_dir):
    from trivy_tpu_torch.fanal.fixtures import (sha256_hex, tar_bytes,
                                                write_docker_archive)
    layer = tar_bytes({"app/config.txt":
                       b"token = ghp_" + b"a" * 36 + b"\n"})
    image = str(ci_dir / "img.tar")
    write_docker_archive(image, [layer], ["sha256:" + sha256_hex(layer)])
    argv = ["image", "--input", image, "--scanners", "secret"]
    port, ref = run_both(argv, ci_dir)
    assert port == ref and b"github-pat" in port
    (ci_dir / "work" / "trivy-secret.yaml").write_text(
        "disable-rules:\n  - github-pat\n")
    # fresh caches: a cached layer keeps the findings of the rules it was
    # walked with, in both packages
    port, ref = run_both(argv, ci_dir, cache_tag="-2")
    assert port == ref and b"github-pat" not in port


# --- report formats and convert --------------------------------------

def _target(name: str, tmp_path) -> list:
    if name == "rootfs":
        return ["rootfs", _rootfs(tmp_path), "--db", DB,
                "--scanners", "vuln,secret"]
    if name == "image":
        return ["image", "--input", _write(tmp_path, "alpine_flask"),
                "--db", DB, "--scanners", "vuln,secret", "--list-all-pkgs"]
    inputs = os.path.join(GOLD, "inputs", name)
    extra = ["--scanners", "vuln,secret", "--secret-config",
             os.path.join(inputs, "trivy-secret.yaml")] \
        if name == "secrets" else ["--list-all-pkgs"]
    return ["repo", inputs, "--db", GOLD_DB, *extra]


TARGETS = ["rootfs", "image", "npm", "pip", "secrets"]
FORMATS = ["json", "table", "sarif", "template", "github", "cosign-vuln"]


def _format_args(fmt: str, tmp_path) -> list:
    if fmt != "template":
        return ["--format", fmt]
    p = tmp_path / "report.tpl"
    p.write_text(TEMPLATE)
    return ["--format", "template", "--template", f"@{p}"]


@pytest.mark.parametrize("target", TARGETS)
def test_every_format_and_convert_like_reference(target, ci_dir,
                                                 monkeypatch):
    monkeypatch.setenv("GITHUB_RUN_ID", "42")
    argv = _target(target, ci_dir)
    for fmt in FORMATS:
        flags = argv
        if fmt == "sarif" and argv[0] == "repo":
            # the JAX package's SARIF writer fails on lockfile package
            # locations (test_sarif_regions_from_package_locations)
            flags = [a for a in argv if a != "--list-all-pkgs"]
        port, ref = run_both(flags + _format_args(fmt, ci_dir), ci_dir)
        assert port == ref, fmt
        assert port.strip(), fmt
    # convert the JAX CLI's JSON report with both CLIs
    ref_json = str(ci_dir / "ref.json")
    with open(ref_json, "wb") as f:
        f.write(ref)
    _, ref_json_bytes = run_both(argv + ["--format", "json"], ci_dir)
    with open(ref_json, "wb") as f:
        f.write(ref_json_bytes)
    for fmt in FORMATS:
        port, ref = run_both(["convert", ref_json] +
                             _format_args(fmt, ci_dir), ci_dir)
        assert port == ref, ("convert", fmt)


def test_sarif_regions_from_package_locations(ci_dir):
    """With --list-all-pkgs the lockfile packages carry line locations,
    and each SARIF result of a vulnerable package points at them. The
    JAX package's writer raises AttributeError on this input, so the
    port is held to its own JSON report here."""
    argv = _target("npm", ci_dir)
    with pytest.raises(AttributeError):
        ref_cli.main(argv + ["--format", "sarif", "--cache-dir",
                             str(ci_dir / "ref-cache"), "--output",
                             str(ci_dir / "ref.sarif")])
    got = {}
    for fmt in ("json", "sarif"):
        out = ci_dir / f"port.{fmt}"
        assert cli.main(argv + ["--format", fmt, "--device", "cpu",
                                "--cache-dir", str(ci_dir / "port-cache"),
                                "--output", str(out)]) == 0
        got[fmt] = json.loads(out.read_text())
    spans = {}
    for r in got["json"]["Results"]:
        for p in r.get("Packages", []):
            spans[(p["Name"], p["Version"])] = [
                (loc["StartLine"], loc["EndLine"])
                for loc in p.get("Locations", [])]
    want = [spans.get((v["PkgName"], v["InstalledVersion"])) or [(1, 1)]
            for r in got["json"]["Results"]
            for v in r.get("Vulnerabilities", [])]
    regions = [[(loc["physicalLocation"]["region"]["startLine"],
                 loc["physicalLocation"]["region"]["endLine"])
                for loc in res["locations"]]
               for res in got["sarif"]["runs"][0]["results"]]
    assert regions == want and any(w != [(1, 1)] for w in want)


# --- filter and exit flags -------------------------------------------

OPENVEX = {"@context": "https://openvex.dev/ns/v0.2.0", "statements": [
    {"vulnerability": {"name": "CVE-2023-2650"},
     "products": [{"@id": "pkg:apk/alpine/libssl3@3.0.7-r0"}],
     "status": "not_affected"},
    {"vulnerability": {"name": "CVE-2025-26519"}, "status": "fixed"}]}
IGNORE_YAML = """\
vulnerabilities:
  - id: CVE-2023-0286
    paths: ["*(alpine 3.17.3)"]
  - id: CVE-2025-26519
    paths: ["lib/*"]
  - id: CVE-2023-2650
    expired_at: 2020-01-01
secrets:
  - id: aws-access-key-id
"""

FLAG_CASES = {
    "severity": (["--severity", "HIGH,CRITICAL"], {}, None, 0),
    "ignore_unfixed": (["--ignore-unfixed"], {}, None, 0),
    "ignore_status": (["--ignore-status", "fixed,affected"], {}, None, 0),
    "ignorefile": (["--ignorefile", "ignore.yaml"], {}, None, 0),
    "vex": (["--vex", "vex.json"], {}, None, 0),
    "exit_code_findings": (["--exit-code", "3"], {}, None, 3),
    "exit_code_all_filtered": (
        ["--exit-code", "3", "--severity", "CRITICAL", "--scanners",
         "vuln"], {}, None, 0),
    "config": (["--config", "ci.yaml"], {}, "severity: HIGH,MEDIUM\n"
               "vulnerability:\n  ignore-unfixed: true\nexit-code: 4\n", 4),
    "env": ([], {"TRIVY_IGNORE_UNFIXED": "true", "TRIVY_EXIT_CODE": "5",
                 "TRIVY_SEVERITY": "MEDIUM,HIGH,CRITICAL",
                 "TRIVY_VEX": "vex.json"}, None, 5),
    "env_under_flag": (["--severity", "UNKNOWN"], {"TRIVY_SEVERITY": "HIGH"},
                       None, 0),
}


@pytest.mark.parametrize("name", sorted(FLAG_CASES))
def test_filter_and_exit_flags_like_reference(name, ci_dir, monkeypatch):
    flags, env, cfg, rc = FLAG_CASES[name]
    work = ci_dir / "work"
    (work / "ignore.yaml").write_text(IGNORE_YAML)
    (work / "vex.json").write_text(json.dumps(OPENVEX))
    if cfg is not None:
        (work / "ci.yaml").write_text(cfg)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["rootfs", _rootfs(ci_dir), "--db", DB, "--scanners",
            "vuln,secret", "--format", "json"] + flags
    port, ref = run_both(argv, ci_dir, rc=rc)
    assert port == ref


def test_filter_flags_change_the_report(ci_dir):
    """The cases above are not vacuous: each filter removes findings."""
    root = _rootfs(ci_dir)
    (ci_dir / "work" / "ignore.yaml").write_text(IGNORE_YAML)
    (ci_dir / "work" / "vex.json").write_text(json.dumps(OPENVEX))
    base = ["rootfs", root, "--db", DB, "--scanners", "vuln,secret",
            "--format", "json"]
    full, _ = run_both(base, ci_dir)
    assert len(_vulns(full)) == 5
    for flags, left in ((["--ignorefile", "ignore.yaml"], 3),
                        (["--vex", "vex.json"], 3),
                        (["--severity", "HIGH,CRITICAL"], 2)):
        port, _ = run_both(base + flags, ci_dir)
        assert len(_vulns(port)) == left, flags
    port, _ = run_both(base + ["--ignorefile", "ignore.yaml"], ci_dir)
    secrets = [s["RuleID"] for r in json.loads(port)["Results"]
               for s in r.get("Secrets", [])]
    assert "aws-access-key-id" not in secrets and secrets


def test_output_writes_the_file_and_nothing_to_stdout(ci_dir, capsys):
    out = ci_dir / "r.sarif"
    assert cli.main(["rootfs", _rootfs(ci_dir), "--db", DB, "--format",
                     "sarif", "-o", str(out), "--device", "cpu",
                     "--cache-dir", str(ci_dir / "c")]) == 0
    assert capsys.readouterr().out == ""
    assert json.loads(out.read_text())["version"] == "2.1.0"


# --- the rego ignore policy ----------------------------------------

IGNORE_POLICY = """package trivy

import data.lib.trivy

default ignore = false

ignore {
	input.VulnerabilityID == "CVE-2023-0286"
}

ignore {
	input.RuleID == "aws-access-key-id"
}
"""


@pytest.mark.parametrize("fmt", ["json", "table", "sarif"])
def test_ignore_policy_like_reference(fmt, ci_dir):
    (ci_dir / "work" / "policy.rego").write_text(IGNORE_POLICY)
    base = ["rootfs", _rootfs(ci_dir), "--db", DB, "--scanners",
            "vuln,secret", "--format", fmt]
    port, ref = run_both(base + ["--ignore-policy", "policy.rego",
                                 "--exit-code", "3"], ci_dir, rc=3)
    assert port == ref
    if fmt == "json":
        full, _ = run_both(base, ci_dir)
        assert ("libcrypto3", "CVE-2023-0286") in _vulns(full)
        kept = _vulns(port)
        assert len(kept) == len(_vulns(full)) - 2   # libcrypto3, libssl3
        assert all(cve != "CVE-2023-0286" for _, cve in kept)
        assert "aws-access-key-id" in full.decode()
        assert "aws-access-key-id" not in port.decode()


# --- refused ---------------------------------------------------------

@pytest.mark.parametrize("command,flags,match", [
    ("image", ["--sbom-sources", "rekor"], "ROADMAP A5")])
def test_unported_options_are_refused(command, flags, match, ci_dir):
    target = ["--input", str(ci_dir / "none.tar")] if command == "image" \
        else [_rootfs(ci_dir)]
    with pytest.raises(SystemExit, match=match):
        cli.main([command, *target, "--db", DB, "--device", "cpu",
                  "--cache-dir", str(ci_dir / "c"), *flags])
