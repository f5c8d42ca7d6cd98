"""The port's `repo` scan held to the reference's own golden reports, on
the CPU: `python -m trivy_tpu_torch repo <input> --device cpu` over each
of the 21 repo configurations of tests/test_golden.py (14 lockfile
ecosystems, npm with and without dev deps, pip, gomod with and without
--skip-files, pom, secrets) must give zero diff against its `.golden`
file under the reference harness's normalization (copied here from
tests/test_golden.py, not imported), and must equal the JAX CLI's
report byte for byte apart from CreatedAt. Inputs and the advisory
fixture DB are the vendored ones under tests/golden/."""

import contextlib
import io
import json
import os

import pytest

import trivy_tpu.cli as ref_cli
from trivy_tpu_torch import __main__ as cli

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")
DB_GLOB = os.path.join(GOLD, "db", "*.yaml")


def normalize(report):
    """The reference readReport normalization (integration_test.go:
    105-138) plus the harness-level fields: CreatedAt and ArtifactName
    dropped, image history, repo tags and digests and vulnerability
    layer digests removed."""
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


def _inputs(name):
    return os.path.join(GOLD, "inputs", name)


# (id, input dir, golden report, extra flags): the repo configurations of
# tests/test_golden.py:98-345
CONFIGS = [
    ("npm", "npm", "npm.json.golden", ["--list-all-pkgs"]),
    ("npm-with-dev", "npm", "npm-with-dev.json.golden",
     ["--list-all-pkgs", "--include-dev-deps"]),
    ("pip", "pip", "pip.json.golden", ["--list-all-pkgs"]),
    ("gomod", "gomod", "gomod.json.golden", []),
    ("pom", "pom", "pom.json.golden", []),
    ("secrets", "secrets", "secrets.json.golden",
     ["--scanners", "vuln,secret", "--secret-config",
      os.path.join(_inputs("secrets"), "trivy-secret.yaml")]),
    ("gomod-skip", "gomod", "gomod-skip.json.golden",
     ["--skip-files", os.path.join(_inputs("gomod"), "submod2", "go.mod")]),
    ("yarn", "yarn", "yarn.json.golden", ["--list-all-pkgs"]),
    ("pnpm", "pnpm", "pnpm.json.golden", []),
    ("pipenv", "pipenv", "pipenv.json.golden", ["--list-all-pkgs"]),
    ("poetry", "poetry", "poetry.json.golden", ["--list-all-pkgs"]),
    ("gradle", "gradle", "gradle.json.golden", []),
    ("conan", "conan", "conan.json.golden", ["--list-all-pkgs"]),
    ("nuget", "nuget", "nuget.json.golden", ["--list-all-pkgs"]),
    ("dotnet", "dotnet", "dotnet.json.golden", ["--list-all-pkgs"]),
    ("packages-props", "packagesprops", "packagesprops.json.golden",
     ["--list-all-pkgs"]),
    ("swift", "swift", "swift.json.golden", ["--list-all-pkgs"]),
    ("cocoapods", "cocoapods", "cocoapods.json.golden",
     ["--list-all-pkgs"]),
    ("pubspec.lock", "pubspec", "pubspec.lock.json.golden",
     ["--list-all-pkgs"]),
    ("mix.lock", "mixlock", "mix.lock.json.golden", ["--list-all-pkgs"]),
    ("composer.lock", "composer", "composer.lock.json.golden",
     ["--list-all-pkgs"]),
]
IDS = [c[0] for c in CONFIGS]


def _argv(input_dir, extra):
    return ["repo", _inputs(input_dir), "--db", DB_GLOB, "--format",
            "json", *extra]


def run_port(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv + ["--device", "cpu"]) == 0
    return buf.getvalue()


def run_reference(argv, tmp_path) -> str:
    out = str(tmp_path / "ref.json")
    with contextlib.redirect_stdout(io.StringIO()):
        assert ref_cli.main(argv + ["--output", out, "--cache-dir",
                                    str(tmp_path / "ref-cache")]) == 0
    with open(out) as f:
        return f.read()


def _body(report: str) -> str:
    """The report as written, CreatedAt left out."""
    return "\n".join(ln for ln in report.splitlines()
                     if not ln.startswith('  "CreatedAt": '))


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run from an empty directory, so no trivy.yaml or ignore file of
    the checkout is read, with the reference's clock unpinned."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TRIVY_TPU_FAKE_NOW", raising=False)
    return tmp_path


@pytest.mark.parametrize("name,input_dir,golden,extra", CONFIGS, ids=IDS)
def test_repo_zero_golden_diff(name, input_dir, golden, extra, in_tmp):
    got = json.loads(run_port(_argv(input_dir, extra)))
    with open(os.path.join(GOLD, "reports", golden)) as f:
        want = json.load(f)
    assert normalize(got) == normalize(want)
    assert got["ArtifactType"] == "repository"


@pytest.mark.parametrize("name,input_dir,golden,extra", CONFIGS, ids=IDS)
def test_repo_identical_to_reference(name, input_dir, golden, extra,
                                     in_tmp):
    argv = _argv(input_dir, extra)
    assert _body(run_port(argv)) == _body(run_reference(argv, in_tmp))
