"""The port's rootfs scan end to end on the CPU, against the JAX package:
`python -m trivy_tpu_torch rootfs --device cpu` and
`python -m trivy_tpu.cli rootfs` write the same JSON report byte for
byte apart from CreatedAt; the secret lane matches the JAX
SecretScanner with its device prefilter forced on; and the port runs
with the JAX package's join and shift-or patched to raise."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
import trivy_tpu.ops.ac as ref_ac
import trivy_tpu.ops.join as ref_join
from trivy_tpu.secret.engine import SecretScanner as RefScanner
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.secret import SecretScanner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "secret_corpus")
DB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_rootfs_report_identical_to_reference(tmp_path):
    """3 MiB of filler puts the secret batch over the 2 MiB floor, so the
    port's torch prefilter and the JAX jnp prefilter both run; the
    corpus files add findings of many rules."""
    root = str(tmp_path / "rootfs")
    chip_smoke.make_rootfs(root, filler_mib=3)
    for name in os.listdir(CORPUS):
        shutil.copy(os.path.join(CORPUS, name),
                    os.path.join(root, "srv", "app", name))
    cmds = {
        "ref": [sys.executable, "-m", "trivy_tpu.cli", "rootfs", root,
                "--db", DB, "--scanners", "vuln,secret", "--format", "json",
                "--cache-dir", str(tmp_path / "cache")],
        "port": [sys.executable, "-m", "trivy_tpu_torch", "rootfs", root,
                 "--db", DB, "--scanners", "vuln,secret", "--format",
                 "json", "--device", "cpu", "--debug-launches"],
    }
    procs = {k: subprocess.Popen(c, cwd=str(tmp_path), env=_env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr[-3000:]
        out[k] = (stdout, stderr)

    def strip(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith('  "CreatedAt": ')]
    assert strip(out["port"][0]) == strip(out["ref"][0])
    report = json.loads(out["port"][0])
    n_secrets = sum(len(r.get("Secrets", [])) for r in report["Results"])
    n_vulns = sum(len(r.get("Vulnerabilities", []))
                  for r in report["Results"])
    assert n_vulns == 5 and n_secrets > 15
    counts = json.loads(out["port"][1].strip().splitlines()[-1])
    assert counts["prefilter_path"] == {"torch": 1}
    assert counts["launches"] == {"shiftor": 0, "csr_join": 0,
                                  "csr_join_compact": 0}


def _corpus_files():
    return [(name, open(os.path.join(CORPUS, name), "rb").read())
            for name in sorted(os.listdir(CORPUS))]


def test_secret_lane_matches_reference_device_path():
    files = _corpus_files()
    ref = RefScanner(use_device=True, small_batch_bytes=0)
    port = SecretScanner(device="cpu", small_batch_bytes=0)
    assert port._keywords == ref._keywords
    want = [s.to_json() for s in ref.scan_files(files)]
    got = [s.to_json() for s in port.scan_files(files)]
    assert got == want and len(got) > 5
    assert dict(port.prefilter_path) == {"torch": 1}
    host = SecretScanner(device="cpu")
    assert [s.to_json() for s in host.scan_files(files)] == want
    assert dict(host.prefilter_path) == {"host": 1}


def test_port_never_calls_the_jax_package(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise AssertionError("the port called into trivy_tpu")
    for mod, names in ((ref_join, ("csr_pair_join", "csr_pair_join_compact",
                                   "pair_join")),
                       (ref_ac, ("shiftor_scan", "pack_chunks",
                                 "build_literal_bank"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    root = str(tmp_path / "rootfs")
    planted = chip_smoke.make_rootfs(root, filler_mib=3)
    assert cli.main(["rootfs", root, "--db", DB, "--scanners",
                     "vuln,secret", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    vulns = {(v["PkgName"], v["VulnerabilityID"])
             for r in report["Results"] for v in r.get("Vulnerabilities", [])}
    secrets = {(r["Target"], s["RuleID"])
               for r in report["Results"] for s in r.get("Secrets", [])}
    assert vulns == chip_smoke.EXPECTED_VULNS
    assert secrets == planted


def test_unsupported_scanner_is_refused(tmp_path):
    """misconfig is ported; an unknown scanner is refused."""
    with pytest.raises(SystemExit, match="not supported"):
        cli.main(["rootfs", str(tmp_path), "--scanners", "nosuch",
                  "--device", "cpu"])
