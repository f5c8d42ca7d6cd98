"""The port stands alone and never hides its device: importing any of
its modules (or chip_smoke) loads neither JAX nor trivy_tpu; without a
GPU its entry points raise unless asked for the CPU; and a CUDA request
whose kernels cannot be built raises instead of running the plain
version."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from trivy_tpu_torch import device as D
from trivy_tpu_torch.db.table import build_table
from trivy_tpu_torch.ops import join as J
from trivy_tpu_torch.ops import kernels
from trivy_tpu_torch.ops import shiftor as so

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import trivy_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    trivy_tpu_torch.__path__, "trivy_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "trivy_tpu"))
need = ["trivy_tpu_torch." + m for m in (
    "jsonpos", "javadb", "fanal.analyzers.lockfiles",
    "fanal.analyzers.lockfiles_extra", "fanal.analyzers.binaries",
    "fanal.analyzers.python", "result.filter", "result.ignore", "vex",
    "flagcfg", "db.boltdb", "db.download", "report.tables", "report.sarif",
    "report.github", "report.predicate", "report.gotemplate",
    "report.template", "attestation", "license_expr", "licensing",
    "sbom", "sbom.cyclonedx", "sbom.spdx", "sbom.io", "sbom.artifact",
    "fanal.ingest", "fanal.analyzers.sbom", "fanal.analyzers.license_file",
    "detect.libscan", "fanal.pipeline", "oci", "fanal.daemon",
    "fanal.containerd", "iac", "iac.core", "iac.detection", "iac.yamlpos",
    "iac.kubernetes", "iac.helm", "iac.cloud", "iac.cloudformation",
    "iac.hcl", "iac.terraform", "iac.gcp", "iac.azure",
    "iac.providers_extra", "iac.tfplan", "iac.rego", "iac.rego.parser",
    "iac.rego.builtins", "iac.rego.eval", "misconf", "misconf.dockerfile",
    "fanal.analyzers.misconf", "compliance", "compliance.spec",
    "compliance.report", "detect.feed", "detect.sched", "obs", "obs.cost",
    "obs.trace", "obs.recorder", "obs.slo", "obs.collect", "obs.check",
    "obs.device", "obs.perf", "obs.perfcheck", "obs.exposition", "log",
    "metrics", "resilience", "resilience.admission", "resilience.retry", "server",
    "server.protowire", "server.convert", "server.listen",
    "server.client", "cloud", "cloud.sigv4", "cloud.aws", "fanal.vm",
    "fanal.gitrepo", "fanal.redis_cache", "fanal.s3_cache", "rekor",
    "fanal.analyzers.executable", "parallel", "parallel.stream",
    "parallel.mesh", "parallel.multihost", "fleet.ring", "fleet.router",
    "fleet.supervisor", "resilience.breaker", "k8s", "k8s.client",
    "k8s.kubeconfig", "k8s.scanner", "k8s.nodes", "k8s.fixtures",
    "module", "plugin", "native", "parallel.follower",
    "resilience.storm")]
bad += [m for m in need if m not in names]
print(len(names), bad)
"""


def test_no_jax_or_reference_import():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) > 30
    assert bad == "[]"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from trivy_tpu_torch import __main__ as cli
    from trivy_tpu_torch.detect.engine import BatchDetector
    from trivy_tpu_torch.fanal.cache import MemoryCache
    from trivy_tpu_torch.fanal.fixtures import tar_bytes, write_docker_archive
    from trivy_tpu_torch.scanner import LocalScanner
    from trivy_tpu_torch.secret import SecretScanner
    from trivy_tpu_torch.server.listen import ServerState
    table = build_table([])
    image = str(tmp_path / "image.tar")
    layer = tar_bytes({"etc/alpine-release": b"3.17.3\n"})
    write_docker_archive(image, [layer], ["sha256:" + "0" * 64])
    for make in (lambda: D.resolve_device(None),
                 lambda: D.resolve_device("cuda"),
                 lambda: SecretScanner(),
                 lambda: BatchDetector(table),
                 lambda: LocalScanner(MemoryCache(), table),
                 lambda: cli.main(["rootfs", str(tmp_path),
                                   "--scanners", "secret"]),
                 lambda: cli.main(["fs", str(tmp_path),
                                   "--scanners", "secret"]),
                 lambda: cli.main(["repo", str(tmp_path),
                                   "--scanners", "secret"]),
                 lambda: cli.main(["image", "--input", image,
                                   "--scanners", "secret", "--cache-dir",
                                   str(tmp_path / "cache")]),
                 lambda: cli.main(["sbom", image, "--scanners", "license",
                                   "--cache-dir", str(tmp_path / "cache")]),
                 lambda: cli.main(["vm", image, "--scanners", "secret"]),
                 # a remote repository raises before it is cloned
                 lambda: cli.main(["repo", f"file://{tmp_path}/none.git",
                                   "--scanners", "secret"]),
                 # an image by name raises before any source is tried
                 # (this name would go to a registry on 127.0.0.1)
                 lambda: cli.main(["image", "http://127.0.0.1:1/a:1",
                                   "--image-src", "remote", "--cache-dir",
                                   str(tmp_path / "cache")]),
                 lambda: cli.main(["image", "alpine:3.19", "--image-src",
                                   "docker,containerd,podman",
                                   "--cache-dir", str(tmp_path / "cache")]),
                 # k8s raises before it reads a kubeconfig
                 lambda: cli.main(["k8s", "--kubeconfig",
                                   str(tmp_path / "none"), "--scanners",
                                   "misconfig"]),
                 # the server raises before it loads a table or listens
                 lambda: cli.main(["server", "--listen", "127.0.0.1:1",
                                   "--db", str(tmp_path / "none.npz"),
                                   "--cache-dir", str(tmp_path / "cache")]),
                 lambda: ServerState(table, str(tmp_path / "srv"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert D.resolve_device("cpu") == torch.device("cpu")
    assert SecretScanner(device="cpu").device.type == "cpu"


class _CudaLike:
    """Stands in for a CUDA tensor: the wrappers route on is_cuda."""
    is_cuda = True


def test_failed_build_raises_instead_of_falling_back(monkeypatch):
    def no_build():
        raise kernels.KernelError("nvcc failed")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(J, "csr_pair_join_plain", plain)
    monkeypatch.setattr(so, "shiftor_plain", plain)
    x = _CudaLike()
    with pytest.raises(kernels.KernelError):
        J.csr_pair_join(x, x, x, x, x, x, x, 0, 256, prefix=(x, x))
    with pytest.raises(kernels.KernelError):
        J.csr_pair_join_compact(x, x, x, x, x, x, x, 0, 256, 128,
                                prefix=(x, x))
    with pytest.raises(kernels.KernelError):
        so.shiftor(x, x, x, x, n_words=3, index=(x, x))
    assert J.csr_join_cuda.launches == 0 and so.shiftor_cuda.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels.os.path, "exists",
                        lambda p: False)
    with pytest.raises(kernels.KernelError, match="nvcc"):
        kernels.build()


def test_launch_error_code_raises():
    with pytest.raises(kernels.KernelError, match="cudaError 1"):
        kernels.check(1, "shiftor")
    kernels.check(0, "shiftor")


def test_chip_smoke_refuses_without_gpu(no_gpu):
    import chip_smoke
    assert chip_smoke.main() != 0
    assert np.array(sorted(chip_smoke.EXPECTED_VULNS)).shape == (5, 2)



def test_build_passes_the_shared_constants(monkeypatch, tmp_path):
    """nvcc gets the constants the wrappers size their buffers with, and
    a change of them names a different library."""
    from trivy_tpu_torch.ops import constants as C
    assert f"-DJOIN_TILE={C.JOIN_TILE}" in kernels.DEFINES
    assert f"-DPREFIX_TOKENS={C.PREFIX_TOKENS}" in kernels.DEFINES
    cmds = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **_kw):
            cmds.append(cmd)

        def communicate(self):
            return b"stopped here", b""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", Proc)
    with pytest.raises(kernels.KernelError, match="stopped here"):
        kernels.build()
    assert len(cmds) == len(kernels.SOURCES)
    assert all(set(kernels.DEFINES) <= set(c) for c in cmds)
    before = kernels._source_hash()
    monkeypatch.setattr(kernels, "DEFINES", ("-DJOIN_TILE=1024",))
    assert kernels._source_hash() != before
