"""The docker and podman daemon image source of the port
(trivy_tpu_torch/fanal/daemon.py) and `image NAME`'s source chain, held
against the JAX package's with the fake Engine-API unix socket of
tests/test_daemon.py: the same socket order, the same reports byte for
byte (the clock fixed, each CLI with its own --cache-dir), and the same
messages when no source has the image. No chain here names `remote`
with a name that would leave 127.0.0.1."""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile

import pytest

import trivy_tpu.cli as ref_cli
import trivy_tpu.fanal.daemon as JD
from test_daemon import fake_daemon  # noqa: F401 — the socket fixture
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.fanal import daemon as PD
from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
from trivy_tpu_torch.fanal.cache import MemoryCache
from trivy_tpu_torch.fanal.pipeline import INGEST

HERE = os.path.dirname(os.path.abspath(__file__))
DB = os.path.join(HERE, "fixtures", "db", "*.yaml")


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    for k in [k for k in os.environ if k.startswith("TRIVY_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", "2026-10-17T00:00:00Z")
    monkeypatch.setenv("CONTAINERD_ROOT", str(tmp_path / "no-containerd"))
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path / "xdg"))
    INGEST.reset_for_tests()

@pytest.fixture(autouse=True)
def _restore_default_ingest():
    """Both CLIs install their --ingest-* flags as their package's
    process default; later tests in this worker get the defaults back."""
    import trivy_tpu.fanal.pipeline as jax_pipeline
    from trivy_tpu_torch.fanal import pipeline as port_pipeline
    saved = (jax_pipeline.default_ingest(), port_pipeline.default_ingest())
    yield
    jax_pipeline.set_default_ingest(saved[0])
    port_pipeline.set_default_ingest(saved[1])


def run_both(argv, tmp_path) -> tuple:
    outs = {}
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        out = str(tmp_path / f"{who}.json")
        extra = ["--cache-dir", str(tmp_path / f"{who}-cache"),
                 "--output", out]
        if who == "port":
            extra += ["--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv + extra) == 0, who
        with open(out, "rb") as f:
            outs[who] = f.read()
    return outs["port"], outs["ref"]


def exit_both(argv, tmp_path) -> str:
    msgs = []
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        extra = ["--cache-dir", str(tmp_path / f"{who}-cache")]
        if who == "port":
            extra += ["--device", "cpu"]
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def _cves(report: bytes) -> set:
    return {v["VulnerabilityID"] for r in json.loads(report)["Results"]
            for v in r.get("Vulnerabilities") or []}


def test_save_image_streams_tarball(fake_daemon, tmp_path):  # noqa: F811
    dest = str(tmp_path / "out.tar")
    PD.save_image("alpine:3.17", dest, fake_daemon)
    cache = MemoryCache()
    ref = ImageArchiveArtifact(dest, cache).inspect()
    assert cache.get_blob(ref.blob_ids[0]).os.family == "alpine"


def test_save_image_missing_image_raises(fake_daemon, tmp_path):  # noqa: F811
    with pytest.raises(PD.DaemonError, match="not found"):
        PD.save_image("missing:latest", str(tmp_path / "o.tar"),
                      fake_daemon)


def test_unreachable_socket_raises(tmp_path):
    with pytest.raises(PD.DaemonError, match="cannot connect"):
        PD.save_image("a:1", str(tmp_path / "o.tar"),
                      str(tmp_path / "absent.sock"))


@pytest.mark.parametrize("env,sources", [
    ({"DOCKER_HOST": "unix:///custom.sock",
      "XDG_RUNTIME_DIR": "/run/user/1"}, ("docker", "podman")),
    ({"DOCKER_HOST": "tcp://1.2.3.4:2375"}, ("docker", "podman")),
    ({"DOCKER_HOST": "unix:///custom.sock",
      "XDG_RUNTIME_DIR": "/run/user/1"}, ("podman",)),
    ({"DOCKER_HOST": "unix:///var/run/docker.sock"}, ("docker",)),
    ({}, ())])
def test_socket_candidates_equal_reference(env, sources):
    got = PD.docker_socket_candidates(env, sources=sources)
    assert got == JD.docker_socket_candidates(env, sources=sources)


def test_save_from_any_daemon_uses_env_socket(fake_daemon, tmp_path,  # noqa: F811
                                              monkeypatch):
    monkeypatch.setenv("DOCKER_HOST", f"unix://{fake_daemon}")
    dest = str(tmp_path / "out.tar")
    assert PD.save_from_any_daemon("alpine:3.17", dest) == fake_daemon
    assert os.path.getsize(dest) > 0


@pytest.mark.parametrize("src", ["docker", "podman", "containerd,docker"])
def test_cli_image_from_daemon_equals_reference(fake_daemon, tmp_path,  # noqa: F811
                                                monkeypatch, src):
    os.makedirs(tmp_path / "tmp")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    if src == "podman":
        os.makedirs(tmp_path / "xdg" / "podman")
        os.symlink(fake_daemon, tmp_path / "xdg" / "podman" / "podman.sock")
    else:
        monkeypatch.setenv("DOCKER_HOST", f"unix://{fake_daemon}")
    port, ref = run_both(["image", "alpine:3.17", "--image-src", src,
                          "--db", DB, "--scanners", "vuln,secret",
                          "--format", "json"], tmp_path)
    assert port == ref
    assert {"CVE-2023-0286", "CVE-2025-26519"} <= _cves(port)
    assert json.loads(port)["ArtifactName"] == "alpine:3.17"
    # each CLI removes the archive it saved
    assert not [f for f in os.listdir(tmp_path / "tmp")
                if f.endswith(".tar")]


def test_cli_daemon_without_image_same_message(fake_daemon, tmp_path,  # noqa: F811
                                               monkeypatch):
    monkeypatch.setenv("DOCKER_HOST", f"unix://{fake_daemon}")
    msg = exit_both(["image", "missing:1", "--image-src", "docker",
                     "--db", DB], tmp_path)
    assert msg.startswith("image acquisition failed: docker: ")
    assert "not found in daemon" in msg


def test_cli_no_daemon_same_message(tmp_path, monkeypatch):
    monkeypatch.setenv("DOCKER_HOST", "unix:///nonexistent/daemon.sock")
    msg = exit_both(["image", "no-such-registry.invalid/app:1",
                     "--image-src", "docker,containerd,podman",
                     "--db", DB], tmp_path)
    assert msg.startswith("image acquisition failed: docker: ")
    assert "; containerd: no containerd store at " in msg


def test_cli_podman_skips_docker_socket(fake_daemon, tmp_path,  # noqa: F811
                                        monkeypatch):
    monkeypatch.setenv("DOCKER_HOST", f"unix://{fake_daemon}")
    msg = exit_both(["image", "alpine:3.17", "--image-src", "podman",
                     "--db", DB], tmp_path)
    assert msg == "image acquisition failed: podman: no daemon socket found"


@pytest.mark.parametrize("spec", ["dokcer", "", " , ", "docker,regsitry"])
def test_cli_unknown_image_src_same_message(tmp_path, spec):
    msg = exit_both(["image", "a:1", "--image-src", spec, "--db", DB],
                    tmp_path)
    assert msg.startswith("unknown --image-src ")
    assert msg.endswith("(valid: docker, containerd, podman, remote)")


def test_cli_image_needs_a_name_or_input(tmp_path):
    assert exit_both(["image", "--db", DB], tmp_path) == \
        "image name or --input <archive> required"


@pytest.mark.parametrize("fmt", ["table", "sarif", "template", "github",
                                 "cosign-vuln"])
def test_cli_daemon_formats_equal_reference(fake_daemon, tmp_path,  # noqa: F811
                                            monkeypatch, fmt):
    """The report formats tests/test_torch_cli.py compares (json above)."""
    monkeypatch.setenv("DOCKER_HOST", f"unix://{fake_daemon}")
    argv = ["image", "alpine:3.17", "--image-src", "docker", "--db", DB,
            "--format", fmt]
    if fmt == "template":
        argv += ["--template", "{{ range . }}{{ .Target }}{{ end }}"]
    port, ref = run_both(argv, tmp_path)
    assert port == ref and port


def test_image_src_from_env_and_config(fake_daemon, tmp_path,  # noqa: F811
                                       monkeypatch):
    """--image-src and --platform bind TRIVY_IMAGE_SRC and trivy.yaml's
    image.source, as in the JAX CLI."""
    monkeypatch.setenv("DOCKER_HOST", f"unix://{fake_daemon}")
    (tmp_path / "work" / "trivy.yaml").write_text(
        "image:\n  source: podman\n")
    msg = exit_both(["image", "alpine:3.17", "--db", DB], tmp_path)
    assert msg == "image acquisition failed: podman: no daemon socket found"
    monkeypatch.setenv("TRIVY_IMAGE_SRC", "docker")
    port, ref = run_both(["image", "alpine:3.17", "--db", DB], tmp_path)
    assert port == ref
