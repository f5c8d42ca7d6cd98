"""The containerd image source of the port
(trivy_tpu_torch/fanal/containerd.py) held against the JAX package's on
the store of tests/test_containerd.py (a bolt meta.db written by
tests/bolt_writer.py and content-addressed blobs): the same name
expansions and resolution, serial walks, and the same reports byte for
byte through `image NAME --image-src containerd` (the clock fixed, each
CLI with its own --cache-dir)."""

from __future__ import annotations

import contextlib
import io
import json
import os

import pytest

import trivy_tpu.cli as ref_cli
import trivy_tpu.fanal.containerd as JCD
from test_containerd import _make_store
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.fanal import containerd as PCD
from trivy_tpu_torch.fanal.cache import MemoryCache

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
    monkeypatch.setenv("DOCKER_HOST", "unix:///nonexistent/daemon.sock")
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path / "xdg"))
    monkeypatch.delenv("CONTAINERD_NAMESPACE", raising=False)

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


def _store(tmp_path, **kw) -> PCD.ContainerdStore:
    return PCD.ContainerdStore(root=_make_store(tmp_path, **kw).root,
                               namespace="default")


@pytest.mark.parametrize("name", [
    "alpine", "alpine:3.17", "myorg/app:1", "ghcr.io/a/b:1",
    "localhost:5000/x", "docker.io/alpine:3.17",
    "alpine@sha256:" + "ab" * 32, "a.b:5000/c/d@sha256:" + "cd" * 32])
def test_name_candidates_equal_reference(name):
    assert PCD.name_candidates(name) == JCD.name_candidates(name)


def test_resolve_familiar_name(tmp_path):
    name, digest = _store(tmp_path).resolve("alpine:3.17")
    assert name == "docker.io/library/alpine:3.17"
    assert digest.startswith("sha256:")
    ref_store = JCD.ContainerdStore(root=str(tmp_path / "containerd"))
    assert ref_store.resolve("alpine:3.17") == (name, digest)


def test_resolve_missing_image(tmp_path):
    with pytest.raises(PCD.ContainerdError, match="not found"):
        _store(tmp_path).resolve("debian:12")


def test_unavailable_store(tmp_path):
    store = PCD.ContainerdStore(root=str(tmp_path / "nope"))
    assert not store.available()
    with pytest.raises(PCD.ContainerdError, match="no containerd store"):
        store.resolve("alpine")


@pytest.mark.parametrize("index", [False, True])
def test_inspect_produces_packages(tmp_path, index):
    store = _store(tmp_path, index=index)
    art = PCD.ContainerdArtifact("alpine:3.17", MemoryCache(),
                                 store=store)
    ref = art.inspect()
    blob = art.cache.get_blob(ref.blob_ids[0])
    assert ref.image_metadata.repo_tags == ["docker.io/library/alpine:3.17"]
    assert blob.os.family == "alpine"
    assert "musl" in {p.name for p in blob.package_infos[0].packages}
    # containerd layers walk serially, as in the JAX package
    assert art.ingest_figures == {"pipelined": False, "layers_walked": 1}
    assert art.image_digest().startswith("sha256:")


def test_platform_not_in_index(tmp_path):
    art = PCD.ContainerdArtifact("alpine:3.17", MemoryCache(),
                                 store=_store(tmp_path, index=True),
                                 platform="linux/arm64")
    with pytest.raises(PCD.ContainerdError,
                       match="no manifest for platform linux/arm64"):
        art.inspect()


def _run_both(argv, tmp_path) -> tuple:
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


@pytest.mark.parametrize("src,index", [("containerd", False),
                                       ("docker,containerd", True)])
def test_cli_image_from_containerd_equals_reference(tmp_path, monkeypatch,
                                                    src, index):
    _make_store(tmp_path, index=index)
    monkeypatch.setenv("CONTAINERD_ROOT", str(tmp_path / "containerd"))
    port, ref = _run_both(["image", "alpine:3.17", "--image-src", src,
                           "--db", DB, "--format", "json"], tmp_path)
    assert port == ref
    doc = json.loads(port)
    assert doc["ArtifactName"] == "alpine:3.17"
    assert doc["Metadata"]["RepoTags"] == ["docker.io/library/alpine:3.17"]
    assert any(r.get("Vulnerabilities") for r in doc["Results"])


@pytest.mark.parametrize("fmt", ["table", "sarif", "template", "github",
                                 "cosign-vuln"])
def test_cli_containerd_formats_equal_reference(tmp_path, monkeypatch, fmt):
    """The report formats tests/test_torch_cli.py compares (json above)."""
    _make_store(tmp_path)
    monkeypatch.setenv("CONTAINERD_ROOT", str(tmp_path / "containerd"))
    argv = ["image", "alpine:3.17", "--image-src", "containerd", "--db", DB,
            "--format", fmt]
    if fmt == "template":
        argv += ["--template", "{{ range . }}{{ .Target }}{{ end }}"]
    port, ref = _run_both(argv, tmp_path)
    assert port == ref and port


def test_cli_chain_falls_through_same_message(tmp_path, monkeypatch):
    _make_store(tmp_path)
    monkeypatch.setenv("CONTAINERD_ROOT", str(tmp_path / "containerd"))
    msgs = []
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        extra = ["--device", "cpu"] if who == "port" else []
        with pytest.raises(SystemExit) as e:
            main(["image", "debian:12", "--image-src", "containerd,podman",
                  "--db", DB, "--cache-dir", str(tmp_path / who)] + extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == (
        "image acquisition failed: containerd: image 'debian:12' not "
        "found in containerd namespace 'default'; podman: no daemon "
        "socket found")
