"""The port's trivy-db download (trivy_tpu_torch/db/download.py
`download_db`, `ensure_db`, through trivy_tpu_torch/oci.py) held against
the JAX package's, with the DB served by the in-process registry of
tests/fake_registry.py: the cases of tests/test_oci_db.py (the pulled
and flattened DB, token auth, no pull while the DB is current, the
staleness gate, a missing media type, the digest check with its
quarantine and retry), and a scan without --db whose report equals the
JAX CLI's from the same pulled DB. Every repository named here is an
http://127.0.0.1 one."""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os

import pytest

import trivy_tpu.cli as ref_cli
from fake_registry import FakeRegistry, tar_gz_of
from test_oci_db import _serve_db
from trivy_tpu.db import download as ref_download
from trivy_tpu.resilience import RetryPolicy as RefRetryPolicy
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import oci
from trivy_tpu_torch.db import download
from trivy_tpu_torch.detect.engine import BatchDetector, PkgQuery

FAST = dict(attempts=3, base_delay_s=0.001, max_delay_s=0.002,
            budget_s=5.0)


@pytest.fixture(autouse=True)
def _fast_retries(tmp_path, monkeypatch):
    monkeypatch.setattr(download, "DOWNLOAD_RETRY", oci.RetryPolicy(**FAST))
    monkeypatch.setattr(ref_download, "DOWNLOAD_RETRY",
                        RefRetryPolicy(**FAST))
    monkeypatch.chdir(tmp_path)
    for k in [k for k in os.environ if k.startswith("TRIVY_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", "2026-10-17T00:00:00Z")

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


def test_download_and_flatten(tmp_path):
    reg, repo = _serve_db(tmp_path)
    try:
        cache = str(tmp_path / "cache")
        p = download.download_db(cache, repository=repo)
        assert os.path.exists(p)
        assert download.read_metadata(cache)["Version"] == \
            download.SCHEMA_VERSION
        table, stats = download.flatten_db(p)
        assert stats["rows"] == 1 and not stats["cached"]
        assert download.flatten_db(p)[1]["cached"]
        # the same bytes as the JAX package's pull
        ref_cache = str(tmp_path / "ref")
        ref_p = ref_download.download_db(ref_cache, repository=repo)
        with open(p, "rb") as a, open(ref_p, "rb") as b:
            assert a.read() == b.read()
    finally:
        reg.stop()


def test_token_auth_flow(tmp_path):
    reg, repo = _serve_db(tmp_path, require_token=True)
    try:
        download.download_db(str(tmp_path / "cache"), repository=repo)
        assert any("/token" in r for r in reg.requests)
    finally:
        reg.stop()


def test_ensure_db_end_to_end(tmp_path):
    """Download, flatten, detect; no new request while NextUpdate holds
    the cached DB current."""
    reg, repo = _serve_db(tmp_path)
    try:
        cache = str(tmp_path / "cache")
        table, stats = download.ensure_db(cache, repository=repo)
        assert stats["downloaded"]
        hits = BatchDetector(table, device="cpu").detect([PkgQuery(
            source="alpine 3.17", ecosystem="alpine", name="musl",
            version="1.2.3-r4")])
        assert [h.vuln_id for h in hits] == ["CVE-2025-26519"]
        n = len(reg.requests)
        _table, stats = download.ensure_db(cache, repository=repo)
        assert len(reg.requests) == n and not stats["downloaded"]
        assert stats["cached"]      # the flatten memo
    finally:
        reg.stop()


def test_needs_update_gates(tmp_path):
    cache = str(tmp_path / "cache")
    assert download.needs_update(cache)
    with pytest.raises(download.DBError):
        download.needs_update(cache, skip=True)
    reg, repo = _serve_db(tmp_path)
    try:
        download.download_db(cache, repository=repo)
    finally:
        reg.stop()
    assert not download.needs_update(cache)
    assert not download.needs_update(cache, skip=True)
    with open(download.metadata_path(cache), "w") as f:
        json.dump({"Version": 1}, f)
    assert download.needs_update(cache) == ref_download.needs_update(cache)
    with pytest.raises(download.DBError):
        download.needs_update(cache, skip=True)


def test_missing_layer_media_type(tmp_path):
    reg = FakeRegistry()
    base = reg.start()
    try:
        reg.put_artifact("x/y", "1", [("application/wrong", b"data")])
        with pytest.raises(oci.OCIError, match="no layer with media type"):
            oci.RegistryClient().download_artifact_layer(
                oci.parse_ref(f"{base}/x/y:1"), oci.MT_TRIVY_DB)
        with pytest.raises(download.DBError, match="no layer with media"):
            download.download_db(str(tmp_path / "c"),
                                 repository=f"{base}/x/y:1")
    finally:
        reg.stop()


def test_blob_digest_verified(tmp_path):
    reg = FakeRegistry()
    base = reg.start()
    try:
        digest = reg.put_blob(b"good")
        reg.blobs[digest] = b"evil"
        with pytest.raises(oci.OCIError, match="digest mismatch"):
            oci.RegistryClient().blob(oci.parse_ref(f"{base}/a/b:1"),
                                      digest)
    finally:
        reg.stop()


def _good_layer():
    meta = json.dumps({"Version": download.SCHEMA_VERSION}).encode()
    return tar_gz_of({"trivy.db": b"boltbytes", "metadata.json": meta})


class _Client:
    """A client whose first `bad_pulls` bodies are complete but
    corrupt."""

    def __init__(self, good, bad_pulls):
        self.good = good
        self.bad_pulls = bad_pulls
        self.pulls = 0

    def manifest(self, ref):
        return {"layers": [{
            "mediaType": oci.MT_TRIVY_DB,
            "digest": "sha256:" + hashlib.sha256(self.good).hexdigest(),
            "size": len(self.good)}]}

    def blob(self, ref, digest, verify=True):
        assert verify is False   # download.py owns the check
        self.pulls += 1
        if self.pulls <= self.bad_pulls:
            return self.good[:-4] + b"XXXX"
        return self.good


def test_corrupt_body_never_installs(tmp_path):
    for mod in (download, ref_download):
        cache = str(tmp_path / mod.__name__)
        with pytest.raises(mod.DBError, match="digest mismatch"):
            mod.download_db(cache, client=_Client(_good_layer(), 99))
        assert not os.path.exists(mod.db_path(cache))
        assert os.listdir(os.path.join(cache, "db", "quarantine"))
    assert os.listdir(tmp_path / download.__name__ / "db" / "quarantine") \
        == os.listdir(tmp_path / ref_download.__name__ / "db"
                      / "quarantine")


def test_transient_corruption_heals_under_retry(tmp_path):
    client = _Client(_good_layer(), 1)
    p = download.download_db(str(tmp_path / "c"), client=client)
    assert client.pulls == 2
    with open(p, "rb") as f:
        assert f.read() == b"boltbytes"
    assert os.listdir(tmp_path / "c" / "db" / "quarantine")


def test_client_without_manifest_installs_unverified(tmp_path):
    class Legacy:
        def download_artifact_layer(self, ref, mt):
            return _good_layer()
    p = download.download_db(str(tmp_path / "c"), client=Legacy())
    with open(p, "rb") as f:
        assert f.read() == b"boltbytes"


def test_layer_without_trivy_db(tmp_path):
    class Legacy:
        def download_artifact_layer(self, ref, mt):
            return tar_gz_of({"other": b"x"})
    with pytest.raises(download.DBError, match="does not contain trivy.db"):
        download.download_db(str(tmp_path / "c"), client=Legacy())


# --- the CLI without --db -----------------------------------------------

def _rootfs(tmp_path) -> str:
    import chip_smoke
    root = str(tmp_path / "rootfs")
    if not os.path.exists(root):
        chip_smoke.make_rootfs(root, filler_mib=0)
    return root


def _scan(main, argv, who):
    buf = io.StringIO()
    extra = ["--device", "cpu"] if who == "port" else []
    with contextlib.redirect_stdout(buf):
        assert main(argv + extra) == 0
    return buf.getvalue()


def test_scan_pulls_the_db_like_reference(tmp_path):
    """No --db, a fresh cache dir each: both CLIs pull the DB from
    --db-repository and give the same report; the port flattens it once
    into the memo beside it. --skip-db-update then makes no request,
    and a stale DB is pulled again."""
    reg, repo = _serve_db(tmp_path)
    try:
        root = _rootfs(tmp_path)
        reports = {}
        for who, main in (("port", cli.main), ("ref", ref_cli.main)):
            argv = ["rootfs", root, "--db-repository", repo,
                    "--cache-dir", str(tmp_path / f"{who}-c")]
            reports[who] = _scan(main, argv, who)
        assert reports["port"] == reports["ref"]
        vulns = [v["VulnerabilityID"]
                 for r in json.loads(reports["port"])["Results"]
                 for v in r.get("Vulnerabilities") or []]
        assert vulns == ["CVE-2025-26519"]
        cache = str(tmp_path / "port-c")
        assert os.path.exists(download.db_path(cache) + ".npz")
        # make the pulled DB stale: --skip-db-update uses it anyway
        with open(download.metadata_path(cache), "w") as f:
            json.dump({"Version": 2, "NextUpdate": "2000-01-01T00:00:00Z"},
                      f)
        os.utime(download.metadata_path(cache), (0, 0))
        n = len(reg.requests)
        argv = ["rootfs", root, "--db-repository", repo,
                "--cache-dir", cache]
        assert _scan(cli.main, argv + ["--skip-db-update"], "port") == \
            reports["port"]
        assert len(reg.requests) == n
        assert _scan(cli.main, argv, "port") == reports["port"]
        assert len(reg.requests) > n
    finally:
        reg.stop()


def test_scan_refuses_a_tampered_db_like_reference(tmp_path):
    reg, repo = _serve_db(tmp_path)
    try:
        for digest, data in list(reg.blobs.items()):
            if data[:2] == b"\x1f\x8b":
                reg.blobs[digest] = data[:-4] + b"XXXX"
        root = _rootfs(tmp_path)
        msgs = []
        for who, main in (("port", cli.main), ("ref", ref_cli.main)):
            cache = str(tmp_path / f"{who}-c")
            argv = ["rootfs", root, "--db-repository", repo, "--cache-dir",
                    cache] + (["--device", "cpu"] if who == "port" else [])
            with pytest.raises(SystemExit) as e:
                main(argv)
            msgs.append(str(e.value))
            assert not os.path.exists(download.db_path(cache))
            assert os.listdir(os.path.join(cache, "db", "quarantine"))
        assert msgs[0] == msgs[1]
        assert msgs[0].startswith("DB unavailable: trivy-db download from ")
        assert "blob digest mismatch (manifest sha256:" in msgs[0]
    finally:
        reg.stop()

