"""`trivy server` in the port (trivy_tpu_torch/server/), on the CPU: the
mirror of tests/test_cli_server.py's TestServer (/healthz, /version, a
client scan, the cache hit, token auth) and of test_protowire.py's
binary end to end, ScanSBOM, the admission queue (429 + Retry-After on
a full queue, 503 while draining, a deadline that expires in the
queue), a failed launch answered with Twirp `internal`, the
observability pages (/metrics open, /debug/* behind the token), the
observability flags accepted and the other JAX server flags refused,
the CLI server drained by SIGTERM with --debug-launches,
and the wire both ways: the JAX client against the port's server and
the port's client against the JAX server give what a same-package pair
gives."""

import base64
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from helpers import ALPINE_OS_RELEASE, APK_INSTALLED, make_image
from trivy_tpu.db import build_table as ref_build_table
from trivy_tpu.db.fixtures import load_fixture_files as ref_load_fixtures
from trivy_tpu.fanal.artifact import ImageArchiveArtifact as RefArtifact
from trivy_tpu.server import client as ref_client
from trivy_tpu.server import listen as ref_listen
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.db import build_table
from trivy_tpu_torch.db.fixtures import load_fixture_files
from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
from trivy_tpu_torch.resilience import AdmissionOptions
from trivy_tpu_torch.server import client
from trivy_tpu_torch.server.listen import serve_background
from trivy_tpu_torch.server.protowire import decode_msg, encode_msg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXGLOB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")
FIXTURES = sorted(glob.glob(FIXGLOB))
TOKEN = "secret-token"
SCAN = "/twirp/trivy.scanner.v1.Scanner/Scan"
NO_RETRY = client.RetryPolicy(attempts=1)


def _table():
    advisories, details, _ = load_fixture_files(FIXTURES)
    return build_table(advisories, details)


def _start(tmp, **kw):
    httpd, state = serve_background("127.0.0.1", 0, _table(), str(tmp),
                                    device="cpu", **kw)
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, state


def _stop(httpd, state):
    httpd.shutdown()
    httpd.server_close()
    state.close()


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("img") / "img.tar")
    make_image(p, [{
        "etc/os-release": ALPINE_OS_RELEASE,
        "etc/alpine-release": b"3.17.3\n",
        "lib/apk/db/installed": APK_INSTALLED,
    }])
    return p


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    base, httpd, state = _start(tmp_path_factory.mktemp("srvcache"),
                                token=TOKEN)
    yield base
    _stop(httpd, state)


@pytest.fixture(scope="module")
def ref_server(tmp_path_factory):
    advisories, details, _ = ref_load_fixtures(FIXTURES)
    httpd, state = ref_listen.serve_background(
        "127.0.0.1", 0, ref_build_table(advisories, details),
        cache_dir=str(tmp_path_factory.mktemp("refcache")), token=TOKEN)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    state.close()


def _post(url, body: bytes, headers: dict):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _scan_json(base, body: dict, **headers):
    return _post(base + SCAN, json.dumps(body).encode(),
                 {"Content-Type": "application/json", **headers})


def _vuln_ids(results):
    return {v.vulnerability_id for r in results for v in r.vulnerabilities}


class TestServer:
    def test_healthz_version(self, server):
        req = urllib.request.Request(server + "/healthz",
                                     headers={"Accept": "text/plain"})
        assert urllib.request.urlopen(req).read() == b"ok"
        h = json.loads(urllib.request.urlopen(server + "/healthz").read())
        assert h["status"] == "ok" and h["device"]["platform"] == "cpu"
        assert h["db_version"] == _table().content_digest()
        assert h["resilience"]["admission"]["active"] == 0
        assert set(h["detectd"]) >= {"dispatches", "batches", "pairs"}
        v = json.loads(urllib.request.urlopen(server + "/version").read())
        assert "Version" in v

    @pytest.mark.parametrize("page", ["/metrics", "/debug/traces",
                                      "/debug/perf"])
    def test_observability_pages_are_served(self, server, page):
        """The pages that answered 404 naming their item before the
        port had them: /metrics is open and strictly parseable, the
        /debug pages answer 401 without the token and 200 with it."""
        from trivy_tpu_torch.obs.exposition import parse_exposition
        if page == "/metrics":
            with urllib.request.urlopen(server + page) as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                fams = parse_exposition(r.read().decode())
            assert fams["trivy_tpu_slo_burn_rate"]["type"] == "gauge"
            return
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server + page)
        assert e.value.code == 401
        req = urllib.request.Request(server + page,
                                     headers={"Trivy-Token": TOKEN})
        doc = json.loads(urllib.request.urlopen(req).read())
        assert doc["pid"] == os.getpid()
        assert ("spans" if page == "/debug/traces" else "shapes") in doc

    def test_client_server_scan(self, server, image_path):
        cache = client.RemoteCache(server, token=TOKEN)
        ref = ImageArchiveArtifact(image_path, cache).inspect()
        scanner = client.RemoteScanner(server, token=TOKEN)
        results, os_info = scanner.scan(ref.name, ref.id, ref.blob_ids)
        assert os_info.family == "alpine"
        assert "CVE-2023-0286" in _vuln_ids(results)
        # a second scan finds its blobs in the server's cache
        _missing_artifact, missing = cache.missing_blobs(ref.id,
                                                         ref.blob_ids)
        assert missing == []

    def test_token_auth(self, server):
        with pytest.raises(client.TwirpError) as e:
            client.RemoteScanner(server, token="wrong").scan("t", "a", [])
        assert e.value.code == "unauthenticated"

    def test_db_version_header_on_scans(self, server):
        code, headers, _ = _scan_json(server, {"target": "t"},
                                      **{"Trivy-Token": TOKEN})
        assert code == 200
        assert headers["X-Trivy-DB-Version"] == _table().content_digest()


def test_proto_end_to_end(tmp_path, image_path):
    """PutBlob, MissingBlobs and Scan in the binary encoding, answered in
    kind; JSON on the same server still works."""
    from trivy_tpu_torch.fanal.cache import MemoryCache
    base, httpd, state = _start(tmp_path / "cache")
    try:
        local = MemoryCache()
        ref = ImageArchiveArtifact(image_path, local).inspect()
        blob_j = local.blobs[ref.blob_ids[0]]
        os_j = blob_j.get("OS", {})
        proto_blob = {
            "schema_version": 2,
            "os": {"family": os_j.get("Family", ""),
                   "name": os_j.get("Name", "")},
            "diff_id": blob_j.get("DiffID", ""),
            "package_infos": [{
                "file_path": pi.get("FilePath", ""),
                "packages": [{
                    "name": p.get("Name", ""),
                    "version": p.get("Version", ""),
                    "release": p.get("Release", ""),
                    "src_name": p.get("SrcName", ""),
                    "src_version": p.get("SrcVersion", ""),
                    "src_release": p.get("SrcRelease", ""),
                    "licenses": p.get("Licenses", []),
                } for p in pi.get("Packages", [])],
            } for pi in blob_j.get("PackageInfos", [])],
        }
        proto = {"Content-Type": "application/protobuf"}
        code, headers, _ = _post(
            base + "/twirp/trivy.cache.v1.Cache/PutBlob",
            encode_msg({"diff_id": ref.blob_ids[0],
                        "blob_info": proto_blob}, "PutBlobRequest"), proto)
        assert code == 200
        assert headers["Content-Type"] == "application/protobuf"
        _, _, raw = _post(
            base + "/twirp/trivy.cache.v1.Cache/MissingBlobs",
            encode_msg({"artifact_id": ref.id, "blob_ids": ref.blob_ids},
                       "MissingBlobsRequest"), proto)
        assert decode_msg(raw, "MissingBlobsResponse").get(
            "missing_blob_ids") in (None, [])
        _, _, raw = _post(base + SCAN, encode_msg({
            "target": "test/image:latest", "artifact_id": ref.id,
            "blob_ids": ref.blob_ids, "options": {"scanners": ["vuln"]},
        }, "ScanRequest"), proto)
        resp = decode_msg(raw, "ScanResponse")
        assert resp["os"]["family"] == "alpine"
        vulns = resp["results"][0]["vulnerabilities"]
        assert "CVE-2023-0286" in {v["vulnerability_id"] for v in vulns}
        sev = next(v for v in vulns
                   if v["vulnerability_id"] == "CVE-2023-0286")
        assert sev["severity"] in (1, 2, 3, 4) and sev["pkg_name"]
        code, headers, raw = _post(
            base + "/twirp/trivy.cache.v1.Cache/MissingBlobs",
            json.dumps({"artifact_id": ref.id,
                        "blob_ids": ref.blob_ids}).encode(),
            {"Content-Type": "application/json"})
        assert "json" in headers["Content-Type"]
        assert json.loads(raw)["missing_blob_ids"] == []
    finally:
        _stop(httpd, state)


def _cdx(packages) -> bytes:
    prop = "aquasecurity:trivy:"
    comps = [{"type": "library", "name": n, "version": v,
              "bom-ref": f"pkg:apk/alpine/{n}@{v}?distro=3.17.3",
              "purl": f"pkg:apk/alpine/{n}@{v}?distro=3.17.3",
              "properties": [{"name": prop + "PkgType", "value": "alpine"},
                             {"name": prop + "SrcName", "value": src},
                             {"name": prop + "SrcVersion", "value": v}]}
             for n, src, v in packages]
    return json.dumps({
        "bomFormat": "CycloneDX", "specVersion": "1.5", "version": 1,
        "serialNumber": "urn:uuid:test-sbom",
        "metadata": {"component": {
            "type": "operating-system", "name": "alpine",
            "version": "3.17.3",
            "properties": [{"name": prop + "Type", "value": "alpine"}]}},
        "components": comps}, sort_keys=True).encode()


def test_scan_sbom_both_ways(server, ref_server):
    """ScanSBOM: the document decoded on the server. The port's client
    and the JAX one, against either server, give the same results."""
    raw = _cdx([("musl", "musl", "1.2.3-r4"),
                ("libssl3", "openssl", "3.0.7-r0")])
    got = {}
    for name, mod in (("port", client), ("ref", ref_client)):
        for where, base in (("port", server), ("ref", ref_server)):
            results, os_info = mod.RemoteScanner(
                base, token=TOKEN).scan_sbom("img.cdx", raw)
            got[name, where] = ([r.to_json() for r in results],
                                (os_info.family, os_info.name))
    assert len({json.dumps(v, sort_keys=True) for v in got.values()}) == 1
    results, os_info = client.RemoteScanner(
        server, token=TOKEN).scan_sbom("img.cdx", raw)
    assert {"CVE-2025-26519", "CVE-2023-0286"} <= _vuln_ids(results)
    assert os_info.family == "alpine"
    # a hostile document is an annotated result, not an error
    code, _, body = _post(
        server + "/twirp/trivy.scanner.v1.Scanner/ScanSBOM",
        json.dumps({"target": "bad", "kind": "cyclonedx",
                    "document": base64.b64encode(b"not json {").decode(),
                    "options": {"scanners": ["vuln"]}}).encode(),
        {"Content-Type": "application/json", "Trivy-Token": TOKEN})
    assert code == 200
    assert "ingest" in {r.get("Class") for r in json.loads(body)["results"]}


def test_wire_both_ways(server, ref_server, image_path):
    """The JAX client against the port's server and the port's client
    against the JAX server: the results a same-package pair gives."""
    got = {}
    for name, mod, art in (("port", client, ImageArchiveArtifact),
                           ("ref", ref_client, RefArtifact)):
        for where, base in (("port", server), ("ref", ref_server)):
            ref = art(image_path, mod.RemoteCache(base, token=TOKEN),
                      scanners=("vuln",)).inspect()
            results, os_info = mod.RemoteScanner(base, token=TOKEN).scan(
                ref.name, ref.id, ref.blob_ids)
            got[name, where] = (
                json.dumps([r.to_json() for r in results], sort_keys=True),
                (os_info.family, os_info.name, os_info.eosl))
    assert got["ref", "port"] == got["ref", "ref"]
    assert got["port", "ref"] == got["port", "port"]
    assert got["port", "port"] == got["ref", "ref"]
    assert "CVE-2023-0286" in got["port", "port"][0]


class _Gate:
    """Holds every scan of a server until released."""

    def __init__(self, state):
        self.entered = threading.Semaphore(0)
        self.release = threading.Event()
        scanner = state.scanner
        scan = scanner.scan

        def held(*a, **k):
            self.entered.release()
            assert self.release.wait(60)
            return scan(*a, **k)
        scanner.scan = held


class TestAdmission:
    def test_full_queue_sheds_429_with_retry_after(self, tmp_path):
        base, httpd, state = _start(
            tmp_path, admission=AdmissionOptions(max_active=1, max_queue=0))
        gate = _Gate(state)
        first = threading.Thread(target=_scan_json, args=(base, {}))
        first.start()
        try:
            assert gate.entered.acquire(timeout=30)
            code, headers, body = _scan_json(base, {})
            assert code == 429
            assert int(headers["Retry-After"]) >= 1
            assert json.loads(body)["code"] == "resource_exhausted"
        finally:
            gate.release.set()
            first.join(60)
            _stop(httpd, state)
        assert not first.is_alive()

    def test_deadline_expires_in_queue(self, tmp_path):
        base, httpd, state = _start(tmp_path, admission=AdmissionOptions(
            max_active=1, max_queue=4, queue_timeout_ms=20000))
        gate = _Gate(state)
        first = threading.Thread(target=_scan_json, args=(base, {}))
        first.start()
        try:
            assert gate.entered.acquire(timeout=30)
            code, headers, body = _scan_json(
                base, {}, **{"X-Trivy-Deadline-Ms": "150"})
            assert code == 429 and "Retry-After" in headers
            assert "deadline exceeded in queue" in json.loads(body)["msg"]
        finally:
            gate.release.set()
            first.join(60)
            _stop(httpd, state)

    def test_drain_sheds_503_and_finishes_in_flight(self, tmp_path):
        base, httpd, state = _start(tmp_path)
        gate = _Gate(state)
        done = {}
        first = threading.Thread(target=lambda: done.setdefault(
            "r", _scan_json(base, {"target": "t"})))
        first.start()
        try:
            assert gate.entered.acquire(timeout=30)
            state.begin_drain()
            code, headers, body = _scan_json(base, {})
            assert code == 503 and int(headers["Retry-After"]) >= 1
            assert json.loads(body)["code"] == "unavailable"
            h = json.loads(urllib.request.urlopen(base + "/healthz").read())
            assert h["status"] == "draining"
            assert not state.drain(0.1)     # the held scan is in flight
            gate.release.set()
            assert state.drain(30)
            first.join(60)
            assert done["r"][0] == 200
        finally:
            gate.release.set()
            _stop(httpd, state)

    def test_failed_launch_answers_internal(self, tmp_path, image_path):
        """No host join: a launch that raises fails the scan with Twirp
        `internal`, and the server goes on."""
        base, httpd, state = _start(tmp_path)
        try:
            cache = client.RemoteCache(base)
            ref = ImageArchiveArtifact(image_path, cache).inspect()
            det = state.scanner.detector
            launch = det._launch

            def broken(*a, **k):
                raise RuntimeError("injected launch failure")
            det._launch = broken
            scanner = client.RemoteScanner(base, retry=NO_RETRY)
            with pytest.raises(client.TwirpError) as e:
                scanner.scan(ref.name, ref.id, ref.blob_ids)
            assert e.value.code == "internal"
            assert "injected launch failure" in str(e.value)
            det._launch = launch
            assert "CVE-2023-0286" in _vuln_ids(
                scanner.scan(ref.name, ref.id, ref.blob_ids)[0])
        finally:
            _stop(httpd, state)


@pytest.mark.parametrize("flag,value,read", [
    ("--trace", "t.json", None),
    ("--incident-dir", "inc", lambda o: o.RECORDER.incident_dir),
    ("--slow-trace-ms", "250", lambda o: o.RECORDER.slow_trace_s * 1e3),
    ("--slo-latency-ms", "750",
     lambda o: o.SLO.latency_threshold_s * 1e3),
    ("--profile-auto-burn", "3", lambda o: o.PROF.auto_burn_threshold),
    ("--profile-cooldown-s", "12", lambda o: o.PROF.cooldown_s),
    ("--ingest-tenant-walker-share", "0.5", None),
    ("--ingest-tenant-byte-share", "0.25", None)],
    ids=lambda a: a if isinstance(a, str) and a.startswith("--") else "")
def test_observability_server_flags_are_accepted(flag, value, read,
                                                 tmp_path):
    """The eight flags the port refused naming ROADMAP A17 before it
    had the observability layer: parsed, refused no more, and applied
    to the process singletons by the server command."""
    from trivy_tpu_torch import obs
    if flag in ("--trace", "--incident-dir"):
        value = str(tmp_path / value)
    args = cli.build_parser().parse_args(
        ["server", "--device", "cpu", flag, value])
    cli._refuse_server_flags(args)
    got = getattr(args, flag[2:].replace("-", "_"))
    assert got == (value if flag in ("--trace", "--incident-dir")
                   else float(value))
    if read is None:
        return
    saved = (obs.RECORDER.incident_dir, obs.RECORDER.slow_trace_s,
             obs.SLO.latency_threshold_s)
    try:
        cli._configure_watch(args)
        assert read(obs) == pytest.approx(got) \
            if isinstance(got, float) else read(obs) == got
    finally:
        obs.RECORDER.incident_dir, obs.RECORDER.slow_trace_s, \
            obs.SLO.latency_threshold_s = saved
        obs.PROF.reset_for_tests()


@pytest.mark.parametrize("argv", [
    [f"--{d.replace('_', '-')}", "1"] for d in cli.SERVER_REFUSED],
    ids=lambda a: a[0])
def test_refused_server_flags_name_their_item(argv, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["server", "--device", "cpu", "--db", FIXGLOB,
                  "--cache-dir", str(tmp_path), *argv])
    msg = str(e.value)
    assert argv[0].split("=")[0].replace("--no-", "--") in msg
    assert "ROADMAP A" in msg


def test_refused_flag_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TRIVY_MESH_MIN_DEVICES", "4")
    with pytest.raises(SystemExit, match="no meshguard"):
        cli.main(["server", "--device", "cpu", "--db", FIXGLOB,
                  "--cache-dir", str(tmp_path)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_server_drains_on_sigterm(tmp_path, image_path):
    """`server` as users run it: a scan, then SIGTERM drains it, and
    --debug-launches prints the launches and detectd's dispatches and
    saves the merged dispatches it kept."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", "server", "--listen",
         f"127.0.0.1:{port}", "--db", FIXGLOB, "--cache-dir", str(tmp_path),
         "--device", "cpu", "--debug-launches", "--token", TOKEN],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                urllib.request.urlopen(base + "/healthz", timeout=5)
                break
            except OSError:
                time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1]
        cache = client.RemoteCache(base, token=TOKEN)
        ref = ImageArchiveArtifact(image_path, cache).inspect()
        results, _ = client.RemoteScanner(base, token=TOKEN).scan(
            ref.name, ref.id, ref.blob_ids)
        assert "CVE-2023-0286" in _vuln_ids(results)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    lines = err.strip().splitlines()
    assert lines[0].startswith("drain: admission stopped")
    debug = json.loads(lines[-1])
    # the CPU launches no kernel
    assert sum(debug["launches"].values()) == 0
    assert debug["detectd"]["dispatches"] == 1
    assert debug["detectd"]["batches"] == 1
    assert debug["merged_recorded"] == 1
    assert os.path.exists(debug["merged_record"])
