"""The port's graftwatch layer (obs/recorder.py, obs/slo.py,
obs/collect.py, obs/check.py and the server's /debug pages) held against
the JAX package: every case of tests/test_graftwatch.py runs here but
the ones below.

  * TestSLO (but its METRICS export case), TestCheck (but the case that
    writes an assembled document with json.dumps) and TestCollect go
    through test_torch_mirror's twins: each value equals the
    reference's at tolerance 0, with the SLO windows under an injected
    clock.
  * The flight recorder, those two cases, the /debug endpoints and the
    fanal attribution spans run against the port alone (ring slots,
    span ids and clocks are the process's own), their servers on the
    CPU.

Not run, with what it needs:
  * TestIncidentDrill::test_routed_hang_drill_end_to_end — a
    `detect.dispatch` hang failpoint and the device breaker (GUARD)
    with its host join, which the port does not have (not ported by
    the north star). The fleet router it runs behind is ported
    (tests/test_torch_fleet.py).

The two /debug/traces cases of TestDebugEndpoints wait, before each
read of the page, until the server has no request in flight: the
server.rpc span reaches the flight recorder after the response is on
the wire, so a client may ask for the trace before it is there.

Beside them: a remote scan's trace assembled from the client's and the
server's fragments by `collect` is one connected tree, and incident
files written by the port's recorder validate with `obs.check`.
"""

import glob
import json
import os
import time
import urllib.request

import pytest

from helpers import ALPINE_OS_RELEASE, APK_INSTALLED, make_image
from test_torch_mirror import port_cases, run_case, twin_cases
from test_torch_obs import reset_port_obs
from trivy_tpu_torch.obs import exposition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXGLOB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")

_TWIN = ("TestSLO::", "TestCheck::", "TestCollect::")
_PORT_ONLY = ("TestSLO::test_device_serving_and_gauge_export",
              "TestCheck::test_clean_incident_and_trace")
_NOT_RUN = ("TestIncidentDrill::",)


@pytest.fixture(autouse=True)
def _port_obs_state():
    reset_port_obs()
    yield
    reset_port_obs()


def _fixture_table():
    from trivy_tpu_torch.db import build_table
    from trivy_tpu_torch.db.fixtures import load_fixture_files
    advisories, details, _ = load_fixture_files(sorted(glob.glob(FIXGLOB)))
    return build_table(advisories, details)


# each watch_server's state by its URL, for _settle
_STATES: dict = {}


@pytest.fixture(scope="class")
def watch_server(tmp_path_factory):
    from trivy_tpu_torch.server.listen import serve_background
    httpd, state = serve_background(
        "127.0.0.1", 0, _fixture_table(),
        cache_dir=str(tmp_path_factory.mktemp("wcache")), device="cpu")
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    _STATES[url] = state
    yield url
    del _STATES[url]
    httpd.shutdown()
    state.close()


def _settle(url: str) -> None:
    """Wait until the server at `url` has no request in flight (its
    spans are in the recorder), as test_torch_cost._quiesce does."""
    state = _STATES[url]
    deadline = time.monotonic() + 30.0
    while state.inflight and time.monotonic() < deadline:
        time.sleep(0.01)
    assert state.inflight == 0


_TRACES_READ = "        doc = json.loads(urllib.request.urlopen(\n"


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_graftwatch.py",
    keep=lambda c: c.startswith(_TWIN) and c not in _PORT_ONLY,
    # the twin module has no FAILPOINTS/GUARD: its autouse fixture is
    # never collected
    subs=[("from twin_trivy.resilience import FAILPOINTS, GUARD\n", "")]))
def test_graftwatch_case_like_reference(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_graftwatch.py",
    keep=lambda c: (not c.startswith(_TWIN) or c in _PORT_ONLY)
    and not c.startswith(_NOT_RUN),
    subs=[("from trivy_tpu_torch.resilience import FAILPOINTS, GUARD\n",
           ""),
          ('cache_dir=str(tmp_path_factory.mktemp("tcache")),',
           'cache_dir=str(tmp_path_factory.mktemp("tcache")), '
           'device="cpu",'),
          # both /debug/traces cases read the page once the server is
          # quiet (C1)
          ('            tid = r.headers.get("X-Trivy-Trace-Id")\n'
           + _TRACES_READ,
           '            tid = r.headers.get("X-Trivy-Trace-Id")\n'
           '        _settle(watch_server)\n' + _TRACES_READ),
          ('        urllib.request.urlopen(req).read()\n' + _TRACES_READ,
           '        urllib.request.urlopen(req).read()\n'
           '        _settle(watch_server)\n' + _TRACES_READ)],
    env={"parse_exposition": exposition.parse_exposition,
         "_settle": _settle}))
def test_graftwatch_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


def test_client_and_server_fragments_assemble(watch_server, tmp_path):
    """One remote scan: the client's fragment (client.scan) and the
    server's (server.rpc and everything under it) assemble into one
    tree whose only root is the client span, and the document
    validates."""
    from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
    from trivy_tpu_torch.obs import RECORDER, check, collect, new_trace
    from trivy_tpu_torch.obs.recorder import debug_traces_payload
    from trivy_tpu_torch.server import client
    img = str(tmp_path / "img.tar")
    make_image(img, [{"etc/os-release": ALPINE_OS_RELEASE,
                      "lib/apk/db/installed": APK_INSTALLED}])
    ref = ImageArchiveArtifact(img, client.RemoteCache(watch_server)) \
        .inspect()
    tid = "fe" * 16
    with new_trace(tid):
        client.RemoteScanner(watch_server).scan(ref.name, ref.id,
                                                ref.blob_ids)
    server = collect.fetch_fragment(watch_server, tid)
    own = {**debug_traces_payload(f"/debug/traces?trace_id={tid}"),
           "url": "client"}
    # in one process the recorder is shared: the server fragment holds
    # the client span too, and assembly dedupes it
    assert {s["name"] for s in server["spans"]} >= {"client.scan",
                                                    "server.rpc", "scan"}
    doc = collect.assemble([own, {**server, "url": watch_server}])
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    ids = {e["args"]["span_id"] for e in xs}
    roots = [e["name"] for e in xs if e["args"]["parent_id"] not in ids]
    assert roots == ["client.scan"]
    rpc = next(e for e in xs if e["name"] == "server.rpc"
               and e["args"]["route"].endswith("/Scan"))
    client_span = next(e for e in xs if e["name"] == "client.scan")
    assert rpc["args"]["parent_id"] == client_span["args"]["span_id"]
    path = tmp_path / "assembled.json"
    collect.write_trace(str(path), doc)
    assert check.check_file(str(path)) == []
    assert RECORDER.spans(tid)


def test_incident_file_validates_and_lists(watch_server, tmp_path):
    """A forced incident snapshot of the live recorder is a valid
    trivy-tpu-incident/1 file that /debug/incidents lists."""
    from trivy_tpu_torch.obs import RECORDER, check
    RECORDER.configure(incident_dir=str(tmp_path))
    urllib.request.urlopen(urllib.request.Request(
        watch_server + "/twirp/trivy.cache.v1.Cache/MissingBlobs",
        data=json.dumps({"artifact_id": "x", "blob_ids": []}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")).read()
    path = RECORDER.incident("manual", force=True)
    assert path and check.check_file(path) == []
    doc = json.loads(urllib.request.urlopen(
        watch_server + "/debug/incidents").read())
    assert [e["path"] for e in doc["incidents"]] == [path]
    assert doc["dir"] == str(tmp_path)
