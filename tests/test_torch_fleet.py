"""The port's fleet (trivy_tpu_torch/fleet/: ring.py, supervisor.py,
router.py; resilience/breaker.py; the client's failover list; the
`router` command) held against tests/test_fleet.py, on the CPU.

  * The ring against the JAX one, on the same input: for the same
    replica URLs, vnodes and seeded keys (numpy default_rng) both give
    the same owner and the same successor order, after an add and a
    remove too; `route_key` is equal on the same bodies. TestHashRing's
    six cases go through test_torch_mirror's twins (each value equal to
    the reference's at tolerance 0).
  * Against the port alone, with the replicas on `device="cpu"`:
    TestRouterScan, TestSharedCache, TestFailover's kill and readmission
    cases, TestShedsAndDeadlines (stub replicas), TestTenantFailover,
    TestCostHeaderAggregation, TestSkewLabelCardinality,
    TestClientFleetAwareness, TestFleetMetrics and TestOpenCache. The
    replicas share the JAX tests' FakeRedis (tests/helpers.py), which
    the port's redis cache speaks to as it would to a server.

Not run, with what they need: TestFailover::test_rpc_route_chaos_flaky_
forwards_all_succeed and TestFailpointGrammar's two cases arm or parse
failpoints, which the port does not have (ROADMAP A, not ported by the
north star); the router drops the `rpc.route` site.

Beside them: the `router` CLI in a subprocess (its flags, `--failpoint`
refused from argv, TRIVY_* env and trivy.yaml, a scan through it, the
SIGTERM drain and the `--trace` fleet dump), a readmission after a
table swap that the skew watch sees before traffic lands, the router's
host-only /debug/profile, and the chip script's `fleet` phase at a
small size.
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_mirror import PORT, port_cases, run_case, twin_cases
from trivy_tpu.fleet import router as ref_router
from trivy_tpu.fleet.ring import HashRing as RefRing
from trivy_tpu_torch.fleet import router as port_router
from trivy_tpu_torch.fleet.ring import HashRing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXGLOB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")


# ---- the ring and the route key against the JAX package -------------------

def _seeded_keys(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    return ["sha256:" + bytes(r).hex() for r in raw]


@pytest.mark.parametrize("n_replicas,vnodes", [(1, 1), (2, 16), (3, 64),
                                               (5, 128)])
def test_ring_placement_equals_reference(n_replicas, vnodes):
    urls = [f"http://127.0.0.1:{14950 + i}" for i in range(n_replicas)]
    port, ref = HashRing(urls, vnodes=vnodes), RefRing(urls, vnodes=vnodes)
    keys = _seeded_keys(n_replicas * 1000 + vnodes, 2000)

    def same():
        assert port.nodes() == ref.nodes() and len(port) == len(ref)
        for k in keys:
            assert port.node_for(k) == ref.node_for(k), k
            assert port.successors(k) == ref.successors(k), k
    same()
    # a join and a loss: the same remap on both sides, and only the
    # keys of the arcs that changed hands move
    before = {k: port.node_for(k) for k in keys}
    for ring in (port, ref):
        ring.add("http://127.0.0.1:14999")
    same()
    moved = [k for k in keys if port.node_for(k) != before[k]]
    assert all(port.node_for(k) == "http://127.0.0.1:14999" for k in moved)
    for ring in (port, ref):
        ring.remove(urls[0])
    same()
    assert all(port.node_for(k) == before[k] for k in keys
               if before[k] != urls[0]
               and port.node_for(k) != "http://127.0.0.1:14999")


def test_route_key_equals_reference():
    rng = np.random.default_rng(7)
    digests = _seeded_keys(8, 6)
    bodies = [{}, {"target": "img"}, {"diff_id": digests[0]},
              {"artifact_id": digests[1], "diff_id": digests[2]},
              {"artifact_id": "", "diff_id": digests[3], "target": "t"},
              {"artifact_id": digests[4], "blob_ids": digests[:3]}]
    routes = list(port_router.ROUTE_DESCRIPTORS)
    for body in bodies:
        for route in routes + ["/twirp/x.y/Z"]:
            assert port_router.route_key(route, body) == \
                ref_router.route_key(route, body)
    # random bodies: keys drawn from the seeded digests or absent
    for _ in range(200):
        body = {k: digests[int(rng.integers(0, 6))]
                for k in ("artifact_id", "diff_id", "target")
                if rng.random() < 0.5}
        route = routes[int(rng.integers(0, len(routes)))]
        assert port_router.route_key(route, body) == \
            ref_router.route_key(route, body)


# ---- tests/test_fleet.py through the twins and on the port ----------------

_TWIN = ("TestHashRing::",)
_NOT_RUN = ("TestFailover::test_rpc_route_chaos_flaky_forwards_all_succeed",
            "TestFailpointGrammar::")
_PORT_SUBS = [("cache_backend=self.cache_url)",
               "cache_backend=self.cache_url, device=\"cpu\")"),
              # TestTenantFailover kills the first replica, which owns
              # none of the case's six keys in 1.3% of port draws: then
              # nothing fails over and its failover count cannot move.
              # The ring owner of key 0 always holds a key
              ("fleet.kill_replica(next(iter(fleet.replicas)))",
               "fleet.kill_replica(\n"
               "            fleet.state.ring.node_for(blob_doc(0)[\"DiffID\"]))")]


def test_every_reference_case_is_accounted_for():
    ids = {c.id for c in port_cases("test_fleet.py", subs=_PORT_SUBS)}
    twin = {i for i in ids if i.startswith(_TWIN)}
    not_run = {i for i in ids if i.startswith(_NOT_RUN)}
    alone = ids - twin - not_run
    assert len(ids) == 31
    assert len(twin) == 6 and len(not_run) == 3 and len(alone) == 22


@pytest.fixture(scope="module")
def table():
    from trivy_tpu_torch.db import build_table
    from trivy_tpu_torch.db.fixtures import load_fixture_files
    advisories, details, _ = load_fixture_files(sorted(glob.glob(FIXGLOB)))
    return build_table(advisories, details)


def _port_fleet_module():
    from test_torch_mirror import load_mirror
    return load_mirror("test_fleet.py", PORT, _PORT_SUBS)


PORT_FLEET = _port_fleet_module()


@pytest.fixture()
def fleet(table):
    f = PORT_FLEET.Fleet(table)
    yield f
    f.close()


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_fleet.py", keep=lambda c: c.startswith(_TWIN)))
def test_fleet_case_like_reference(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_fleet.py",
    keep=lambda c: not c.startswith(_TWIN + _NOT_RUN), subs=_PORT_SUBS))
def test_fleet_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


# ---- the port's own cases -------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, headers: dict | None = None) -> dict:
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_readmission_after_a_table_swap_reports_the_new_version(table):
    """A replica that comes back serving another DB: the probe that
    readmits it hands the router its db_version first, so the skew watch
    counts the disagreement before any request lands there."""
    from trivy_tpu_torch.db.table import RawAdvisory
    from trivy_tpu_torch.metrics import METRICS
    from trivy_tpu_torch.server.listen import serve_background
    fleet = PORT_FLEET.Fleet(table)
    try:
        victim, other = sorted(fleet.replicas)
        v_old = fleet.replicas[other][1].db_version
        for i in range(4):
            PORT_FLEET.put_blob(fleet.url, i)
            PORT_FLEET.scan(fleet.url, i)
        assert set(fleet.state.db_versions().values()) == {v_old}
        skew0 = METRICS.family_sum("trivy_tpu_fleet_db_version_skew_total")
        port = fleet.kill_replica(victim)
        i = 0
        while victim not in fleet.state.supervisor.lost():
            key = PORT_FLEET.blob_doc(i)["DiffID"]
            if fleet.state.ring.node_for(key) == victim:
                PORT_FLEET.put_blob(fleet.url, i)
                PORT_FLEET.scan(fleet.url, i)
            i += 1
            assert i < 500
        # the victim comes back on the same port with a newer table
        from trivy_tpu_torch.db import build_table
        from trivy_tpu_torch.db.fixtures import load_fixture_files
        adv, details, _ = load_fixture_files(sorted(glob.glob(FIXGLOB)))
        adv = list(adv) + [RawAdvisory(
            "alpine 3.17", "alpine", "zlib", "CVE-2099-0001",
            fixed_version="1.2.14-r0")]
        new = build_table(adv, details)
        httpd, state = serve_background(
            "127.0.0.1", port, new, cache_dir="",
            cache_backend=fleet.cache_url, device="cpu")
        fleet.replicas[victim] = (httpd, state)
        v_new = state.db_version
        assert v_new != v_old
        deadline = time.monotonic() + 10.0
        while victim in fleet.state.supervisor.lost():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert fleet.state.db_versions()[victim] == v_new
        assert METRICS.family_sum(
            "trivy_tpu_fleet_db_version_skew_total") == skew0 + 1
    finally:
        fleet.close()


def test_router_profile_captures_the_host_only(table):
    """The router's /debug/profile answers the JAX router's schema with
    a host capture (device "cpu", no kernel), whatever the process's
    profiler is configured for; a wrong token is refused."""
    from trivy_tpu_torch.fleet import RouterOptions, serve_router_background
    from trivy_tpu_torch.obs import PROF, RECORDER
    from trivy_tpu_torch.obs import check as obs_check
    stub = PORT_FLEET.StubReplica()
    PROF.reset_for_tests()   # device "cuda", the replicas' default
    PROF.configure(cooldown_s=0.0)
    router, state = serve_router_background(
        "127.0.0.1", 0, [stub.url], RouterOptions(token="t"))
    base = f"http://127.0.0.1:{router.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/debug/profile?ms=20")
        assert e.value.code == 401
        doc = _get(base + "/debug/profile?ms=20",
                   {"Trivy-Token": "t"})
        assert doc["schema"] == "trivy-tpu-profile/1"
        assert doc["device"] == "cpu" and doc["events"] == 0
        assert obs_check.check_file(doc["manifest"]) == []
        assert doc["manifest"].startswith(RECORDER.incident_dir)
        perf = _get(base + "/debug/perf", {"Trivy-Token": "t"})
        assert {"shapes", "totals", "memory"} <= set(perf)
    finally:
        router.shutdown()
        router.server_close()
        state.close()
        stub.close()
        PROF.reset_for_tests()


def _router_cli(args: list, env: dict | None = None, cwd: str = REPO):
    return subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", "router", *args],
        cwd=cwd, env={**os.environ, "PYTHONPATH": REPO, **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("how", ["argv", "env", "config"])
def test_router_cli_refuses_failpoints(how, tmp_path):
    args = ["--listen", "127.0.0.1:1", "--replica", "http://127.0.0.1:2"]
    env = {}
    if how == "argv":
        args += ["--failpoint", "rpc.route=error"]
    elif how == "env":
        env["TRIVY_FAILPOINT"] = "rpc.route=error"
    else:
        (tmp_path / "trivy.yaml").write_text(
            "resilience:\n  failpoints: rpc.route=error\n")
    proc = _router_cli(args, env, cwd=str(tmp_path))
    _out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "--failpoint" in err and "failpoints" in err


def test_router_cli_needs_a_replica(tmp_path):
    proc = _router_cli(["--listen", "127.0.0.1:1"], cwd=str(tmp_path))
    _out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "at least one --replica" in err


def test_router_cli_routes_drains_and_dumps_the_fleet_trace(table,
                                                            tmp_path):
    """`router` as users run it, in front of two CPU replicas: its
    flags reach the ring and the fault domains (and the fleet.* keys of
    trivy.yaml), a scan through it equals one straight at a replica,
    SIGTERM drains it, and --trace writes one assembled trace whose
    router.forward span parents the replica's server.rpc."""
    from trivy_tpu_torch.obs import check as obs_check
    from trivy_tpu_torch.server.listen import serve_background
    replicas = []
    for _ in range(2):
        httpd, state = serve_background("127.0.0.1", 0, table,
                                        str(tmp_path / "cache"),
                                        token="t", device="cpu")
        replicas.append((f"http://127.0.0.1:{httpd.server_address[1]}",
                         httpd, state))
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    trace = tmp_path / "fleet.json"
    (tmp_path / "trivy.yaml").write_text(
        "fleet:\n  ring-vnodes: 7\n  replica-fail-threshold: 5\n")
    proc = _router_cli(
        ["--listen", f"127.0.0.1:{port}", "--replica", replicas[0][0],
         "--replica", replicas[1][0], "--trace", str(trace),
         "--token", "t", "--replica-reset-ms", "500",
         "--incident-dir", str(tmp_path / "inc")], cwd=str(tmp_path))
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.communicate()[1]
            try:
                health = _get(base + "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert health["fleet"]["ring"] == {
            "replicas": sorted(u for u, _, _ in replicas), "vnodes": 7}
        assert health["fleet"]["lost"] == []
        doc = PORT_FLEET.blob_doc(3)
        PORT_FLEET.post(base, "/twirp/trivy.cache.v1.Cache/PutBlob",
                        {"diff_id": doc["DiffID"], "blob_info": doc},
                        headers={"Trivy-Token": "t"})
        req = urllib.request.Request(
            base + "/twirp/trivy.scanner.v1.Scanner/Scan",
            data=json.dumps({"target": "img3", "artifact_id":
                             doc["DiffID"], "blob_ids": [doc["DiffID"]],
                             "options": {"scanners": ["vuln"]}}).encode(),
            headers={"Content-Type": "application/json",
                     "Trivy-Token": "t",
                     "X-Trivy-Trace-Id": "feedc0de" * 4}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            routed = json.loads(r.read())
            answered = r.headers["X-Trivy-Replica"]
        assert answered in {u for u, _, _ in replicas}
        direct = PORT_FLEET.scan(replicas[1][0], 3,
                                 headers={"Trivy-Token": "t"})
        assert json.dumps(routed, sort_keys=True) == \
            json.dumps(direct, sort_keys=True)
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=10).read().decode()
        assert 'trivy_tpu_fleet_replica_state{replica="' in metrics
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for _u, httpd, state in replicas:
            httpd.shutdown()
            httpd.server_close()
            state.close()
    assert proc.returncode == 0, err
    assert "router drain: admission stopped" in err
    assert obs_check.check_file(str(trace)) == []
    events = json.loads(trace.read_text())["traceEvents"]
    spans = {e["args"]["span_id"]: e for e in events if e["ph"] == "X"
             and e["args"].get("trace_id") == "feedc0de" * 4}
    rpc = [e for e in spans.values() if e["name"] == "server.rpc"
           and e["args"]["parent_id"] in spans]
    assert rpc and spans[rpc[0]["args"]["parent_id"]]["name"] == \
        "router.forward"
    assert any(e["name"] == "router.rpc" for e in spans.values())


def test_chip_fleet_phase_at_a_small_size_on_cpu(tmp_path):
    """chip_smoke's `fleet` phase on the CPU: two in-process replicas
    over a small apps table behind a `router` CLI process, fresh
    artifacts analyzed through the router, a c=16 round equal to the
    serial reports, a replica killed mid-round and readmitted, the
    client's failover list and the observability checks."""
    import chip_smoke as cs
    from trivy_tpu_torch import types as T
    from trivy_tpu_torch.fanal.analyzers import (INDIVIDUAL_PKG_ANALYZERS,
                                                 AnalyzerGroup)
    from trivy_tpu_torch.fanal.artifact import FilesystemArtifact
    from trivy_tpu_torch.fanal.cache import FSCache
    from trivy_tpu_torch.scanner import LocalScanner
    from trivy_tpu_torch.secret import SecretScanner
    table, _deb, names, _raw = cs.apps_table(np.random.default_rng(7),
                                             shrink=10)
    # the checkouts draw from the first 6,000 npm names; past the small
    # table's, a name has no advisory
    names = {eco: cs.app_names(eco, max(len(v), 6000))
             for eco, v in names.items()}
    # the server phase's clients, small: analyzed into an FS cache, each
    # scanned once by a CPU LocalScanner (the serial reports)
    cache_dir = str(tmp_path / "server-cache")
    cache = FSCache(cache_dir)
    refs = []
    for i, (files, _s) in enumerate(cs.server_checkouts(
            np.random.default_rng(9), names, n_distinct=5, n_repeat=1,
            text=(1 << 10, 2 << 10))):
        root = str(tmp_path / f"client{i}")
        cs._write_tree(root, files)
        refs.append(FilesystemArtifact(
            root, cache, group=AnalyzerGroup(
                disabled=INDIVIDUAL_PKG_ANALYZERS + ("sbom",)),
            scanners=("vuln", "secret"),
            secret_scanner=SecretScanner(device="cpu")).inspect())
    local = LocalScanner(cache, table, device="cpu")
    opts = T.ScanOptions(scanners=("vuln", "secret"))
    serial = []
    for ref in refs:
        results, os_info = local.scan(ref.name, ref.id, ref.blob_ids, opts)
        serial.append((cs._canon(results), cs._os_key(os_info)))
    local.close()
    fig = cs.fleet_phase(str(tmp_path), table, names,
                         (cache_dir, refs, serial), device="cpu",
                         n_fresh=2, text=(1 << 10, 2 << 10))
    assert fig["fresh"]["artifacts"] == 2
    assert fig["c16"]["failed"] == 0 and fig["kill"]["failed"] == 0
    assert min(fig["c16"]["requests_by_replica"]) > 0
    assert fig["kill"]["failovers"] > 0 and fig["kill"]["readmissions"] >= 1
    assert fig["failover_client"] == {"equal": True, "promoted": True}
    assert fig["obs"]["trace_chain"] == ["client.scan", "router.rpc",
                                         "router.forward", "server.rpc"]
    assert {"trivy_tpu_fleet_replica_state",
            "trivy_tpu_fleet_failovers_total",
            "trivy_tpu_fleet_router_latency_seconds"} <= \
        set(fig["obs"]["families"])
    # the CPU launches no kernel; each replica recorded its dispatches
    assert sum(fig["launches"].values()) == 0
    assert fig["fresh"]["shiftor_launches"] == 0 and fig["records"]
