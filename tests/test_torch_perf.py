"""The port's graftprof layer (obs/perf.py: the dispatch ledger, the
memory view and the torch.profiler capture; obs/perfcheck.py) held
against the JAX package: every case of tests/test_perf.py runs here but
the one below.

  * TestDispatchLedger and TestPerfcheck go through test_torch_mirror's
    twins: each value equals the reference's at tolerance 0; but the
    memory-view case, whose `isinstance(..., dict)` a twin cannot pass.
  * That case, TestEngineIntegration, TestProfiler, TestDebugSurfaces
    and TestAcceptanceDrill run against the port alone, on the CPU: the
    detector with `device="cpu"`, and each Profiler the tests build with
    `device="cpu"` (a CPU capture records the CPU activity only; the
    port's profiler defaults to the card). The drill's fleet is the
    port's router (fleet/router.py) in front of two CPU replicas
    sharing one FakeRedis cache (`drill_fleet` below).

Beside them: the per-shape ledger rows of the same batches equal the
reference's shape-table keys, a capture "on the card" that saw no CUDA
kernel raises and writes no trace, and the kernel summary counts the
card's busy time as the union of kernel intervals.
"""

import glob
import os

import pytest

from test_torch_mirror import port_cases, run_case, twin_cases
from test_torch_obs import reset_port_obs
from trivy_tpu_torch.obs import exposition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXGLOB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")

_TWIN = ("TestDispatchLedger::", "TestPerfcheck::")
_PORT_ONLY = "TestDispatchLedger::test_resident_and_memory_status"


@pytest.fixture(autouse=True, scope="module")
def _port_obs_state():
    reset_port_obs()
    yield
    reset_port_obs()


@pytest.fixture(autouse=True)
def _cpu_profiler():
    """PROF is process-wide: each case starts from its defaults, on the
    CPU."""
    from trivy_tpu_torch.obs import PROF
    PROF.reset_for_tests()
    PROF.configure(device="cpu")
    yield
    PROF.reset_for_tests()


def _fixture_table():
    from trivy_tpu_torch.db import build_table
    from trivy_tpu_torch.db.fixtures import load_fixture_files
    advisories, details, _ = load_fixture_files(sorted(glob.glob(FIXGLOB)))
    return build_table(advisories, details)


@pytest.fixture(scope="class")
def perf_server(tmp_path_factory):
    from trivy_tpu_torch.server.listen import serve_background
    httpd, state = serve_background(
        "127.0.0.1", 0, _fixture_table(),
        cache_dir=str(tmp_path_factory.mktemp("pcache")), device="cpu")
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    state.close()


@pytest.fixture(scope="class")
def drill_fleet(tmp_path_factory):
    """tests/test_perf.py's drill fleet on the port: two CPU replicas
    sharing one FakeRedis cache behind the router."""
    from helpers import FakeRedis
    from trivy_tpu_torch.fleet.router import serve_router_background
    from trivy_tpu_torch.obs import RECORDER
    from trivy_tpu_torch.server.listen import serve_background
    table = _fixture_table()
    redis = FakeRedis()
    backend = f"redis://127.0.0.1:{redis.port}"
    incident_dir = str(tmp_path_factory.mktemp("drill-incidents"))
    RECORDER.configure(incident_dir=incident_dir, incident_cooldown_s=0.0)
    replicas = []
    for _ in range(2):
        httpd, state = serve_background(
            "127.0.0.1", 0, table,
            cache_dir=str(tmp_path_factory.mktemp("cache")),
            cache_backend=backend, device="cpu")
        replicas.append([f"http://127.0.0.1:{httpd.server_address[1]}",
                         httpd, state])
    rhttpd, rstate = serve_router_background(
        "127.0.0.1", 0, [u for u, _, _ in replicas])
    yield {"router": f"http://127.0.0.1:{rhttpd.server_address[1]}",
           "replicas": replicas, "incident_dir": incident_dir}
    RECORDER.configure(incident_cooldown_s=30.0)
    rhttpd.shutdown()
    rhttpd.server_close()
    rstate.close()
    for _, httpd, state in replicas:
        httpd.shutdown()
        httpd.server_close()
        state.close()
    redis.close()


_NO_GUARD = "from {}.resilience import FAILPOINTS, GUARD\n"


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_perf.py",
    keep=lambda c: c.startswith(_TWIN) and c != _PORT_ONLY,
    subs=[(_NO_GUARD.format("twin_trivy"), "")]))
def test_perf_case_like_reference(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_perf.py",
    keep=lambda c: c == _PORT_ONLY or not c.startswith(_TWIN),
    subs=[(_NO_GUARD.format("trivy_tpu_torch"), ""),
          ("p.configure(cooldown_s=cooldown)",
           "p.configure(cooldown_s=cooldown, device=\"cpu\")"),
          ("det = BatchDetector(table)",
           "det = BatchDetector(table, device=\"cpu\")"),
          ('cache_dir=str(tmp_path_factory.mktemp("tkcache")),',
           'cache_dir=str(tmp_path_factory.mktemp("tkcache")), '
           'device="cpu",')],
    env={"parse_exposition": exposition.parse_exposition}))
def test_perf_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


def _shape_rows(pkg: str) -> tuple:
    """One detector of `pkg` runs the same three batches → (the new
    shape-table rows by (site, t_pad, h_cap), every row's keys)."""
    import importlib
    engine = importlib.import_module(pkg + ".detect.engine")
    perf = importlib.import_module(pkg + ".obs.perf")
    db = importlib.import_module(pkg + ".db")
    fixtures = importlib.import_module(pkg + ".db.fixtures")
    advisories, details, _ = fixtures.load_fixture_files(
        sorted(glob.glob(FIXGLOB)))
    det = engine.BatchDetector(
        db.build_table(advisories, details),
        **({"device": "cpu"} if pkg == "trivy_tpu_torch" else {}))
    before = {(r["site"], r["t_pad"], r["h_cap"]): r["dispatches"]
              for r in perf.LEDGER.shape_table()}
    Q = engine.PkgQuery
    try:
        det.detect_many([
            [Q("alpine 3.17", "apk", "openssl", "3.0.7-r0")],
            [Q("alpine 3.17", "apk", "musl", "1.2.3-r4"),
             Q("alpine 3.17", "apk", "openssl", "3.0.8-r0")],
            []])
    finally:
        det.close()
    rows = perf.LEDGER.shape_table()
    new = {(r["site"], r["t_pad"], r["h_cap"]):
           r["dispatches"] - before.get((r["site"], r["t_pad"],
                                         r["h_cap"]), 0)
           for r in rows}
    return ({k: v for k, v in new.items() if v}, {frozenset(r)
                                                 for r in rows})


def test_shape_table_equals_reference():
    port_new, port_keys = _shape_rows("trivy_tpu_torch")
    ref_new, ref_keys = _shape_rows("trivy_tpu")
    assert port_new == ref_new and port_new
    assert port_keys == ref_keys


def test_card_capture_without_kernel_events_raises(tmp_path, monkeypatch):
    """A capture on the card that recorded no CUDA kernel raises and
    writes no trace: a CPU-only profile never passes for the card's.
    (Here the CUDA activity is withheld, as a profiler that cannot see
    the card would.)"""
    from trivy_tpu_torch.obs import RECORDER, perf
    RECORDER.configure(incident_dir=str(tmp_path))
    cpu_only = perf._activities("cpu")
    monkeypatch.setattr(perf, "_activities", lambda device: cpu_only)
    p = perf.Profiler()
    p.configure(cooldown_s=0.0, device="cuda")
    with pytest.raises(perf.NoDeviceEvents):
        p.capture(20)
    assert not glob.glob(str(tmp_path / "profile-*" / "trace.json"))
    assert not glob.glob(str(tmp_path / "profile-*.json"))
    out = str(tmp_path / "cli")
    with pytest.raises(perf.NoDeviceEvents):
        with p.capture_dir(out):
            pass
    assert not os.path.exists(os.path.join(out, "trace.json"))
    # the one-at-a-time slot was released either way
    p.configure(device="cpu")
    assert p.capture(10)["device"] == "cpu"


def test_kernel_summary_busy_time_is_the_union():
    import torch

    from trivy_tpu_torch.obs.perf import kernel_summary

    class Ev:
        def __init__(self, name, lo, hi, cuda=True):
            self.name = name
            self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                                else torch.autograd.DeviceType.CPU)
            self.time_range = type("R", (), {"start": lo, "end": hi})

    class Prof:
        def events(self):
            return [Ev("csr_tile_kernel", 0.0, 100.0),
                    Ev("csr_compact_kernel", 50.0, 150.0),
                    Ev("shiftor_kernel", 400.0, 500.0),
                    Ev("aten::cat", 0.0, 1000.0, cuda=False)]
    doc = kernel_summary(Prof())
    assert doc["events"] == 3
    assert doc["busy_ms"] == pytest.approx(0.25)
    assert doc["kernels"]["csr_tile_kernel"] == {"count": 1,
                                                 "device_ms": 0.1}
    assert set(doc["kernels"]) == {"csr_tile_kernel", "csr_compact_kernel",
                                   "shiftor_kernel"}
