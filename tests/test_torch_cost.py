"""The port's graftcost layer (obs/cost.py: request ledgers,
apportionment, the tenant aggregator, the X-Trivy-Cost codec, the
conservation report and /debug/costs) held against the JAX package:
every case of tests/test_cost.py runs here but the ones below.

  * TestHeaderCodec, TestCheckCosts and the apportionment cases that
    need no `with` block (SYSTEM fallthrough, dropped queue ms, the
    pro-rata split) go through test_torch_mirror's twins at tolerance 0,
    both packages' cost singletons reset first.
  * Every other case runs against the port alone (ledger clocks, context
    managers and process-wide series), its live server on the CPU with
    warmup on.

Not run, with what they need:
  * TestDedupApportionment::test_two_tenants_shared_base_layer_one_
    dispatch — a `detect.dispatch` failpoint to park detectd (the
    failpoints are not ported by the north star).
    test_dedup_apportionment_parks_detectd_without_failpoints below
    holds the same property, with a slowed launch.
  * TestStormConservationDrill::test_fleet_kill_c8_three_tenants_
    conserves — graftstorm and the fleet (ROADMAP A12).

Beside them: conservation holds after concurrent scans of several
tenants through the live server.
"""

import concurrent.futures as cf
import contextvars
import glob
import json
import os
import time
import urllib.request

import pytest

from helpers import ALPINE_OS_RELEASE, APK_INSTALLED, make_image
from test_torch_mirror import port_cases, run_case, twin_cases
from test_torch_obs import reset_port_obs
from trivy_tpu.obs import cost as ref_cost
from trivy_tpu_torch.obs import cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXGLOB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")

_TWIN = ("TestHeaderCodec::", "TestCheckCosts::",
         "TestLedgerAndApportionment::test_unattributed_charge_lands_in_",
         "TestLedgerAndApportionment::test_queue_ms_outside_request_",
         "TestLedgerAndApportionment::test_shares_split_pro_rata_")
_NOT_RUN = ("TestDedupApportionment::", "TestStormConservationDrill::")


@pytest.fixture(autouse=True, scope="module")
def _port_obs_state():
    reset_port_obs()
    yield
    reset_port_obs()


@pytest.fixture
def _both_reset():
    cost.reset_for_tests()
    ref_cost.reset_for_tests()


def _table():
    from trivy_tpu_torch.db import build_table
    from trivy_tpu_torch.db.fixtures import load_fixture_files
    advisories, details, _ = load_fixture_files(sorted(glob.glob(FIXGLOB)))
    return build_table(advisories, details)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from trivy_tpu_torch.detect.sched import SchedOptions
    from trivy_tpu_torch.server.listen import serve_background
    cost.TENANTS.reset_for_tests()
    # warmup on: the boot-time ladder launches run outside any request,
    # and the SYSTEM tenant absorbs them
    httpd, state = serve_background(
        "127.0.0.1", 0, _table(),
        cache_dir=str(tmp_path_factory.mktemp("costcache")),
        detect_opts=SchedOptions(warmup=True),
        device="cpu")
    yield f"http://127.0.0.1:{httpd.server_address[1]}", state
    httpd.shutdown()
    state.close()


@pytest.fixture(scope="module")
def server(served):
    return served[0]


def _image(path: str) -> str:
    make_image(path, [{"etc/os-release": ALPINE_OS_RELEASE,
                       "lib/apk/db/installed": APK_INSTALLED}])
    return path


@pytest.fixture(scope="module")
def scanned(served, tmp_path_factory):
    """One scan of tenant acme, settled when the fixture returns."""
    from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
    from trivy_tpu_torch.server.client import RemoteCache, RemoteScanner
    server, state = served
    img = _image(str(tmp_path_factory.mktemp("costimg") / "img.tar"))
    ref = ImageArchiveArtifact(img, RemoteCache(server)).inspect()
    scanner = RemoteScanner(server, tenant="acme")
    results, _ = scanner.scan(ref.name, ref.id, ref.blob_ids)
    assert results
    _quiesce(state)
    return scanner


def _quiesce(state) -> None:
    """Wait until the server has no request in flight. A request settles
    into its tenant's row after its response is on the wire, so a client
    may return before its scan is counted."""
    deadline = time.monotonic() + 30.0
    while state.inflight and time.monotonic() < deadline:
        time.sleep(0.01)
    assert state.inflight == 0


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_cost.py", keep=lambda c: c.startswith(_TWIN)))
def test_cost_case_like_reference(cls, fn, given, request, _both_reset):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_cost.py",
    keep=lambda c: not c.startswith(_TWIN + _NOT_RUN),
    subs=[("from helpers import parse_exposition",
           "from trivy_tpu_torch.obs.exposition import parse_exposition")]))
def test_cost_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


def test_dedup_apportionment_parks_detectd_without_failpoints():
    """The reference's dedup billing case, with the dispatcher parked by
    a slowed warm launch instead of a failpoint: two tenants submit the
    same queries into one coalesced round; the first owns every unique
    pair and pays the round's device ms, the second's collapsed
    duplicates bill as avoided ms."""
    from trivy_tpu_torch.detect.engine import BatchDetector, PkgQuery
    from trivy_tpu_torch.detect.sched import DispatchScheduler, SchedOptions
    cost.reset_for_tests()
    contextvars.copy_context().run(
        lambda: cost.charge_device_ms("test.rate", 10.0, real_rows=1000))
    qs = [PkgQuery(source="alpine 3.17", ecosystem="alpine", name=n,
                   version=v)
          for n, v in (("openssl", "3.0.7-r0"), ("openssl", "3.0.8-r0"),
                       ("musl", "1.2.3-r4"), ("zlib", "1.2.12-r2"))]
    warm = [PkgQuery(source="debian 11", ecosystem="debian", name="bash",
                     version="5.1-2+deb11u1")]
    det = BatchDetector(_table(), device="cpu")
    launch = det._launch
    slow = {"s": 0.0}

    def slowed(*a, **kw):
        time.sleep(slow["s"])
        return launch(*a, **kw)
    det._launch = slowed
    sched = DispatchScheduler(det, SchedOptions(coalesce_wait_ms=400.0))

    def submit(tenant):
        def body():
            with cost.request_ledger(tenant) as led:
                return led, sched.submit([qs])
        return contextvars.copy_context().run(body)
    try:
        for attempt in range(4):
            slow["s"] = 0.15 * (attempt + 1)
            fut_w = sched.submit([warm])
            led_a, fut_a = submit("acme")
            led_b, fut_b = submit("borg")
            fut_w.result(60)
            hits_a, hits_b = fut_a.result(60), fut_b.result(60)
            if led_b.value("avoided_ms") > 0.0:
                break
    finally:
        sched.close()
        det.close()
    assert len(hits_a) == len(hits_b) == 1
    assert led_a.value("avoided_ms") == 0.0
    assert led_b.value("avoided_ms") > 0.0
    assert led_a.value("device_ms") > 0.0
    assert led_b.value("device_ms") == 0.0


def test_conservation_holds_under_concurrent_tenants(served, scanned,
                                                     tmp_path):
    """Eight concurrent scans of three tenants through detectd's merged
    dispatches: the tenants' device ms and transfer bytes sum to the
    dispatch ledger's, and every tenant settled under its own label."""
    from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
    from trivy_tpu_torch.obs import LEDGER
    from trivy_tpu_torch.obs.check import check_costs
    from trivy_tpu_torch.server.client import RemoteCache, RemoteScanner
    server, state = served
    # both sides of the equation from zero (earlier cases reset the cost
    # side alone), once every earlier request has settled
    _quiesce(state)
    LEDGER.reset_for_tests()
    cost.reset_for_tests()
    img = _image(str(tmp_path / "img.tar"))
    ref = ImageArchiveArtifact(img, RemoteCache(server)).inspect()

    def one(i):
        sc = RemoteScanner(server, tenant=f"t{i % 3}")
        sc.scan(ref.name, ref.id, ref.blob_ids)
        return sc.last_cost
    with cf.ThreadPoolExecutor(8) as pool:
        docs = list(pool.map(one, range(8)))
    assert all(d["tenant"] == f"t{i % 3}" for i, d in enumerate(docs))
    _quiesce(state)
    doc = json.loads(urllib.request.urlopen(server + "/debug/costs").read())
    assert check_costs(doc) == []
    assert doc["conservation"]["device_ms"]["ok"]
    assert doc["conservation"]["transfer_bytes"]["ok"]
    for t in ("t0", "t1", "t2"):
        assert doc["tenants"][t]["scans"].get("ok", 0) >= 2
