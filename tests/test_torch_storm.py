"""The port's graftstorm (trivy_tpu_torch/resilience/storm.py) held
against tests/test_storm.py and the JAX package's storm, on the CPU.

  * Through test_torch_mirror's twins (both packages, tolerance 0):
    TestScheduleGeneration, TestExpositionCheck and
    TestMinimization::test_replay_schema_validation. Source edits: the
    FAILPOINTS/GUARD import goes (the port has neither), `known_site` is
    the JAX failpoint catalog's (the port has no catalog to hold its
    menus to), TestExpositionCheck renders the port's own METRICS (the
    two packages' registries hold different series), and `json` dumps a
    twin through the port's side once the reference's side dumps the
    same text.
  * Against the port alone, with its servers on the CPU (run_storm and
    serve_background get device="cpu"):
    TestTenantIsolation::test_adversarial_tenant_drill_c8 and
    ::test_replay_round_trips_tenant_quota_knobs, TestGracefulDrain's
    three cases and TestDBVersionIdentity's four. The drain case slows
    the server's scans by wrapping its scanner (`slow_scans`) where the
    JAX case arms an `rpc.scan` slow failpoint. The two TestTenantIsolation
    cases run their storm in an interpreter of their own (torch and the
    port, one intra-op thread, no JAX): the flood's 20 requests come
    from threads that share the server's interpreter lock, and on a
    loaded host any other thread of the test process staggers them
    until they no longer overflow the 4+2 tenant cap, as the
    reference's drill does under load.

Not run, with what they need:
  * TestAcceptance's six drills: failpoints (`detect.dispatch`,
    `detect.device_get`, `detect.mesh:1`, `rpc.route`, `memo.get`,
    `memo.put`) or a `host_loss` event, which the port refuses
    (StormRefused: it has no failpoints and no meshguard, ROADMAP A, not
    ported by the north star); ::test_generated_schedule_smoke's sampled
    schedule holds failpoints.
  * TestTenantIsolation::test_generated_adversarial_schedule_passes (its
    sampled schedule, seed 2, holds two failpoints) and
    ::test_quota_failpoint_sheds_well_formed (an `admission.quota`
    failpoint).
  * TestReplayDeterminism (a `detect.dispatch` failpoint) and
    TestMinimization::test_planted_failure_minimizes_and_replays (an
    `rpc.scan` plant): the planted-failure minimization below holds the
    same property with an invariant the test registers.
  * TestWideSweep: marked slow (sampled schedules, which hold
    failpoints).

Beside them: generate_schedule JSON-equal to the reference's over seeds
0–39 on every topology; the seeded workload (tables, request and SBOM
documents, ingest archives) equal to the reference's; the port's oracle
equal to the JAX storm's on the same schedule, load seed and table for
single, fleet, ingest and mesh; a fleet drill (kill, DB upgrade, flood)
and an ingest drill (both hostile variants) passing every invariant;
StormRefused through run_storm, a replay and the CLI (exit 2); the CLI
on a schedule it can run; and the chip script's `storm` phase at a
small size. The drills run with one intra-op thread.
"""

import json
import os
import pickle
import subprocess
import sys
import tarfile
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_mirror import port_cases, run_case, twin_cases, unwrap
from trivy_tpu.resilience import storm as ref_storm
from trivy_tpu_torch.resilience import storm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The drills' servers run their plain joins on the CPU: one
    intra-op thread each keeps a loaded host from stretching them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table():
    return storm.storm_table()


# ---- tests/test_storm.py through the twins and on the port ----------------

class _TwinJson:
    """`json` for the twin cases: dumps a twin through the port's side,
    once the reference's side dumps the same text."""
    loads = staticmethod(json.loads)

    @staticmethod
    def dumps(v, **kw):
        port = json.dumps(unwrap(v, 0), **kw)
        assert port == json.dumps(unwrap(v, 1), **kw)
        return port


def slow_scans(state, seconds: float) -> None:
    """Every scan the server runs from now on sleeps `seconds` first."""
    scanner = state.scanner
    scan = scanner.scan

    def slowed(*a, **kw):
        time.sleep(seconds)
        return scan(*a, **kw)
    scanner.scan = slowed


_STORM_CHILD = """
import pickle, sys
import torch
torch.set_num_threads(1)
from trivy_tpu_torch.resilience import storm
digest, args, kw = pickle.loads(sys.stdin.buffer.read())
table = storm.storm_table()
assert table.content_digest() == digest
report = storm.run_storm(*args, table=table, device="cpu", **kw)
sys.stdout.buffer.write(pickle.dumps(report))
"""


def _run_storm_cpu(*a, table, **kw):
    """run_storm on the CPU in an interpreter of its own (torch and the
    port, one intra-op thread, no JAX): the drill's server and load
    share the interpreter lock with no thread of the test process. The
    table must be storm_table()'s, which the child builds again."""
    out = subprocess.run(
        [sys.executable, "-c", _STORM_CHILD],
        input=pickle.dumps((table.content_digest(), a, kw)),
        capture_output=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    return pickle.loads(out.stdout)


_TWIN = ("TestScheduleGeneration::", "TestExpositionCheck::",
         "TestMinimization::test_replay_schema_validation")
_PORT = ("TestTenantIsolation::test_adversarial_tenant_drill_c8",
         "TestTenantIsolation::test_replay_round_trips_tenant_quota_knobs",
         "TestGracefulDrain::", "TestDBVersionIdentity::")
_NOT_RUN = ("TestAcceptance::",
            "TestTenantIsolation::test_generated_adversarial_schedule_",
            "TestTenantIsolation::test_quota_failpoint_sheds_well_formed",
            "TestReplayDeterminism::",
            "TestMinimization::test_planted_failure_minimizes_and_replays")
_TWIN_SUBS = [
    ("from twin_trivy.resilience import FAILPOINTS, GUARD\n", ""),
    ("from twin_trivy.resilience.failpoints import known_site",
     "from trivy_tpu.resilience.failpoints import known_site"),
    ("from twin_trivy.metrics import METRICS",
     "from trivy_tpu_torch.metrics import METRICS")]
_PORT_SUBS = [
    ("from trivy_tpu_torch.resilience import FAILPOINTS, GUARD\n", ""),
    ("run_storm(", "run_storm_cpu("),
    ('FAILPOINTS.set("rpc.scan", "slow", 400.0)', "slow_scans(state, 0.4)"),
    ('FAILPOINTS.configure("")\n            httpd.shutdown()',
     "httpd.shutdown()"),
    ('cache_backend="memory")', 'cache_backend="memory", device="cpu")'),
    ('cache_dir="", cache_backend=shared)',
     'cache_dir="", cache_backend=shared, device="cpu")')]
_PORT_ENV = {"run_storm_cpu": _run_storm_cpu, "slow_scans": slow_scans}


def test_every_reference_case_is_accounted_for():
    ids = {c.id for c in port_cases(
        "test_storm.py", keep=lambda c: not c.startswith("TestWideSweep::"),
        subs=_PORT_SUBS, env=_PORT_ENV)}
    twin = {i for i in ids if i.startswith(_TWIN)}
    alone = {i for i in ids if i.startswith(_PORT)}
    not_run = {i for i in ids if i.startswith(_NOT_RUN)}
    assert twin | alone | not_run == ids
    assert len(ids) == 32
    assert len(twin) == 13 and len(alone) == 9 and len(not_run) == 10


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_storm.py", keep=lambda c: c.startswith(_TWIN), subs=_TWIN_SUBS,
    env={"json": _TwinJson}))
def test_storm_case_like_reference(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_storm.py", keep=lambda c: c.startswith(_PORT), subs=_PORT_SUBS,
    env=_PORT_ENV))
def test_storm_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


# ---- the schedule grammar and the workload against the JAX package --------

_KNOBS = [{},
          {"n_events": 6, "watchdog_ms": 50.0, "mesh_hosts": 2},
          {"n_events": 9, "horizon_ms": 900.0, "mesh_devices": 8,
           "replicas": 2, "watchdog_ms": 80.0, "mesh_hosts": 3}]


@pytest.mark.parametrize("topology", storm.TOPOLOGIES)
def test_generate_schedule_equals_reference(topology):
    """One seed names one timeline in both packages, failpoint events
    included: seeds 0–39 under three sets of knobs."""
    for seed in range(40):
        for knobs in _KNOBS:
            port = storm.generate_schedule(seed, topology, **knobs)
            ref = ref_storm.generate_schedule(seed, topology, **knobs)
            assert json.dumps(port.to_json(), sort_keys=True) == \
                json.dumps(ref.to_json(), sort_keys=True), (seed, knobs)
            assert [e.label() for e in port.events] == \
                [e.label() for e in ref.events]


def _archive_members(path: str) -> dict:
    with tarfile.open(path) as tf:
        return {m.name: tf.extractfile(m).read() for m in tf.getmembers()
                if m.isfile()}


def test_workload_equals_reference(tmp_path):
    """The seeded workload: both tables (columns and content digest),
    the request and SBOM documents, and the ingest archives' members."""
    for port_t, ref_t in ((storm.storm_table(), ref_storm.storm_table()),
                          (storm.storm_table(n_pkgs=96, seed=9),
                           ref_storm.storm_table(n_pkgs=96, seed=9)),
                          (storm.alt_storm_table(),
                           ref_storm.alt_storm_table())):
        assert port_t.content_digest() == ref_t.content_digest()
        for col in ("hash", "lo_tok", "hi_tok", "flags", "group"):
            np.testing.assert_array_equal(getattr(port_t, col),
                                          getattr(ref_t, col))
    for load_seed in (0, 7, 2261):
        for idx in range(6):
            doc = storm.request_doc(load_seed, idx)
            assert doc == ref_storm.request_doc(load_seed, idx)
            assert storm.request_sbom_doc(load_seed, idx) == \
                ref_storm.request_sbom_doc(load_seed, idx)
            for variant in ("clean",) + storm.HOSTILE_VARIANTS:
                assert storm.build_sbom_document(load_seed, idx, variant) \
                    == ref_storm.build_sbom_document(load_seed, idx,
                                                     variant)
            for variant in ("clean", "truncated"):
                a, b = (str(tmp_path / f"{w}-{idx}.tar")
                        for w in ("port", "ref"))
                storm.build_ingest_archive(a, doc, variant)
                ref_storm.build_ingest_archive(b, doc, variant)
                assert _archive_members(a) == _archive_members(b)
    assert storm.canonical_digest({"b": [1, 2], "a": "x"}) == \
        ref_storm.canonical_digest({"b": [1, 2], "a": "x"})
    opts, ref_opts = storm.StormOptions(tenants=3), \
        ref_storm.StormOptions(tenants=3)
    assert [storm.tenant_for(opts, i) for i in range(7)] == \
        [ref_storm.tenant_for(ref_opts, i) for i in range(7)]


_ORACLE_RUNS = {
    "single": [storm.StormEvent(at_ms=100.0, kind="swap_table")],
    "fleet": [storm.StormEvent(at_ms=60.0, kind="kill_replica", replica=0,
                               dur_ms=200.0)],
    "ingest": [storm.StormEvent(at_ms=100.0, kind="hostile_layer",
                                variant="truncated", dur_ms=200.0)],
    "mesh": [storm.StormEvent(at_ms=100.0, kind="swap_table")],
}


@pytest.mark.parametrize("topology", sorted(_ORACLE_RUNS))
def test_oracle_equals_reference(topology, table):
    """The same schedule, load seed and table through both packages'
    storms: the unfaulted oracle pass (every request's response digest)
    is equal, request by request."""
    events = _ORACLE_RUNS[topology]

    def sched(mod):
        return mod.Schedule(seed=31, topology=topology, horizon_ms=600.0,
                            events=[mod.StormEvent(**vars(e))
                                    for e in events])
    # a 1 s walk deadline: a loaded host must not turn one side's walk
    # into a timed-out partial
    kw = {"requests": 6, "concurrency": 2, "replicas": 2,
          "watchdog_ms": 250.0}
    port = storm.run_storm(sched(storm), storm.StormOptions(**kw),
                           table=table, device="cpu")
    ref = ref_storm.run_storm(sched(ref_storm),
                              ref_storm.StormOptions(**kw),
                              table=ref_storm.storm_table())
    assert len(port.oracle) == 6
    assert port.oracle == ref.oracle
    assert port.ok, port.violations


# ---- the port's own drills --------------------------------------------------

def test_fleet_drill_kill_db_swap_flood(table):
    """Three replicas behind the router at c=4: replica 0 killed and
    restarted on its port, a tenant flood, a rolling DB upgrade; every
    invariant passes, the flood ran in full and every victim completed."""
    sched = storm.Schedule(seed=41, topology="fleet", horizon_ms=1000.0,
                           events=[
        storm.StormEvent(at_ms=50.0, kind="kill_replica", replica=0,
                         dur_ms=300.0),
        storm.StormEvent(at_ms=100.0, kind="adversarial_tenant", arg=8.0),
        storm.StormEvent(at_ms=200.0, kind="db_swap")])
    rep = storm.run_storm(sched, storm.StormOptions(
        requests=12, concurrency=4, replicas=3, tenants=3), table=table,
        device="cpu")
    assert rep.ok, rep.violations
    assert all(o is not None for o in rep.outcomes)
    assert len(rep.flood_outcomes) == 8
    assert all(o.status in ("ok", "shed") for o in rep.flood_outcomes)
    assert rep.summary()["events"] == [e.label() for e in sched.events]


def test_ingest_drill_both_hostile_variants(table):
    """The ingest pipeline and the sbom lane under a truncated and a
    bomb window: every invariant passes (no 5xx, no lost request, each
    hostile request an annotated partial, the ingest breakers closed).
    Which requests land in a window is wall-clock coupled: one re-run is
    allowed for THAT side-assert, and the invariants hold on each."""
    sched = storm.Schedule(seed=43, topology="ingest", horizon_ms=1200.0,
                           events=[
        storm.StormEvent(at_ms=0.0, kind="hostile_layer",
                         variant="truncated", dur_ms=500.0),
        storm.StormEvent(at_ms=500.0, kind="hostile_layer", variant="bomb",
                         dur_ms=0.0)])
    for _attempt in range(2):
        rep = storm.run_storm(sched, storm.StormOptions(
            requests=8, concurrency=2, watchdog_ms=250.0), table=table,
            device="cpu")
        assert rep.ok, rep.violations
        seen = {v for o in rep.outcomes for v in storm.HOSTILE_VARIANTS
                if f"variant={v}" in o.detail}
        if seen == set(storm.HOSTILE_VARIANTS):
            break
    else:
        raise AssertionError(f"hostile variants seen: {seen}")
    assert all(o.partial for o in rep.outcomes if "variant=" in o.detail
               and o.status == "ok")


def test_minimize_planted_invariant_to_one_event_and_replay(table,
                                                           tmp_path):
    """A failure planted by an invariant the test registers (any
    swap_table event violates it), buried among two floods: minimization
    cuts the schedule to the one swap, the replay artifact validates
    under obs.check, and replaying it fails the same way. The invariant
    is removed after."""
    from trivy_tpu_torch.obs.check import check_file

    @storm.invariant("planted_swap")
    def _planted(ctx):
        return [f"planted: {e.label()}" for e in ctx.schedule.events
                if e.kind == "swap_table"]
    try:
        sched = storm.Schedule(seed=47, topology="single", horizon_ms=500.0,
                               events=[
            storm.StormEvent(at_ms=40.0, kind="adversarial_tenant", arg=3.0),
            storm.StormEvent(at_ms=120.0, kind="swap_table"),
            storm.StormEvent(at_ms=300.0, kind="adversarial_tenant",
                             arg=3.0)])
        opts = storm.StormOptions(requests=6, concurrency=2,
                                  artifact_dir=str(tmp_path))
        rep = storm.run_storm(sched, opts, table=table, device="cpu")
        assert set(rep.violations) == {"planted_swap"}
        minimal, min_rep, trials = storm.minimize_schedule(
            sched, opts, table=table, oracle=rep.oracle, device="cpu")
        assert [e.kind for e in minimal.events] == ["swap_table"]
        assert set(min_rep.violations) == {"planted_swap"}
        assert trials >= 3
        path = str(tmp_path / "replay.json")
        storm.write_replay(path, minimal, opts, min_rep, minimized=True)
        assert check_file(path) == []
        sched2, opts2 = storm.load_replay(path)
        assert sched2 == minimal
        rep2 = storm.run_storm(sched2, opts2, table=table, device="cpu")
        assert rep2.violations == min_rep.violations
    finally:
        storm.INVARIANTS.pop("planted_swap", None)
    assert "planted_swap" not in storm.INVARIANTS


# ---- what the port refuses --------------------------------------------------

_REFUSED = [storm.StormEvent(at_ms=20.0, site="detect.dispatch", mode="hang",
                             arg=150.0, dur_ms=300.0),
            storm.StormEvent(at_ms=50.0, kind="swap_table"),
            storm.StormEvent(at_ms=60.0, kind="host_loss", mode="hang",
                             arg=150.0, dur_ms=0.0, host=1)]


def _storm_cli(args: list, cwd: str):
    return subprocess.run(
        [sys.executable, "-m", "trivy_tpu_torch.resilience.storm", *args],
        cwd=cwd, env={**os.environ, "PYTHONPATH": REPO,
                      "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("how", ["run_storm", "replay", "cli", "cli_replay"])
def test_refused_events_are_named_before_any_topology(how, tmp_path):
    """A failpoint or host_loss event: StormRefused names each by its
    label, with the reason, before any server starts (no thread, no
    summary); the CLI exits 2 on the first refused round."""
    sched = storm.Schedule(seed=5, topology="mesh", horizon_ms=800.0,
                           events=list(_REFUSED))
    labels = [_REFUSED[0].label(), _REFUSED[2].label()]
    path = str(tmp_path / "replay.json")
    storm.write_replay(path, sched, storm.StormOptions(),
                       storm.StormReport(sched, [], {}, {}), minimized=False)
    if how.startswith("cli"):
        args = (["--replay", path] if how == "cli_replay" else
                ["--seed", "1", "--topology", "single"])
        out = _storm_cli([*args, "--device", "cpu"], str(tmp_path))
        assert out.returncode == 2, out.stderr[-2000:]
        assert out.stdout == ""
        assert "cannot run" in out.stderr
        if how == "cli":
            want = storm.refused_events(storm.generate_schedule(1, "single"))
            assert want and all(label in out.stderr for label, _ in want)
        else:
            assert all(label in out.stderr for label in labels)
        return
    if how == "replay":
        sched, _opts = storm.load_replay(path)
    threads = {t.ident for t in threading.enumerate()}
    with pytest.raises(storm.StormRefused) as e:
        storm.run_storm(sched, storm.StormOptions(requests=2), device="cpu")
    assert [label for label, _ in e.value.refused] == labels
    assert "no failpoints" in e.value.refused[0][1]
    assert "meshguard" in e.value.refused[1][1]
    assert all(label in str(e.value) for label in labels)
    assert not {t.ident for t in threading.enumerate()} - threads


def test_cli_runs_a_schedule_it_can(tmp_path):
    """`python -m trivy_tpu_torch.resilience.storm --device cpu` on a
    seed whose sampled schedule holds no refused event (fleet, seed 0: a
    flood, a table swap and a rolling upgrade): one summary line, ok,
    exit 0; --virtual-devices is accepted and changes nothing."""
    out = _storm_cli(["--seed", "0", "--topology", "fleet", "--requests",
                      "6", "--concurrency", "2", "--device", "cpu",
                      "--virtual-devices", "8"], str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True and summary["violations"] == {}
    assert summary["events"] == [
        e.label() for e in storm.generate_schedule(0, "fleet").events]
    assert "--virtual-devices" in _storm_cli(["--help"], str(tmp_path)).stdout


def test_run_storm_raises_without_gpu(monkeypatch, table):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = {t.ident for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storm.run_storm(storm.Schedule(seed=1, topology="single",
                                       horizon_ms=100.0), table=table)
    assert not {t.ident for t in threading.enumerate()} - threads


# ---- the chip script's storm phase ------------------------------------------

def test_chip_storm_phase_at_a_small_size_on_cpu():
    """chip_smoke's `storm` phase on the CPU over a 64-package table: the
    refusal, then the fleet, ingest and mesh runs with every invariant
    passing, no launch on the CPU, the mesh's dispatches at its ledger
    site, the fleet's recorded dispatches on the table; and the ingest
    rows the phase holds against shift-or."""
    import chip_smoke as cs
    small = storm.storm_table(n_pkgs=64)
    fig = cs.storm_phase(small, device="cpu", requests=8)
    assert [label for label, _ in fig["refusal"]["refused"]] == \
        ["detect.dispatch=error@50+200ms"]
    for name in ("fleet", "ingest", "mesh"):
        run = fig[name]
        assert run["summary"]["ok"]
        assert set(run["invariants"].values()) == {"pass"}
        assert sum(run["launches"].values()) == 0
    assert fig["mesh"]["mesh_dispatches"] > 0
    assert fig["fleet"]["records"]
    assert fig["fleet"]["flood"]["requests"] == 12
    sched, opts = cs.storm_runs()["ingest"]
    padded, bank, rows = cs.storm_secret_rows(opts, sched.seed)
    assert rows > 0 and padded.shape[0] >= rows
    from trivy_tpu_torch.secret import BUILTIN_RULES
    assert set(bank.kw_bytes) == {
        k.lower().encode() for r in BUILTIN_RULES
        if r.id in ("github-pat", "aws-access-key-id") for k in r.keywords}
