"""graftstorm: seeded chaos schedules against the port's own servers,
the invariant engine over what they answered, and failing-schedule
minimization with replayable artifacts (the port's copy of the JAX
package's `resilience/storm.py`).

  schedules    a seeded generator samples a timeline of events from ONE
               integer seed; the same (seed, topology, knobs) gives a
               JSON-identical schedule, equal to the JAX package's, its
               failpoint events included (the menus below are data).
  harness      a runner stands up a real in-process topology of port
               servers (single, mesh, fleet behind the router, or the
               ingest pipeline in front of a server) on the card, or on
               the CPU when asked, runs an unfaulted ORACLE pass, then
               drives a seeded concurrent scan load over HTTP while a
               thread of its own executes the schedule against the live
               servers: replica kills and restarts on the same port,
               table swaps, rolling DB upgrades, hostile layers and
               tenant floods.
  invariants   probes evaluated after the run: no request lost (every
               one completed or shed with a well-formed 429/503/504),
               completed results bit-identical to the oracle their
               X-Trivy-DB-Version names, every breaker the port has
               closed again, no surviving non-daemon thread, strict
               /metrics with shed-aware accounting, an incident file
               for each breaker opening, tenant isolation under a
               flood, and cost conservation against the graftprof
               ledger.
  minimization a failing schedule is delta-debugged (drop events, then
               halve windows) to a minimal one, written with its
               captured incident as a replay artifact (`--replay FILE`
               re-runs it; `python -m trivy_tpu_torch.obs.check`
               validates it).

What the port refuses: it has no failpoints and no meshguard (ROADMAP
A, not ported by the north star). A schedule holding a `failpoint` or a
`host_loss` event raises StormRefused naming each such event before any
topology starts; nothing pretends to inject the fault, and no event is
pruned. Every other kind runs. A kernel fault in a replica is a lost
request the invariants report: there is no host join to fall back on.

CLI:  python -m trivy_tpu_torch.resilience.storm \\
          --seed N --rounds K --topology {single,mesh,fleet,ingest} \\
          [--device cpu]
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import tempfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import asdict, dataclass, field, replace

from ..log import get as _get_logger
from ..metrics import METRICS
from ..server import DB_VERSION_HEADER, TENANT_HEADER

_log = _get_logger("resilience.storm")

TOPOLOGIES = ("single", "mesh", "fleet", "ingest")
REPLAY_SCHEMA = "trivy-tpu-storm-replay/1"

# the fault menus per topology, as the JAX package samples them: the
# generator draws from these so that one seed names one timeline in both
# packages. Every entry is a failpoint site, which the port refuses
# (StormRefused); the draws still consume the same random numbers
_SINGLE_FAULTS = (
    ("detect.dispatch", "error"), ("detect.dispatch", "hang"),
    ("detect.dispatch", "slow"), ("detect.dispatch", "flaky"),
    ("detect.device_get", "error"), ("detect.device_get", "flaky"),
    ("detect.compile", "error"), ("rpc.scan", "slow"),
    ("detect.query_upload", "error"), ("detect.query_upload", "hang"),
    ("detect.query_upload", "flaky"),
    ("stream.prefetch", "error"), ("stream.prefetch", "flaky"),
)
_MESH_FAULTS = (
    ("detect.mesh", "error"), ("detect.mesh", "hang"),
    ("detect.mesh", "flaky"),
)
_FLEET_FAULTS = (
    ("rpc.route", "error"), ("rpc.route", "flaky"),
    ("rpc.route", "slow"), ("rpc.scan", "error"),
    ("rpc.scan", "flaky"),
)
_MEMO_FAULTS = (
    ("memo.get", "error"), ("memo.get", "flaky"),
    ("memo.put", "error"), ("memo.put", "flaky"),
)
_INGEST_FAULTS = (
    ("fanal.walk", "error"), ("fanal.walk", "hang"),
    ("fanal.walk", "flaky"),
    ("fanal.analyze", "error"), ("fanal.analyze", "hang"),
    ("fanal.analyze", "flaky"),
    ("secret.prefilter", "error"), ("secret.prefilter", "hang"),
    ("secret.prefilter", "flaky"),
    ("sbom.parse", "error"), ("sbom.parse", "hang"),
    ("sbom.parse", "flaky"),
)
HOSTILE_VARIANTS = ("truncated", "bomb")

# the event kinds the port cannot run, and why
REFUSED_KINDS = {
    "failpoint": "the port has no failpoints (not ported by the north "
                 "star)",
    "host_loss": "a host loss hangs every mesh slot of one host through "
                 "meshguard's failpoints; the port has neither meshguard "
                 "nor failpoints (not ported by the north star)",
}


class StormRefused(ValueError):
    """A schedule holds events the port cannot run: each is named by its
    label, with the reason. Raised before any topology starts."""

    def __init__(self, refused: list[tuple[str, str]]):
        self.refused = refused
        lines = "; ".join(f"{label}: {why}" for label, why in refused)
        super().__init__(f"storm: {len(refused)} event(s) the port "
                         f"cannot run: {lines}")


# ---------------------------------------------------------------------------
# schedule grammar


@dataclass
class StormEvent:
    """One timeline entry. `at_ms` is the offset from load start;
    `dur_ms` bounds the window (0 = until the schedule ends).

    kinds the port runs:
      kill_replica  shut replica `replica` down at at_ms, restart it on
                    the same port at at_ms+dur_ms (fleet only).
      swap_table    a DB hot swap through the generation drain on
                    replica `replica` (0 outside fleet), to the same
                    table content: the drill is the drain.
      db_swap       a rolling advisory-DB upgrade: every server state
                    hot-swaps to the alternate table (another content
                    digest) in slot order while load flows; redetectd
                    sweeps the shared memo, each response must match the
                    oracle its X-Trivy-DB-Version names, and the
                    router's skew counter must go quiet once the roll
                    converges.
      hostile_layer (ingest only) scans issued in the window use the
                    `variant` hostile artifact (a truncated gzip layer
                    or a decompression bomb; for the sbom lane a
                    truncated or component-bomb document).
      adversarial_tenant
                    one hostile tenant ("storm-adv") bursts `arg` extra
                    requests at at_ms while the paced victim load flows,
                    under per-tenant admission quotas.
    kinds the port refuses (StormRefused): `failpoint` (arm
    `site=mode(arg[,seed])`) and `host_loss` (every `detect.mesh:<slot>`
    of synthetic host `host` hangs).
    """
    at_ms: float
    kind: str = "failpoint"
    site: str = ""
    mode: str = ""
    arg: float = 0.0
    seed: int = 0
    dur_ms: float = 0.0
    replica: int = 0
    variant: str = ""
    host: int = 0

    def label(self) -> str:
        if self.kind == "failpoint":
            arg = "" if self.mode == "error" else f":{self.arg:g}"
            return (f"{self.site}={self.mode}{arg}"
                    f"@{self.at_ms:g}+{self.dur_ms:g}ms")
        if self.kind == "hostile_layer":
            return (f"hostile_layer({self.variant})"
                    f"@{self.at_ms:g}+{self.dur_ms:g}ms")
        if self.kind == "host_loss":
            return (f"host_loss(host={self.host})"
                    f"@{self.at_ms:g}+{self.dur_ms:g}ms")
        if self.kind == "adversarial_tenant":
            return (f"adversarial_tenant(n={self.arg:g})"
                    f"@{self.at_ms:g}ms")
        return f"{self.kind}[{self.replica}]@{self.at_ms:g}ms"


@dataclass
class Schedule:
    seed: int
    topology: str
    horizon_ms: float
    events: list[StormEvent] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"seed": self.seed, "topology": self.topology,
                "horizon_ms": self.horizon_ms,
                "events": [asdict(e) for e in self.events]}

    @classmethod
    def from_json(cls, doc: dict) -> "Schedule":
        return cls(int(doc["seed"]), str(doc["topology"]),
                   float(doc["horizon_ms"]),
                   [StormEvent(**e) for e in doc.get("events", [])])


def refused_events(schedule: Schedule) -> list[tuple[str, str]]:
    """→ [(label, reason)] of the schedule's events the port refuses."""
    return [(ev.label(), REFUSED_KINDS[ev.kind])
            for ev in schedule.events if ev.kind in REFUSED_KINDS]


def generate_schedule(seed: int, topology: str, n_events: int = 4,
                      horizon_ms: float = 1500.0, mesh_devices: int = 4,
                      replicas: int = 3,
                      watchdog_ms: float = 50.0,
                      mesh_hosts: int = 2) -> Schedule:
    """Sample one fault timeline from `seed`. Deterministic: the same
    (seed, topology, knobs) always yields a JSON-identical schedule, the
    JAX package's too. Windows overlap by construction (starts land in
    the first 60% of the horizon, durations span 25–60% of it)."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r} "
                         f"(known: {', '.join(TOPOLOGIES)})")
    rng = random.Random(seed)
    menu: list[tuple[str, str]] = list(_SINGLE_FAULTS)
    kinds = ["failpoint"] * 3 + ["swap_table"]
    if topology == "mesh":
        menu += list(_MESH_FAULTS) * 2
        kinds += ["host_loss"]
    if topology == "fleet":
        menu += list(_FLEET_FAULTS) + list(_MEMO_FAULTS)
        kinds += ["kill_replica"] * 2 + ["db_swap"]
    if topology == "ingest":
        menu = list(_INGEST_FAULTS) * 2 + [("rpc.scan", "slow")]
        kinds = ["failpoint"] * 3 + ["hostile_layer"] * 2 + \
            ["swap_table"]
    # at most one adversarial-tenant flood per schedule, on every
    # topology
    kinds = kinds + ["adversarial_tenant"]
    events: list[StormEvent] = []
    used_sites: set[str] = set()
    for _ in range(max(int(n_events), 1)):
        at = rng.uniform(0.0, horizon_ms * 0.6)
        dur = rng.uniform(horizon_ms * 0.25, horizon_ms * 0.6)
        kind = rng.choice(kinds)
        if kind == "adversarial_tenant":
            if any(e.kind == "adversarial_tenant" for e in events):
                continue
            # an ingest request is a full client-side walk, so its
            # bursts stay small
            lo, hi = (4, 8) if topology == "ingest" else (8, 16)
            events.append(StormEvent(
                at_ms=round(at, 1), kind="adversarial_tenant",
                arg=float(rng.randrange(lo, hi + 1))))
            continue
        if kind == "hostile_layer":
            events.append(StormEvent(
                at_ms=round(at, 1), kind="hostile_layer",
                dur_ms=round(dur, 1),
                variant=HOSTILE_VARIANTS[
                    rng.randrange(len(HOSTILE_VARIANTS))]))
            continue
        if kind == "host_loss":
            events.append(StormEvent(
                at_ms=round(at, 1), kind="host_loss", mode="hang",
                arg=round(rng.uniform(watchdog_ms * 2.2,
                                      watchdog_ms * 4.0), 1),
                dur_ms=round(dur, 1),
                host=rng.randrange(max(mesh_hosts, 1))))
            continue
        if kind == "kill_replica":
            events.append(StormEvent(
                at_ms=round(at, 1), kind="kill_replica",
                dur_ms=round(dur, 1),
                replica=rng.randrange(max(replicas, 1))))
            continue
        if kind == "swap_table":
            events.append(StormEvent(
                at_ms=round(at, 1), kind="swap_table",
                replica=rng.randrange(max(replicas, 1))
                if topology == "fleet" else 0))
            continue
        if kind == "db_swap":
            events.append(StormEvent(at_ms=round(at, 1),
                                     kind="db_swap"))
            continue
        # one spec per site at a time, as the reference samples them
        for _attempt in range(8):
            site, mode = menu[rng.randrange(len(menu))]
            if site == "detect.mesh":
                site = f"detect.mesh:{rng.randrange(max(mesh_devices, 1))}"
            if site not in used_sites:
                break
        if site in used_sites:
            continue
        used_sites.add(site)
        arg, spec_seed = 0.0, 0
        if mode == "hang":
            mult = (8.0, 12.0) if site.startswith("fanal.") \
                or site == "sbom.parse" else (2.2, 4.0)
            arg = round(rng.uniform(watchdog_ms * mult[0],
                                    watchdog_ms * mult[1]), 1)
        elif mode == "slow":
            arg = round(rng.uniform(5.0, 25.0), 1)
        elif mode == "flaky":
            arg = round(rng.uniform(0.1, 0.4), 3)
            spec_seed = rng.randrange(1 << 16)
        events.append(StormEvent(
            at_ms=round(at, 1), site=site, mode=mode, arg=arg,
            seed=spec_seed, dur_ms=round(dur, 1)))
    events.sort(key=lambda e: (e.at_ms, e.kind, e.site, e.replica))
    return Schedule(seed, topology, horizon_ms, events)


# ---------------------------------------------------------------------------
# seeded workload: a self-contained advisory table + scan request docs


def storm_table(n_pkgs: int = 16, seed: int = 604):
    """A deterministic AdvisoryTable that needs no fixture files: every
    package gets 1–3 alpine-style advisories with seeded fixed-version
    bounds. The first k packages are the same for every n_pkgs ≥ k."""
    from ..db.table import RawAdvisory, build_table
    rng = random.Random(seed)
    raw, details = [], {}
    for i in range(n_pkgs):
        name = f"storm-pkg-{i}"
        for j in range(rng.randrange(1, 4)):
            vid = f"CVE-2026-{i:03d}{j}"
            raw.append(RawAdvisory(
                source="alpine 3.17", ecosystem="alpine",
                pkg_name=name, vuln_id=vid,
                fixed_version=f"{1 + j}.{rng.randrange(10)}.0-r0",
                severity=rng.choice(("LOW", "MEDIUM", "HIGH"))))
            details[vid] = {"Title": f"storm planted bug {vid}",
                            "Severity": "HIGH"}
    return build_table(raw, details)


def alt_storm_table():
    """The db_swap event's upgrade target: the same package namespace,
    other seeded bounds, so another content digest whose results differ
    from storm_table()'s."""
    return storm_table(seed=605)


def request_doc(load_seed: int, idx: int, n_pkgs: int = 16) -> dict:
    """The idx-th scan request of a seeded load: a blob document whose
    DiffID doubles as the artifact id (PutBlob and Scan key to the same
    ring owner)."""
    rng = random.Random((load_seed << 20) ^ idx)
    diff = "sha256:" + hashlib.sha256(
        f"storm|{load_seed}|{idx}".encode()).hexdigest()
    pkgs = []
    for _ in range(rng.randrange(1, 7)):
        k = rng.randrange(n_pkgs)
        ver = f"{rng.randrange(1, 4)}.{rng.randrange(10)}.0-r0"
        pkgs.append({"Name": f"storm-pkg-{k}", "Version": ver,
                     "SrcName": f"storm-pkg-{k}", "SrcVersion": ver})
    return {
        "SchemaVersion": 2, "DiffID": diff,
        "OS": {"Family": "alpine", "Name": "3.17.3"},
        "PackageInfos": [{"FilePath": "lib/apk/db/installed",
                          "Packages": pkgs}],
    }


def request_sbom_doc(load_seed: int, idx: int,
                     n_pkgs: int = 16) -> bytes:
    """The idx-th request's inventory as a CycloneDX document (the sbom
    lane of the ingest drill): the same seeded packages request_doc()
    puts in a blob, written as encode_cyclonedx writes alpine packages,
    so both lanes detect against the same advisories."""
    blob = request_doc(load_seed, idx, n_pkgs)
    comps = []
    for p in blob["PackageInfos"][0]["Packages"]:
        purl = (f"pkg:apk/alpine/{p['Name']}@{p['Version']}"
                f"?distro=3.17.3")
        comps.append({
            "type": "library",
            "bom-ref": purl,
            "name": p["Name"], "version": p["Version"],
            "purl": purl,
            "properties": [
                {"name": "aquasecurity:trivy:PkgType",
                 "value": "alpine"},
                {"name": "aquasecurity:trivy:SrcName",
                 "value": p["SrcName"]},
                {"name": "aquasecurity:trivy:SrcVersion",
                 "value": p["SrcVersion"]},
            ],
        })
    doc = {
        "bomFormat": "CycloneDX", "specVersion": "1.5",
        "serialNumber": f"urn:uuid:storm-sbom-{load_seed}-{idx}",
        "version": 1,
        "metadata": {"component": {
            "type": "operating-system", "name": "alpine",
            "version": "3.17.3",
            "properties": [{"name": "aquasecurity:trivy:Type",
                            "value": "alpine"}]}},
        "components": comps,
    }
    return json.dumps(doc, sort_keys=True).encode()


def build_sbom_document(load_seed: int, idx: int, variant: str,
                        max_components: int = 64) -> bytes:
    """clean | truncated (JSON cut mid-token: a `malformed` annotation)
    | bomb (components past the drill's budget: a clamped prefix decode
    and `budget.components`)."""
    raw = request_sbom_doc(load_seed, idx)
    if variant == "clean":
        return raw
    if variant == "truncated":
        return raw[:48]
    doc = json.loads(raw)
    base = doc["components"]
    flood = []
    k = 0
    while len(flood) <= max_components * 8:
        for c in base:
            c2 = dict(c)
            c2["bom-ref"] = f"{c['bom-ref']}#{k}"
            k += 1
            flood.append(c2)
    doc["components"] = flood
    return json.dumps(doc, sort_keys=True).encode()


# ---------------------------------------------------------------------------
# options, outcomes, report


@dataclass
class StormOptions:
    """Runner knobs (CLI flags of the same names). The port has no
    dispatch watchdog: `watchdog_ms` scales the ingest budgets and the
    schedule generator's hang arguments, `breaker_reset_ms` the replica
    and ingest breakers' reset windows."""
    requests: int = 24
    concurrency: int = 8
    load_seed: int = 0          # 0 = derived from the schedule seed
    replicas: int = 3           # fleet width
    mesh_devices: int = 4
    mesh_db_shards: int = 2
    mesh_hosts: int = 2         # synthetic hosts (refused host_loss only)
    watchdog_ms: float = 50.0
    breaker_reset_ms: float = 150.0
    admit_max_active: int = 0   # 0 = unbounded (no admission sheds)
    admit_max_queue: int = 8
    # per-tenant quotas (0/0.0 = off). With an adversarial_tenant event
    # and none of these set, run_storm derives victim-safe defaults:
    # tenant_max_active = concurrency (a victim worker holds at most one
    # request in flight, so victims never trip their own cap) and a
    # small tenant_max_queue the burst overflows as 429s
    admit_tenant_max_active: int = 0
    admit_tenant_max_queue: int = 0
    admit_tenant_rate: float = 0.0
    settle_s: float = 8.0       # post-schedule liveness window
    request_timeout_s: float = 30.0
    artifact_dir: str = ""      # incident/replay dir ("" = tmpdir)
    # distinct tenants the load round-robins through (request idx %
    # tenants); 1 = untenanted. Replay artifacts record the mix
    tenants: int = 1


@dataclass
class Outcome:
    idx: int
    status: str          # "ok" | "shed" | "lost"
    code: int = 0
    digest: str = ""
    latency_ms: float = 0.0
    detail: str = ""
    well_formed: bool = True
    # the response carried ingest degradation annotations (a
    # deterministic partial): left out of the bit-identity probe, held
    # to the annotation contract instead
    partial: bool = False
    # the X-Trivy-DB-Version the answering server stamped: under a
    # db_swap schedule the digest must match the oracle it names
    db_version: str = ""

    def key(self) -> tuple:
        return (self.idx, self.status, self.code, self.digest)


@dataclass
class StormReport:
    schedule: Schedule
    outcomes: list[Outcome]
    oracle: dict[int, str]
    violations: dict[str, list[str]]
    incident_dir: str = ""
    duration_s: float = 0.0
    # adversarial_tenant schedules: the flood's own outcomes, kept apart
    # from the victim load's
    flood_outcomes: list[Outcome] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def sheds(self) -> int:
        return sum(1 for o in self.outcomes if o.status == "shed")

    def p99_ms(self) -> float:
        lats = sorted(o.latency_ms for o in self.outcomes
                      if o.status == "ok")
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(len(lats) * 0.99))]

    def summary(self) -> dict:
        out = {
            "seed": self.schedule.seed,
            "topology": self.schedule.topology,
            "events": [e.label() for e in self.schedule.events],
            "requests": len(self.outcomes),
            "ok": self.ok,
            "sheds": self.sheds(),
            "p99_ms": round(self.p99_ms(), 2),
            "violations": self.violations,
            "duration_s": round(self.duration_s, 2),
        }
        if self.flood_outcomes:
            out["flood"] = {
                "requests": len(self.flood_outcomes),
                "sheds": sum(1 for o in self.flood_outcomes
                             if o.status == "shed")}
        return out


def canonical_digest(doc: dict) -> str:
    return hashlib.sha256(json.dumps(
        doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def tenant_for(opts: StormOptions, idx: int) -> str:
    """The idx-th load request's tenant ("" = no header → "default"): a
    round-robin over `opts.tenants` synthetic tenants, so replays keep
    the same mix."""
    if opts.tenants <= 1:
        return ""
    return f"storm-t{idx % opts.tenants}"


# ---------------------------------------------------------------------------
# topologies


def _post(base: str, route: str, doc: dict, timeout: float,
          headers: dict | None = None):
    """→ (status, headers, parsed JSON body). Raises on transport
    errors; HTTP error statuses are returned, not raised."""
    req = urllib.request.Request(
        base + route, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            parsed = json.loads(body) if body else {}
        except json.JSONDecodeError:
            parsed = {"_raw": body.decode(errors="replace")[:200]}
        return e.code, dict(e.headers), parsed


def mesh_slots(n: int, device) -> tuple:
    """`n` mesh slots on `device`: on the CPU n slots of it, on CUDA the
    cards in turn (repeated slots of one card on a one-card machine, as
    the chip script lays its grids)."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return tuple([torch.device("cpu")] * max(n, 1))
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", i % count) for i in range(max(n, 1)))


class _Topology:
    """The surface the runner drives: a scan URL, schedule events on the
    live servers, their metrics endpoints, and teardown."""

    kind = ""

    def __init__(self, table, opts: StormOptions, device=None,
                 launch_record=None):
        self.table = table
        self.opts = opts
        self.device = device
        # handed to every server, which records a few merged dispatches
        # in it (the chip script holds them against the plain join)
        self.launch_record = launch_record
        # the db_swap event's upgrade target (another content digest);
        # run_storm computes the post-swap oracle against it
        self.table2 = alt_storm_table()
        self.db_swapped = False

    # the base URL scans go to (the router for fleet, the server else)
    url: str = ""
    # run_storm pushes the seeded blob documents (PutBlob) first when
    # True; the ingest topology pushes per request (its blobs come out
    # of the walk)
    push_blobs: bool = True

    def metrics_urls(self) -> list[str]:
        return [self.url]

    def server_states(self) -> list:
        raise NotImplementedError

    def do_request(self, idx: int, doc: dict, timeout: float,
                   tenant: str = "") -> Outcome:
        """Issue the idx-th load request: one Scan RPC over the pushed
        blob (the ingest topology runs the whole client-side walk)."""
        o = _scan_once(self.url, doc, timeout, tenant=tenant)
        o.idx = idx
        return o

    def apply(self, ev: StormEvent) -> None:
        """Start one schedule event against the live topology (run_storm
        has refused the failpoint and host_loss kinds)."""
        if ev.kind == "swap_table":
            self.swap(ev.replica)
        elif ev.kind == "db_swap":
            self.db_swap()
        elif ev.kind == "kill_replica":
            self.kill(ev.replica)
        elif ev.kind == "hostile_layer":
            self.push_hostile(ev.variant)
        # adversarial_tenant: the flood is traffic, which run_storm's
        # load phase sends against the same epoch; nothing to start here

    def revert(self, ev: StormEvent) -> None:
        """End one event's window."""
        if ev.kind == "kill_replica":
            self.restart(ev.replica)
        elif ev.kind == "hostile_layer":
            self.pop_hostile(ev.variant)

    def push_hostile(self, variant: str) -> None:
        pass

    def pop_hostile(self, variant: str) -> None:
        pass

    def swap(self, replica: int) -> None:
        states = self.server_states()
        if states:
            states[replica % len(states)].swap_table(self.table)

    def db_swap(self) -> None:
        """A rolling DB upgrade under load: every live server hot-swaps
        to the alternate table in slot order (each swap starts that
        server's redetectd sweep when a memo is wired)."""
        self.db_swapped = True
        for st in self.server_states():
            st.swap_table(self.table2)

    def kill(self, replica: int) -> None:
        pass

    def restart(self, replica: int) -> None:
        pass

    def settled(self) -> list[str]:
        """→ [] once every breaker the topology has is closed again. A
        lone server has none: no breaker wraps a launch in the port."""
        return []

    def close(self) -> None:
        raise NotImplementedError


def _admission(opts: StormOptions):
    from . import AdmissionOptions
    return AdmissionOptions(
        max_active=opts.admit_max_active,
        max_queue=opts.admit_max_queue,
        tenant_max_active=opts.admit_tenant_max_active,
        tenant_max_queue=opts.admit_tenant_max_queue,
        tenant_rate=opts.admit_tenant_rate)


class SingleTopology(_Topology):
    kind = "single"

    def __init__(self, table, opts: StormOptions, mesh_opts=None,
                 sbom_opts=None, device=None, launch_record=None):
        super().__init__(table, opts, device, launch_record)
        from ..server.listen import serve_background
        self.httpd, self.state = serve_background(
            "127.0.0.1", 0, table, cache_dir="",
            cache_backend="memory", admission=_admission(opts),
            mesh_opts=mesh_opts, sbom_opts=sbom_opts, device=device,
            launch_record=launch_record)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def server_states(self):
        return [self.state]

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.state.close()


class MeshTopology(SingleTopology):
    """One server joining over a dp×db mesh of `mesh_devices` slots on
    the chosen device (mesh_slots). No meshguard: a slot has no fault
    domain of its own, so the reference's slot and host site mapping
    (`resolve_site`, `host_sites`) has nothing to map, and host_loss and
    detect.mesh events are refused; swaps re-shard the new table over
    the same mesh."""

    kind = "mesh"

    def __init__(self, table, opts: StormOptions, device=None,
                 launch_record=None):
        from ..server.listen import MeshOptions
        super().__init__(table, opts, mesh_opts=MeshOptions(
            devices=opts.mesh_devices, db_shards=opts.mesh_db_shards,
            slots=mesh_slots(opts.mesh_devices, device)),
            device=device, launch_record=launch_record)


class FleetTopology(_Topology):
    """The router in front of `replicas` port servers sharing one
    in-process cache and one result memo; a killed replica restarts on
    its port over the table the fleet is rolling toward."""

    kind = "fleet"

    def __init__(self, table, opts: StormOptions, device=None,
                 launch_record=None):
        from ..fanal.cache import MemoryCache
        from ..fleet import (ReplicaOptions, RouterOptions,
                             serve_router_background)
        from ..fleet.memo import MemoryMemo
        from . import RetryPolicy
        super().__init__(table, opts, device, launch_record)
        # rolling db_swap: restarts come back on the table the fleet is
        # CURRENTLY rolling toward, not the boot table
        self.active_table = table
        # one shared cache: a failover Scan finds its blobs wherever it
        # lands (the redis/s3 contract, without a socket in the loop)
        self.shared_cache = MemoryCache()
        # one shared result memo: a layer detected by any replica is a
        # memo hit on all of them, per db_version
        self.shared_memo = MemoryMemo()
        self.replicas: list = []     # slot → (httpd, state, url) | None
        self.ports: list[int] = []
        for _ in range(opts.replicas):
            self.replicas.append(None)
            self.ports.append(0)
        for slot in range(opts.replicas):
            self._start(slot)
        urls = [entry[2] for entry in self.replicas]
        self.router, self.router_state = serve_router_background(
            "127.0.0.1", 0, urls,
            RouterOptions(
                retry=RetryPolicy(attempts=4, base_delay_s=0.01,
                                  max_delay_s=0.05, budget_s=5.0),
                replica=ReplicaOptions(
                    fail_threshold=2,
                    reset_timeout_ms=opts.breaker_reset_ms,
                    probe_interval_ms=50.0,
                    probe_timeout_ms=2000.0)))
        self.url = f"http://127.0.0.1:{self.router.server_address[1]}"

    def _start(self, slot: int) -> None:
        from ..server.listen import serve_background
        httpd, state = serve_background(
            "127.0.0.1", self.ports[slot], self.active_table,
            cache_dir="",
            cache_backend=self.shared_cache,
            memo_backend=self.shared_memo,
            admission=_admission(self.opts), device=self.device,
            launch_record=self.launch_record)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        self.replicas[slot] = (httpd, state, url)
        self.ports[slot] = httpd.server_address[1]

    def server_states(self):
        return [entry[1] for entry in self.replicas
                if entry is not None]

    def metrics_urls(self) -> list[str]:
        return [self.url] + [entry[2] for entry in self.replicas
                             if entry is not None]

    def swap(self, replica: int) -> None:
        entry = self.replicas[replica % len(self.replicas)]
        if entry is not None:
            entry[1].swap_table(self.active_table)

    def db_swap(self) -> None:
        self.db_swapped = True
        self.active_table = self.table2
        for entry in self.replicas:
            if entry is not None:
                entry[1].swap_table(self.table2)

    def kill(self, replica: int) -> None:
        slot = replica % len(self.replicas)
        entry = self.replicas[slot]
        if entry is None:
            return
        httpd, state, _url = entry
        self.replicas[slot] = None
        httpd.shutdown()
        httpd.server_close()
        state.close()

    def restart(self, replica: int) -> None:
        slot = replica % len(self.replicas)
        if self.replicas[slot] is None:
            self._start(slot)

    def settled(self) -> list[str]:
        problems = super().settled()
        sup = self.router_state.supervisor
        lost = sup.lost()
        if lost:
            problems.append(f"replicas still lost: {lost}")
        for url, st in sup.status()["replicas"].items():
            if st["state"] != "closed":
                problems.append(f"replica {url} breaker {st['state']}")
        return problems

    def close(self) -> None:
        self.router.shutdown()
        self.router.server_close()
        self.router_state.close()
        for slot in range(len(self.replicas)):
            self.kill(slot)


class IngestTopology(SingleTopology):
    """The ingest containment drill: even-indexed load requests run the
    FULL client-side archive flow (ImageArchiveArtifact through the
    supervised pipeline with small budgets, blob push, Scan RPC) against
    one in-process server; odd-indexed requests ride the sbom lane (the
    same seeded inventory as a CycloneDX document through the ScanSBOM
    RPC, decoded by the server under its budgets). `hostile_layer`
    windows swap the archive for a truncated-gzip or decompression-bomb
    variant and the document for a truncated or component-bomb one. The
    contract: zero 5xx, every affected scan a deterministic ANNOTATED
    partial, the ingest breakers closed once the windows end. Every
    request's token file goes through the shift-or kernel (one shared
    scanner, small-batch floor 0)."""

    kind = "ingest"
    push_blobs = False
    sbom_lane = True

    def __init__(self, table, opts: StormOptions, load_seed: int = 0,
                 device=None, launch_record=None):
        from ..sbom.artifact import SBOMOptions
        w = opts.watchdog_ms
        # the bomb document (~8× the component cap) must trip the count
        # budget (the port has no parse watchdog, so no parse deadline)
        self._sbom_cap = 64
        self.sbom_opts = SBOMOptions(
            max_doc_bytes=1 << 20, max_components=self._sbom_cap)
        super().__init__(table, opts, sbom_opts=self.sbom_opts,
                         device=device, launch_record=launch_record)
        from ..fanal.pipeline import IngestOptions
        # budgets sized against the drill fixtures: the bomb variant
        # (zeros expanding ~1000×) trips the ratio guard
        self.ingest_opts = IngestOptions(
            walkers=2, analyzers=2,
            max_file_bytes=1 << 20, max_layer_bytes=1 << 20,
            max_members=5000, layer_deadline_ms=w * 4.0,
            max_inflight_bytes=4 << 20, max_ratio=50.0,
            ratio_floor=64 << 10)
        # ONE shared secret scanner with the small-batch floor at 0:
        # every request's token file goes through the shift-or kernel
        # (per-layer fixture bytes never cross the 2 MiB floor), one
        # bank on the card for every concurrent scan, as in a server
        # process. The bank is cut to the two rules the fixture plants
        from ..secret import BUILTIN_RULES, SecretScanner
        self.secret_scanner = SecretScanner(
            rules=[r for r in BUILTIN_RULES
                   if r.id in ("github-pat", "aws-access-key-id")],
            small_batch_bytes=0, device=device)
        # the kernel's build and first launch, before the oracle pass:
        # the first request would otherwise pay it inside its walk's
        # deadline
        self.secret_scanner._keyword_masks_device([b"warmup " * 8])
        # LIFO of armed hostile windows: overlapping windows must not
        # clobber each other. Mutated only by the thread that runs the
        # schedule; workers read it
        self._hostile_stack: list = []
        self._fixture_dir = tempfile.mkdtemp(prefix="storm-ingest-")
        self._paths: dict = {}
        from ..fanal.fixtures import gz_bytes, sha256_hex, tar_bytes
        # the bomb layer is idx-independent; build its blob once
        bomb_tar = tar_bytes({"filler/zeros.bin": b"\0" * (4 << 20)})
        self._bomb = (gz_bytes(bomb_tar), sha256_hex(bomb_tar))
        for i in range(opts.requests):
            doc = request_doc(load_seed, i)
            for variant in ("clean",) + HOSTILE_VARIANTS:
                p = os.path.join(self._fixture_dir,
                                 f"img-{i}-{variant}.tar")
                build_ingest_archive(p, doc, variant, self._bomb)
                self._paths[(i, variant)] = p
        # the sbom lane's documents (odd request indices): the same
        # seeded inventories as CycloneDX bytes, the hostile windows
        # swapping the DOCUMENT rather than the layer archive
        self._sbom_docs = {
            (i, variant): build_sbom_document(
                load_seed, i, variant, self._sbom_cap)
            for i in range(1, opts.requests, 2)
            for variant in ("clean",) + HOSTILE_VARIANTS}

    def push_hostile(self, variant: str) -> None:
        self._hostile_stack.append(variant)

    def pop_hostile(self, variant: str) -> None:
        stack = list(self._hostile_stack)
        if variant in stack:
            stack.reverse()
            stack.remove(variant)
            stack.reverse()
            self._hostile_stack = stack

    def do_request(self, idx: int, doc: dict, timeout: float,
                   tenant: str = "") -> Outcome:
        from ..fanal.artifact import ImageArchiveArtifact
        from ..fanal.cache import MemoryCache
        stack = self._hostile_stack
        variant = stack[-1] if stack else "clean"
        if idx % 2:
            return self._do_sbom_request(idx, timeout, tenant, variant)
        path = self._paths.get((idx, variant)) \
            or self._paths[(idx, "clean")]
        cache = MemoryCache()
        t0 = time.perf_counter()
        try:
            art = ImageArchiveArtifact(path, cache,
                                       scanners=("vuln", "secret"),
                                       secret_scanner=self.secret_scanner,
                                       ingest=self.ingest_opts)
            ref = art.inspect()
        except Exception as e:  # noqa: BLE001 — a containment breach
            return Outcome(idx, "lost",
                           detail=f"ingest raised "
                                  f"{type(e).__name__}: {e}"[:160])
        partial = any((cache.blobs.get(b) or {}).get("IngestErrors")
                      for b in ref.blob_ids)
        try:
            for b in ref.blob_ids:
                code, _, body = _post(
                    self.url, "/twirp/trivy.cache.v1.Cache/PutBlob",
                    {"diff_id": b, "blob_info": cache.blobs[b]},
                    timeout=timeout)
                if code != 200:
                    return _classify(idx, code, {}, body,
                                     (time.perf_counter() - t0) * 1e3)
            code, headers, body = _post(
                self.url, "/twirp/trivy.scanner.v1.Scanner/Scan",
                {"target": f"ingest-{idx}", "artifact_id": ref.id,
                 "blob_ids": ref.blob_ids,
                 "options": {"scanners": ["vuln", "secret"]}},
                timeout=timeout,
                headers={"X-Trivy-Deadline-Ms":
                         str(int(timeout * 1e3)),
                         **({TENANT_HEADER: tenant}
                            if tenant else {})})
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            return Outcome(idx, "lost",
                           latency_ms=(time.perf_counter() - t0) * 1e3,
                           detail=f"{type(e).__name__}: {e}"[:160])
        o = _classify(idx, code, headers, body,
                      (time.perf_counter() - t0) * 1e3)
        o.idx = idx
        o.partial = partial
        if variant != "clean":
            o.detail = (o.detail + f" variant={variant}").strip()
            if o.status == "ok" and not o.partial:
                # a clean-looking result off a truncated or bomb layer
                # means the containment silently under-reported
                o.well_formed = False
                o.detail = (f"hostile variant {variant} yielded no "
                            f"ingest annotation")
        return o

    def _do_sbom_request(self, idx: int, timeout: float, tenant: str,
                         variant: str) -> Outcome:
        """The sbom lane: the (maybe hostile) document through the
        ScanSBOM RPC, decoded under the server's budgets. The same
        contract as the archive lane: zero 5xx, hostile input always an
        annotated partial."""
        import base64

        from ..sbom.artifact import doc_digest
        raw = self._sbom_docs[(idx, variant)]
        t0 = time.perf_counter()
        try:
            code, headers, body = _post(
                self.url,
                "/twirp/trivy.scanner.v1.Scanner/ScanSBOM",
                {"target": f"sbom-{idx}",
                 "artifact_id": doc_digest(raw),
                 "kind": "cyclonedx",
                 "document": base64.b64encode(raw).decode(),
                 "options": {"scanners": ["vuln"]}},
                timeout=timeout,
                headers={"X-Trivy-Deadline-Ms":
                         str(int(timeout * 1e3)),
                         **({TENANT_HEADER: tenant}
                            if tenant else {})})
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            return Outcome(idx, "lost",
                           latency_ms=(time.perf_counter() - t0) * 1e3,
                           detail=f"{type(e).__name__}: {e}"[:160])
        o = _classify(idx, code, headers, body,
                      (time.perf_counter() - t0) * 1e3)
        o.idx = idx
        # the decode's degradations surface as the report's "ingest"
        # result
        o.partial = isinstance(body, dict) and any(
            r.get("Class") == "ingest"
            for r in body.get("results") or [])
        if variant != "clean":
            o.detail = (o.detail + f" variant={variant}").strip()
            if o.status == "ok" and not o.partial:
                o.well_formed = False
                o.detail = (f"hostile sbom variant {variant} yielded "
                            f"no parse annotation")
        return o

    def settled(self) -> list[str]:
        problems = super().settled()
        from ..fanal.pipeline import INGEST
        for stage, name in INGEST.status()["breakers"].items():
            if name != "closed":
                problems.append(f"ingest {stage} breaker {name}")
        return problems

    def close(self) -> None:
        super().close()
        import shutil
        shutil.rmtree(self._fixture_dir, ignore_errors=True)


def ingest_layers(doc: dict) -> list[dict]:
    """The clean ingest archive's layers as {path: bytes}: an alpine
    os-release layer, an apk-db layer carrying the request doc's
    storm-pkg set and a token file, and a padding layer."""
    pkgs = doc["PackageInfos"][0]["Packages"]
    blocks = [f"P:{p['Name']}\nV:{p['Version']}\nA:x86_64\n"
              f"o:{p['Name']}\nL:MIT\n" for p in pkgs]
    apk_db = ("\n".join(blocks) + "\n").encode()
    os_release = (b'NAME="Alpine Linux"\nID=alpine\n'
                  b'VERSION_ID=3.17.3\n')
    # the secrets lane: a per-request token file (the doc's packages
    # salt it, so responses differ), scanned through the shift-or kernel
    # by IngestTopology's small_batch_bytes=0 scanner
    secret_cfg = (
        f"# storm secrets lane ({pkgs[0]['Name']})\n"
        f"github_token = ghp_{'a' * 36}\n"
        f"aws_access_key_id = \"AKIA{'Z' * 16}\" \n").encode()
    return [{"etc/os-release": os_release},
            {"lib/apk/db/installed": apk_db, "app/config.txt": secret_cfg},
            {"usr/share/doc/pad.txt": b"pad " * 256}]


def build_ingest_archive(path: str, doc: dict, variant: str,
                         bomb: tuple | None = None) -> None:
    """One docker-save archive for the ingest drill (fanal.fixtures'
    writers) of ingest_layers(doc).

      clean      well-formed, 3 gzipped layers
      truncated  the apk layer's gzip blob cut mid-stream (the walk hits
                 EOFError: a deterministic `layer_error` partial)
      bomb       an extra layer of zeros that trips the decompression
                 ratio guard mid-stream
    """
    from ..fanal.fixtures import (gz_bytes, sha256_hex, tar_bytes,
                                  write_docker_archive)
    layer_tars = [tar_bytes(files) for files in ingest_layers(doc)]
    blobs = [gz_bytes(t) for t in layer_tars]
    diff_ids = ["sha256:" + sha256_hex(t) for t in layer_tars]
    if variant == "truncated":
        blobs[1] = blobs[1][:max(len(blobs[1]) // 2, 20)]
    elif variant == "bomb" and bomb is not None:
        blobs.append(bomb[0])
        diff_ids.append("sha256:" + bomb[1])
    write_docker_archive(path, blobs, diff_ids,
                         repo_tag=f"storm/ingest:{variant}")


def build_topology(table, schedule: Schedule, opts: StormOptions,
                   device=None, launch_record=None) -> _Topology:
    kw = {"device": device, "launch_record": launch_record}
    if schedule.topology == "single":
        return SingleTopology(table, opts, **kw)
    if schedule.topology == "mesh":
        return MeshTopology(table, opts, **kw)
    if schedule.topology == "fleet":
        return FleetTopology(table, opts, **kw)
    if schedule.topology == "ingest":
        return IngestTopology(table, opts,
                              load_seed=opts.load_seed
                              or schedule.seed, **kw)
    raise ValueError(f"unknown topology {schedule.topology!r}")


# ---------------------------------------------------------------------------
# strict exposition check


def check_exposition(text: str) -> list[str]:
    """Validate one /metrics payload under the strict exposition parser
    (obs.exposition: TYPE before sample, label escaping, histogram
    cumulativity, +Inf == _count); → [] when clean."""
    from ..obs.exposition import parse_exposition
    try:
        parse_exposition(text)
    except ValueError as e:
        return [str(e)]
    return []


# ---------------------------------------------------------------------------
# invariant registry

INVARIANTS: dict = {}


def invariant(name: str):
    def deco(fn):
        INVARIANTS[name] = fn
        return fn
    return deco


@dataclass
class RunContext:
    """Everything the invariant probes see after one run."""
    schedule: Schedule
    opts: StormOptions
    outcomes: list[Outcome]
    oracle: dict[int, str]
    settle_problems: list[str]
    leaked_threads: list[str]
    metrics: dict[str, str]            # url → /metrics text
    shed_counter_delta: float
    breaker_opens: int                 # breaker_open events in-window
    incident_files: list[str]
    incident_dir: str
    # db_swap: `oracle2` is the post-swap oracle (None when the schedule
    # never swapped); v1/v2 the before/after table digests;
    # skew_settle_delta the skew increments after the fleet's version
    # view converged
    db_swap: bool = False
    oracle2: "dict[int, str] | None" = None
    v1: str = ""
    v2: str = ""
    skew_settle_delta: float = 0.0
    requests: int = 0
    # this run's DELTAS of the graftprof ledger totals against the
    # tenant-attributed totals, read after teardown
    cost_conservation: dict = field(default_factory=dict)
    # adversarial_tenant: the flood's own outcomes (never in `outcomes`:
    # the victim probes see only the paced load) and the oracle pass's
    # latencies, the victims' solo baseline ({} when the oracle was
    # given, as in minimization trials: the latency bound is then
    # vacuous)
    adversarial: bool = False
    flood_outcomes: list = field(default_factory=list)
    oracle_lat: dict = field(default_factory=dict)


@invariant("no_lost_requests")
def _inv_lost(ctx: RunContext) -> list[str]:
    out = []
    for o in ctx.outcomes:
        if o.status == "lost":
            out.append(f"request {o.idx}: {o.code or 'conn'} "
                       f"{o.detail}")
        elif o.status == "shed" and not o.well_formed:
            out.append(f"request {o.idx}: malformed shed "
                       f"({o.code}: {o.detail})")
        elif o.status == "ok" and not o.well_formed:
            # ingest drill: a hostile artifact answered as if clean
            out.append(f"request {o.idx}: {o.detail}")
    return out


@invariant("bit_identity")
def _inv_identity(ctx: RunContext) -> list[str]:
    out = []
    for o in ctx.outcomes:
        if o.status != "ok" or o.partial:
            # annotated partials are the degradation contract, held by
            # no_lost_requests instead
            continue
        if ctx.db_swap:
            # a response must match the oracle its OWN
            # X-Trivy-DB-Version names: old hits under the new header
            # (or the reverse) is version mixing
            if o.db_version == ctx.v2:
                want = (ctx.oracle2 or {}).get(o.idx)
                if want is not None and o.digest != want:
                    out.append(f"request {o.idx}: v2-stamped result "
                               f"drifted from the post-swap oracle")
            elif o.db_version == ctx.v1:
                want = ctx.oracle.get(o.idx)
                if want is not None and o.digest != want:
                    out.append(f"request {o.idx}: v1-stamped result "
                               f"drifted from the pre-swap oracle")
            else:
                out.append(f"request {o.idx}: unknown "
                           f"X-Trivy-DB-Version "
                           f"{o.db_version[:19]!r}")
            continue
        want = ctx.oracle.get(o.idx)
        if want is not None and o.digest != want:
            out.append(f"request {o.idx}: result drifted from the "
                       f"unfaulted oracle")
    return out


@invariant("db_swap_converged")
def _inv_db_swap(ctx: RunContext) -> list[str]:
    """db_swap schedules only: after settle every server is on the new
    table (a complete post-swap oracle) and the skew counter is quiet."""
    if not ctx.db_swap:
        return []
    out = []
    if ctx.oracle2 is None or len(ctx.oracle2) < ctx.requests:
        missing = ctx.requests - len(ctx.oracle2 or {})
        out.append(f"post-swap oracle incomplete: {missing} "
                   f"request(s) failed against the settled, "
                   f"fully-rolled topology")
    if ctx.skew_settle_delta > 0:
        out.append(f"db-version skew counter moved "
                   f"{ctx.skew_settle_delta:g} time(s) after settle "
                   f"— the rolling swap never converged")
    return out


@invariant("breakers_reclose")
def _inv_liveness(ctx: RunContext) -> list[str]:
    return list(ctx.settle_problems)


@invariant("no_leaked_threads")
def _inv_threads(ctx: RunContext) -> list[str]:
    return [f"surviving non-daemon thread {n}"
            for n in ctx.leaked_threads]


@invariant("metrics_wellformed")
def _inv_metrics(ctx: RunContext) -> list[str]:
    out = []
    for url, text in ctx.metrics.items():
        if text is None:
            out.append(f"{url}/metrics unreachable after the run")
            continue
        for p in check_exposition(text):
            out.append(f"{url}: {p}")
    # the sheds a directly-connected client saw must show in the
    # server's shed counter (the router may mint fleet sheds itself)
    client_sheds = sum(1 for o in ctx.outcomes if o.status == "shed")
    if ctx.schedule.topology != "fleet" and client_sheds \
            and ctx.shed_counter_delta <= 0:
        out.append(f"{client_sheds} client-visible sheds but "
                   f"trivy_tpu_requests_shed_total never moved")
    return out


@invariant("incident_on_breaker_open")
def _inv_incident(ctx: RunContext) -> list[str]:
    if ctx.breaker_opens and not ctx.incident_files:
        return [f"{ctx.breaker_opens} breaker opening(s) but no "
                f"incident file in {ctx.incident_dir}"]
    return []


@invariant("tenant_isolation")
def _inv_tenant_isolation(ctx: RunContext) -> list[str]:
    """adversarial_tenant schedules only: the flood must not degrade
    anyone else. Victims never shed; every flood overflow is a
    well-formed 429; whatever completes stays bit-identical. When the
    flood is the schedule's only event, the victim p99 stays within 3×
    the solo (oracle-pass) baseline, floored at 300 ms."""
    if not ctx.adversarial:
        return []
    out = []
    for o in ctx.outcomes:
        if o is not None and o.status == "shed":
            out.append(f"victim request {o.idx} shed ({o.code}) "
                       f"under the tenant flood")
    others = [e for e in ctx.schedule.events
              if e.kind != "adversarial_tenant"]
    lats = sorted(o.latency_ms for o in ctx.outcomes
                  if o is not None and o.status == "ok")
    base = sorted(ctx.oracle_lat.values())
    if not others and lats and base:
        p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
        b99 = base[min(len(base) - 1, int(len(base) * 0.99))]
        bound = max(3.0 * b99, 300.0)
        if p99 > bound:
            out.append(f"victim p99 {p99:.0f}ms exceeds {bound:.0f}ms "
                       f"(3x solo baseline {b99:.0f}ms)")
    for o in ctx.flood_outcomes:
        if o.status == "shed":
            if not o.well_formed:
                out.append(f"flood request {o.idx}: malformed shed "
                           f"({o.code}: {o.detail})")
            elif o.code != 429 and not ctx.breaker_opens:
                out.append(f"flood request {o.idx}: {o.code} shed "
                           f"with no breaker opening — quota "
                           f"overflow must be a 429")
        elif o.status == "ok":
            if o.partial:
                continue
            want = ctx.oracle.get(o.idx)
            if want is not None and o.digest != want \
                    and not ctx.db_swap:
                out.append(f"flood request {o.idx}: completed result "
                           f"drifted from the unfaulted oracle")
        else:
            out.append(f"flood request {o.idx}: "
                       f"{o.code or 'conn'} {o.detail}")
    return out


@invariant("cost_conservation")
def _inv_cost(ctx: RunContext) -> list[str]:
    """Across the whole run (kills, failovers, sheds, warm-up) the
    device ms and conserved transfer bytes the graftprof ledger measured
    equal what the tenant rows (SYSTEM included) were charged."""
    out = []
    for axis in ("device_ms", "transfer_bytes"):
        rec = ctx.cost_conservation.get(axis)
        if rec and not rec.get("ok"):
            out.append(
                f"{axis}: ledger moved {rec['ledger']:g} but "
                f"attribution moved {rec['attributed']:g} "
                f"(leak or double count)")
    return out


# ---------------------------------------------------------------------------
# the runner


def _nondaemon_threads() -> dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()
            if not t.daemon and t.ident is not None}


def _cost_totals() -> dict:
    """The absolute totals of both conservation sides: the graftprof
    ledger (measured) and the tenant attribution (charged)."""
    from ..obs import cost as _cost
    from ..obs.perf import LEDGER
    agg = LEDGER.aggregate()
    att = _cost.TENANTS.totals()
    return {
        "ledger_ms": float(agg.get("device_ms_total", 0.0)),
        "ledger_bytes": float(sum(
            int(agg.get("transfer_bytes", {}).get(p, 0))
            for p in _cost.CONSERVED_TRANSFER_PATHS)),
        "att_ms": att["device_ms"],
        "att_bytes": att["transfer_bytes"],
    }


def _conservation_deltas(base: dict, timeout_s: float = 2.0) -> dict:
    """→ the run's {device_ms, transfer_bytes} conservation record. A
    handler settles its ledger after its response is written, so the
    attribution can trail the last response by a beat: poll until both
    axes reconcile (or the timeout makes the gap the invariant's)."""
    def _ok(a: float, b: float, abs_tol: float) -> bool:
        return abs(a - b) <= max(abs_tol, 0.01 * max(a, b))

    deadline = time.monotonic() + timeout_s
    while True:
        cur = _cost_totals()
        d_lms = cur["ledger_ms"] - base["ledger_ms"]
        d_ams = cur["att_ms"] - base["att_ms"]
        d_lb = cur["ledger_bytes"] - base["ledger_bytes"]
        d_ab = cur["att_bytes"] - base["att_bytes"]
        ok_ms = _ok(d_lms, d_ams, 0.5)
        ok_b = _ok(d_lb, d_ab, 4096.0)
        if (ok_ms and ok_b) or time.monotonic() >= deadline:
            return {
                "device_ms": {"ledger": round(d_lms, 3),
                              "attributed": round(d_ams, 3),
                              "ok": ok_ms},
                "transfer_bytes": {"ledger": int(d_lb),
                                   "attributed": int(d_ab),
                                   "ok": ok_b},
            }
        time.sleep(0.02)


class _ScheduleDriver(threading.Thread):
    """Runs start/end actions at their offsets from the shared epoch
    `t0` (the load workers pace their requests against the same epoch,
    so the windows overlap the traffic). When the load drains early,
    `flush()` runs every remaining action at once (a kill without its
    restart would fail the liveness probe for nothing)."""

    def __init__(self, topo: _Topology, schedule: Schedule,
                 t0: float):
        super().__init__(name="storm-driver", daemon=True)
        actions: list[tuple[float, int, StormEvent, str]] = []
        for n, ev in enumerate(schedule.events):
            actions.append((ev.at_ms, n, ev, "apply"))
            if ev.kind in ("kill_replica", "hostile_layer"):
                end = ev.at_ms + (ev.dur_ms or schedule.horizon_ms)
                actions.append((end, n, ev, "revert"))
        actions.sort(key=lambda a: (a[0], a[1]))
        self._actions = actions
        self._topo = topo
        self._cursor = 0
        self._cv = threading.Condition()
        self._flushed = False
        self.t0 = t0

    def run(self) -> None:
        while True:
            with self._cv:
                if self._cursor >= len(self._actions):
                    return
                at_ms, _, ev, op = self._actions[self._cursor]
                if self._flushed:
                    wait = 0.0
                else:
                    wait = at_ms / 1e3 - (time.monotonic() - self.t0)
                if wait > 0:
                    self._cv.wait(timeout=min(wait, 0.05))
                    continue
                self._cursor += 1
            self._fire(ev, op)

    def _fire(self, ev: StormEvent, op: str) -> None:
        _log.info("storm: %s %s", op, ev.label())
        try:
            if op == "apply":
                self._topo.apply(ev)
            else:
                self._topo.revert(ev)
        except Exception:
            _log.exception("storm: %s %s failed", op, ev.label())

    def flush(self) -> None:
        with self._cv:
            self._flushed = True
            self._cv.notify()
        self.join(timeout=30.0)


def _classify(idx: int, code: int, headers: dict, body,
              latency_ms: float) -> Outcome:
    if 200 <= code < 300:
        return Outcome(idx, "ok", code, canonical_digest(body),
                       latency_ms,
                       db_version=headers.get(DB_VERSION_HEADER)
                       or "")
    if code in (429, 503):
        well = True
        detail = ""
        try:
            ra = float(headers.get("Retry-After") or "")
            if ra < 1.0:
                well, detail = False, f"Retry-After {ra} < 1"
        except ValueError:
            well, detail = False, "missing/unparseable Retry-After"
        if not isinstance(body, dict) or body.get("code") not in (
                "resource_exhausted", "unavailable"):
            well, detail = False, f"bad shed body {body!r}"[:120]
        return Outcome(idx, "shed", code, latency_ms=latency_ms,
                       detail=detail, well_formed=well)
    if code == 504:
        well = isinstance(body, dict) and \
            body.get("code") == "deadline_exceeded"
        return Outcome(idx, "shed", code, latency_ms=latency_ms,
                       detail="" if well else f"bad 504 body {body!r}",
                       well_formed=well)
    return Outcome(idx, "lost", code, latency_ms=latency_ms,
                   detail=str(body)[:160])


def _scan_once(url: str, doc: dict, timeout: float,
               tenant: str = "") -> Outcome:
    diff = doc["DiffID"]
    t0 = time.perf_counter()
    try:
        code, headers, body = _post(
            url, "/twirp/trivy.scanner.v1.Scanner/Scan",
            {"target": diff[:19], "artifact_id": diff,
             "blob_ids": [diff], "options": {"scanners": ["vuln"]}},
            timeout=timeout,
            headers={"X-Trivy-Deadline-Ms": str(int(timeout * 1e3)),
                     **({TENANT_HEADER: tenant} if tenant else {})})
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        return Outcome(-1, "lost",
                       latency_ms=(time.perf_counter() - t0) * 1e3,
                       detail=f"{type(e).__name__}: {e}"[:160])
    return _classify(-1, code, headers, body,
                     (time.perf_counter() - t0) * 1e3)


def run_storm(schedule: Schedule, opts: StormOptions | None = None,
              table=None, oracle: dict[int, str] | None = None,
              device=None, launch_record=None) -> StormReport:
    """Refuse the events the port cannot run, then stand up the
    topology on `device` (CUDA unless "cpu"; no GPU raises), run the
    oracle pass (unless given), push the blobs, drive the concurrent
    load while the schedule executes, settle, tear down and evaluate
    every invariant probe. `launch_record` (server.listen.LaunchRecord)
    goes to every server the topology starts."""
    refused = refused_events(schedule)
    if refused:
        raise StormRefused(refused)
    from ..device import resolve_device
    device = resolve_device(device)
    opts = opts or StormOptions()
    if table is None:
        table = storm_table()
    # an adversarial_tenant schedule needs per-tenant quotas to mean
    # anything: victim-safe defaults when the caller set none
    adv_events = [ev for ev in schedule.events
                  if ev.kind == "adversarial_tenant"]
    if adv_events and not (opts.admit_tenant_max_active
                           or opts.admit_tenant_max_queue
                           or opts.admit_tenant_rate):
        opts = replace(
            opts,
            admit_tenant_max_active=max(2, opts.concurrency),
            admit_tenant_max_queue=max(1, opts.concurrency // 4))
    load_seed = opts.load_seed or schedule.seed
    docs = [request_doc(load_seed, i) for i in range(opts.requests)]

    # per-run incident capture (the invariant needs THIS run's files);
    # RECORDER is process-wide, so its settings are saved and restored
    from ..fanal.pipeline import INGEST
    from ..obs.recorder import RECORDER
    run_dir = tempfile.mkdtemp(
        prefix=f"storm-{schedule.topology}-{schedule.seed}-",
        dir=opts.artifact_dir or None)
    saved = (RECORDER.incident_dir, RECORDER.incident_cooldown_s)
    RECORDER.configure(incident_dir=run_dir, incident_cooldown_s=0.05)
    # the ingest breakers take the run's fast reset window, closed
    # around the run
    saved_ingest = [(INGEST.breaker(s).fail_threshold,
                     INGEST.breaker(s).reset_timeout_s)
                    for s in INGEST.STAGES]
    INGEST.configure(fail_threshold=3,
                     reset_timeout_s=opts.breaker_reset_ms / 1e3)
    INGEST.reset_for_tests()
    baseline_threads = _nondaemon_threads()
    shed0 = METRICS.get("trivy_tpu_requests_shed_total")
    events0 = len(RECORDER.events())
    cost0 = _cost_totals()
    t_run0 = time.perf_counter()

    try:
        topo = build_topology(table, schedule, opts, device=device,
                              launch_record=launch_record)
    except BaseException:
        _restore(saved, saved_ingest)
        raise
    try:
        # blobs first (the events start with the load, not the setup)
        if topo.push_blobs:
            for doc in docs:
                code, _, body = _post(
                    topo.url, "/twirp/trivy.cache.v1.Cache/PutBlob",
                    {"diff_id": doc["DiffID"], "blob_info": doc},
                    timeout=opts.request_timeout_s)
                if code != 200:
                    raise RuntimeError(f"storm setup: PutBlob → "
                                       f"{code} {body}")
        oracle_lat: dict[int, float] = {}
        if oracle is None:
            oracle = {}
            for i, doc in enumerate(docs):
                o = topo.do_request(i, doc, opts.request_timeout_s)
                if o.status != "ok":
                    raise RuntimeError(
                        f"storm oracle pass failed on request {i}: "
                        f"{o.status} {o.code} {o.detail}")
                oracle[i] = o.digest
                # the serial pass doubles as the victims' latency
                # baseline for tenant_isolation
                oracle_lat[i] = o.latency_ms

        # the storm pass: the concurrent load and the schedule's thread,
        # paced against one epoch. Requests spread over ~85% of the
        # horizon so the windows overlap real traffic; the pacing is a
        # function of the request index (a replay keeps it)
        outcomes: list = [None] * len(docs)
        t0 = time.monotonic() + 0.02
        span_s = schedule.horizon_ms * 0.85 / 1e3
        driver = _ScheduleDriver(topo, schedule, t0)

        def worker(ids):
            for i in ids:
                delay = t0 + (i / max(len(docs), 1)) * span_s \
                    - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                try:
                    o = topo.do_request(i, docs[i],
                                        opts.request_timeout_s,
                                        tenant=tenant_for(opts, i))
                except Exception as e:  # noqa: BLE001 — a surprise
                    # (a 200 with a truncated body) is a lost request
                    # the invariants report
                    o = Outcome(i, "lost",
                                detail=f"{type(e).__name__}: {e}"[:160])
                o.idx = i
                outcomes[i] = o

        threads = [threading.Thread(
            target=worker, name=f"storm-load-{k}",
            args=(range(k, len(docs), opts.concurrency),))
            for k in range(opts.concurrency)]

        # adversarial_tenant floods: one thread per flood request, all
        # released at the event's offset; their outcomes kept apart
        flood_outcomes: list[Outcome] = []
        flood_lock = threading.Lock()

        def flood_worker(ev: StormEvent, j: int) -> None:
            delay = t0 + ev.at_ms / 1e3 - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            base = j % len(docs)
            try:
                o = topo.do_request(base, docs[base],
                                    opts.request_timeout_s,
                                    tenant="storm-adv")
            except Exception as e:  # noqa: BLE001 — as for the victims
                o = Outcome(base, "lost",
                            detail=f"{type(e).__name__}: {e}"[:160])
            o.idx = base
            with flood_lock:
                flood_outcomes.append(o)

        flood_threads = [
            threading.Thread(target=flood_worker,
                             name=f"storm-flood-{n}-{j}",
                             args=(ev, j), daemon=True)
            for n, ev in enumerate(adv_events)
            for j in range(max(1, int(ev.arg)))]

        driver.start()
        for t in threads + flood_threads:
            t.start()
        for t in threads:
            t.join()
        for t in flood_threads:
            t.join(timeout=opts.request_timeout_s + 5.0)
        driver.flush()

        # settle: every breaker must find its way back to closed. Serial
        # probe scans admit the ingest breakers' half-open probes; the
        # router's readmission loop runs on its own thread
        settle_deadline = time.monotonic() + opts.settle_s
        time.sleep(opts.breaker_reset_ms / 1e3)
        settle_problems = topo.settled()
        probe_n = 0
        while settle_problems and time.monotonic() < settle_deadline:
            # docs[0]'s content under a fresh DiffID: a memo miss, so a
            # real dispatch
            probe_n += 1
            probe = dict(docs[0])
            probe["DiffID"] = f"sha256:{0x5e771e0000 + probe_n:064x}"
            if topo.push_blobs:
                _post(topo.url,
                      "/twirp/trivy.cache.v1.Cache/PutBlob",
                      {"diff_id": probe["DiffID"],
                       "blob_info": probe},
                      timeout=opts.request_timeout_s)
            topo.do_request(0, probe, opts.request_timeout_s)
            if getattr(topo, "sbom_lane", False):
                topo.do_request(1, probe, opts.request_timeout_s)
            time.sleep(0.05)
            settle_problems = topo.settled()

        # db_swap epilogue: (a) the post-swap oracle: a settled, fully
        # rolled topology answers every request under the new table
        # (this pass also converges the router's version view); (b) the
        # skew counter stays quiet across a second pass
        oracle2 = None
        skew_settle_delta = 0.0
        if topo.db_swapped:
            oracle2 = {}
            for i, doc in enumerate(docs):
                o = topo.do_request(i, doc, opts.request_timeout_s)
                if o.status == "ok":
                    oracle2[i] = o.digest
            skew0 = METRICS.family_sum(
                "trivy_tpu_fleet_db_version_skew_total")
            for i, doc in enumerate(docs):
                topo.do_request(i, doc, opts.request_timeout_s)
            skew_settle_delta = METRICS.family_sum(
                "trivy_tpu_fleet_db_version_skew_total") - skew0

        metrics: dict = {}
        for url in topo.metrics_urls():
            try:
                with urllib.request.urlopen(url + "/metrics",
                                            timeout=10) as r:
                    metrics[url] = r.read().decode()
            except (urllib.error.URLError, OSError):
                metrics[url] = None
    finally:
        try:
            topo.close()
        finally:
            _restore(saved, saved_ingest)

    # conservation read AFTER teardown: every handler has settled, and
    # warm-up and probe work has landed in SYSTEM
    cost_deltas = _conservation_deltas(cost0)

    # leaked threads: everything the run created must be gone
    leak_deadline = time.monotonic() + 10.0
    leaked = {}
    while time.monotonic() < leak_deadline:
        leaked = {i: n for i, n in _nondaemon_threads().items()
                  if i not in baseline_threads}
        if not leaked:
            break
        time.sleep(0.05)

    breaker_opens = sum(
        1 for ev in RECORDER.events()[events0:]
        if ev.get("kind") == "breaker_open")
    try:
        incident_files = sorted(
            n for n in os.listdir(run_dir) if n.endswith(".json"))
    except OSError:
        incident_files = []

    ctx = RunContext(
        schedule=schedule, opts=opts, outcomes=outcomes,
        oracle=oracle, settle_problems=settle_problems,
        leaked_threads=sorted(leaked.values()), metrics=metrics,
        shed_counter_delta=METRICS.get(
            "trivy_tpu_requests_shed_total") - shed0,
        breaker_opens=breaker_opens, incident_files=incident_files,
        incident_dir=run_dir,
        db_swap=topo.db_swapped, oracle2=oracle2,
        v1=table.content_digest(),
        v2=topo.table2.content_digest(),
        skew_settle_delta=skew_settle_delta,
        requests=len(docs),
        cost_conservation=cost_deltas,
        adversarial=bool(adv_events),
        flood_outcomes=flood_outcomes,
        oracle_lat=oracle_lat)
    violations = {}
    for name, probe in INVARIANTS.items():
        msgs = probe(ctx)
        if msgs:
            violations[name] = msgs
    return StormReport(schedule=schedule, outcomes=outcomes,
                       oracle=oracle, violations=violations,
                       incident_dir=run_dir,
                       duration_s=time.perf_counter() - t_run0,
                       flood_outcomes=flood_outcomes)


def _restore(saved: tuple, saved_ingest: list) -> None:
    """Put back the recorder's incident settings and the ingest
    breakers' knobs, and close the breakers."""
    from ..fanal.pipeline import INGEST
    from ..obs.recorder import RECORDER
    for stage, (threshold, reset_s) in zip(INGEST.STAGES, saved_ingest):
        br = INGEST.breaker(stage)
        br.fail_threshold, br.reset_timeout_s = threshold, reset_s
    INGEST.reset_for_tests()
    RECORDER.configure(incident_dir=saved[0],
                       incident_cooldown_s=saved[1])


# ---------------------------------------------------------------------------
# minimization: delta-debug a failing schedule


def minimize_schedule(schedule: Schedule, opts: StormOptions,
                      table=None, oracle: dict[int, str] | None = None,
                      max_trials: int = 24, device=None
                      ) -> tuple[Schedule, StormReport, int]:
    """Shrink a failing schedule to a minimal one that still fails:
    greedy event drops to a fixpoint, then window halving. → (minimal
    schedule, its failing report, trials spent). The caller supplies the
    oracle so trials never re-run the unfaulted pass."""
    if table is None:
        table = storm_table()
    trials = 0
    last_fail: StormReport | None = None

    def fails(evts: list[StormEvent]) -> bool:
        nonlocal trials, last_fail
        if trials >= max_trials:
            return False
        trials += 1
        rep = run_storm(replace(schedule, events=evts), opts,
                        table=table, oracle=oracle, device=device)
        if not rep.ok:
            last_fail = rep
        return not rep.ok

    events = list(schedule.events)
    i = 0
    while i < len(events) and len(events) > 1:
        cand = events[:i] + events[i + 1:]
        if fails(cand):
            events = cand        # dropped; retry the same position
        else:
            i += 1
    for i, ev in enumerate(list(events)):
        while ev.dur_ms >= 100.0 and trials < max_trials:
            shorter = replace(ev, dur_ms=round(ev.dur_ms / 2, 1))
            if fails(events[:i] + [shorter] + events[i + 1:]):
                ev = shorter
                events[i] = ev
            else:
                break
    minimal = replace(schedule, events=events)
    if last_fail is None or last_fail.schedule.events != events:
        # re-run the exact minimal schedule so the report matches it
        last_fail = run_storm(minimal, opts, table=table,
                              oracle=oracle, device=device)
    return minimal, last_fail, trials


# ---------------------------------------------------------------------------
# replay artifacts


def write_replay(path: str, schedule: Schedule, opts: StormOptions,
                 report: StormReport, minimized: bool) -> str:
    """Write the replayable failing-schedule artifact: the schedule, the
    load parameters, the violations and the newest captured incident
    (obs.check validates the document)."""
    incident = None
    for name in reversed(sorted(
            os.listdir(report.incident_dir))
            if os.path.isdir(report.incident_dir) else []):
        if name.endswith(".json"):
            try:
                with open(os.path.join(report.incident_dir, name)) as f:
                    incident = json.load(f)
                break
            except (OSError, json.JSONDecodeError):
                continue
    doc = {
        "schema": REPLAY_SCHEMA,
        "schedule": schedule.to_json(),
        "load": {
            "requests": opts.requests,
            "concurrency": opts.concurrency,
            "load_seed": opts.load_seed or schedule.seed,
            "admit_max_active": opts.admit_max_active,
            "admit_max_queue": opts.admit_max_queue,
            "admit_tenant_max_active": opts.admit_tenant_max_active,
            "admit_tenant_max_queue": opts.admit_tenant_max_queue,
            "admit_tenant_rate": opts.admit_tenant_rate,
            "watchdog_ms": opts.watchdog_ms,
            "breaker_reset_ms": opts.breaker_reset_ms,
            "replicas": opts.replicas,
            "mesh_devices": opts.mesh_devices,
            "mesh_hosts": opts.mesh_hosts,
            "tenants": opts.tenants,
        },
        "violations": report.violations,
        "minimized": minimized,
        "incident": incident,
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path


def load_replay(path: str) -> tuple[Schedule, StormOptions]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != REPLAY_SCHEMA:
        raise ValueError(f"{path}: not a storm replay artifact "
                         f"(schema {doc.get('schema')!r})")
    schedule = Schedule.from_json(doc["schedule"])
    load = doc.get("load", {})
    opts = StormOptions(
        requests=int(load.get("requests", 24)),
        concurrency=int(load.get("concurrency", 8)),
        load_seed=int(load.get("load_seed", 0)),
        admit_max_active=int(load.get("admit_max_active", 0)),
        admit_max_queue=int(load.get("admit_max_queue", 8)),
        admit_tenant_max_active=int(
            load.get("admit_tenant_max_active", 0)),
        admit_tenant_max_queue=int(
            load.get("admit_tenant_max_queue", 0)),
        admit_tenant_rate=float(load.get("admit_tenant_rate", 0.0)),
        watchdog_ms=float(load.get("watchdog_ms", 50.0)),
        breaker_reset_ms=float(load.get("breaker_reset_ms", 150.0)),
        replicas=int(load.get("replicas", 3)),
        mesh_devices=int(load.get("mesh_devices", 4)),
        mesh_hosts=int(load.get("mesh_hosts", 2)),
        tenants=int(load.get("tenants", 1)))
    return schedule, opts


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m trivy_tpu_torch.resilience.storm",
        description="graftstorm: seeded chaos schedules against the "
                    "port's in-process scan topology, with an invariant "
                    "engine and failing-schedule minimization. A "
                    "schedule with a failpoint or host_loss event is "
                    "refused (exit 2): the port has no failpoints and "
                    "no meshguard")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=1,
                    help="schedules to run (round r uses seed+r)")
    ap.add_argument("--topology", choices=TOPOLOGIES, default="single")
    ap.add_argument("--events", type=int, default=4,
                    help="fault events per schedule")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--mesh-devices", type=int, default=4)
    ap.add_argument("--mesh-hosts", type=int, default=2,
                    help="synthetic hosts the generator draws host_loss "
                         "events over (the port refuses host_loss)")
    ap.add_argument("--admit-max-active", type=int, default=0)
    ap.add_argument("--admit-tenant-max-active", type=int, default=0,
                    help="per-tenant active cap (0 = off; "
                         "adversarial_tenant schedules derive "
                         "victim-safe defaults when no tenant quota "
                         "flag is set)")
    ap.add_argument("--admit-tenant-max-queue", type=int, default=0)
    ap.add_argument("--admit-tenant-rate", type=float, default=0.0,
                    help="per-tenant admission rate (req/s token "
                         "bucket; 0 = off)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="distinct X-Trivy-Tenant ids the load "
                         "round-robins through (1 = untenanted)")
    ap.add_argument("--artifact-dir", default="",
                    help="where failing-schedule replay artifacts and "
                         "incident snapshots land (default: a tmpdir)")
    ap.add_argument("--replay", default="", metavar="FILE",
                    help="re-run a failing-schedule artifact instead "
                         "of generating schedules")
    ap.add_argument("--no-minimize", action="store_true",
                    help="on failure, skip delta-debugging the "
                         "schedule down to a minimal one")
    ap.add_argument("--virtual-devices", type=int, default=0,
                    help="accepted for the JAX CLI's sake and ignored: "
                         "the mesh lays its --mesh-devices slots on the "
                         "chosen --device (N slots of the CPU, or the "
                         "cards in turn)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    table = storm_table()
    if args.replay:
        schedule, opts = load_replay(args.replay)
        if args.artifact_dir:
            opts.artifact_dir = args.artifact_dir
        try:
            report = run_storm(schedule, opts, table=table,
                               device=args.device)
        except StormRefused as e:
            print(str(e), file=sys.stderr)
            return 2
        print(json.dumps(report.summary()))
        return 0 if report.ok else 1

    opts = StormOptions(
        requests=args.requests, concurrency=args.concurrency,
        replicas=args.replicas, mesh_devices=args.mesh_devices,
        mesh_hosts=args.mesh_hosts,
        admit_max_active=args.admit_max_active,
        admit_tenant_max_active=args.admit_tenant_max_active,
        admit_tenant_max_queue=args.admit_tenant_max_queue,
        admit_tenant_rate=args.admit_tenant_rate,
        artifact_dir=args.artifact_dir, tenants=args.tenants)
    for r in range(args.rounds):
        seed = args.seed + r
        schedule = generate_schedule(
            seed, args.topology, n_events=args.events,
            mesh_devices=args.mesh_devices, replicas=args.replicas,
            watchdog_ms=opts.watchdog_ms,
            mesh_hosts=args.mesh_hosts)
        try:
            report = run_storm(schedule, opts, table=table,
                               device=args.device)
        except StormRefused as e:
            print(f"round {r} (seed {seed}): {e}", file=sys.stderr)
            return 2
        print(json.dumps(report.summary()))
        if report.ok:
            continue
        if not args.no_minimize:
            minimal, report, trials = minimize_schedule(
                schedule, opts, table=table, oracle=report.oracle,
                device=args.device)
            print(json.dumps({"minimized": minimal.to_json(),
                              "trials": trials,
                              "violations": report.violations}))
            schedule = minimal
        out = os.path.join(
            args.artifact_dir or report.incident_dir,
            f"storm-replay-{args.topology}-{seed}.json")
        write_replay(out, schedule, opts, report,
                     minimized=not args.no_minimize)
        print(json.dumps({"replay_artifact": out}))
        return 1
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
