"""``python -m trivy_tpu_torch.obs.check`` — offline graftwatch validator.

Incident files and assembled trace dumps are the artifacts an operator
ships around (bug reports, postmortems) and the artifacts tooling
ingests — a malformed one discovered at read time is evidence lost.
This validator checks them offline, with no server running:

  * schema: incident files must carry the trivy-tpu-incident/1 shape
    (reason, captured_unix, spans/logs/pinned); trace dumps must be
    Chrome trace-event documents whose "X" events carry the graftscope
    span args (span_id/trace_id/parent_id) with numeric ts/dur;
  * span-edge acyclicity: parent pointers must form a forest — a
    cycle (possible only through id collision or a corrupted merge)
    would hang any consumer that walks parents;
  * id discipline: duplicate span ids inside one document are flagged
    (the collect assembler dedupes; a file that still has duplicates
    was built wrong);
  * graftstorm replay artifacts (trivy-tpu-storm-replay/1): the
    schedule grammar and load parameters `--replay` needs, plus the
    embedded incident document when one was captured;
  * graftprof live-capture manifests (trivy-tpu-profile/1): the
    reason/timing fields and a non-empty artifact file list — an
    empty capture is a profile that profiled nothing;
  * graftcost documents (trivy-tpu-costs/1): /debug/costs bodies and
    the merged fleet doc `obs.collect --costs` assembles — the tenant
    table's numeric totals, the scans outcome map, and the
    conservation block's ledger/attributed/ok triples.

The port's copy of the JAX package's obs/check.py (the port's tests
run it over freshly produced incidents, trace dumps and profile
manifests, plus corrupted variants). Exit 0 clean, 1 findings, 2 unreadable input.
"""

from __future__ import annotations

import json


def _walk_parents(span_id: str, parents: dict[str, str]) -> str | None:
    """Follow parent pointers from span_id; → an error string on a
    cycle, None when the chain terminates."""
    seen = {span_id}
    cur = parents.get(span_id, "")
    steps = 0
    while cur:
        if cur in seen:
            return (f"span {span_id}: parent chain cycles back "
                    f"through {cur}")
        seen.add(cur)
        cur = parents.get(cur, "")
        steps += 1
        if steps > len(parents) + 1:
            return f"span {span_id}: parent chain does not terminate"
    return None


def _check_span_set(spans: list[dict], where: str) -> list[str]:
    """Shared span-list validation: required fields, types, duplicate
    ids, parent acyclicity."""
    problems: list[str] = []
    parents: dict[str, str] = {}
    for i, s in enumerate(spans):
        if not isinstance(s, dict):
            problems.append(f"{where}[{i}]: not an object")
            continue
        sid = s.get("span_id")
        if not sid or not isinstance(sid, str):
            problems.append(f"{where}[{i}]: missing span_id")
            continue
        if not isinstance(s.get("name"), str) or not s.get("name"):
            problems.append(f"{where}[{i}] ({sid}): missing name")
        for field in ("ts_unix", "dur_ms"):
            v = s.get(field)
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(
                    f"{where}[{i}] ({sid}): bad {field} {v!r}")
        if sid in parents:
            problems.append(f"{where}: duplicate span id {sid}")
            continue
        parents[sid] = s.get("parent_id") or ""
    for sid in parents:
        err = _walk_parents(sid, parents)
        if err:
            problems.append(f"{where}: {err}")
    return problems


def check_incident(doc: dict) -> list[str]:
    """Validate one incident document (recorder.FlightRecorder.SCHEMA)."""
    problems: list[str] = []
    if doc.get("schema") != "trivy-tpu-incident/1":
        problems.append(f"unknown incident schema {doc.get('schema')!r}")
    if not isinstance(doc.get("reason"), str) or not doc.get("reason"):
        problems.append("missing reason")
    if not isinstance(doc.get("captured_unix"), (int, float)):
        problems.append("missing captured_unix")
    for field in ("spans", "logs", "events"):
        if not isinstance(doc.get(field), list):
            problems.append(f"missing {field} list")
    if not isinstance(doc.get("pinned"), dict):
        problems.append("missing pinned map")
    if isinstance(doc.get("spans"), list):
        problems += _check_span_set(doc["spans"], "spans")
    if isinstance(doc.get("pinned"), dict):
        for tid, entry in doc["pinned"].items():
            if not isinstance(entry, dict) \
                    or not isinstance(entry.get("spans"), list):
                problems.append(f"pinned[{tid}]: malformed entry")
                continue
            problems += _check_span_set(entry["spans"],
                                        f"pinned[{tid}]")
            for s in entry["spans"]:
                if isinstance(s, dict) and \
                        s.get("trace_id") not in ("", tid):
                    problems.append(
                        f"pinned[{tid}]: span {s.get('span_id')} "
                        f"belongs to trace {s.get('trace_id')}")
    if isinstance(doc.get("logs"), list):
        for i, rec in enumerate(doc["logs"]):
            if not isinstance(rec, dict) or "msg" not in rec:
                problems.append(f"logs[{i}]: malformed record")
    return problems


def check_trace(doc: dict) -> list[str]:
    """Validate one Chrome trace-event document (graftscope export or
    collect.assemble output)."""
    problems: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    parents: dict[str, str] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"traceEvents[{i}]: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"traceEvents[{i}]: unknown phase {ph!r}")
            continue
        if ph != "X":
            continue   # instants/metadata carry no span identity
        missing = [k for k in ("name", "ts", "dur", "pid", "tid",
                               "args") if k not in ev]
        if missing:
            problems.append(
                f"traceEvents[{i}]: missing {', '.join(missing)}")
            continue
        for field in ("ts", "dur"):
            if not isinstance(ev[field], (int, float)) \
                    or ev[field] < 0:
                problems.append(
                    f"traceEvents[{i}]: bad {field} {ev[field]!r}")
        args = ev["args"]
        sid = args.get("span_id") if isinstance(args, dict) else None
        if not sid:
            problems.append(f"traceEvents[{i}]: args.span_id missing")
            continue
        if sid in parents:
            problems.append(f"duplicate span id {sid}")
            continue
        parents[sid] = args.get("parent_id") or ""
    for sid in parents:
        err = _walk_parents(sid, parents)
        if err:
            problems.append(err)
    return problems


def check_storm_replay(doc: dict) -> list[str]:
    """Validate one graftstorm failing-schedule replay artifact
    (resilience.storm.REPLAY_SCHEMA): the schedule grammar, the load
    parameters `--replay` needs to reproduce the run, and — when an
    incident was captured with it — the embedded incident document."""
    problems: list[str] = []
    sched = doc.get("schedule")
    if not isinstance(sched, dict):
        problems.append("missing schedule object")
    else:
        for field in ("seed", "topology", "horizon_ms"):
            if field not in sched:
                problems.append(f"schedule: missing {field}")
        events = sched.get("events")
        if not isinstance(events, list):
            problems.append("schedule: missing events list")
        else:
            for i, ev in enumerate(events):
                if not isinstance(ev, dict):
                    problems.append(f"events[{i}]: not an object")
                    continue
                kind = ev.get("kind", "failpoint")
                if kind not in ("failpoint", "kill_replica",
                                "swap_table", "db_swap",
                                "hostile_layer", "host_loss",
                                "adversarial_tenant"):
                    problems.append(
                        f"events[{i}]: unknown kind {kind!r}")
                if kind == "adversarial_tenant" and (
                        not isinstance(ev.get("arg"), (int, float))
                        or ev["arg"] < 1):
                    # arg is the flood's burst size; a replay with a
                    # zero-request flood reproduces nothing
                    problems.append(
                        f"events[{i}]: adversarial_tenant with bad "
                        f"flood size {ev.get('arg')!r}")
                if kind == "hostile_layer" and \
                        ev.get("variant") not in ("truncated",
                                                  "bomb"):
                    problems.append(
                        f"events[{i}]: hostile_layer with unknown "
                        f"variant {ev.get('variant')!r}")
                if not isinstance(ev.get("at_ms"), (int, float)) \
                        or ev["at_ms"] < 0:
                    problems.append(
                        f"events[{i}]: bad at_ms {ev.get('at_ms')!r}")
                if kind == "failpoint" and not ev.get("site"):
                    problems.append(f"events[{i}]: failpoint without "
                                    f"a site")
    load = doc.get("load")
    if not isinstance(load, dict):
        problems.append("missing load object")
    else:
        for field in ("requests", "concurrency", "load_seed"):
            if not isinstance(load.get(field), int):
                problems.append(f"load: missing {field}")
        # tenants is optional (older replays predate the graftcost
        # tenant-mix knob); when present it must be a positive int or
        # --replay cannot reproduce the recorded tenant round-robin
        if "tenants" in load and (
                not isinstance(load["tenants"], int)
                or load["tenants"] < 1):
            problems.append(
                f"load: bad tenants {load['tenants']!r}")
        # graftfair tenant-quota knobs: optional (older replays
        # predate them); when present they must be non-negative
        # numbers or --replay arms different quotas than the run
        for field in ("admit_tenant_max_active",
                      "admit_tenant_max_queue", "admit_tenant_rate"):
            if field in load and (
                    not isinstance(load[field], (int, float))
                    or load[field] < 0):
                problems.append(
                    f"load: bad {field} {load[field]!r}")
    if not isinstance(doc.get("violations"), dict):
        problems.append("missing violations map")
    incident = doc.get("incident")
    if incident is not None:
        if not isinstance(incident, dict):
            problems.append("incident is not an object")
        else:
            problems += [f"incident: {p}"
                         for p in check_incident(incident)]
    return problems


def check_profile(doc: dict) -> list[str]:
    """Validate one graftprof live-capture manifest
    (trivy-tpu-profile/1, written next to the torch.profiler
    artifact dir by obs.perf.Profiler.capture)."""
    problems: list[str] = []
    if doc.get("schema") != "trivy-tpu-profile/1":
        problems.append(f"unknown profile schema {doc.get('schema')!r}")
    if not isinstance(doc.get("reason"), str) or not doc.get("reason"):
        problems.append("missing reason")
    for field in ("requested_ms", "duration_ms", "started_unix"):
        v = doc.get(field)
        if not isinstance(v, (int, float)) or v < 0:
            problems.append(f"bad {field} {v!r}")
    if not isinstance(doc.get("artifact_dir"), str) \
            or not doc.get("artifact_dir"):
        problems.append("missing artifact_dir")
    files = doc.get("files")
    if not isinstance(files, list) \
            or not all(isinstance(f, str) for f in files):
        problems.append("missing files list")
    elif not files:
        # a capture that produced no artifact files profiled nothing —
        # the operator shipped an empty directory
        problems.append("capture produced no profile artifacts")
    return problems


def check_costs(doc: dict) -> list[str]:
    """Validate one graftcost document (trivy-tpu-costs/1): a server's
    /debug/costs body, the router's fleet-scope table, or the merged
    fleet doc `obs.collect --costs` assembles. The tenant table is the
    contract: every row carries the numeric totals fields plus a scans
    outcome map; the optional conservation block carries the
    ledger/attributed/ok triple per axis."""
    problems: list[str] = []
    if doc.get("schema") != "trivy-tpu-costs/1":
        problems.append(f"unknown costs schema {doc.get('schema')!r}")
    tenants = doc.get("tenants")
    if not isinstance(tenants, dict):
        problems.append("missing tenants table")
    else:
        for tenant, row in tenants.items():
            if not isinstance(row, dict):
                problems.append(f"tenants[{tenant}]: not an object")
                continue
            for field in ("queue_ms", "service_ms", "device_ms",
                          "transfer_bytes", "host_ms", "ingest_bytes",
                          "ingest_ms", "secret_bytes", "avoided_ms"):
                v = row.get(field)
                if not isinstance(v, (int, float)) or v < 0:
                    problems.append(
                        f"tenants[{tenant}]: bad {field} {v!r}")
            scans = row.get("scans")
            if not isinstance(scans, dict) or not all(
                    isinstance(n, int) for n in scans.values()):
                problems.append(
                    f"tenants[{tenant}]: malformed scans map")
    conservation = doc.get("conservation")
    if conservation is not None:
        if not isinstance(conservation, dict):
            problems.append("conservation is not an object")
        else:
            for axis in ("device_ms", "transfer_bytes"):
                rec = conservation.get(axis)
                if not isinstance(rec, dict):
                    problems.append(f"conservation: missing {axis}")
                    continue
                for field in ("ledger", "attributed"):
                    if not isinstance(rec.get(field), (int, float)):
                        problems.append(
                            f"conservation[{axis}]: bad {field} "
                            f"{rec.get(field)!r}")
                if not isinstance(rec.get("ok"), bool):
                    problems.append(
                        f"conservation[{axis}]: missing ok verdict")
    # fleet-merged docs carry per-source fragments; each must itself
    # be a costs doc (or an unreachable-process error stub)
    sources = doc.get("sources")
    if sources is not None:
        if not isinstance(sources, list):
            problems.append("sources is not a list")
        else:
            for i, frag in enumerate(sources):
                if not isinstance(frag, dict):
                    problems.append(f"sources[{i}]: not an object")
                    continue
                if frag.get("error"):
                    continue   # unreachable process, recorded as such
                problems += [f"sources[{i}]: {p}"
                             for p in check_costs(frag)]
    return problems


def check_file(path: str) -> list[str]:
    """Validate one file, auto-detecting its kind by content."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable: {e}"]
    if not isinstance(doc, dict):
        return ["top level is not an object"]
    if "traceEvents" in doc:
        return check_trace(doc)
    if doc.get("schema", "").startswith("trivy-tpu-storm-replay"):
        return check_storm_replay(doc)
    if doc.get("schema", "").startswith("trivy-tpu-profile"):
        return check_profile(doc)
    if doc.get("schema", "").startswith("trivy-tpu-costs"):
        return check_costs(doc)
    if "schema" in doc or "reason" in doc:
        return check_incident(doc)
    return ["neither a trace dump (traceEvents), an incident file "
            "(schema/reason), a profile manifest, nor a storm replay "
            "artifact"]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m trivy_tpu_torch.obs.check",
        description="validate graftwatch incident files and trace "
                    "dumps offline (schema + span-edge acyclicity)")
    ap.add_argument("paths", nargs="+", metavar="FILE")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-file OK lines")
    args = ap.parse_args(argv)
    bad = unreadable = 0
    for path in args.paths:
        problems = check_file(path)
        if not problems:
            if not args.quiet:
                print(f"{path}: OK")
            continue
        if problems[0].startswith("unreadable:"):
            unreadable += 1
        bad += 1
        for p in problems:
            print(f"{path}: {p}")
    if unreadable:
        return 2
    return 1 if bad else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
