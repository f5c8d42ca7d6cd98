"""graftwatch trace assembly: one trace across processes.

A scan served by the scan server produces span fragments in up to
three places: the client process (`client.scan`), the fleet router
(`router.rpc` and a `router.forward` per hop, fleet/router.py) when one
stands in front, and the server that served it (`server.rpc` and
everything under it). Each process exposes its
flight-recorder buffer at `/debug/traces?trace_id=`; this module pulls
those fragments (or takes a process's own, from
`recorder.debug_traces_payload`) and assembles ONE Chrome/Perfetto
trace-event document spanning client → server → detect → device.

Cross-process rules:

  * fragments are deduped by span id (in-process tests share one
    recorder, and a retry may surface the same span twice);
  * parent edges stitch via the X-Trivy-Parent-Span header: a
    fragment's root span carries the forwarding span's id as its
    parent, so the assembled tree is connected without any clock
    agreement between processes;
  * timestamps use each span's WALL clock (ts_unix) — perf_counter
    bases are process-local — offset to the earliest span in the
    document;
  * every source process gets its own Chrome pid plus a
    process_name metadata event naming its URL.

`python -m trivy_tpu_torch.obs.collect --url SERVER [--url ...]
--trace-id ID [--token T] -o FILE` pulls the named processes;
`--router URL` discovers a fleet's replicas through the router's
/healthz. `--costs` switches the sweep to graftcost: it pulls every
process's token-gated /debug/costs and sums the replica tenant tables
into one trivy-tpu-costs/1 document; `--perf` embeds each process's
/debug/perf fragment too. `obs.check` validates the result offline.

The port's copy of the JAX package's obs/collect.py, which also takes
the token the server's /debug pages are gated by.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request


def fetch_fragment(base_url: str, trace_id: str | None = None,
                   timeout: float = 5.0, token: str = "") -> dict:
    """GET one process's /debug/traces buffer. Raises on transport
    errors — callers decide whether a missing fragment is fatal (a
    replica that died mid-incident is exactly when you want the other
    fragments anyway)."""
    url = base_url.rstrip("/") + "/debug/traces"
    if trace_id:
        url += "?" + urllib.parse.urlencode({"trace_id": trace_id})
    req = urllib.request.Request(
        url, headers={"Trivy-Token": token} if token else {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def fetch_fragments(base_urls, trace_id: str | None = None,
                    timeout: float = 5.0, token: str = "") -> list[dict]:
    """Fetch from every URL, skipping unreachable processes (their
    absence is recorded as an empty fragment with an `error`)."""
    out = []
    for url in base_urls:
        try:
            frag = fetch_fragment(url, trace_id, timeout, token)
        except Exception as e:  # noqa: BLE001 — best-effort sweep
            out.append({"url": url, "spans": [], "error": str(e)})
            continue
        frag["url"] = url
        out.append(frag)
    return out


def discover(router_url: str, timeout: float = 5.0) -> list[str]:
    """→ [router_url, replica...] from the router's /healthz fleet
    block."""
    with urllib.request.urlopen(
            router_url.rstrip("/") + "/healthz", timeout=timeout) as r:
        doc = json.loads(r.read())
    replicas = ((doc.get("fleet") or {}).get("ring") or {}) \
        .get("replicas") or []
    return [router_url.rstrip("/")] + list(replicas)


def assemble(fragments: list[dict]) -> dict:
    """→ one Chrome trace-event document over every fragment's spans,
    deduped by span id; each source gets its own pid + process_name
    metadata row."""
    events = []
    seen: set = set()
    base = None
    for frag in fragments:
        for s in frag.get("spans") or ():
            if s["span_id"] in seen:
                continue
            ts = float(s.get("ts_unix") or 0.0)
            if base is None or ts < base:
                base = ts
    base = base or 0.0
    for pid, frag in enumerate(fragments, start=1):
        url = frag.get("url") or f"process-{pid}"
        added = False
        for s in frag.get("spans") or ():
            if s["span_id"] in seen:
                continue
            seen.add(s["span_id"])
            added = True
            events.append({
                "name": s["name"],
                "cat": "graftwatch",
                "ph": "X",
                "ts": round((float(s.get("ts_unix") or 0.0) - base)
                            * 1e6, 3),
                "dur": round(float(s.get("dur_ms") or 0.0) * 1e3, 3),
                "pid": pid,
                "tid": s.get("thread_id", 0),
                "args": {
                    "trace_id": s.get("trace_id", ""),
                    "span_id": s["span_id"],
                    "parent_id": s.get("parent_id", ""),
                    "cpu_ms": s.get("cpu_ms", 0.0),
                    **(s.get("attrs") or {}),
                },
            })
        if added:
            events.append({
                "name": "process_name", "ph": "M", "pid": pid,
                "tid": 0, "args": {"name": url},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def collect_trace(router_url: str, trace_id: str | None = None,
                  timeout: float = 5.0, urls=None,
                  token: str = "") -> dict:
    """Discover the fleet behind `router_url` (or use explicit
    `urls`), fetch every fragment, and assemble one document."""
    if urls is None:
        urls = discover(router_url, timeout)
    return assemble(fetch_fragments(urls, trace_id, timeout, token))


def fetch_debug(base_url: str, endpoint: str, token: str = "",
                timeout: float = 5.0) -> dict:
    """GET one process's token-gated /debug/<endpoint> payload."""
    req = urllib.request.Request(
        base_url.rstrip("/") + "/debug/" + endpoint,
        headers={"Trivy-Token": token} if token else {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _merge_tenant_tables(tables: list[dict]) -> dict:
    """Sum per-tenant totals rows across replica tables: numeric
    fields add, scans outcome maps add per outcome."""
    out: dict = {}
    for table in tables:
        for tenant, row in table.items():
            if not isinstance(row, dict):
                continue
            dst = out.setdefault(tenant, {"scans": {}})
            for field, v in row.items():
                if field == "scans":
                    for outcome, n in (v or {}).items():
                        dst["scans"][outcome] = \
                            dst["scans"].get(outcome, 0) + int(n)
                elif isinstance(v, (int, float)):
                    dst[field] = round(dst.get(field, 0) + v, 3)
    return out


def collect_costs(router_url: str, token: str = "",
                  timeout: float = 5.0, urls=None,
                  with_perf: bool = False) -> dict:
    """Discover the fleet behind `router_url` (or use explicit
    `urls`), pull every /debug/costs, and assemble one fleet-wide
    trivy-tpu-costs/1 document. Replica tenant tables merge; the
    router's fleet-scope table stays a source fragment only (it
    re-aggregates the replicas' relayed headers). Conservation folds
    across replica fragments: sums per axis, verdict ANDed — one
    leaking replica fails the fleet."""
    if urls is None:
        urls = discover(router_url, timeout)
    sources: list[dict] = []
    replica_tables: list[dict] = []
    cons_sum: dict = {}
    cons_seen = False
    for url in urls:
        try:
            frag = fetch_debug(url, "costs", token, timeout)
        except Exception as e:  # noqa: BLE001 — best-effort sweep
            sources.append({"url": url, "error": str(e)})
            continue
        frag["url"] = url
        sources.append(frag)
        if frag.get("scope") == "fleet":
            continue   # the router re-aggregates replica headers
        if isinstance(frag.get("tenants"), dict):
            replica_tables.append(frag["tenants"])
        cons = frag.get("conservation")
        if isinstance(cons, dict):
            cons_seen = True
            for axis in ("device_ms", "transfer_bytes"):
                rec = cons.get(axis) or {}
                dst = cons_sum.setdefault(
                    axis, {"ledger": 0, "attributed": 0, "ok": True})
                dst["ledger"] = round(
                    dst["ledger"] + rec.get("ledger", 0), 3)
                dst["attributed"] = round(
                    dst["attributed"] + rec.get("attributed", 0), 3)
                dst["ok"] = bool(dst["ok"] and rec.get("ok", False))
    doc = {
        "schema": "trivy-tpu-costs/1",
        "scope": "fleet-merged",
        "tenants": _merge_tenant_tables(replica_tables),
        "sources": sources,
    }
    if cons_seen:
        doc["conservation"] = cons_sum
    if with_perf:
        perf = []
        for url in urls:
            try:
                frag = fetch_debug(url, "perf", token, timeout)
            except Exception as e:  # noqa: BLE001
                perf.append({"url": url, "error": str(e)})
                continue
            frag["url"] = url
            perf.append(frag)
        doc["perf"] = perf
    return doc


def write_trace(path: str, doc: dict) -> None:
    import os
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m trivy_tpu_torch.obs.collect",
        description="assemble one Chrome/Perfetto trace across "
                    "processes (a server and its clients, or a "
                    "graftfleet router and its replicas)")
    ap.add_argument("--router", default="",
                    help="router base URL (replicas discovered via "
                         "its /healthz)")
    ap.add_argument("--trace-id", default="",
                    help="assemble one trace (default: every span "
                         "still in the fleet's flight recorders)")
    ap.add_argument("--url", action="append", default=[],
                    help="extra process URL to pull a fragment from "
                         "(repeatable)")
    ap.add_argument("-o", "--output", required=True,
                    help="output trace file (Perfetto / "
                         "chrome://tracing)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--costs", action="store_true",
                    help="assemble one fleet-wide trivy-tpu-costs/1 "
                         "document from every process's /debug/costs "
                         "instead of a trace")
    ap.add_argument("--perf", action="store_true",
                    help="embed each process's /debug/perf fragment "
                         "in the costs document (implies --costs)")
    ap.add_argument("--token", default="",
                    help="Trivy-Token for the token-gated /debug "
                         "endpoints (--costs/--perf)")
    args = ap.parse_args(argv)
    if not args.router and not args.url:
        ap.error("give --router or at least one --url")
    urls = (discover(args.router, args.timeout) if args.router
            else []) + list(args.url)
    if args.costs or args.perf:
        doc = collect_costs(args.router, args.token, args.timeout,
                            urls=urls, with_perf=args.perf)
        write_trace(args.output, doc)
        print(f"{len(doc['tenants'])} tenants from "
              f"{len(doc['sources'])} processes → {args.output}")
        return 0
    doc = collect_trace(args.router, args.trace_id or None,
                        args.timeout, urls=urls, token=args.token)
    write_trace(args.output, doc)
    print(f"{len(doc['traceEvents'])} events from {len(urls)} "
          f"processes → {args.output}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
