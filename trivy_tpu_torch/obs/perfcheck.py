"""``python -m trivy_tpu_torch.obs.perfcheck OLD.json NEW.json`` — the
perf-regression gate.

ROADMAP's standing caveat is that perf PRs ship with no way to tell a
real regression from bench noise: the bench trajectory holds one JSON
tail per round and comparing them is eyeball work. This gate makes the
comparison mechanical and noise-aware, so a recorded device round
becomes a baseline the fleet can actually hold:

  * both inputs are bench tails — the single JSON object bench.py
    prints (a BENCH_rXX.json wrapper with a ``parsed`` object is
    unwrapped automatically). Schema problems (not an object, no
    numeric metrics, NaN/Inf values) exit 2 — a malformed baseline
    must fail loudly, not silently compare nothing;
  * metrics are the numeric leaves, addressed by dotted path
    (``secrets.secret_mbps_device``). Direction is inferred from the
    name: throughput-shaped metrics (``*_per_sec``, ``*mbps``,
    ``*throughput*``, ``*speedup*``, ``*ips*``, ``*hit_rate*``) must
    not drop, latency/cost-shaped ones (``*_ms``, ``*_s``, ``*p99*``,
    ``*bytes*``, ``*waste*``, ``*compile*``, ``*shed*``, ``*failed*``)
    must not rise; unclassifiable names are reported but never gate.
    A few leaves carry a HARD cap gated on the new value alone
    (``cost_overhead_pct`` < 2 — graftcost attribution must stay
    nearly free), because relative compare against a near-zero
    healthy baseline pages on jitter;
  * noise awareness: a leaf that is a LIST of numbers is a repeat
    spread — the comparison uses medians and widens the bound by
    k·MAD/|median| (median absolute deviation, robust to one bad
    repeat), so a delta inside the scenario's own observed spread
    never pages. Scalars use the flat relative threshold
    (``--threshold``, default 10%);
  * allow-list: ``--allow metric=reason`` (repeatable) or
    ``--allow-file FILE`` (``{"allow": [{"metric":..., "reason":...}]}``)
    waives a KNOWN regression — every entry must carry a reason, ; a reason-less waiver exits 2.

Exit codes: 0 clean (or all regressions allow-listed), 1 unwaived
regression, 2 malformed input / bad allow-list.
"""

from __future__ import annotations

import json
import math

# name fragments that classify a metric's good direction; HIGHER is
# checked first so "mb_s" / "per_sec" never fall through to the
# lower-better "_s" suffix rule
_HIGHER = ("per_sec", "mbps", "mb_s", "throughput", "speedup",
           "hit_rate", "ips", "occupancy")
_LOWER_FRAGMENTS = ("p99", "p50", "latency", "waste", "shed", "lost",
                    "failed", "compile", "overflow", "stall",
                    "overhead")
_LOWER_SUFFIXES = ("_ms", "_s", "_seconds", "_bytes")

# hard ceilings, gated on the NEW value alone: a percentage that must
# simply stay small (graftcost's attribution overhead) has a near-zero
# healthy baseline, and relative compare against near-zero turns every
# jitter into a page — these leaves skip the relative gate and fail
# only when the fresh round exceeds the cap
_ABS_CAPS = {"cost_overhead_pct": 2.0}


class SchemaError(ValueError):
    """The input is not a valid bench tail."""


def _classify(name: str) -> str | None:
    for frag in _HIGHER:
        if frag in name:
            return "higher"
    for frag in _LOWER_FRAGMENTS:
        if frag in name:
            return "lower"
    if name.endswith(_LOWER_SUFFIXES) or "bytes" in name:
        return "lower"
    return None


def direction(path: str) -> str | None:
    """→ "higher" | "lower" | None for one dotted metric path. The
    leaf name decides first; an unclassifiable leaf inherits from the
    full path (so `graftprof.transfer_bytes.dense` reads as byte-
    shaped even though its leaf is just the path label)."""
    leaf = _classify(path.rsplit(".", 1)[-1].lower())
    if leaf is not None:
        return leaf
    return _classify(path.lower())


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def flatten(doc: dict, prefix: str = "") -> dict:
    """→ {dotted_path: float | [float, ...]} over the tail's numeric
    leaves; a list kept whole is a repeat spread. Non-finite values
    raise SchemaError — a NaN baseline gates nothing."""
    out: dict = {}
    for key, v in doc.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        elif _is_num(v):
            if not math.isfinite(v):
                raise SchemaError(f"{path}: non-finite value {v!r}")
            out[path] = float(v)
        elif isinstance(v, list) and v and all(_is_num(x) for x in v):
            vals = [float(x) for x in v]
            if any(not math.isfinite(x) for x in vals):
                raise SchemaError(f"{path}: non-finite repeat value")
            out[path] = vals
    return out


def load_tail(path: str) -> dict:
    """Read one bench tail → its flat metric map. Raises SchemaError
    on anything that is not a usable tail."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SchemaError(f"{path}: unreadable: {e}") from None
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]   # a BENCH_rXX.json record wraps its tail
    if not isinstance(doc, dict):
        raise SchemaError(f"{path}: top level is not an object")
    flat = flatten(doc)
    if not flat:
        raise SchemaError(f"{path}: no numeric metrics in tail")
    return flat


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _mad(xs: list[float]) -> float:
    """Median absolute deviation — robust spread of a repeat list."""
    m = _median(xs)
    return _median([abs(x - m) for x in xs])


def _value_and_noise(v) -> tuple[float, float]:
    """→ (comparison value, absolute noise scale): scalars carry no
    self-described noise; repeat lists compare by median with their
    MAD as the noise scale."""
    if isinstance(v, list):
        return _median(v), _mad(v)
    return v, 0.0


def compare(old: dict, new: dict, threshold: float = 0.10,
            mad_k: float = 3.0) -> dict:
    """Diff two flat metric maps. → {"regressions": [...],
    "improvements": [...], "unclassified": [...], "missing": [...],
    "checked": n}. A metric regresses when it moved in its bad
    direction by more than max(threshold, mad_k·MAD/|median|) —
    the per-scenario repeat spread widens the bound, never narrows
    it."""
    regressions, improvements, unclassified, missing = [], [], [], []
    capped = []
    checked = 0
    # cap pass over NEW: gate capped leaves on their absolute ceiling,
    # even when the metric has no baseline yet (a fresh scenario's
    # first round must still respect the cap)
    for path in sorted(new):
        cap = _ABS_CAPS.get(path.rsplit(".", 1)[-1].lower())
        if cap is None:
            continue
        nv, _ = _value_and_noise(new[path])
        checked += 1
        if nv > cap:
            capped.append({"metric": path, "value": nv, "cap": cap})
    for path in sorted(old):
        if path not in new:
            missing.append(path)
            continue
        if path.rsplit(".", 1)[-1].lower() in _ABS_CAPS:
            continue   # gated by the cap pass, not relative drift
        d = direction(path)
        ov, onoise = _value_and_noise(old[path])
        nv, nnoise = _value_and_noise(new[path])
        if d is None:
            if ov != nv:
                unclassified.append({"metric": path, "old": ov,
                                     "new": nv})
            continue
        checked += 1
        scale = max(abs(ov), 1e-12)
        delta = (ov - nv) if d == "higher" else (nv - ov)
        rel = delta / scale
        noise_rel = mad_k * max(onoise, nnoise) / scale
        bound = max(threshold, noise_rel)
        entry = {"metric": path, "old": ov, "new": nv,
                 "direction": d, "change": round(-rel, 4)
                 if d == "higher" else round(rel, 4),
                 "bound": round(bound, 4)}
        if rel > bound:
            regressions.append(entry)
        elif rel < -bound:
            improvements.append(entry)
    return {"regressions": regressions, "improvements": improvements,
            "capped": capped, "unclassified": unclassified,
            "missing": missing, "checked": checked}


def load_allowlist(allow_args: list[str],
                   allow_file: str | None) -> dict[str, str]:
    """→ {metric: reason}. Every waiver MUST carry a non-empty reason —
    raises SchemaError
    otherwise."""
    allow: dict[str, str] = {}
    if allow_file:
        try:
            with open(allow_file) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise SchemaError(
                f"--allow-file {allow_file}: unreadable: {e}") from None
        entries = doc.get("allow") if isinstance(doc, dict) else None
        if not isinstance(entries, list):
            raise SchemaError(f"--allow-file {allow_file}: expected "
                              f'{{"allow": [...]}}')
        for i, e in enumerate(entries):
            if not isinstance(e, dict) or not e.get("metric"):
                raise SchemaError(
                    f"--allow-file entry {i}: missing metric")
            if not str(e.get("reason") or "").strip():
                raise SchemaError(
                    f"--allow-file entry {e['metric']!r}: every "
                    f"waiver must carry a reason")
            allow[str(e["metric"])] = str(e["reason"])
    for spec in allow_args:
        metric, sep, reason = spec.partition("=")
        if not sep or not metric or not reason.strip():
            raise SchemaError(
                f"--allow {spec!r}: expected metric=reason (the "
                f"reason is required)")
        allow[metric] = reason
    return allow


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m trivy_tpu_torch.obs.perfcheck",
        description="diff two bench-tail JSON documents with "
                    "noise-aware bounds; exit 1 on an unwaived "
                    "regression, 2 on malformed input")
    ap.add_argument("old", metavar="OLD.json")
    ap.add_argument("new", metavar="NEW.json")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="flat relative regression bound for metrics "
                         "without a repeat spread (default 0.10)")
    ap.add_argument("--mad-k", type=float, default=3.0,
                    help="repeat-spread widening: bound = max("
                         "threshold, K*MAD/|median|) (default 3.0)")
    ap.add_argument("--allow", action="append", default=[],
                    metavar="METRIC=REASON",
                    help="waive one known regression (reason "
                         "required; repeatable)")
    ap.add_argument("--allow-file", default="",
                    help='JSON allow-list: {"allow": [{"metric": ..., '
                         '"reason": ...}]}')
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the improvement/summary lines")
    args = ap.parse_args(argv)
    try:
        allow = load_allowlist(args.allow, args.allow_file or None)
        old = load_tail(args.old)
        new = load_tail(args.new)
    except SchemaError as e:
        print(f"perfcheck: {e}")
        return 2
    report = compare(old, new, threshold=args.threshold,
                     mad_k=args.mad_k)
    failed = []
    for r in report["regressions"]:
        reason = allow.get(r["metric"])
        if reason is not None:
            print(f"ALLOWED  {r['metric']}: {r['old']} -> {r['new']} "
                  f"({r['change']:+.1%} vs bound {r['bound']:.1%}) — "
                  f"{reason}")
        else:
            failed.append(r)
            print(f"REGRESS  {r['metric']}: {r['old']} -> {r['new']} "
                  f"({r['change']:+.1%}, bound {r['bound']:.1%})")
    for r in report["capped"]:
        reason = allow.get(r["metric"])
        if reason is not None:
            print(f"ALLOWED  {r['metric']}: {r['value']} over cap "
                  f"{r['cap']} — {reason}")
        else:
            failed.append(r)
            print(f"REGRESS  {r['metric']}: {r['value']} exceeds "
                  f"hard cap {r['cap']}")
    if not args.quiet:
        for r in report["improvements"]:
            print(f"improve  {r['metric']}: {r['old']} -> {r['new']} "
                  f"({r['change']:+.1%})")
        for path in report["missing"]:
            print(f"missing  {path}: present in OLD, absent in NEW "
                  f"(scenario skipped?)")
        flagged = len(report["regressions"]) + len(report["capped"])
        print(f"perfcheck: {report['checked']} metrics checked, "
              f"{len(failed)} regression(s), "
              f"{flagged - len(failed)} allowed, "
              f"{len(report['improvements'])} improvement(s)")
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
