"""Strict Prometheus text-exposition parser (format 0.0.4).

The port's copy of the JAX package's obs/exposition.py: the port's
tests and `chip_smoke.py` hold every /metrics payload to it, so both
packages enforce ONE definition of "strict".

The scraper is forgiving; this parser is not. A malformed family,
label escape, or histogram inconsistency raises ValueError so a bad
series fails the caller instead of the production scraper:

  * samples must follow their family's `# TYPE` line (no duplicate
    TYPE, no TYPE after samples);
  * label blocks parse with full exposition escaping (\\\\, \\", \\n),
    no duplicate labels, no junk;
  * histogram families emit only `_bucket`/`_sum`/`_count` children,
    with per-label-set bucket ordering + cumulativity, a `+Inf`
    bucket, and `_count` equal to it.
"""

from __future__ import annotations

import math
import re

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_SAMPLE_RE = re.compile(
    r"(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>\S+)(?: (?P<ts>-?\d+))?\Z")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _parse_label_block(block: str) -> dict:
    """Parse `a="x",b="y"` with exposition escaping (\\\\, \\", \\n)."""
    labels = {}
    i, n = 0, len(block)
    while i < n:
        eq = block.index("=", i)
        name = block[i:eq]
        if not _NAME_RE.match(name):
            raise ValueError(f"bad label name {name!r}")
        if eq + 1 >= n or block[eq + 1] != '"':
            raise ValueError(f"label {name}: value not quoted")
        j = eq + 2
        out = []
        while True:
            if j >= n:
                raise ValueError(f"label {name}: unterminated value")
            c = block[j]
            if c == "\\":
                if j + 1 >= n:
                    raise ValueError(f"label {name}: dangling escape")
                nxt = block[j + 1]
                if nxt == "n":
                    out.append("\n")
                elif nxt in ('"', "\\"):
                    out.append(nxt)
                else:
                    raise ValueError(
                        f"label {name}: bad escape \\{nxt}")
                j += 2
            elif c == '"':
                j += 1
                break
            else:
                out.append(c)
                j += 1
        if name in labels:
            raise ValueError(f"duplicate label {name}")
        labels[name] = "".join(out)
        if j < n:
            if block[j] != ",":
                raise ValueError(f"junk after label {name}")
            j += 1
        i = j
    return labels


def _parse_value(raw: str) -> float:
    if raw in ("+Inf", "Inf"):
        return math.inf
    if raw == "-Inf":
        return -math.inf
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"bad sample value {raw!r}") from None


def parse_exposition(text: str) -> dict:
    """Strictly parse Prometheus text exposition format 0.0.4.

    → {family: {"type": str, "help": str | None,
                "samples": [(sample_name, {labels}, value)]}}

    Raises ValueError on malformed lines, samples without a preceding
    # TYPE, sample names that don't belong to their family (histogram
    children must be _bucket/_sum/_count), duplicate TYPE lines, and
    histogram inconsistencies: unordered or non-cumulative buckets,
    missing le="+Inf", or +Inf bucket ≠ _count.
    """
    families: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if not _NAME_RE.match(name):
                raise ValueError(f"line {lineno}: bad HELP name")
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []})
            fam["help"] = re.sub(
                r"\\(n|\\)",
                lambda m: "\n" if m.group(1) == "n" else "\\",
                help_text)
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ")
            if len(parts) != 2 or not _NAME_RE.match(parts[0]) \
                    or parts[1] not in _TYPES:
                raise ValueError(f"line {lineno}: bad TYPE line")
            name, kind = parts
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []})
            if fam["type"] is not None:
                raise ValueError(f"line {lineno}: duplicate TYPE {name}")
            if fam["samples"]:
                raise ValueError(
                    f"line {lineno}: TYPE {name} after its samples")
            fam["type"] = kind
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample "
                             f"{line!r}")
        sname = m.group("name")
        labels = _parse_label_block(m.group("labels") or "")
        value = _parse_value(m.group("value"))
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) \
                    and sname[:-len(suffix)] in families \
                    and families[sname[:-len(suffix)]]["type"] \
                    in ("histogram", "summary"):
                base = sname[:-len(suffix)]
                break
        fam = families.get(base)
        if fam is None or fam["type"] is None:
            raise ValueError(
                f"line {lineno}: sample {sname} without # TYPE")
        if fam["type"] == "histogram" and base == sname:
            # (summary families legally emit bare-name quantile
            # samples; only histograms are restricted to children)
            raise ValueError(
                f"line {lineno}: bare sample {sname} for "
                f"histogram family")
        fam["samples"].append((sname, labels, value))

    for name, fam in families.items():
        if fam["type"] == "histogram":
            _check_histogram(name, fam["samples"])
    return families


def _check_histogram(name: str, samples: list) -> None:
    """Bucket cumulativity, +Inf presence, _sum/_count consistency —
    per label set (ignoring le)."""
    series: dict = {}
    for sname, labels, value in samples:
        rest = tuple(sorted((k, v) for k, v in labels.items()
                            if k != "le"))
        slot = series.setdefault(
            rest, {"buckets": [], "sum": None, "count": None})
        if sname == f"{name}_bucket":
            if "le" not in labels:
                raise ValueError(f"{name}: bucket without le label")
            slot["buckets"].append((_parse_value(labels["le"]), value))
        elif sname == f"{name}_sum":
            slot["sum"] = value
        elif sname == f"{name}_count":
            slot["count"] = value
    for rest, slot in series.items():
        buckets = slot["buckets"]
        if not buckets:
            raise ValueError(f"{name}{dict(rest)}: no buckets")
        edges = [e for e, _ in buckets]
        if edges != sorted(edges):
            raise ValueError(f"{name}{dict(rest)}: le out of order")
        counts = [c for _, c in buckets]
        if any(b > a for a, b in zip(counts[1:], counts)):
            raise ValueError(
                f"{name}{dict(rest)}: buckets not cumulative")
        if not math.isinf(edges[-1]):
            raise ValueError(f"{name}{dict(rest)}: missing le=\"+Inf\"")
        if slot["count"] is None or slot["sum"] is None:
            raise ValueError(f"{name}{dict(rest)}: missing _sum/_count")
        if slot["count"] != counts[-1]:
            raise ValueError(
                f"{name}{dict(rest)}: _count {slot['count']} != +Inf "
                f"bucket {counts[-1]}")
