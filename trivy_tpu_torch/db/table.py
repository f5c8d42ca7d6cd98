"""Columnar advisory table: the device-resident flattening of trivy-db.

The same columns, flags and token encoding as the JAX package's table,
so a table flattened by either package joins identically in both.

The reference keeps advisories in nested BoltDB buckets and does random
access per package (trivy-db pkg/vulnsrc; fixture shape:
integration/testdata/fixtures/db/alpine.yaml). Here the whole DB is
flattened once at load time into hash-sorted arrays (SURVEY.md §7 step 2):

    hash[A, 2]      fnv1a64(source + "\\0" + pkg_name) as (hi, lo) int32
    lo_tok[A, K]    lower-bound version tokens
    hi_tok[A, K]    upper-bound version tokens
    flags[A]        interval shape + polarity + inexact bits (ops.constants)
    group[A]        advisory group id (one advisory may span several rows)

plus host-side metadata per group (vuln id, package name for collision
verification, report strings) and a vulnerability-detail dict for FillInfo
(reference pkg/vulnerability/vulnerability.go:60).
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import version as V
from ..ops import constants as C
from ..ops.hashing import key_hash, split_u64
from .constraints import ConstraintError, Interval, parse_constraint

KEY_WIDTH = V.KEY_WIDTH


@dataclass
class RawAdvisory:
    """One advisory as found in the source DB (one per (source, pkg, vuln))."""
    source: str                 # bucket, e.g. "alpine 3.9" or "pip::"
    ecosystem: str              # version scheme key, e.g. "alpine", "pip"
    pkg_name: str
    vuln_id: str
    fixed_version: str = ""     # OS style
    affected_version: str = ""  # OS style
    vulnerable_ranges: str = ""  # language style constraint set ("||" OR)
    patched_versions: str = ""   # language style
    unaffected_versions: str = ""
    status: str = ""
    severity: str = ""           # source-provided severity (e.g. distro)
    data_source: Optional[dict] = None
    vendor_ids: tuple = ()
    arches: tuple = ()           # Rocky/Alma: advisory applies per-arch
    cpe_indices: tuple = ()      # Red Hat: affected CPE index scope


@dataclass
class AdvisoryGroup:
    """Host metadata for one advisory (row group)."""
    source: str
    ecosystem: str
    pkg_name: str
    vuln_id: str
    fixed_version: str
    status: str
    severity: str
    data_source: Optional[dict]
    vendor_ids: tuple
    arches: tuple = ()
    cpe_indices: tuple = ()
    # raw bound strings per row for exact host recheck of inexact rows
    rows: list = field(default_factory=list)  # [(polarity, Interval)]
    # set when the constraint grammar wasn't interval-representable:
    # (vulnerable_ranges, patched_versions, unaffected_versions) raw
    # strings, evaluated host-side via constraints.eval_constraint with
    # the reference's IsVulnerable semantics (compare.go:21-55)
    raw_specs: Optional[tuple] = None


class AdvisoryTable:
    def __init__(self, hash_: np.ndarray, lo_tok, hi_tok, flags, group,
                 groups: list[AdvisoryGroup], window: int,
                 details: dict | None = None,
                 aux: dict | None = None):
        self.hash = hash_
        self.lo_tok = lo_tok
        self.hi_tok = hi_tok
        self.flags = flags
        self.group = group
        self.groups = groups
        # max rows sharing one hash — diagnostic only (real trivy-db is
        # violently skewed: the CSR pair join is sized per query, so this
        # no longer bounds any device shape)
        self.window = max(window, 1)
        self.details = details or {}
        # side tables that scope advisories at query time, e.g.
        # "Red Hat CPE" {repository/nvr → cpe indices}
        self.aux = aux or {}
        self.sources = sorted({g.source for g in groups})
        self._device: dict | None = None   # torch.device → tensors
        # one upload per device although the server's threads may ask
        # for the arrays at the same time
        self._device_lock = threading.Lock()
        self._hash_u64 = None
        self._digest: Optional[str] = None

    def sources_for_prefix(self, prefix: str) -> list[str]:
        """Buckets matching an ecosystem prefix — the columnar equivalent
        of the reference's prefix bucket scan (library/driver.go:111
        GetAdvisories("pip::", name))."""
        return [s for s in self.sources if s.startswith(prefix)]

    def __len__(self):
        return self.hash.shape[0]

    def nbytes_by_column(self) -> dict:
        """Per-column bytes of the flattened table: the dispatch
        ledger's `advisory_table.<col>` resident breakdown. `hash_u64`
        appears once the lookup view has been built."""
        cols = {"hash": self.hash, "lo_tok": self.lo_tok,
                "hi_tok": self.hi_tok, "flags": self.flags,
                "group": self.group}
        if self._hash_u64 is not None:
            cols["hash_u64"] = self._hash_u64
        return {name: int(arr.nbytes) for name, arr in cols.items()}

    def content_digest(self) -> str:
        """Deterministic digest of everything that feeds a result: the
        join arrays, the groups' report metadata, the FillInfo details
        and the side tables; the same value as the JAX package's table
        gives for the same rows. Computed once."""
        if self._digest is None:
            h = hashlib.sha256()
            for arr in (self.hash, self.lo_tok, self.hi_tok,
                        self.flags, self.group):
                h.update(str(arr.shape).encode())
                h.update(np.ascontiguousarray(arr).tobytes())
            for g in self.groups:
                h.update(f"{g.source}|{g.pkg_name}|{g.vuln_id}|"
                         f"{g.fixed_version}|{g.status}|{g.severity}|"
                         f"{g.raw_specs}\n".encode())
            h.update(json.dumps(self.details, sort_keys=True).encode())
            h.update(json.dumps(self.aux, sort_keys=True).encode())
            self._digest = "sha256:" + h.hexdigest()
        return self._digest

    @property
    def hash_u64(self) -> np.ndarray:
        """Sorted uint64 view of the (hi, lo) hash pairs for the host-side
        vectorized bucket lookup (np.searchsorted). The biased int32
        halves (ops.hashing.split_u64) are unbiased back here."""
        if self._hash_u64 is None:
            hi = (self.hash[:, 0].astype(np.int64) + (1 << 31)).astype(
                np.uint64)
            lo = (self.hash[:, 1].astype(np.int64) + (1 << 31)).astype(
                np.uint64)
            self._hash_u64 = (hi << np.uint64(32)) | lo
        return self._hash_u64

    def device_arrays(self, device):
        """(lo_tok, hi_tok, flags, lo_pre, hi_pre) as torch tensors on
        `device`, uploaded once per device and reused by every batch.
        lo_pre/hi_pre are the join kernel's [A, 4] prefix planes
        (ops.join.prefix_planes), which it reads first. Hashes stay on
        the host: the bucket lookup is a host searchsorted, and the join
        only reads version tokens and flags."""
        import torch

        from ..ops.join import prefix_planes
        device = torch.device(device)
        with self._device_lock:
            cached = self._device.get(device) if self._device else None
            if cached is None:
                lo, hi, flags = (torch.from_numpy(np.ascontiguousarray(x))
                                 .to(device)
                                 for x in (self.lo_tok, self.hi_tok,
                                           self.flags))
                cached = (lo, hi, flags, *prefix_planes(lo, hi))
                self._device = {**(self._device or {}), device: cached}
            return cached

    @classmethod
    def from_numpy(cls, hash_, lo_tok, hi_tok, flags, group, groups,
                   window: int = 1, details: dict | None = None,
                   aux: dict | None = None) -> "AdvisoryTable":
        """Build a table from another flattening's columns and group
        metadata: the way a table flattened by the JAX package carries
        across unchanged. `groups` holds either the saved-table dicts
        (the `.npz` meta format) or objects with AdvisoryGroup's
        attributes, whose `rows` are (polarity, interval) pairs."""
        return cls(np.asarray(hash_, np.int32), np.asarray(lo_tok, np.int32),
                   np.asarray(hi_tok, np.int32), np.asarray(flags, np.int32),
                   np.asarray(group, np.int32),
                   [_group_from(g) for g in groups], int(window),
                   details, aux)

    def save(self, path: str) -> None:
        """Write the columnar `.npz` that `load` (and the JAX package's
        AdvisoryTable.load) reads, to a temporary file of its own first
        and then renamed into place: a crash never leaves a truncated
        file under the name, and two writers never share a temp file."""
        import os
        import tempfile
        dest = path if path.endswith(".npz") else path + ".npz"
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest) or ".",
                                   prefix=os.path.basename(dest) + ".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                self._savez(f)
        except BaseException:
            os.unlink(tmp)
            raise
        os.replace(tmp, dest)

    def _savez(self, f) -> None:
        np.savez(
            f, hash=self.hash, lo_tok=self.lo_tok, hi_tok=self.hi_tok,
            flags=self.flags, group=self.group,
            meta=np.frombuffer(json.dumps({
                "window": self.window,
                "groups": [
                    {"source": g.source, "ecosystem": g.ecosystem,
                     "pkg_name": g.pkg_name, "vuln_id": g.vuln_id,
                     "fixed_version": g.fixed_version, "status": g.status,
                     "severity": g.severity, "data_source": g.data_source,
                     "vendor_ids": list(g.vendor_ids),
                     "arches": list(g.arches),
                     "cpe_indices": list(g.cpe_indices),
                     "raw_specs": list(g.raw_specs) if g.raw_specs
                     else None,
                     "rows": [[p, iv.lo, iv.lo_incl, iv.hi, iv.hi_incl]
                              for p, iv in g.rows]}
                    for g in self.groups],
                "details": self.details,
                "aux": self.aux,
            }).encode(), dtype=np.uint8))

    @classmethod
    def load(cls, path: str) -> "AdvisoryTable":
        """Read a columnar `.npz` table as the JAX package saves it."""
        z = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(z["meta"]).decode())
        return cls.from_numpy(z["hash"], z["lo_tok"], z["hi_tok"],
                              z["flags"], z["group"], meta["groups"],
                              meta["window"], meta.get("details", {}),
                              meta.get("aux", {}))


def _group_from(g) -> AdvisoryGroup:
    if not isinstance(g, dict):
        g = {
            "source": g.source, "ecosystem": g.ecosystem,
            "pkg_name": g.pkg_name, "vuln_id": g.vuln_id,
            "fixed_version": g.fixed_version, "status": g.status,
            "severity": g.severity, "data_source": g.data_source,
            "vendor_ids": g.vendor_ids, "arches": g.arches,
            "cpe_indices": g.cpe_indices, "raw_specs": g.raw_specs,
            "rows": [[p, iv.lo, iv.lo_incl, iv.hi, iv.hi_incl]
                     for p, iv in g.rows],
        }
    return AdvisoryGroup(
        source=g["source"], ecosystem=g["ecosystem"],
        pkg_name=g["pkg_name"], vuln_id=g["vuln_id"],
        fixed_version=g["fixed_version"], status=g["status"],
        severity=g["severity"], data_source=g["data_source"],
        vendor_ids=tuple(g["vendor_ids"]),
        arches=tuple(g.get("arches") or ()),
        cpe_indices=tuple(g.get("cpe_indices") or ()),
        raw_specs=tuple(g["raw_specs"]) if g.get("raw_specs") else None,
        rows=[(p, Interval(lo, li, hi, hi_i))
              for p, lo, li, hi, hi_i in g["rows"]])


def _encode_bound(ecosystem: str, v: Optional[str]):
    """→ (tokens or None, exact). None tokens means unparseable (drop row,
    matching the reference's skip-on-parse-failure)."""
    if not v:
        return None, True
    try:
        k = V.encode_version(ecosystem, v)
    except (ValueError, KeyError):
        return None, False
    return k.tokens, k.exact


def _flatten_advisory(adv: RawAdvisory, key_width: int,
                      pad_row: np.ndarray):
    """Flatten ONE advisory → (group, rows_out): constraint parsing and
    version-token encoding, pure in the advisory's content."""
    g = AdvisoryGroup(
        source=adv.source, ecosystem=adv.ecosystem,
        pkg_name=adv.pkg_name, vuln_id=adv.vuln_id,
        fixed_version=adv.fixed_version or _first_fixed(adv),
        status=adv.status, severity=adv.severity,
        data_source=adv.data_source, vendor_ids=adv.vendor_ids,
        arches=adv.arches, cpe_indices=adv.cpe_indices,
    )
    intervals: list[tuple[bool, Interval]] = []
    raw_fallback = False
    if adv.vulnerable_ranges:
        try:
            for iv in parse_constraint(adv.vulnerable_ranges):
                intervals.append((True, iv))
            for spec in (adv.patched_versions,
                         adv.unaffected_versions):
                if spec:
                    for iv in parse_constraint(spec):
                        intervals.append((False, iv))
        except ConstraintError:
            # grammar not interval-representable (caret/tilde/!=/
            # wildcards/empty member): one catch-all row, exact
            # host evaluation of the raw spec per pair — NEVER a
            # silent drop or mangled parse
            raw_fallback = True
    else:
        # OS-style: [affected, fixed) — unfixed when fixed_version == ""
        intervals.append((True, Interval(
            lo=adv.affected_version or None, lo_incl=True,
            hi=adv.fixed_version or None, hi_incl=False)))

    rows_out: list[tuple[np.ndarray, np.ndarray, int]] = []
    for positive, iv in ([] if raw_fallback else intervals):
        lo_tok, lo_exact = _encode_bound(adv.ecosystem, iv.lo)
        hi_tok, hi_exact = _encode_bound(adv.ecosystem, iv.hi)
        if (iv.lo and lo_tok is None) or (iv.hi and hi_tok is None):
            # bound string parsed but isn't token-encodable: the
            # whole advisory goes through the exact host path
            raw_fallback = bool(adv.vulnerable_ranges)
            if not raw_fallback:
                # OS-style: catch-all row, host recheck over g.rows
                g.rows = [(p, v) for p, v in intervals]
                rows_out = [(pad_row, pad_row, C.INEXACT)]
            break
        flags = 0
        if iv.lo:
            flags |= C.HAS_LO | (C.LO_INCL if iv.lo_incl else 0)
        if iv.hi:
            flags |= C.HAS_HI | (C.HI_INCL if iv.hi_incl else 0)
        if not (lo_exact and hi_exact):
            flags |= C.INEXACT
        if not positive:
            flags |= C.NEGATIVE
        rows_out.append((lo_tok if lo_tok is not None else pad_row,
                         hi_tok if hi_tok is not None else pad_row,
                         flags))
        g.rows.append((positive, iv))
    if adv.vulnerable_ranges:
        # language advisories always carry their raw constraint
        # strings: host rechecks (inexact tokens, npm prerelease
        # queries) evaluate the reference's IsVulnerable semantics
        # directly instead of the interval approximation
        g.raw_specs = (adv.vulnerable_ranges, adv.patched_versions,
                       adv.unaffected_versions)
    if raw_fallback:
        g.rows = []
        rows_out = [(pad_row, pad_row, C.INEXACT)]
    return g, rows_out


def build_table(raw: list[RawAdvisory], details: dict | None = None,
                key_width: int = KEY_WIDTH,
                aux: dict | None = None) -> AdvisoryTable:
    """Flatten raw advisories into the sorted columnar table."""
    hash_vals: list[int] = []
    lo_rows: list[np.ndarray] = []
    hi_rows: list[np.ndarray] = []
    flag_rows: list[int] = []
    group_rows: list[int] = []
    groups: list[AdvisoryGroup] = []
    pad_row = np.full(key_width, 1, dtype=np.int32)  # PAD

    for adv in raw:
        g, rows_out = _flatten_advisory(adv, key_width, pad_row)
        gid = len(groups)
        h = key_hash(adv.source, adv.pkg_name)
        for lo_tok, hi_tok, flags in rows_out:
            hash_vals.append(h)
            lo_rows.append(lo_tok)
            hi_rows.append(hi_tok)
            flag_rows.append(flags)
            group_rows.append(gid)
        if rows_out:
            groups.append(g)

    if not hash_vals:
        empty = np.zeros((0, 2), dtype=np.int32)
        return AdvisoryTable(empty, np.zeros((0, key_width), np.int32),
                             np.zeros((0, key_width), np.int32),
                             np.zeros(0, np.int32), np.zeros(0, np.int32),
                             [], 1, details, aux)

    hashes = split_u64(hash_vals)                       # [A, 2]
    order = np.lexsort((hashes[:, 1], hashes[:, 0]))
    hashes = hashes[order]
    lo_tok = np.stack(lo_rows)[order]
    hi_tok = np.stack(hi_rows)[order]
    flags = np.asarray(flag_rows, np.int32)[order]
    group = np.asarray(group_rows, np.int32)[order]

    # window = max rows sharing one hash (bucket size)
    _, counts = np.unique(hashes.view([("hi", np.int32), ("lo", np.int32)]),
                          return_counts=True)
    window = int(counts.max())

    return AdvisoryTable(hashes, lo_tok, hi_tok, flags, group,
                         groups, window, details, aux)


def _first_fixed(adv: RawAdvisory) -> str:
    """Language advisories format PatchedVersions — RAW specs, comma-
    joined and uniq'd — as the report FixedVersion; with no patched
    list, the '< x' upper bounds of the vulnerable ranges stand in
    (reference pkg/detector/library/driver.go createFixedVersions)."""
    if adv.patched_versions:
        vers = [t.strip() for t in adv.patched_versions.split("||")]
        return ", ".join(dict.fromkeys(v for v in vers if v))
    out = []
    for version in (adv.vulnerable_ranges or "").split("||"):
        for spec in version.split(","):
            spec = spec.strip()
            if spec.startswith("<") and not spec.startswith("<="):
                out.append(spec[1:].strip())
    return ", ".join(dict.fromkeys(out))
