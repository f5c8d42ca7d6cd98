"""LibraryIndex: batched library-version detection on the advisory join.

Third-party-library detection has the shape of CVE matching: a corpus
maps fingerprint tokens (per-version build signatures) to (library,
version) pairs, and an observed binary's tokens are looked up against
it. That lookup is the hash-sorted columnar join the detector already
runs for advisories, so a fingerprint corpus flattens into the
`AdvisoryTable` arrays and detection goes through `BatchDetector` and
its join kernels, with no device code of its own.

Encoding:

  bucket (source)   `libfp::<corpus>`: prefix-scannable like the
                    ecosystems' `pip::` buckets, and disjoint from every
                    advisory source.
  pkg_name          the fingerprint token (the join key).
  vuln_id           `<library>@<version>`: a hit names one library
                    version that contains the token.
  constraint        `>=v, <=v`: the exact-version interval.

A query carries the DECLARED version (from a purl or lockfile): a hit
confirms the declaration; an observation whose tokens hit only other
versions exposes a lying purl. `oracle` recomputes the same hits from
first principles with NumPy, for the parity tests.

The port's copy of the JAX package's module, with its metrics and its
resident-memory ledger, without the `libscan.flatten` failpoint.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from .. import version as V
from ..db.table import AdvisoryTable, RawAdvisory, build_table
from ..metrics import METRICS
from ..obs.perf import LEDGER

# version scheme of corpus versions; "semver" covers the java and native
# library corpora of the fingerprint literature
LIB_ECOSYSTEM = "semver"

SOURCE_PREFIX = "libfp::"


@dataclass(frozen=True)
class LibraryFingerprint:
    """One corpus record: `token` (a per-version build signature)
    observed in `library` at exactly `version`."""
    corpus: str
    library: str
    version: str
    token: str


@dataclass(frozen=True)
class LibraryObservation:
    """One observed token with the version its container DECLARES (purl,
    lockfile, SBOM component). `ref` rides through to the hits, like
    PkgQuery.ref."""
    corpus: str
    token: str
    declared_version: str
    ref: object = None


def corpus_source(corpus: str) -> str:
    return SOURCE_PREFIX + corpus


class LibraryIndex:
    """A fingerprint corpus flattened into AdvisoryTable arrays."""

    def __init__(self, table: AdvisoryTable,
                 fingerprints: tuple[LibraryFingerprint, ...]):
        self.table = table
        self.fingerprints = fingerprints

    @classmethod
    def build(cls, fingerprints,
              key_width: int = V.KEY_WIDTH) -> "LibraryIndex":
        # dedup in a fixed order: the table digest must not depend on
        # the order the corpus came in
        fps = tuple(sorted(set(fingerprints),
                           key=lambda f: (f.corpus, f.token,
                                          f.library, f.version)))
        raw = [RawAdvisory(
            source=corpus_source(f.corpus),
            ecosystem=LIB_ECOSYSTEM,
            pkg_name=f.token,
            vuln_id=f"{f.library}@{f.version}",
            vulnerable_ranges=f">={f.version}, <={f.version}",
            status="identified",
            data_source={"ID": "libfp", "Name": f.corpus},
        ) for f in fps]
        table = build_table(raw, details={}, key_width=key_width)
        METRICS.inc("trivy_tpu_libscan_fingerprints_total", float(len(fps)))
        LEDGER.note_resident("library_index", int(
            table.hash.nbytes + table.lo_tok.nbytes + table.hi_tok.nbytes
            + table.flags.nbytes + table.group.nbytes))
        return cls(table, fps)

    def content_digest(self) -> str:
        """Salted table digest: a LibraryIndex and a CVE table built from
        identical arrays must not collide."""
        h = hashlib.sha256(b"libfp|")
        h.update(self.table.content_digest().encode())
        return "sha256:" + h.hexdigest()

    def corpora(self) -> list[str]:
        return sorted({f.corpus for f in self.fingerprints})

    def queries(self, observations) -> list:
        """Observations → PkgQuery rows for BatchDetector. Unversioned
        observations are skipped (nothing to verify; they are absent
        from the hit map)."""
        from .engine import PkgQuery
        out = [PkgQuery(source=corpus_source(obs.corpus),
                        ecosystem=LIB_ECOSYSTEM, name=obs.token,
                        version=obs.declared_version, ref=obs)
               for obs in observations if obs.declared_version]
        METRICS.inc("trivy_tpu_libscan_queries_total", float(len(out)))
        return out

    @staticmethod
    def confirmations(hits) -> dict:
        """Hits → {observation: sorted [(library, version)]}: the
        library versions consistent with each observation's token and
        declared version."""
        out: dict = {}
        for h in hits:
            lib, _, ver = h.vuln_id.rpartition("@")
            out.setdefault(h.query.ref, []).append((lib, ver))
        return {k: sorted(set(v)) for k, v in out.items()}

    def detect(self, detector, observations) -> dict:
        """One batched round trip: observations → queries → the
        detector's join → confirmation map."""
        return self.confirmations(detector.detect(
            self.queries(observations)))

    def oracle(self, observations) -> dict:
        """Brute-force NumPy mirror of `detect`: encode every corpus
        version and every declared version with the table's tokenizer
        and confirm by exact token-vector equality, with the host
        comparator for inexact encodings (the table's own recheck)."""
        width = self.table.lo_tok.shape[1]
        enc: dict = {}

        def key(ver: str):
            if ver not in enc:
                try:
                    enc[ver] = V.encode_version(LIB_ECOSYSTEM, ver, width)
                except (ValueError, KeyError):
                    # an unparseable declared version gives no hit, as
                    # the detector skips it (engine._ver_index)
                    enc[ver] = None
            return enc[ver]

        by_token: dict = {}
        for f in self.fingerprints:
            by_token.setdefault((f.corpus, f.token), []).append(f)
        out: dict = {}
        for obs in observations:
            if not obs.declared_version:
                continue
            qk = key(obs.declared_version)
            if qk is None:
                continue
            pairs = []
            for f in by_token.get((obs.corpus, obs.token), ()):
                fk = key(f.version)
                if fk is None:
                    continue
                if qk.exact and fk.exact:
                    same = bool(np.array_equal(qk.tokens, fk.tokens))
                else:
                    same = V.compare(LIB_ECOSYSTEM, obs.declared_version,
                                     f.version) == 0
                if same:
                    pairs.append((f.library, f.version))
            if pairs:
                out[obs] = sorted(set(pairs))
        return out
