"""SBOM documents as scan artifacts.

An SBOM scan has no walk: the document IS the package inventory, so
`SBOMArtifact.inspect()` decodes it into one `BlobInfo` and the detect
path behind it is the one every scan takes.

  content address   ONE blob keyed by the document digest (sha256 of
                    the raw bytes) and the decoder version
                    (`DECODER_VERSIONS`), as analyzer versions key a
                    layer, so a decoder fix re-keys every SBOM blob.
  identity          `blob.diff_id` is the document digest; the applier
                    stamps it on every package as its layer.
  containment       malformed JSON, unknown formats, lying component
                    data and byte, component or depth budget trips give
                    a deterministic annotated partial (`IngestErrors`)
                    under a salted id (`partial_blob_id`), so the
                    canonical key stays missing. `inspect()` never
                    raises on the document's content.

This is the port's copy of the JAX package's module without its
supervision: no parse watchdog, no parse breaker, no failpoints, no
metrics and no cost accounting, which the port does not carry (the
breaker and failpoints by its design, ROADMAP "not ported"). So the
`timeout`, `error` and `breaker_open` annotations of the JAX package
cannot arise here; every input fault gives the same annotations and the
same salted id as there.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

from .. import types as T
from ..fanal.cache import cache_key
from ..fanal.ingest import ingest_error, partial_blob_id

PARSE_SITE = "sbom.parse"

# the decoder's version, as an analyzer's: bumping it re-keys every
# cached SBOM blob (v2: epoch-prefix parsing and the distro-family purl
# type mapping)
DECODER_VERSIONS = {"sbom": 2}


@dataclass
class SBOMOptions:
    """Hostile-input budgets, sized so that no real document trips them
    while a crafted one stays bounded. (The JAX package's parse deadline
    has no counterpart: the port has no parse watchdog.)"""
    max_doc_bytes: int = 64 << 20     # raw document byte budget
    max_components: int = 100_000     # component/package count budget
    max_depth: int = 200              # JSON nesting budget


_DEFAULT_OPTS = SBOMOptions()


def doc_digest(raw: bytes) -> str:
    """The SBOM's content address: sha256 of the raw document bytes, not
    of the decoded blob, so duplicate documents share one key before any
    parsing."""
    return "sha256:" + hashlib.sha256(raw).hexdigest()


def json_depth(doc, limit: int) -> int:
    """Iterative nesting depth, capped at `limit`+1: a crafted deep
    document costs neither a full walk nor a recursion."""
    deepest = 0
    stack = [(doc, 1)]
    while stack:
        node, d = stack.pop()
        if d > deepest:
            deepest = d
        if d > limit:
            return d
        if isinstance(node, dict):
            stack.extend((v, d + 1) for v in node.values())
        elif isinstance(node, list):
            stack.extend((v, d + 1) for v in node)
    return deepest


class SBOMArtifact:
    """One SBOM document → one content-addressed blob and artifact."""

    def __init__(self, raw: bytes, cache, name: str = "",
                 opts: SBOMOptions | None = None):
        self.raw = raw
        self.cache = cache
        self.name = name
        self.opts = opts or _DEFAULT_OPTS
        self.digest = doc_digest(raw)
        self.format = ""          # set by the decode: cyclonedx | spdx-json

    @classmethod
    def from_doc(cls, doc: dict, cache, name: str = "",
                 opts: SBOMOptions | None = None) -> "SBOMArtifact":
        """For a document already parsed: the content address is its
        canonical JSON, stable across key order."""
        raw = json.dumps(doc, sort_keys=True,
                         separators=(",", ":")).encode()
        return cls(raw, cache, name=name, opts=opts)

    def _parse_doc(self, errors: list) -> dict | None:
        """Raw bytes → document dict, or None with the fault annotated."""
        opts = self.opts
        if len(self.raw) > opts.max_doc_bytes:
            errors.append(ingest_error(
                PARSE_SITE, "budget.doc_bytes",
                f"document is {len(self.raw)} bytes "
                f"(budget {opts.max_doc_bytes})"))
            return None
        try:
            text = self.raw.decode("utf-8", errors="strict")
        except UnicodeDecodeError as e:
            errors.append(ingest_error(PARSE_SITE, "encoding",
                                       f"not UTF-8: {e}"))
            return None
        try:
            doc = json.loads(text)
        except RecursionError:
            errors.append(ingest_error(
                PARSE_SITE, "budget.depth",
                "document nesting exceeded the parser's limit"))
            return None
        except json.JSONDecodeError as e:
            if "SPDXVersion:" in text:
                from .spdx import parse_tag_value
                try:
                    return parse_tag_value(text)
                except Exception as e2:  # noqa: BLE001 — contained
                    errors.append(ingest_error(
                        PARSE_SITE, "malformed",
                        f"SPDX tag-value: {type(e2).__name__}: {e2}"))
                    return None
            errors.append(ingest_error(
                PARSE_SITE, "malformed",
                f"not JSON (line {e.lineno}): {e.msg}"))
            return None
        if not isinstance(doc, dict):
            errors.append(ingest_error(
                PARSE_SITE, "malformed",
                f"top-level {type(doc).__name__}, want object"))
            return None
        if json_depth(doc, opts.max_depth) > opts.max_depth:
            errors.append(ingest_error(
                PARSE_SITE, "budget.depth",
                f"document nesting exceeds {opts.max_depth} levels"))
            return None
        return doc

    def _clamp_components(self, doc: dict, errors: list) -> dict:
        """Component-bomb budget: decode a deterministic prefix and
        annotate, instead of walking an unbounded list."""
        cap = self.opts.max_components
        for key in ("components", "packages"):
            items = doc.get(key)
            if isinstance(items, list) and len(items) > cap:
                errors.append(ingest_error(
                    PARSE_SITE, "budget.components",
                    f"{len(items)} {key} (budget {cap}); "
                    f"first {cap} decoded"))
                doc = dict(doc)
                doc[key] = items[:cap]
        return doc

    def _decode(self, errors: list) -> T.BlobInfo:
        """Document bytes → BlobInfo; every input fault is an
        annotation, never an exception."""
        from .cyclonedx import decode_cyclonedx
        from .io import detect_format, unwrap_attestation
        from .spdx import decode_spdx

        doc = self._parse_doc(errors)
        if doc is None:
            return T.BlobInfo()
        try:
            doc = unwrap_attestation(doc)
            self.format = detect_format(doc)
        except ValueError as e:
            errors.append(ingest_error(PARSE_SITE, "format", str(e)))
            return T.BlobInfo()
        doc = self._clamp_components(doc, errors)
        try:
            detail = (decode_cyclonedx(doc)
                      if self.format == "cyclonedx"
                      else decode_spdx(doc))
        except Exception as e:  # noqa: BLE001 — lying document data
            errors.append(ingest_error(
                PARSE_SITE, "decode_error",
                f"{type(e).__name__}: {e}"))
            return T.BlobInfo()
        return T.BlobInfo(
            os=detail.os,
            package_infos=[T.PackageInfo(packages=detail.packages)]
            if detail.packages else [],
            applications=detail.applications)

    def inspect(self):
        """→ ArtifactReference. A degraded decode is cached under a
        salted partial id with its annotations."""
        from ..fanal.artifact import ArtifactReference

        errors: list = []
        blob = self._decode(errors)
        blob.diff_id = self.digest
        if errors:
            blob.ingest_errors = errors
        blob_id = cache_key(self.digest, DECODER_VERSIONS, {})
        if errors:
            blob_id = partial_blob_id(blob_id, errors)
        self.cache.put_blob(blob_id, blob)
        self.cache.put_artifact(blob_id, {"SchemaVersion": 2})
        atype = (T.ArtifactType.SPDX if self.format.startswith("spdx")
                 else T.ArtifactType.CYCLONEDX)
        return ArtifactReference(
            name=self.name or self.digest, type=atype,
            id=blob_id, blob_ids=[blob_id])
