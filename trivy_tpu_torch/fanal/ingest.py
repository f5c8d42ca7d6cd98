"""Ingest annotations, shared by the layer pipeline (pipeline.py) and
the SBOM decode (sbom/artifact.py).

A degraded analysis (a hostile layer or document, a budget trip) is not
an exception: it becomes structured per-stage annotations on the blob
(`ingest_error`), and the blob is cached under a salted id
(`partial_blob_id`) so the canonical key never maps to a partial. The
scanner reports the annotations as one "Ingest Degradations" result."""

from __future__ import annotations

import hashlib
import json


def ingest_error(stage: str, kind: str, detail: str = "",
                 layer: int | None = None, path: str = "") -> dict:
    """One structured per-stage degradation annotation. PascalCase
    keys, so the dict rides BlobInfo and Result JSON verbatim (cache
    round trip, report output)."""
    err = {"Stage": stage, "Kind": kind}
    if detail:
        err["Detail"] = detail
    if layer is not None:
        err["Layer"] = int(layer)
    if path:
        err["Path"] = path
    return err


def partial_blob_id(blob_id: str, errors: list) -> str:
    """The deterministic salted cache key of a PARTIAL result: the
    canonical blob id never maps to a degraded BlobInfo, so the next
    scan decodes again instead of serving the partial, while this scan
    still has an addressable blob to read."""
    h = hashlib.sha256()
    h.update(b"ingest-partial|")
    h.update(blob_id.encode())
    h.update(json.dumps(errors, sort_keys=True,
                        separators=(",", ":")).encode())
    return "sha256:" + h.hexdigest()
