"""SBOM format detection + artifact bridge (reference pkg/sbom/sbom.go
DetectFormat:111 and pkg/fanal/artifact/sbom/sbom.go)."""

from __future__ import annotations

import json

from .. import types as T
from .cyclonedx import decode_cyclonedx, encode_cyclonedx
from .spdx import decode_spdx, encode_spdx

__all__ = [
    "decode_cyclonedx", "decode_sbom_doc", "decode_sbom_file",
    "decode_spdx", "detect_format", "encode_cyclonedx", "encode_spdx",
    "unwrap_attestation", "write_sbom",
]


def detect_format(doc: dict) -> str:
    if doc.get("bomFormat") == "CycloneDX":
        return "cyclonedx"
    if str(doc.get("spdxVersion", "")).startswith("SPDX-"):
        return "spdx-json"
    raise ValueError("unknown SBOM format (want CycloneDX or SPDX JSON)")


def unwrap_attestation(doc: dict) -> dict:
    """DSSE envelope / in-toto statement → the wrapped SBOM document
    (reference sbom.go FormatAttestCycloneDXJSON +
    FormatLegacyCosignAttestCycloneDXJSON decode paths); non-attestation
    documents pass through unchanged."""
    from ..attestation import AttestationError, decode_any
    try:
        st = decode_any(doc)
    except AttestationError:
        return doc
    sbom = st.sbom_document()
    if isinstance(sbom, dict):
        return sbom
    return doc


def decode_sbom_file(path: str, cache, opts=None):
    """→ ArtifactReference whose single blob carries the decoded detail.
    Accepts JSON documents (CycloneDX/SPDX, optionally attestation-
    wrapped) and SPDX tag-value text (FormatSPDXTV, sbom.go:111).
    Never raises on document content: a hostile or malformed file
    yields an annotated partial (sbom/artifact.py)."""
    from .artifact import SBOMArtifact
    with open(path, "rb") as f:
        raw = f.read()
    return SBOMArtifact(raw, cache, name=path, opts=opts).inspect()


def decode_sbom_doc(doc: dict, cache, name: str = ""):
    """Decode an (optionally attestation-wrapped) SBOM document into a
    cached blob → ArtifactReference (the rekor/attestation ingress;
    file and RPC ingress hand raw bytes to SBOMArtifact directly)."""
    from .artifact import SBOMArtifact
    return SBOMArtifact.from_doc(doc, cache, name=name).inspect()


def write_sbom(report: T.Report, fmt: str, out,
               app_version: str = "dev") -> None:
    doc = encode_cyclonedx(report, app_version=app_version) \
        if fmt == "cyclonedx" \
        else encode_spdx(report, app_version=app_version)
    json.dump(doc, out, indent=2)
    out.write("\n")
