"""In-toto attestation decoding (reference pkg/attestation).

A cosign SBOM attestation is a DSSE envelope whose base64 payload is an
in-toto statement; the predicate either IS the SBOM document or wraps it
in a CosignPredicate `{"Data": ...}` (attestation.go:13-18,23-45).
"""

from __future__ import annotations

import base64
import json

IN_TOTO_PAYLOAD_TYPE = "application/vnd.in-toto+json"


class AttestationError(Exception):
    pass


class Statement:
    def __init__(self, type_: str = "", predicate_type: str = "",
                 subject=None, predicate=None):
        self.type = type_
        self.predicate_type = predicate_type
        self.subject = subject or []
        self.predicate = predicate

    @classmethod
    def from_envelope(cls, doc: dict) -> "Statement":
        """DSSE envelope {payloadType, payload(b64), signatures} →
        Statement (attestation.go UnmarshalJSON)."""
        if doc.get("payloadType") != IN_TOTO_PAYLOAD_TYPE:
            raise AttestationError(
                f"invalid attestation payload type: "
                f"{doc.get('payloadType')!r}")
        try:
            payload = base64.b64decode(doc.get("payload", ""))
            st = json.loads(payload)
        except (ValueError, json.JSONDecodeError) as e:
            raise AttestationError(
                f"failed to decode attestation payload: {e}") from e
        return cls.from_statement(st)

    @classmethod
    def from_statement(cls, st: dict) -> "Statement":
        return cls(type_=st.get("_type", ""),
                   predicate_type=st.get("predicateType", ""),
                   subject=st.get("subject", []),
                   predicate=st.get("predicate"))

    def sbom_document(self):
        """The wrapped SBOM: either the predicate itself (new cosign) or
        CosignPredicate.Data (legacy) — pkg/sbom/sbom.go:195-211."""
        pred = self.predicate
        if isinstance(pred, dict) and "Data" in pred and \
                not pred.get("bomFormat") and not pred.get("spdxVersion"):
            return pred["Data"]
        return pred


def is_envelope(doc) -> bool:
    return isinstance(doc, dict) and "payloadType" in doc and \
        "payload" in doc


def decode_any(doc: dict):
    """DSSE envelope or bare in-toto statement → Statement."""
    if is_envelope(doc):
        return Statement.from_envelope(doc)
    if isinstance(doc, dict) and "_type" in doc and \
            "predicateType" in doc:
        return Statement.from_statement(doc)
    raise AttestationError("not an attestation document")
