"""Rekor transparency-log client (reference pkg/rekor/client.go), the
port's copy of the JAX package's rekor.py.

The two REST endpoints the reference uses:
  * POST /api/v1/index/retrieve {"hash": "sha256:..."} → [entry ids]
  * POST /api/v1/log/entries/retrieve {"entryUUIDs": [...]}
    → [{id: {"attestation": {"data": base64}, ...}}]

Entry ids are a tree id (16 hex) and a UUID (64 hex) (client.go
NewEntryID:37). The image scan's remote-SBOM shortcut and the
unpackaged post-handler ask it."""

from __future__ import annotations

import base64
import json
import urllib.request

MAX_GET_ENTRIES = 10  # client.go MaxGetEntriesLimit


class RekorError(Exception):
    pass


class EntryID:
    def __init__(self, raw: str):
        if len(raw) == 80:
            self.tree_id, self.uuid = raw[:16], raw[16:]
        elif len(raw) == 64:
            self.tree_id, self.uuid = "", raw
        else:
            raise RekorError(f"invalid entry UUID: {raw!r}")

    def __str__(self):
        return self.tree_id + self.uuid


class Client:
    def __init__(self, rekor_url: str, timeout: float = 15.0):
        self.base = rekor_url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict):
        req = urllib.request.Request(
            f"{self.base}{path}", data=json.dumps(payload).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"[]")
        except Exception as e:
            raise RekorError(f"rekor request failed: {e}") from e

    def search(self, hash_: str) -> list[EntryID]:
        """The ids of the entries whose subjects include this digest
        (client.go Search:73)."""
        ids = self._post("/api/v1/index/retrieve", {"hash": hash_})
        return [EntryID(i) for i in ids or []]

    def get_entries(self, entry_ids: list[EntryID]) -> list[bytes]:
        """The entries' attestation statements (client.go
        GetEntries:92); an entry without one is skipped."""
        if len(entry_ids) > MAX_GET_ENTRIES:
            raise RekorError(f"over get entries limit ({MAX_GET_ENTRIES})")
        if not entry_ids:
            return []
        payload = self._post("/api/v1/log/entries/retrieve",
                             {"entryUUIDs": [str(e) for e in entry_ids]})
        uuids = {e.uuid for e in entry_ids}
        out = []
        for bundle in payload or []:
            for raw_id, entry in bundle.items():
                try:
                    eid = EntryID(raw_id)
                except RekorError:
                    continue
                if eid.uuid not in uuids:
                    continue
                data = ((entry or {}).get("attestation") or {}).get("data")
                if not data:
                    continue
                try:
                    out.append(base64.b64decode(data))
                except ValueError:
                    continue
        return out


def fetch_sbom_statement(rekor_url: str, digest: str):
    """A digest (sha256:...) → the decoded in-toto Statement of its
    first entry with an SBOM predicate, or None (remote_sbom.go
    inspectSBOMAttestation)."""
    from .attestation import decode_any
    client = Client(rekor_url)
    ids = client.search(digest)
    if not ids:
        return None
    for raw in client.get_entries(ids[:MAX_GET_ENTRIES]):
        try:
            doc = json.loads(raw)
        except json.JSONDecodeError:
            continue
        try:
            return decode_any(doc)
        except Exception:
            continue
    return None
