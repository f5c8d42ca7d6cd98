"""Blob/artifact cache — the checkpoint/resume system.

Mirrors pkg/fanal/cache: content+code-version addressed keys
(key.go:18-60: sha256 over diffID + analyzer versions + scan options) let
a rescan skip every already-analyzed layer (MissingBlobs diff, reference
pkg/fanal/artifact/image/image.go:113). Backends: in memory, and a
directory of JSON files (the reference's bbolt file). The port registers
fewer analyzers than the JAX package, so its keys differ from the JAX
package's: the two must not share a cache directory."""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

from .. import types as T
from ..log import get as _get_logger

SCHEMA_VERSION = 2

log = _get_logger("fanal.cache")


def open_cache(backend: str, cache_dir: str = ""):
    """Backend selection (reference initCache, run.go:344): "fs" is an
    FSCache under `cache_dir`, "memory" a MemoryCache. The Redis and S3
    backends are not ported."""
    if backend == "memory":
        return MemoryCache()
    if backend == "fs":
        return FSCache(cache_dir)
    raise ValueError(f"unknown cache backend {backend!r} (fs | memory)")


def cache_key(base_id: str, analyzer_versions: dict,
              options: Optional[dict] = None) -> str:
    h = hashlib.sha256()
    h.update(base_id.encode())
    h.update(json.dumps({"v": SCHEMA_VERSION,
                         "analyzers": analyzer_versions,
                         "options": options or {}},
                        sort_keys=True).encode())
    return "sha256:" + h.hexdigest()


class MemoryCache:
    def __init__(self):
        self.artifacts: dict[str, dict] = {}
        self.blobs: dict[str, dict] = {}

    def missing_blobs(self, artifact_id: str,
                      blob_ids: list[str]) -> tuple[bool, list[str]]:
        missing = [b for b in blob_ids if b not in self.blobs]
        return artifact_id not in self.artifacts, missing

    def put_artifact(self, artifact_id: str, info: dict):
        self.artifacts[artifact_id] = info

    def put_blob(self, blob_id: str, blob: T.BlobInfo):
        self.blobs[blob_id] = blob.to_json()

    def get_artifact(self, artifact_id: str) -> Optional[dict]:
        return self.artifacts.get(artifact_id)

    def get_blob(self, blob_id: str) -> Optional[T.BlobInfo]:
        j = self.blobs.get(blob_id)
        return blob_from_json(j) if j is not None else None


class FSCache(MemoryCache):
    """One JSON file per key under <root>/artifact and <root>/blob (the
    reference keeps a bbolt file with artifact/blob buckets,
    cache/fs.go:22-40).

    Crash safety: writes land on a unique temp path and `os.replace` in,
    so a kill mid-put leaves a stray temp file, never a truncated entry;
    a read that finds a corrupt entry anyway moves it aside to
    `*.corrupt` and serves a miss."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(os.path.join(root, "artifact"), exist_ok=True)
        os.makedirs(os.path.join(root, "blob"), exist_ok=True)

    def _path(self, bucket: str, key: str) -> str:
        return os.path.join(self.root, bucket,
                            key.replace(":", "_") + ".json")

    @staticmethod
    def _write_atomic(path: str, payload: dict) -> None:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path),
            prefix=os.path.basename(path) + ".tmp.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass   # a crash leaves a stray tmp, never a bad entry
            raise

    @staticmethod
    def _read_json(path: str):
        """→ decoded JSON, or None (a miss) after moving a corrupt entry
        aside."""
        try:
            with open(path) as f:
                return json.load(f)
        except OSError:
            return None
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            quarantine = path + ".corrupt"
            try:
                os.replace(path, quarantine)
            except OSError:
                pass   # a racing reader already moved it; still a miss
            log.warning("moved corrupt cache entry %s to %s (serving a "
                        "miss)", path, quarantine)
            return None

    def missing_blobs(self, artifact_id, blob_ids):
        missing = [b for b in blob_ids
                   if not os.path.exists(self._path("blob", b))]
        return (not os.path.exists(self._path("artifact", artifact_id)),
                missing)

    def put_artifact(self, artifact_id, info):
        self._write_atomic(self._path("artifact", artifact_id), info)

    def put_blob(self, blob_id, blob):
        self._write_atomic(self._path("blob", blob_id), blob.to_json())

    def get_artifact(self, artifact_id):
        return self._read_json(self._path("artifact", artifact_id))

    def get_blob(self, blob_id):
        j = self._read_json(self._path("blob", blob_id))
        if j is None:
            return None
        from ..metrics import METRICS
        METRICS.inc("trivy_tpu_fleet_cache_hits_total", backend="fs")
        return blob_from_json(j)


# --- JSON → dataclass decoding (cache round trip) ---

def _pkg_from_json(j: dict) -> T.Package:
    ident = j.get("Identifier") or {}
    return T.Package(
        id=j.get("ID", ""), name=j.get("Name", ""),
        identifier=T.PkgIdentifier(purl=ident.get("PURL", ""),
                                   bom_ref=ident.get("BOMRef", ""),
                                   uid=ident.get("UID", "")),
        version=j.get("Version", ""), release=j.get("Release", ""),
        epoch=j.get("Epoch", 0), arch=j.get("Arch", ""),
        src_name=j.get("SrcName", ""), src_version=j.get("SrcVersion", ""),
        src_release=j.get("SrcRelease", ""), src_epoch=j.get("SrcEpoch", 0),
        licenses=j.get("Licenses", []), maintainer=j.get("Maintainer", ""),
        modularitylabel=j.get("Modularitylabel", ""),
        dev=j.get("Dev", False), indirect=j.get("Indirect", False),
        depends_on=j.get("DependsOn", []),
        layer=_layer_from_json(j.get("Layer")),
        file_path=j.get("FilePath", ""), digest=j.get("Digest", ""),
        locations=j.get("Locations", []),
        installed_files=j.get("InstalledFiles", []),
    )


def _layer_from_json(j) -> T.Layer:
    j = j or {}
    return T.Layer(digest=j.get("Digest", ""), diff_id=j.get("DiffID", ""),
                   created_by=j.get("CreatedBy", ""))


def _code_line_from_json(cl: dict) -> T.CodeLine:
    return T.CodeLine(
        number=cl.get("Number", 0), content=cl.get("Content", ""),
        is_cause=cl.get("IsCause", False),
        annotation=cl.get("Annotation", ""),
        truncated=cl.get("Truncated", False),
        highlighted=cl.get("Highlighted", ""),
        first_cause=cl.get("FirstCause", False),
        last_cause=cl.get("LastCause", False))


def _secret_from_json(j: dict) -> T.Secret:
    return T.Secret(
        file_path=j.get("FilePath", ""),
        findings=[T.SecretFinding(
            rule_id=f.get("RuleID", ""), category=f.get("Category", ""),
            severity=f.get("Severity", ""), title=f.get("Title", ""),
            start_line=f.get("StartLine", 0), end_line=f.get("EndLine", 0),
            code=T.Code(lines=[_code_line_from_json(cl) for cl in
                               (f.get("Code") or {}).get("Lines", [])]),
            match=f.get("Match", ""),
            layer=_layer_from_json(f.get("Layer")),
        ) for f in j.get("Findings", [])],
    )


def _misconf_from_json(j: dict) -> T.Misconfiguration:
    return T.Misconfiguration(
        file_type=j.get("FileType", ""),
        file_path=j.get("FilePath", ""),
        successes=j.get("Successes", 0),
        exceptions=j.get("Exceptions", 0),
        failures=[_detected_misconf_from_json(f)
                  for f in j.get("Failures", [])],
    )


def _detected_misconf_from_json(j: dict) -> T.DetectedMisconfiguration:
    cm = j.get("CauseMetadata") or {}
    return T.DetectedMisconfiguration(
        type=j.get("Type", ""), id=j.get("ID", ""),
        avd_id=j.get("AVDID", ""), title=j.get("Title", ""),
        description=j.get("Description", ""), message=j.get("Message", ""),
        namespace=j.get("Namespace", ""), query=j.get("Query", ""),
        resolution=j.get("Resolution", ""), severity=j.get("Severity", ""),
        primary_url=j.get("PrimaryURL", ""),
        references=j.get("References", []), status=j.get("Status", ""),
        layer=_layer_from_json(j.get("Layer")),
        cause_metadata=T.CauseMetadata(
            provider=cm.get("Provider", ""), service=cm.get("Service", ""),
            start_line=cm.get("StartLine", 0),
            end_line=cm.get("EndLine", 0),
            code=T.Code(lines=[_code_line_from_json(cl) for cl in
                               (cm.get("Code") or {}).get("Lines", [])])),
    )


def blob_from_json(j: dict) -> T.BlobInfo:
    os_j = j.get("OS") or {}
    repo_j = j.get("Repository")
    bi_j = j.get("BuildInfo")
    return T.BlobInfo(
        schema_version=j.get("SchemaVersion", SCHEMA_VERSION),
        digest=j.get("Digest", ""), diff_id=j.get("DiffID", ""),
        created_by=j.get("CreatedBy", ""),
        opaque_dirs=j.get("OpaqueDirs", []),
        whiteout_files=j.get("WhiteoutFiles", []),
        os=T.OS(family=os_j.get("Family", ""), name=os_j.get("Name", ""),
                eosl=os_j.get("EOSL", False),
                extended=os_j.get("extended", False)),
        repository=T.Repository(family=repo_j.get("Family", ""),
                                release=repo_j.get("Release", ""))
        if repo_j else None,
        package_infos=[T.PackageInfo(
            file_path=pi.get("FilePath", ""),
            packages=[_pkg_from_json(p) for p in pi.get("Packages", [])])
            for pi in j.get("PackageInfos", [])],
        applications=[T.Application(
            type=a.get("Type", ""), file_path=a.get("FilePath", ""),
            packages=[_pkg_from_json(p) for p in a.get("Packages", [])])
            for a in j.get("Applications", [])],
        misconfigurations=[_misconf_from_json(m)
                           for m in j.get("Misconfigurations", [])],
        secrets=[_secret_from_json(s) for s in j.get("Secrets", [])],
        licenses=[T.DetectedLicense(
            severity=li.get("Severity", ""),
            category=li.get("Category", ""),
            pkg_name=li.get("PkgName", ""),
            file_path=li.get("FilePath", ""),
            name=li.get("Name", ""), text=li.get("Text", ""),
            confidence=li.get("Confidence", 1.0),
            link=li.get("Link", ""))
            for li in j.get("Licenses", [])],
        build_info=T.BuildInfo(content_sets=bi_j.get("ContentSets", []),
                               nvr=bi_j.get("Nvr", ""),
                               arch=bi_j.get("Arch", ""))
        if bi_j else None,
        # partial-scan annotations survive the cache round trip, so a
        # warm scan of a partial blob still reports them
        ingest_errors=j.get("IngestErrors", []),
    )
