"""Artifacts: things that can be inspected into (artifact id, blob ids),
with each blob's analysis kept in the cache.

Mirrors pkg/fanal/artifact: image archives (docker-save tarballs and OCI
image layouts, artifact/image/archive) and local filesystems
(artifact/local/fs.go). Missing layers walk one after another; the
secret lane then scans every walked layer's candidate files in ONE
SecretScanner.scan_files_many call, so an image is one prefilter batch
(one shift-or launch when it is large enough), with findings identical
to per-layer calls. Registry, daemon and containerd sources are not
ported."""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import os
import tarfile
from dataclasses import dataclass
from typing import Optional

from .. import types as T
from .analyzers import AnalyzerGroup
from .cache import cache_key
from .walker import (DEFAULT_SECRET_CONFIG, blob_info,
                     normalize_skip_globs, walk_fs, walk_layer_tar)


@dataclass
class ArtifactReference:
    name: str
    type: str
    id: str
    blob_ids: list
    image_metadata: Optional[T.Metadata] = None


class _Artifact:
    def __init__(self, cache, group: Optional[AnalyzerGroup] = None,
                 scanners: tuple = ("vuln",), secret_scanner=None):
        if "secret" in scanners and secret_scanner is None:
            raise ValueError("the secret scanner needs a SecretScanner")
        self.cache = cache
        self.group = group or AnalyzerGroup()
        self.scanners = scanners
        self.secret_scanner = secret_scanner

    @property
    def want_secrets(self) -> bool:
        return "secret" in self.scanners


class _ImageInspectMixin(_Artifact):
    """Image assembly shared by the docker-archive and OCI-layout paths:
    cache keys, the missing-layer walk and the artifact info."""

    skip_files: tuple = ()
    skip_dir_globs: tuple = ()
    secret_config_path: str = DEFAULT_SECRET_CONFIG

    @staticmethod
    def _created_by(config: dict, diff_ids: list) -> list:
        history = [h for h in config.get("history", [])
                   if not h.get("empty_layer")]
        created_by = [h.get("created_by", "") for h in history]
        return created_by + [""] * (len(diff_ids) - len(created_by))

    def _image_keys(self, image_id: str, diff_ids: list):
        versions = self.group.versions()
        opts = {"scanners": sorted(self.scanners)}
        # skip filters change blob content, so they are part of the key
        sf = normalize_skip_globs(self.skip_files)
        sd = normalize_skip_globs(self.skip_dir_globs)
        if sf:
            opts["skip_files"] = sorted(sf)
        if sd:
            opts["skip_dirs"] = sorted(sd)
        return (cache_key(image_id, versions, opts),
                [cache_key(d, versions, opts) for d in diff_ids])

    def _walk_missing_layers(self, diff_ids, blob_ids, created_by,
                             missing, open_layer,
                             layer_digests=None) -> None:
        """open_layer(i) → the layer's tarfile. Walks each missing layer,
        scans all their secret candidates in one batch, and caches the
        blobs in layer order."""
        walked = []
        for i, (diff_id, blob_id, cb) in enumerate(
                zip(diff_ids, blob_ids, created_by)):
            if blob_id not in missing:
                continue
            with open_layer(i) as layer_tf:
                scan = walk_layer_tar(
                    layer_tf, self.group,
                    collect_secrets=self.want_secrets,
                    skip_files=self.skip_files,
                    skip_dir_globs=self.skip_dir_globs,
                    secret_config_path=self.secret_config_path)
            bi = blob_info(scan, diff_id=diff_id, created_by=cb)
            if layer_digests:
                bi.digest = layer_digests[i]
            walked.append((blob_id, bi, scan.secret_files))
        with_secrets = [w for w in walked if w[2]]
        if self.want_secrets and with_secrets:
            per_layer = self.secret_scanner.scan_files_many(
                [files for _b, _bi, files in with_secrets])
            for (_b, bi, _f), secrets in zip(with_secrets, per_layer):
                bi.secrets = secrets
        for blob_id, bi, _files in walked:
            self.cache.put_blob(blob_id, bi)

    def _put_artifact_info(self, artifact_id: str, config: dict):
        self.cache.put_artifact(artifact_id, T.ArtifactInfo(
            architecture=config.get("architecture", ""),
            created=config.get("created", ""),
            os=config.get("os", "")).to_json())


def _open_layer_bytes(data: bytes) -> tarfile.TarFile:
    """A layer blob, plain or gzip (by its 1f 8b magic) → its tarfile."""
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return tarfile.open(fileobj=io.BytesIO(data))


def _blob_path(digest: str) -> str:
    algo, hexd = digest.split(":", 1)
    return f"blobs/{algo}/{hexd}"


class ImageArchiveArtifact(_ImageInspectMixin):
    """A docker-save tarball or an OCI image layout in one tarball."""

    def __init__(self, path: str, cache,
                 group: Optional[AnalyzerGroup] = None,
                 scanners: tuple = ("vuln",), secret_scanner=None,
                 skip_files: tuple = (), skip_dirs: tuple = (),
                 secret_config_path: str = DEFAULT_SECRET_CONFIG):
        super().__init__(cache, group, scanners, secret_scanner)
        self.path = path
        self.skip_files = tuple(skip_files)
        self.skip_dir_globs = tuple(skip_dirs)
        self.secret_config_path = secret_config_path

    def inspect(self) -> ArtifactReference:
        with tarfile.open(self.path) as tf:
            names = tf.getnames()
            if "manifest.json" in names:
                return self._inspect_docker_archive(tf)
            if "index.json" in names:
                return self._inspect_oci_layout(tf)
            raise ValueError(f"{self.path}: not a docker/oci image archive")

    def _inspect_docker_archive(self, tf: tarfile.TarFile):
        manifest = json.load(tf.extractfile("manifest.json"))[0]
        config = json.load(tf.extractfile(manifest["Config"]))
        diff_ids = config.get("rootfs", {}).get("diff_ids", [])
        layer_paths = manifest.get("Layers", [])
        # the JAX package's image id: sha256 of the key-sorted config
        # JSON, not of the config file's bytes
        image_id = "sha256:" + hashlib.sha256(
            json.dumps(config, sort_keys=True).encode()).hexdigest()
        artifact_id, blob_ids = self._image_keys(image_id, diff_ids)
        missing_artifact, missing = self.cache.missing_blobs(
            artifact_id, blob_ids)
        self._walk_missing_layers(
            diff_ids, blob_ids, self._created_by(config, diff_ids),
            missing,
            lambda i: _open_layer_bytes(
                tf.extractfile(layer_paths[i]).read()))
        metadata = T.Metadata(image_id=image_id, diff_ids=diff_ids,
                              repo_tags=manifest.get("RepoTags") or [],
                              image_config=config)
        if missing_artifact:
            self._put_artifact_info(artifact_id, config)
        name = metadata.repo_tags[0] if metadata.repo_tags else self.path
        return ArtifactReference(
            name=name, type=T.ArtifactType.CONTAINER_IMAGE, id=artifact_id,
            blob_ids=blob_ids, image_metadata=metadata)

    def _inspect_oci_layout(self, tf: tarfile.TarFile):
        index = json.load(tf.extractfile("index.json"))
        mdesc = index["manifests"][0]
        manifest = json.load(tf.extractfile(_blob_path(mdesc["digest"])))
        config = json.load(tf.extractfile(
            _blob_path(manifest["config"]["digest"])))
        diff_ids = config.get("rootfs", {}).get("diff_ids", [])
        image_id = manifest["config"]["digest"]
        artifact_id, blob_ids = self._image_keys(image_id, diff_ids)
        missing_artifact, missing = self.cache.missing_blobs(
            artifact_id, blob_ids)
        layer_digests = [ld["digest"] for ld in manifest["layers"]]
        self._walk_missing_layers(
            diff_ids, blob_ids, self._created_by(config, diff_ids),
            missing,
            lambda i: _open_layer_bytes(
                tf.extractfile(_blob_path(layer_digests[i])).read()),
            layer_digests=layer_digests)
        metadata = T.Metadata(image_id=image_id, diff_ids=diff_ids,
                              image_config=config)
        if missing_artifact:
            self._put_artifact_info(artifact_id, config)
        return ArtifactReference(
            name=self.path, type=T.ArtifactType.CONTAINER_IMAGE,
            id=artifact_id, blob_ids=blob_ids, image_metadata=metadata)


class FilesystemArtifact(_Artifact):
    """A directory tree as one synthetic blob
    (pkg/fanal/artifact/local/fs.go:114): walk → post-analyzers over the
    whole tree → blob info → secret scan → content-addressed cache key →
    cache put. The skip globs and `secret_config_path` are relative to
    the root (the CLI's `_rel_globs` makes them so)."""

    def __init__(self, root: str, cache,
                 group: Optional[AnalyzerGroup] = None,
                 scanners: tuple = ("vuln",), secret_scanner=None,
                 secret_config_path: str = DEFAULT_SECRET_CONFIG,
                 skip_files: tuple = (), skip_dirs: tuple = ()):
        super().__init__(cache, group, scanners, secret_scanner)
        self.root = root
        self.secret_config_path = secret_config_path
        self.skip_files = tuple(skip_files)
        self.skip_dir_globs = tuple(skip_dirs)

    def inspect(self) -> ArtifactReference:
        scan = walk_fs(self.root, self.group,
                       collect_secrets=self.want_secrets,
                       secret_config_path=self.secret_config_path,
                       skip_files=self.skip_files,
                       skip_dir_globs=self.skip_dir_globs)
        bi = blob_info(scan)
        if self.want_secrets and scan.secret_files:
            bi.secrets = self.secret_scanner.scan_files(scan.secret_files)
        content_id = "sha256:" + hashlib.sha256(
            json.dumps(bi.to_json(), sort_keys=True).encode()).hexdigest()
        blob_id = cache_key(content_id, self.group.versions(),
                            {"scanners": sorted(self.scanners)})
        self.cache.put_blob(blob_id, bi)
        self.cache.put_artifact(blob_id, {"SchemaVersion": 2})
        return ArtifactReference(
            name=os.path.abspath(self.root).rstrip("/"),
            type=T.ArtifactType.FILESYSTEM, id=blob_id, blob_ids=[blob_id])
