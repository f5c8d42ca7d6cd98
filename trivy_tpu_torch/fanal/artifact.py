"""Artifacts: things that can be inspected into (artifact id, blob ids),
with each blob's analysis kept in the cache.

Mirrors pkg/fanal/artifact: image archives (docker-save tarballs and OCI
image layouts, artifact/image/archive) and local filesystems
(artifact/local/fs.go), and registry images streamed layer by layer
(RegistryArtifact). Missing layers walk through the ingest pipeline
(pipeline.py) when the source can stream them, else one after another;
the secret lane then scans every walked layer's candidate files in ONE
SecretScanner.scan_files_many call, so an image is one prefilter batch
(one shift-or launch when it is large enough), with findings identical
to per-layer calls. The containerd source lives in containerd.py, the
docker and podman daemons in daemon.py."""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import tarfile
from dataclasses import dataclass
from typing import Optional

from .. import types as T
from ..obs import span
from .analyzers import AnalyzerGroup
from .cache import cache_key
from .ingest import partial_blob_id
from .pipeline import archive_member_stream
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
    """Image assembly shared by the archive, registry and containerd
    sources: cache keys, the missing-layer walk and the artifact info."""

    skip_files: tuple = ()
    skip_dir_globs: tuple = ()
    secret_config_path: str = DEFAULT_SECRET_CONFIG
    ingest = None   # pipeline.IngestOptions; None = the process default
    # how the last inspect walked its missing layers (--debug-launches)
    ingest_figures: dict = {}

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
        # user rego checks change the misconfigurations; with none set,
        # the keys are those without them
        fp = self.group.misconf.fingerprint()
        if fp:
            opts["config_checks"] = fp
        return (cache_key(image_id, versions, opts),
                [cache_key(d, versions, opts) for d in diff_ids])

    def _ingest_options(self):
        from .pipeline import default_ingest
        return self.ingest or default_ingest()

    def _missing_blobs(self, artifact_id: str, blob_ids: list):
        """The cache check, spanned with its hits and misses: a hit
        skips a layer's walk altogether."""
        with span("fanal.cache_check", blobs=len(blob_ids)) as sp:
            missing_artifact, missing = self.cache.missing_blobs(
                artifact_id, blob_ids)
            sp.attrs.update(hits=len(blob_ids) - len(missing),
                            misses=len(missing))
            return missing_artifact, missing

    def _walk_missing_layers(self, diff_ids, blob_ids, created_by,
                             missing, open_layer, layer_digests=None,
                             stream_open=None) -> None:
        """open_layer(i) → a context manager yielding the layer's
        tarfile (the serial walk). When the ingest pipeline is enabled
        and the source gives `stream_open(i)`, a thread-safe context
        manager yielding a pipeline.LayerStream, the missing layers walk
        through the pipeline instead. Either way every walked layer's
        secret candidates go through ONE scan_files_many call, and the
        blobs are cached in layer order; a partial layer is cached
        under its salted id, which replaces its entry in `blob_ids`."""
        ingest = self._ingest_options()
        tasks = [(i, diff_id, blob_id, cb) for i, (diff_id, blob_id, cb)
                 in enumerate(zip(diff_ids, blob_ids, created_by))
                 if blob_id in missing]
        if ingest.enabled and stream_open is not None:
            walked = self._walk_pipelined(ingest, tasks, stream_open)
        else:
            walked = []
            for i, diff_id, _blob_id, _cb in tasks:
                # one span per layer walk: layer sizes are skewed, and
                # one fat layer can dominate the walk
                with span("fanal.layer_walk", layer=i,
                          diff_id=diff_id) as sp, \
                        open_layer(i) as layer_tf:
                    walked.append(walk_layer_tar(
                        layer_tf, self.group,
                        collect_secrets=self.want_secrets,
                        skip_files=self.skip_files,
                        skip_dir_globs=self.skip_dir_globs,
                        secret_config_path=self.secret_config_path))
                    sp.attrs.update(
                        packages=sum(len(p.packages) for p in
                                     walked[-1].result.package_infos),
                        applications=len(walked[-1].result.applications))
            self.ingest_figures = {"pipelined": False,
                                   "layers_walked": len(tasks)}
        finalized = []
        for (i, diff_id, blob_id, cb), scan in zip(tasks, walked):
            bi = blob_info(scan, diff_id=diff_id, created_by=cb)
            if layer_digests:
                bi.digest = layer_digests[i]
            if scan.partial:
                blob_id = partial_blob_id(blob_id, bi.ingest_errors)
                blob_ids[i] = blob_id
            finalized.append((blob_id, bi, scan.secret_files))
        with_secrets = [w for w in finalized if w[2]]
        if self.want_secrets and with_secrets:
            per_layer = self.secret_scanner.scan_files_many(
                [files for _b, _bi, files in with_secrets])
            for (_b, bi, _f), secrets in zip(with_secrets, per_layer):
                bi.secrets = secrets
        for blob_id, bi, _files in finalized:
            self.cache.put_blob(blob_id, bi)

    def _walk_pipelined(self, ingest, tasks, stream_open) -> list:
        """The missing layers through the ingest pipeline → their
        BlobScans in layer order. A digest mismatch re-raises the
        source's own error; nothing is cached then."""
        from .pipeline import IngestIntegrityError, IngestPipeline, LayerTask
        pipe = IngestPipeline(
            self.group, ingest, collect_secrets=self.want_secrets,
            secret_config_path=self.secret_config_path,
            skip_files=self.skip_files, skip_dir_globs=self.skip_dir_globs)
        try:
            with span("fanal.pipeline", layers=len(tasks)) as sp:
                scans = pipe.run([LayerTask(
                    idx=i, diff_id=diff_id, blob_id=blob_id, created_by=cb,
                    open_stream=(lambda i=i: stream_open(i)))
                    for i, diff_id, blob_id, cb in tasks])
                sp.attrs.update(partial=sum(
                    1 for s in scans.values() if s.partial))
        except IngestIntegrityError as e:
            raise (e.__cause__ or e) from None
        finally:
            pipe.close()
        walked = [scans[i] for i, _d, _b, _c in tasks]
        self.ingest_figures = {
            "pipelined": True, "layers_walked": len(tasks),
            "walkers": len(pipe.walker_threads),
            "partial_layers": sum(s.partial for s in walked)}
        return walked

    def _put_artifact_info(self, artifact_id: str, config: dict):
        self.cache.put_artifact(artifact_id, T.ArtifactInfo(
            architecture=config.get("architecture", ""),
            created=config.get("created", ""),
            os=config.get("os", "")).to_json())


@contextlib.contextmanager
def _open_layer_bytes(data: bytes):
    """A layer blob, plain or gzip (by its 1f 8b magic) → its tarfile."""
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    with tarfile.open(fileobj=io.BytesIO(data)) as layer_tf:
        yield layer_tf


def _blob_path(digest: str) -> str:
    algo, hexd = digest.split(":", 1)
    return f"blobs/{algo}/{hexd}"


class ImageArchiveArtifact(_ImageInspectMixin):
    """A docker-save tarball or an OCI image layout in one tarball."""

    def __init__(self, path: str, cache,
                 group: Optional[AnalyzerGroup] = None,
                 scanners: tuple = ("vuln",), secret_scanner=None,
                 skip_files: tuple = (), skip_dirs: tuple = (),
                 secret_config_path: str = DEFAULT_SECRET_CONFIG,
                 ingest=None):
        super().__init__(cache, group, scanners, secret_scanner)
        self.path = path
        self.skip_files = tuple(skip_files)
        self.skip_dir_globs = tuple(skip_dirs)
        self.secret_config_path = secret_config_path
        self.ingest = ingest

    def inspect(self) -> ArtifactReference:
        with tarfile.open(self.path) as tf:
            names = tf.getnames()
            if "manifest.json" in names:
                return self._inspect_docker_archive(tf)
            if "index.json" in names:
                return self._inspect_oci_layout(tf)
            raise ValueError(f"{self.path}: not a docker/oci image archive")

    def image_digest(self) -> str:
        """sha256 of the raw image config (docker-save), or the
        manifest digest of an OCI layout: what attestations name."""
        with tarfile.open(self.path) as tf:
            names = tf.getnames()
            if "manifest.json" in names:
                manifest = json.load(tf.extractfile("manifest.json"))[0]
                raw = tf.extractfile(manifest["Config"]).read()
                return "sha256:" + hashlib.sha256(raw).hexdigest()
            if "index.json" in names:
                index = json.load(tf.extractfile("index.json"))
                return index["manifests"][0]["digest"]
        raise ValueError(f"{self.path}: not an image archive")

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
        missing_artifact, missing = self._missing_blobs(
            artifact_id, blob_ids)
        self._walk_missing_layers(
            diff_ids, blob_ids, self._created_by(config, diff_ids),
            missing,
            lambda i: _open_layer_bytes(
                tf.extractfile(layer_paths[i]).read()),
            # its own outer handle per call, so walkers never share one
            stream_open=lambda i: archive_member_stream(
                self.path, layer_paths[i]))
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
        missing_artifact, missing = self._missing_blobs(
            artifact_id, blob_ids)
        layer_digests = [ld["digest"] for ld in manifest["layers"]]
        self._walk_missing_layers(
            diff_ids, blob_ids, self._created_by(config, diff_ids),
            missing,
            lambda i: _open_layer_bytes(
                tf.extractfile(_blob_path(layer_digests[i])).read()),
            layer_digests=layer_digests,
            stream_open=lambda i: archive_member_stream(
                self.path, _blob_path(layer_digests[i])))
        metadata = T.Metadata(image_id=image_id, diff_ids=diff_ids,
                              image_config=config)
        if missing_artifact:
            self._put_artifact_info(artifact_id, config)
        return ArtifactReference(
            name=self.path, type=T.ArtifactType.CONTAINER_IMAGE,
            id=artifact_id, blob_ids=blob_ids, image_metadata=metadata)


class RegistryArtifact(_ImageInspectMixin):
    """An image pulled from a registry, its layers streamed from the blob
    responses into the walk (reference pkg/fanal/artifact/image/
    image.go:241-330): no tarball lands on disk."""

    def __init__(self, image: str, cache,
                 group: Optional[AnalyzerGroup] = None,
                 scanners: tuple = ("vuln",), secret_scanner=None,
                 secret_config_path: str = DEFAULT_SECRET_CONFIG,
                 platform: str = "linux/amd64", client=None,
                 skip_files: tuple = (), skip_dirs: tuple = (),
                 ingest=None, manifest: Optional[dict] = None):
        from ..oci import default_client, parse_ref
        super().__init__(cache, group, scanners, secret_scanner)
        self.image = image
        self.ref = parse_ref(image)
        self.client = client or default_client()
        self.platform = platform or "linux/amd64"
        self.secret_config_path = secret_config_path
        self.skip_files = tuple(skip_files)
        self.skip_dir_globs = tuple(skip_dirs)
        self.ingest = ingest
        self._manifest = manifest

    def manifest(self) -> dict:
        if self._manifest is None:
            self._manifest = self.client.manifest(self.ref, self.platform)
        return self._manifest

    def image_digest(self) -> str:
        return self.manifest()["config"]["digest"]

    def inspect(self) -> ArtifactReference:
        man = self.manifest()
        config = json.loads(self.client.blob(self.ref,
                                             man["config"]["digest"]))
        diff_ids = config.get("rootfs", {}).get("diff_ids", [])
        layers = man.get("layers", [])
        image_id = man["config"]["digest"]
        artifact_id, blob_ids = self._image_keys(image_id, diff_ids)
        missing_artifact, missing = self._missing_blobs(
            artifact_id, blob_ids)

        @contextlib.contextmanager
        def open_layer(i):
            layer = layers[i]
            mode = "r|gz" if layer.get("mediaType", "").endswith(
                ("+gzip", ".gzip")) else "r|*"
            with self.client.blob_stream(self.ref,
                                         layer["digest"]) as stream:
                with tarfile.open(fileobj=stream, mode=mode) as ltf:
                    yield ltf
                # the digest check comes after the walk and before the
                # cache: a tampered blob never lands in it
                stream.verify()

        @contextlib.contextmanager
        def stream_open(i):
            # a connection of its own per call, so walkers stream
            # independently. A digest mismatch is the one failure the
            # pipeline must not degrade around: IngestIntegrityError,
            # re-raised as the client's own OCIError
            from .pipeline import (IngestIntegrityError, bounded_drain,
                                   layer_tar_stream)
            with self.client.blob_stream(self.ref,
                                         layers[i]["digest"]) as stream:
                with layer_tar_stream(stream) as ls:
                    yield ls
                if not ls.fully_spooled and not bounded_drain(stream, ls):
                    # a mid-stream stop with a tail too big or too slow
                    # to hash within the layer's budgets: the layer is a
                    # partial, cached only under its salted id
                    return
                try:
                    stream.verify()
                except Exception as e:
                    raise IngestIntegrityError(str(e)) from e

        self._walk_missing_layers(
            diff_ids, blob_ids, self._created_by(config, diff_ids),
            missing, open_layer,
            layer_digests=[ld["digest"] for ld in layers],
            stream_open=stream_open)
        metadata = T.Metadata(image_id=image_id, diff_ids=diff_ids,
                              repo_tags=[self.image], image_config=config)
        if missing_artifact:
            self._put_artifact_info(artifact_id, config)
        return ArtifactReference(
            name=self.image, type=T.ArtifactType.CONTAINER_IMAGE,
            id=artifact_id, blob_ids=blob_ids, image_metadata=metadata)


class FilesystemArtifact(_Artifact):
    """A directory tree as one synthetic blob
    (pkg/fanal/artifact/local/fs.go:114): walk → post-analyzers over the
    whole tree → blob info → secret scan → content-addressed cache key →
    cache put. `file_checksum` stamps lockfile packages with their
    file's sha1 (the SPDX formats). The skip globs and `secret_config_path` are relative to
    the root (the CLI's `_rel_globs` makes them so)."""

    def __init__(self, root: str, cache,
                 group: Optional[AnalyzerGroup] = None,
                 scanners: tuple = ("vuln",), secret_scanner=None,
                 secret_config_path: str = DEFAULT_SECRET_CONFIG,
                 skip_files: tuple = (), skip_dirs: tuple = (),
                 file_checksum: bool = False):
        super().__init__(cache, group, scanners, secret_scanner)
        self.root = root
        self.secret_config_path = secret_config_path
        self.skip_files = tuple(skip_files)
        self.skip_dir_globs = tuple(skip_dirs)
        self.file_checksum = file_checksum

    def inspect(self) -> ArtifactReference:
        scan = walk_fs(self.root, self.group,
                       collect_secrets=self.want_secrets,
                       secret_config_path=self.secret_config_path,
                       skip_files=self.skip_files,
                       skip_dir_globs=self.skip_dir_globs,
                       file_checksum=self.file_checksum)
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
