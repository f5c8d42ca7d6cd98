"""The containerd image source: the daemon's on-disk store, read
directly. The port's copy of the JAX package's fanal/containerd.py.

The reference (pkg/fanal/image/daemon/containerd.go) asks the daemon over
gRPC to export an OCI archive; with no gRPC client in the standard
library, this reads what the daemon would serve from its store:

  <root>/io.containerd.metadata.v1.bolt/meta.db
      a bolt DB; an image is v1/<namespace>/image/<name>/target
      ({digest, mediatype, size}), read with db/boltdb.py
  <root>/io.containerd.content.v1.content/blobs/<alg>/<hex>
      manifest, config and layer blobs, content-addressed

The layers walk serially (no `stream_open`), as in the JAX package.
Names are tried in containerd's stored, fully qualified form
(docker.io/library/...). The namespace is "default" or
$CONTAINERD_NAMESPACE; the root /var/lib/containerd or $CONTAINERD_ROOT.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import tarfile

from .. import types as T
from ..db.boltdb import BoltDB, BoltError
from .artifact import ArtifactReference, _ImageInspectMixin
from .walker import DEFAULT_SECRET_CONFIG

DEFAULT_ROOT = "/var/lib/containerd"

_INDEX_TYPES = (
    "application/vnd.oci.image.index.v1+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
)


class ContainerdError(RuntimeError):
    pass


def name_candidates(image: str) -> list[str]:
    """The familiar name's expansions, most qualified first."""
    base = image.split("@", 1)[0]
    tail = image[len(base):]
    host = base.split("/", 1)[0]
    # the first component is a host only when a path follows it
    has_host = "/" in base and ("." in host or ":" in host
                                or host == "localhost")
    if ":" not in base.rsplit("/", 1)[-1] and not tail:
        base += ":latest"
    out = [base + tail]
    if not has_host:
        if "/" not in base:
            out.insert(0, f"docker.io/library/{base}{tail}")
        else:
            out.insert(0, f"docker.io/{base}{tail}")
    elif base.startswith("docker.io/") and \
            "/" not in base[len("docker.io/"):]:
        # docker.io/<name> is stored as docker.io/library/<name>
        out.insert(0, "docker.io/library/" + base[len("docker.io/"):]
                   + tail)
    return list(dict.fromkeys(out))


class ContainerdStore:
    """A read-only view of a containerd root directory."""

    def __init__(self, root: str = "", namespace: str = ""):
        self.root = root or os.environ.get("CONTAINERD_ROOT", DEFAULT_ROOT)
        self.namespace = namespace or os.environ.get(
            "CONTAINERD_NAMESPACE", "default")
        self.meta_path = os.path.join(
            self.root, "io.containerd.metadata.v1.bolt", "meta.db")
        self.blob_root = os.path.join(
            self.root, "io.containerd.content.v1.content", "blobs")

    def available(self) -> bool:
        return os.path.exists(self.meta_path)

    def _descend(self, db: BoltDB, path: list[bytes]):
        """Nested buckets by name → the last one's value, or None."""
        entries = ((k, v, True) for k, v in db.buckets())
        val = None
        for want in path:
            found = None
            for key, v, is_bucket in entries:
                if key == want and is_bucket:
                    found = v
                    break
            if found is None:
                return None
            val = found
            entries = db.walk_bucket(val)
        return val

    def resolve(self, image: str) -> tuple[str, str]:
        """An image name → (its stored name, its target's digest)."""
        if not self.available():
            raise ContainerdError(f"no containerd store at {self.root}")
        try:
            with BoltDB(self.meta_path) as db:
                for cand in name_candidates(image):
                    for img_bucket in (b"image", b"images"):
                        val = self._descend(db, [
                            b"v1", self.namespace.encode(), img_bucket,
                            cand.encode(), b"target"])
                        if val is None:
                            continue
                        for key, v, is_b in db.walk_bucket(val):
                            if key == b"digest" and not is_b:
                                return cand, v.decode()
        except BoltError as e:
            raise ContainerdError(
                f"containerd metadata unreadable: {e}") from None
        raise ContainerdError(
            f"image {image!r} not found in containerd namespace "
            f"{self.namespace!r}")

    def blob_path(self, digest: str) -> str:
        alg, _, hexd = digest.partition(":")
        p = os.path.join(self.blob_root, alg, hexd)
        if not os.path.exists(p):
            raise ContainerdError(f"blob {digest} missing from store")
        return p

    def read_json(self, digest: str) -> dict:
        with open(self.blob_path(digest), "rb") as f:
            return json.load(f)


def _select_platform(entries: list[dict], platform: str) -> dict:
    """The registry source's selection rule (oci.select_platform)."""
    from ..oci import OCIError, select_platform
    try:
        return select_platform(entries, platform)
    except OCIError as e:
        raise ContainerdError(str(e)) from None


class ContainerdArtifact(_ImageInspectMixin):
    """An image in a containerd content store."""

    def __init__(self, image: str, cache, group=None,
                 scanners: tuple = ("vuln",), secret_scanner=None,
                 secret_config_path: str = DEFAULT_SECRET_CONFIG,
                 platform: str = "linux/amd64",
                 store: ContainerdStore | None = None,
                 skip_files: tuple = (), skip_dirs: tuple = (),
                 target: tuple | None = None):
        super().__init__(cache, group, scanners, secret_scanner)
        self.image = image
        self.store = store or ContainerdStore()
        self.platform = platform or "linux/amd64"
        self.secret_config_path = secret_config_path
        self.skip_files = tuple(skip_files)
        self.skip_dir_globs = tuple(skip_dirs)
        self._target = target   # (stored name, digest), already resolved
        self._resolved = None

    def image_digest(self) -> str:
        """The config digest, as RegistryArtifact.image_digest."""
        return self.manifest()[1]["config"]["digest"]

    def manifest(self) -> tuple[str, dict]:
        """→ (stored name, the platform's manifest)."""
        if self._resolved is None:
            name, digest = self._target or self.store.resolve(self.image)
            man = self.store.read_json(digest)
            if man.get("mediaType") in _INDEX_TYPES or \
                    "manifests" in man and "layers" not in man:
                entry = _select_platform(man.get("manifests", []),
                                         self.platform)
                man = self.store.read_json(entry["digest"])
            self._resolved = (name, man)
        return self._resolved

    def inspect(self) -> ArtifactReference:
        name, man = self.manifest()
        config = self.store.read_json(man["config"]["digest"])
        diff_ids = config.get("rootfs", {}).get("diff_ids", [])
        layers = man.get("layers", [])
        image_id = man["config"]["digest"]
        artifact_id, blob_ids = self._image_keys(image_id, diff_ids)
        missing_artifact, missing = self.cache.missing_blobs(
            artifact_id, blob_ids)

        @contextlib.contextmanager
        def open_layer(i):
            layer = layers[i]
            media = layer.get("mediaType", "")
            if media.endswith("+zstd"):
                raise ContainerdError(
                    f"zstd layer {layer['digest']} unsupported")
            with open(self.store.blob_path(layer["digest"]), "rb") as raw:
                src = gzip.GzipFile(fileobj=raw) \
                    if media.endswith(("+gzip", ".gzip")) else raw
                with src, tarfile.open(fileobj=src, mode="r|*") as ltf:
                    yield ltf

        self._walk_missing_layers(
            diff_ids, blob_ids, self._created_by(config, diff_ids),
            missing, open_layer,
            layer_digests=[ld["digest"] for ld in layers])
        metadata = T.Metadata(image_id=image_id, diff_ids=diff_ids,
                              repo_tags=[name], image_config=config)
        if missing_artifact:
            self._put_artifact_info(artifact_id, config)
        return ArtifactReference(
            name=self.image, type=T.ArtifactType.CONTAINER_IMAGE,
            id=artifact_id, blob_ids=blob_ids, image_metadata=metadata)
