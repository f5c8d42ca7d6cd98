"""The docker and podman daemon image source over their unix sockets, on
the standard library: the port's copy of the JAX package's
fanal/daemon.py.

Mirrors the reference's daemon sources (pkg/fanal/image/daemon/docker.go
ImageSave, podman.go): `GET /images/{name}/get` of the Docker Engine API
(podman serves the same docker-compatible route) streams a docker-save
tarball, which the archive source (fanal/artifact.py
ImageArchiveArtifact) then walks through the ingest pipeline. Sockets in
the reference's order: $DOCKER_HOST (unix:// only), the default docker
socket, then podman's rootless and rootful sockets.
"""

from __future__ import annotations

import http.client
import os
import socket
import urllib.parse


class DaemonError(RuntimeError):
    pass


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 60.0):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        try:
            sock.connect(self._socket_path)
        except OSError as e:
            sock.close()
            raise DaemonError(
                f"cannot connect to {self._socket_path}: {e}") from None
        self.sock = sock


def docker_socket_candidates(env=None,
                             sources=("docker", "podman")) -> list[str]:
    """The socket paths of the requested daemon sources, in order."""
    env = env if env is not None else os.environ
    out = []
    if "docker" in sources:
        host = env.get("DOCKER_HOST", "")
        if host.startswith("unix://"):
            out.append(host[len("unix://"):])
        out.append("/var/run/docker.sock")
    if "podman" in sources:
        runtime_dir = env.get("XDG_RUNTIME_DIR", "")
        if runtime_dir:
            out.append(os.path.join(runtime_dir, "podman", "podman.sock"))
        out.append("/run/podman/podman.sock")
    return list(dict.fromkeys(out))


def save_image(image: str, dest: str, socket_path: str,
               timeout: float = 300.0) -> None:
    """`docker save` over the API: GET /images/{name}/get → the tarball
    at `dest`."""
    conn = _UnixHTTPConnection(socket_path, timeout=timeout)
    try:
        conn.request("GET", f"/images/{urllib.parse.quote(image, safe='')}"
                            "/get", headers={"Host": "docker"})
        resp = conn.getresponse()
        if resp.status == 404:
            raise DaemonError(f"image {image!r} not found in daemon")
        if resp.status != 200:
            raise DaemonError(
                f"daemon returned {resp.status}: "
                f"{resp.read(200).decode(errors='replace')}")
        with open(dest, "wb") as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except (http.client.HTTPException, OSError) as e:
        raise DaemonError(f"daemon image save failed: {e}") from None
    finally:
        conn.close()


def save_from_any_daemon(image: str, dest: str, env=None,
                         sources=("docker", "podman")) -> str:
    """Try the requested sources' sockets in order → the socket that
    served the image; DaemonError when none has it."""
    errors = []
    for path in docker_socket_candidates(env, sources):
        if not os.path.exists(path):
            continue
        try:
            save_image(image, dest, path)
            return path
        except DaemonError as e:
            errors.append(f"{path}: {e}")
    raise DaemonError("; ".join(errors) or "no daemon socket found")
