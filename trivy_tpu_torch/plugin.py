"""Subprocess plugins (reference pkg/plugin/plugin.go).

A plugin lives in `<home>/plugins/<name>/` (`TRIVY_TPU_HOME`, default
`~/.trivy-tpu`) with a `plugin.yaml` manifest:

    name: kubectl
    version: 0.1.0
    usage: scan kubectl output
    platforms:
      - selector: {os: linux, arch: amd64}
        uri: ./mybin            # or http(s)/archive for Install
        bin: ./mybin

`python -m trivy_tpu_torch plugin install <dir|archive|url>` copies the
plugin in, `python -m trivy_tpu_torch <name> args...` runs it (Run:104,
argv passthrough), and the platform is chosen as in selectPlatform:122
(an empty selector matches everything; os and arch are compared with
the host's).
"""

from __future__ import annotations

import os
import platform as _platform
import shutil
import subprocess
import tarfile
import tempfile
import zipfile

import yaml

from .log import logger


class PluginError(Exception):
    pass


def plugins_dir() -> str:
    base = os.environ.get("TRIVY_TPU_HOME") or \
        os.path.join(os.path.expanduser("~"), ".trivy-tpu")
    return os.path.join(base, "plugins")


def _host_os() -> str:
    return _platform.system().lower()


def _host_arch() -> str:
    m = _platform.machine().lower()
    return {"x86_64": "amd64", "aarch64": "arm64",
            "arm64": "arm64"}.get(m, m)


class Plugin:
    def __init__(self, manifest: dict, dir_: str):
        self.name = str(manifest.get("name", ""))
        self.version = str(manifest.get("version", ""))
        self.usage = str(manifest.get("usage",
                                      manifest.get("summary", "")))
        self.description = str(manifest.get("description", ""))
        self.platforms = manifest.get("platforms") or []
        self.dir = dir_

    def select_platform(self) -> dict:
        """The first platform whose selector matches the host's os and
        arch (reference selectPlatform:122)."""
        for p in self.platforms:
            sel = p.get("selector") or {}
            os_ok = not sel.get("os") or sel["os"] == _host_os()
            arch_ok = not sel.get("arch") or sel["arch"] == _host_arch()
            if os_ok and arch_ok:
                return p
        raise PluginError(
            f"plugin {self.name}: no platform matches "
            f"{_host_os()}/{_host_arch()}")

    def bin_path(self) -> str:
        p = self.select_platform()
        binrel = p.get("bin") or ""
        if not binrel:
            raise PluginError(f"plugin {self.name}: no bin specified")
        path = os.path.normpath(os.path.join(self.dir, binrel))
        if not path.startswith(os.path.normpath(self.dir)):
            raise PluginError(f"plugin {self.name}: bin escapes "
                              "plugin directory")
        return path

    def run(self, args: list[str]) -> int:
        binp = self.bin_path()
        if not os.path.exists(binp):
            raise PluginError(f"plugin binary not found: {binp}")
        return subprocess.run([binp] + list(args)).returncode


def _read_manifest(dir_: str) -> dict:
    mf = os.path.join(dir_, "plugin.yaml")
    if not os.path.exists(mf):
        raise PluginError(f"no plugin.yaml in {dir_}")
    with open(mf, encoding="utf-8") as f:
        manifest = yaml.safe_load(f) or {}
    if not manifest.get("name"):
        raise PluginError("plugin.yaml missing 'name'")
    return manifest


def _copy_in(root: str) -> str:
    manifest = _read_manifest(root)
    dest = os.path.join(plugins_dir(), manifest["name"])
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(root, dest)
    return dest


def install(src: str) -> Plugin:
    """Install from a local directory, a local archive (.tar.gz, .zip)
    or an http(s) URL (the URL needs egress; local paths always work)."""
    tmp_cleanup = None
    if src.startswith(("http://", "https://")):
        import urllib.request
        fd, tmp = tempfile.mkstemp(suffix=os.path.basename(src))
        os.close(fd)
        try:
            urllib.request.urlretrieve(src, tmp)  # noqa: S310
        except Exception as e:
            os.unlink(tmp)
            raise PluginError(f"failed to download {src}: {e}") from e
        src = tmp_cleanup = tmp
    try:
        if os.path.isdir(src):
            dest = _copy_in(src)
        else:
            with tempfile.TemporaryDirectory() as td:
                _extract(src, td)
                root = td
                entries = os.listdir(td)
                if "plugin.yaml" not in entries and len(entries) == 1:
                    root = os.path.join(td, entries[0])
                dest = _copy_in(root)
    finally:
        if tmp_cleanup:
            os.unlink(tmp_cleanup)
    plugin = Plugin(_read_manifest(dest), dest)
    try:
        os.chmod(plugin.bin_path(), 0o755)
    except PluginError:
        pass
    logger.warning("installed plugin %s %s", plugin.name, plugin.version)
    return plugin


def _extract(archive: str, dest: str) -> None:
    if archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            z.extractall(dest)  # noqa: S202
        return
    with tarfile.open(archive) as tf:
        for m in tf.getmembers():
            target = os.path.normpath(os.path.join(dest, m.name))
            if not target.startswith(os.path.normpath(dest)):
                continue
            tf.extract(m, dest, filter="data")


def uninstall(name: str) -> None:
    dest = os.path.join(plugins_dir(), name)
    if not os.path.exists(dest):
        raise PluginError(f"plugin {name} not installed")
    shutil.rmtree(dest)


def load(name: str) -> Plugin:
    dest = os.path.join(plugins_dir(), name)
    return Plugin(_read_manifest(dest), dest)


def load_all() -> list[Plugin]:
    out = []
    root = plugins_dir()
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        try:
            out.append(Plugin(_read_manifest(d), d))
        except PluginError:
            continue
    return out


def run(name: str, args: list[str]) -> int:
    return load(name).run(args)


def exists(name: str) -> bool:
    return os.path.exists(os.path.join(plugins_dir(), name,
                                       "plugin.yaml"))
