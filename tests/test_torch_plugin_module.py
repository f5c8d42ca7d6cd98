"""Extension modules and plugins in the port (trivy_tpu_torch/module.py,
plugin.py, the module hooks of fanal/analyzers, the Custom result of
scanner.py, the `plugin` and `module` commands and the plugin
passthrough of __main__.py), on the CPU:

  * every case of tests/test_plugin_module.py, run against the port;
  * both CLIs in fresh processes, with TRIVY_TPU_FAKE_NOW and
    TRIVY_TPU_FAKE_UUID fixed and a working and cache directory per
    run, over one TRIVY_TPU_HOME per surface: `fs` with an analyzer
    module and a delete module, with an update and an insert module,
    with modules that raise in `analyze` and in `post_scan`; `image
    --input` of a three-layer archive whose module matches files in two
    layers (the batched analyzer path and the applier across layers);
    `plugin list`, `plugin info`, `module list` and the passthrough's
    output and exit code. Equal exit codes, and reports byte-equal apart
    from CreatedAt and the Custom result: the JAX package's cache reader
    (trivy_tpu/fanal/cache.py blob_from_json) drops a blob's custom
    resources, so its reports never carry that result, while the port
    keeps them as the reference does. The port's Custom result is held
    to the entries the test computes from the files, and the port's
    report less that result is held byte for byte to the JAX one;
  * `vm` on an ext4 disk (the per-file analyzer path);
  * client and server in-process with the modules loaded on both sides:
    custom resources over JSON (the port's client) and protobuf (a
    PutBlob and a Scan in the Go client's encoding), each against the
    JAX server on the same requests;
  * AnalyzerGroup().versions() and the FS cache key with a module
    loaded, equal in both packages and moved by the module."""

import concurrent.futures
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tarfile
import textwrap
import urllib.request
import zipfile

import pytest

from helpers import ALPINE_OS_RELEASE, APK_INSTALLED
from trivy_tpu import module as ref_module
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import module as tmod
from trivy_tpu_torch import plugin
from trivy_tpu_torch.fanal.fixtures import (gz_bytes, sha256_hex, tar_bytes,
                                            write_docker_archive)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DB = os.path.join(REPO, "tests", "golden", "db", "*.yaml")
FIX_DB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")
NOW = "2026-10-17T00:00:00Z"
UUID = "3ff14136-e09f-4df9-80ea-%012d"
_CREATED = re.compile(rb'\n\s*"CreatedAt": "[^"]*",')


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_HOME", str(tmp_path / "home"))
    yield tmp_path / "home"
    tmod.clear_modules()
    ref_module.clear_modules()


def make_plugin_dir(tmp_path, name="echo-plugin", code=0):
    d = tmp_path / name
    d.mkdir()
    (d / "plugin.yaml").write_text(f"""\
name: {name}
version: 0.1.0
usage: echoes args
description: prints its arguments
platforms:
  - selector:
      os: linux
    uri: ./echo.sh
    bin: ./echo.sh
""")
    (d / "echo.sh").write_text(
        f"#!/bin/sh\necho plugin-ran \"$@\"\nexit {code}\n")
    os.chmod(d / "echo.sh", 0o755)
    return d


# ---- tests/test_plugin_module.py on the port --------------------------

class TestPlugin:
    def test_install_from_dir_and_run(self, tmp_path, capfd):
        src = make_plugin_dir(tmp_path)
        p = plugin.install(str(src))
        assert p.name == "echo-plugin"
        assert plugin.exists("echo-plugin")
        code = plugin.run("echo-plugin", ["hello"])
        assert code == 0
        out = capfd.readouterr().out
        assert "plugin-ran hello" in out

    @pytest.mark.parametrize("kind", ["tar.gz", "zip"])
    def test_install_from_archive(self, tmp_path, kind):
        src = make_plugin_dir(tmp_path, "arc-plugin")
        arc = tmp_path / f"p.{kind}"
        if kind == "zip":
            with zipfile.ZipFile(arc, "w") as z:
                for f in sorted(src.iterdir()):
                    z.write(f, f"arc-plugin/{f.name}")
        else:
            with tarfile.open(arc, "w:gz") as tf:
                tf.add(src, arcname="arc-plugin")
        p = plugin.install(str(arc))
        assert p.name == "arc-plugin"
        assert os.access(p.bin_path(), os.X_OK)

    def test_platform_selection(self, tmp_path):
        d = tmp_path / "never"
        d.mkdir()
        (d / "plugin.yaml").write_text("""\
name: never
version: 1.0.0
platforms:
  - selector:
      os: windows
    bin: ./x.exe
""")
        p = plugin.install(str(d))
        with pytest.raises(plugin.PluginError):
            p.select_platform()

    def test_uninstall_and_list(self, tmp_path):
        plugin.install(str(make_plugin_dir(tmp_path)))
        assert [p.name for p in plugin.load_all()] == ["echo-plugin"]
        plugin.uninstall("echo-plugin")
        assert plugin.load_all() == []

    def test_cli_passthrough(self, tmp_path, capfd):
        plugin.install(str(make_plugin_dir(tmp_path)))
        code = cli.main(["echo-plugin", "a", "b"])
        assert code == 0
        assert "plugin-ran a b" in capfd.readouterr().out


MODULE_SRC = textwrap.dedent('''\
    name = "marker"
    version = 1
    required_files = [r"marker\\.txt$"]

    def analyze(path, content):
        return {"content": content.decode().strip()}

    post_scan_spec = {"action": "insert"}

    def post_scan(results):
        return results
''')


class TestModule:
    def test_load_and_analyze(self, home, tmp_path):
        mdir = home / "modules"
        mdir.mkdir(parents=True)
        (mdir / "marker.py").write_text(MODULE_SRC)
        mods = tmod.load_modules()
        assert [m.name for m in mods] == ["marker"]

        from trivy_tpu_torch.fanal.artifact import FilesystemArtifact
        from trivy_tpu_torch.fanal.cache import MemoryCache
        target = tmp_path / "t"
        target.mkdir()
        (target / "marker.txt").write_text("found-me")
        cache = MemoryCache()
        art = FilesystemArtifact(str(target), cache, scanners=("vuln",))
        ref = art.inspect()
        blob = cache.blobs[ref.blob_ids[0]]
        crs = blob.get("CustomResources", [])
        assert crs and crs[0]["Type"] == "marker"
        assert crs[0]["Data"]["content"] == "found-me"
        # and it survives the cache's reader, into the applier's detail
        assert cache.get_blob(ref.blob_ids[0]).custom_resources == crs

    def test_post_scan_delete(self, home):
        mdir = home / "modules"
        mdir.mkdir(parents=True)
        (mdir / "dropper.py").write_text(textwrap.dedent('''\
            name = "dropper"
            version = 1
            post_scan_spec = {"action": "delete",
                              "ids": ["CVE-2023-0286"]}

            def post_scan(results):
                return results
        '''))
        tmod.load_modules()
        from trivy_tpu_torch import types as T
        results = [T.Result(
            target="t", clazz=T.ResultClass.OS_PKGS,
            vulnerabilities=[
                T.DetectedVulnerability(
                    vulnerability_id="CVE-2023-0286", pkg_name="ssl"),
                T.DetectedVulnerability(
                    vulnerability_id="CVE-2025-26519", pkg_name="musl"),
            ])]
        out = tmod.apply_post_scan(results)
        ids = [v.vulnerability_id for v in out[0].vulnerabilities]
        assert ids == ["CVE-2025-26519"]

    def test_module_versions_in_cache_key(self, home):
        mdir = home / "modules"
        mdir.mkdir(parents=True)
        (mdir / "marker.py").write_text(MODULE_SRC)
        tmod.load_modules()
        from trivy_tpu_torch.fanal.analyzers import AnalyzerGroup
        versions = AnalyzerGroup().versions()
        assert versions.get("module:marker") == 1
        tmod.clear_modules()
        assert "module:marker" not in AnalyzerGroup().versions()


# ---- both CLIs in fresh processes -------------------------------------

LOCKFILES = r"(package-lock\.json|requirements\.txt|go\.mod)$"
MODULES = {
    "lockmark": textwrap.dedent(f'''\
        name = "lockmark"
        version = 2
        required_files = [r"{LOCKFILES}"]

        def analyze(path, content):
            lines = content.decode().splitlines()
            return {{"lines": len(lines), "last": lines[-1].strip()}}
    '''),
    "dropper": textwrap.dedent('''\
        name = "dropper"
        version = 1
        post_scan_spec = {"action": "delete", "ids": ["CVE-2020-28724"]}

        def post_scan(results):
            return results
    '''),
    "bumper": textwrap.dedent('''\
        name = "bumper"
        version = 1
        post_scan_spec = {"action": "update", "ids": ["CVE-2022-23628"]}

        def post_scan(results):
            for entry in results:
                for v in entry["vulnerabilities"]:
                    v.vulnerability.severity = "CRITICAL"
            return results
    '''),
    "adder": textwrap.dedent('''\
        import copy
        name = "adder"
        version = 1
        post_scan_spec = {"action": "insert"}

        def post_scan(results):
            for res in results:
                if res.vulnerabilities:
                    v = copy.deepcopy(res.vulnerabilities[0])
                    v.vulnerability_id = "MODULE-2026-0001"
                    res.vulnerabilities.append(v)
                    break
            return results
    '''),
    "bad_analyze": textwrap.dedent(f'''\
        name = "bad-analyze"
        version = 1
        required_files = [r"{LOCKFILES}"]

        def analyze(path, content):
            raise ValueError("module bug")
    '''),
    "bad_post": textwrap.dedent('''\
        name = "bad-post"
        version = 1
        post_scan_spec = {"action": "insert"}

        def post_scan(results):
            raise RuntimeError("module bug")
    '''),
    "imgmark": textwrap.dedent('''\
        name = "imgmark"
        version = 1
        required_files = [r"^etc/marker/"]

        def analyze(path, content):
            return {"text": content.decode().strip(), "bytes": len(content)}
    '''),
}
# surface → (its modules, argv, port-only argv)
SCAN_SURFACES = {
    "fs-analyze-delete": (("lockmark", "dropper"),
                          ["fs", "{tree}", "--db", GOLDEN_DB]),
    "fs-update-insert": (("bumper", "adder"),
                         ["fs", "{tree}", "--db", GOLDEN_DB]),
    "fs-raising": (("bad_analyze", "bad_post"),
                   ["fs", "{tree}", "--db", GOLDEN_DB]),
    "image-layers": (("imgmark",),
                     ["image", "--input", "{image}", "--db", FIX_DB,
                      "--scanners", "vuln"]),
}
TEXT_SURFACES = {
    "plugin-list": ["plugin", "list"],
    "plugin-info": ["plugin", "info", "echo-plugin"],
    "passthrough": ["echo-plugin", "a", "b"],
    "module-list": ["module", "list"],
}
IMAGE_LAYERS = [
    {"etc/os-release": ALPINE_OS_RELEASE,
     "etc/alpine-release": b"3.17.3\n",
     "lib/apk/db/installed": APK_INSTALLED,
     "etc/marker/a.conf": b"alpha\n"},
    {"usr/share/doc/readme": b"no marker here\n"},
    {"etc/marker/b.conf": b"beta beta\n"},
]


def _tree(root):
    """npm + pip + gomod golden inputs in one tree (five CVEs)."""
    for name in ("npm", "pip", "gomod"):
        shutil.copytree(os.path.join(REPO, "tests", "golden", "inputs",
                                     name), os.path.join(root, name))
    return root


def _image(path):
    blobs, diff_ids = [], []
    for files in IMAGE_LAYERS:
        raw = tar_bytes(files)
        blobs.append(gz_bytes(raw))
        diff_ids.append("sha256:" + sha256_hex(raw))
    write_docker_archive(path, blobs, diff_ids, repo_tag="mods/img:1")
    return path


def _home(root, modules):
    mdir = os.path.join(root, "modules")
    os.makedirs(mdir)
    for name in modules:
        with open(os.path.join(mdir, name + ".py"), "w") as f:
            f.write(MODULES[name])
    return root


def _expected_custom(module, files):
    """The Custom entries the module gives for {path: bytes}."""
    if module == "imgmark":
        return [{"Type": "imgmark", "FilePath": p,
                 "Data": {"text": c.decode().strip(), "bytes": len(c)}}
                for p, c in files]
    out = []
    for p, c in files:
        lines = c.decode().splitlines()
        out.append({"Type": "lockmark", "FilePath": p,
                    "Data": {"lines": len(lines),
                             "last": lines[-1].strip()}})
    return out


def _lockfiles(tree):
    out = []
    for dirpath, _dirs, names in os.walk(tree):
        for n in names:
            full = os.path.join(dirpath, n)
            rel = os.path.relpath(full, tree).replace(os.sep, "/")
            if re.search(LOCKFILES, rel) and "node_modules" not in rel:
                with open(full, "rb") as f:
                    out.append((rel, f.read()))
    return sorted(out)


def _run(cmd, cwd, env):
    p = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                       timeout=300)
    return p.returncode, p.stdout, p.stderr


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mods")
    tree = _tree(str(tmp / "tree"))
    image = _image(str(tmp / "img.tar"))
    plug_home = tmp / "home-plugins"
    (plug_home / "plugins").mkdir(parents=True)
    shutil.copytree(make_plugin_dir(tmp, code=7),
                    plug_home / "plugins" / "echo-plugin")
    _home(str(plug_home), ("lockmark", "dropper"))
    return {"tmp": tmp, "tree": tree, "image": image,
            "plug_home": str(plug_home)}


@pytest.fixture(scope="module")
def cli_runs(world):
    """Every surface through both CLIs, each in a fresh process with its
    own working and cache directory → {surface: {"port"|"ref": (rc,
    output, stderr)}}."""
    tmp = world["tmp"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("TRIVY_")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", TRIVY_TPU_FAKE_NOW=NOW,
               TRIVY_TPU_FAKE_UUID=UUID)
    jobs = {}
    for name, (mods, argv) in SCAN_SURFACES.items():
        home = _home(str(tmp / f"home-{name}"), mods)
        argv = [a.format(**world) for a in argv]
        for who in ("port", "ref"):
            work = tmp / f"{name}-{who}"
            work.mkdir()
            out = work / "out.json"
            cmd = [sys.executable, "-m"] + (
                ["trivy_tpu_torch"] + argv + ["--device", "cpu"]
                if who == "port" else ["trivy_tpu.cli"] + argv) + [
                "--format", "json", "--cache-dir", str(work / "cache"),
                "-o", str(out)]
            jobs[name, who] = (cmd, str(work), dict(
                env, HOME=str(work), TRIVY_TPU_HOME=home), out)
    for name, argv in TEXT_SURFACES.items():
        for who in ("port", "ref"):
            work = tmp / f"{name}-{who}"
            work.mkdir()
            cmd = [sys.executable, "-m",
                   "trivy_tpu_torch" if who == "port" else "trivy_tpu.cli"
                   ] + argv
            jobs[name, who] = (cmd, str(work), dict(
                env, HOME=str(work), TRIVY_TPU_HOME=world["plug_home"]),
                None)
    results = {}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {key: pool.submit(_run, *job[:3]) for key, job in jobs.items()}
        for (name, who), fut in futs.items():
            rc, stdout, err = fut.result()
            out = jobs[name, who][3]
            if out is not None:
                stdout = out.read_bytes() if out.exists() else b""
            results.setdefault(name, {})[who] = (rc, stdout, err)
    return results


def _split_custom(raw: bytes):
    """A port JSON report → (its bytes less the Custom result, that
    result's entries), after checking the writer's round trip."""
    doc = json.loads(raw)
    assert (json.dumps(doc, indent=2, ensure_ascii=False) + "\n").encode() \
        == raw
    custom = [r for r in doc["Results"] if r.get("Class") == "custom"]
    doc["Results"] = [r for r in doc["Results"] if r.get("Class") != "custom"]
    assert len(custom) <= 1
    rest = (json.dumps(doc, indent=2, ensure_ascii=False) + "\n").encode()
    return rest, (custom[0]["CustomResources"] if custom else None)


def _vulns(raw: bytes) -> dict:
    return {(r["Target"], v["VulnerabilityID"]): v["Severity"]
            for r in json.loads(raw)["Results"]
            for v in r.get("Vulnerabilities", [])}


@pytest.mark.parametrize("surface", sorted(SCAN_SURFACES))
def test_scan_like_reference(cli_runs, world, surface):
    port, ref = cli_runs[surface]["port"], cli_runs[surface]["ref"]
    assert port[0] == ref[0] == 0, (port[2][-2000:], ref[2][-2000:])
    rest, custom = _split_custom(_CREATED.sub(b"", port[1]))
    assert rest == _CREATED.sub(b"", ref[1])
    vulns = _vulns(port[1])
    if surface == "fs-analyze-delete":
        assert custom == _expected_custom("lockmark",
                                          _lockfiles(world["tree"]))
        assert ("pip/requirements.txt", "CVE-2019-14806") in vulns
        assert not any(i == "CVE-2020-28724" for _t, i in vulns)
    elif surface == "fs-update-insert":
        assert custom is None
        assert vulns["gomod/go.mod", "CVE-2022-23628"] == "CRITICAL"
        assert sum(i == "MODULE-2026-0001" for _t, i in vulns) == 1
    elif surface == "fs-raising":
        assert custom is None
        assert b"bad-post post_scan failed" in port[2]
        assert len(vulns) == 8   # every finding of the three trees
    else:
        marked = [(p, c) for layer in IMAGE_LAYERS
                  for p, c in sorted(layer.items())
                  if p.startswith("etc/marker/")]
        assert custom == _expected_custom("imgmark", marked)
        assert any(i == "CVE-2023-0286" for _t, i in vulns)


@pytest.mark.parametrize("surface", sorted(TEXT_SURFACES))
def test_commands_like_reference(cli_runs, surface):
    port, ref = cli_runs[surface]["port"], cli_runs[surface]["ref"]
    assert port[0] == ref[0], (port[2][-2000:], ref[2][-2000:])
    assert port[1] == ref[1]
    want = {"plugin-list": (0, b"echo-plugin\t0.1.0\techoes args\n"),
            "passthrough": (7, b"plugin-ran a b\n")}.get(surface)
    if want:
        assert (port[0], port[1]) == want
    if surface == "module-list":
        assert [ln.split(b"\t")[:2] for ln in port[1].splitlines()] == \
            [[b"dropper", b"1"], [b"lockmark", b"2"]]
    if surface == "plugin-info":
        assert b"name: echo-plugin\nversion: 0.1.0\n" in port[1]


# ---- in-process: vm, client/server, cache keys -----------------------

def test_vm_carries_custom_resources(world, tmp_path, monkeypatch):
    """`vm` analyzes file by file (fanal/vm.py): the module's entries
    reach the report, and the rest equals the run without modules."""
    from trivy_tpu_torch.fanal.fixtures import ext4_image
    disk = tmp_path / "disk.img"
    files = dict(IMAGE_LAYERS[0])
    files.update(IMAGE_LAYERS[2])
    disk.write_bytes(ext4_image(files, 8))
    outs = {}
    for with_mods in (True, False):
        home = str(tmp_path / f"home-{with_mods}")
        _home(home, ("imgmark",) if with_mods else ())
        monkeypatch.setenv("TRIVY_TPU_HOME", home)
        out = tmp_path / f"vm-{with_mods}.json"
        assert cli.main(["vm", str(disk), "--db", FIX_DB, "--device", "cpu",
                         "--scanners", "vuln", "--format", "json",
                         "--cache-dir", str(tmp_path / f"c-{with_mods}"),
                         "-o", str(out)]) == 0
        outs[with_mods] = out.read_bytes()
    rest, custom = _split_custom(outs[True])
    assert _CREATED.sub(b"", rest) == _CREATED.sub(b"", outs[False])
    assert custom == _expected_custom(
        "imgmark", sorted((p, c) for p, c in files.items()
                          if p.startswith("etc/marker/")))


def _servers(tmp):
    from trivy_tpu.db import build_table as ref_build_table
    from trivy_tpu.db.fixtures import load_fixture_files as ref_load
    from trivy_tpu.server import listen as ref_listen
    from trivy_tpu_torch.db import build_table
    from trivy_tpu_torch.db.fixtures import load_fixture_files
    from trivy_tpu_torch.server.listen import serve_background
    fixtures = sorted(glob.glob(FIX_DB))
    adv, det, _ = load_fixture_files(fixtures)
    port = serve_background("127.0.0.1", 0, build_table(adv, det),
                            str(tmp / "port-srv"), device="cpu")
    adv, det, _ = ref_load(fixtures)
    ref = ref_listen.serve_background("127.0.0.1", 0,
                                      ref_build_table(adv, det),
                                      str(tmp / "ref-srv"))
    return {"port": port, "ref": ref}


def _post(url, body: bytes, ctype: str) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def test_client_server_json_and_protobuf(world, tmp_path):
    """Modules loaded on both sides: the port's client ships the blob's
    custom resources as JSON and gets the Custom result back; a Go
    client's protobuf PutBlob with custom resources gets them back in
    its ScanResponse. The JAX server, given the same requests, answers
    the same results less that one."""
    from trivy_tpu.fanal.artifact import ImageArchiveArtifact as RefArtifact
    from trivy_tpu.server import client as ref_client
    from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
    from trivy_tpu_torch.server import client
    from trivy_tpu_torch.server.protowire import decode_msg, encode_msg
    mdir = _home(str(tmp_path / "home"), ("imgmark",)) + "/modules"
    tmod.load_modules(mdir)
    ref_module.load_modules(mdir)
    servers = _servers(tmp_path)
    try:
        bases = {who: f"http://127.0.0.1:{httpd.server_address[1]}"
                 for who, (httpd, _state) in servers.items()}
        got = {}
        for who, mod, art in (("port", client, ImageArchiveArtifact),
                              ("ref", ref_client, RefArtifact)):
            ref = art(world["image"], mod.RemoteCache(bases[who]),
                      scanners=("vuln",)).inspect()
            results, _os = mod.RemoteScanner(bases[who]).scan(
                ref.name, ref.id, ref.blob_ids)
            got[who] = [r.to_json() for r in results]
        custom = [r for r in got["port"] if r.get("Class") == "custom"]
        assert [r for r in got["port"] if r.get("Class") != "custom"] == \
            got["ref"]
        marked = [(p, c) for layer in IMAGE_LAYERS
                  for p, c in sorted(layer.items())
                  if p.startswith("etc/marker/")]
        assert len(custom) == 1 and custom[0]["CustomResources"] == \
            _expected_custom("imgmark", marked)

        proto_blob = {
            "schema_version": 2,
            "os": {"family": "alpine", "name": "3.17.3"},
            "package_infos": [{"file_path": "lib/apk/db/installed",
                               "packages": [{"name": "libssl3",
                                             "version": "3.0.7-r0",
                                             "src_name": "openssl",
                                             "src_version": "3.0.7-r0"}]}],
            "custom_resources": [{"type": "imgmark",
                                  "file_path": "etc/marker/a.conf",
                                  "data": {"text": "alpha", "bytes": 6}}],
        }
        pb = "application/protobuf"
        resp = {}
        for who, base in bases.items():
            _post(base + "/twirp/trivy.cache.v1.Cache/PutBlob", encode_msg(
                {"diff_id": "sha256:" + "ab" * 32, "blob_info": proto_blob},
                "PutBlobRequest"), pb)
            raw = _post(base + "/twirp/trivy.scanner.v1.Scanner/Scan",
                        encode_msg({"target": "pb/img:1",
                                    "artifact_id": "sha256:" + "cd" * 32,
                                    "blob_ids": ["sha256:" + "ab" * 32],
                                    "options": {"scanners": ["vuln"]}},
                                   "ScanRequest"), pb)
            resp[who] = decode_msg(raw, "ScanResponse")
        port_results = resp["port"]["results"]
        pcustom = [r for r in port_results if r.get("class") == "custom"]
        assert [r for r in port_results if r.get("class") != "custom"] == \
            resp["ref"]["results"]
        assert "CVE-2023-0286" in {
            v["vulnerability_id"] for r in port_results
            for v in r.get("vulnerabilities", [])}
        assert len(pcustom) == 1
        assert pcustom[0]["custom_resources"] == [
            {"type": "imgmark", "file_path": "etc/marker/a.conf",
             "data": {"text": "alpha", "bytes": 6.0}}]
    finally:
        for httpd, state in servers.values():
            httpd.shutdown()
            httpd.server_close()
            state.close()


def test_versions_and_fs_cache_key_like_reference(world, tmp_path):
    from trivy_tpu.fanal.analyzers import AnalyzerGroup as RefGroup
    from trivy_tpu.fanal.artifact import FilesystemArtifact as RefFS
    from trivy_tpu.fanal.cache import MemoryCache as RefCache
    from trivy_tpu_torch.fanal.analyzers import AnalyzerGroup
    from trivy_tpu_torch.fanal.artifact import FilesystemArtifact
    from trivy_tpu_torch.fanal.cache import MemoryCache

    def keys():
        port = FilesystemArtifact(world["tree"], MemoryCache()).inspect()
        ref = RefFS(world["tree"], RefCache()).inspect()
        return port.blob_ids, ref.blob_ids

    bare = keys()
    assert bare[0] == bare[1]
    mdir = _home(str(tmp_path / "home"), ("lockmark",)) + "/modules"
    tmod.load_modules(mdir)
    ref_module.load_modules(mdir)
    versions = AnalyzerGroup().versions()
    assert versions == RefGroup().versions()
    assert versions["module:lockmark"] == 2
    loaded = keys()
    assert loaded[0] == loaded[1] and loaded[0] != bare[0]


def test_chip_extensions_phase_at_a_small_size_on_cpu(tmp_path, home):
    """chip_smoke.py's `extensions` phase at a small size with
    device="cpu": both modules listed, the report the fs report less one
    ID plus the Custom result of the checkout's 8 lockfiles, nothing
    launched, and the modules gone after."""
    import numpy as np

    import chip_smoke
    table, _deb, names, _raw = chip_smoke.apps_table(
        np.random.default_rng(7), shrink=6)
    db = str(tmp_path / "apps.npz")
    table.save(db)
    root = tmp_path / "checkout"
    for rel, data in chip_smoke.checkout_files(
            np.random.default_rng(8), names, text_mib=1).items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    fs_report, _counts, _s = chip_smoke.inprocess_cli(
        ["fs", str(root), "--db", db, "--scanners", "vuln,secret",
         "--device", "cpu"], {db: table})
    counts, fig = chip_smoke.extensions_phase(
        str(tmp_path), str(root), table, db, fs_report, device="cpu")
    assert fig["modules"] == ["drop-one", "lockfile-digest"]
    assert fig["custom_resources"] == 8
    assert fig["deleted"] == chip_smoke._droppable_id(fs_report)
    assert 0 < fig["vulnerabilities"] < sum(
        len(r.get("Vulnerabilities", [])) for r in fs_report["Results"])
    assert counts["launches"] == {"shiftor": 0, "csr_join": 0,
                                  "csr_join_compact": 0}
    assert os.listdir(home / "modules") == []
    assert tmod.loaded_modules() == []
