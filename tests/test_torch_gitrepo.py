"""Remote `repo` (fanal/gitrepo.py and `__main__._repo_checkout`) held
against the JAX CLI on the CPU: a bare repository made with the host's
`git` under tmp_path and cloned through file://, on its default branch,
`--branch`, `--tag` and `--commit`, gives byte-equal reports in both
CLIs (the clock fixed), named by the URL; `looks_like_url` agrees with
the reference's; the three refusals (a ref flag on a local path, a
target that is neither a path nor a URL, a clone that fails) end both
CLIs with the same message; and no clone is left behind."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import tempfile

import pytest

import trivy_tpu.cli as ref_cli
from trivy_tpu.fanal import gitrepo as ref_git
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.fanal import gitrepo as port_git

HERE = os.path.dirname(os.path.abspath(__file__))
DB = os.path.join(HERE, "golden", "db", "*.yaml")
NOW = "2026-10-17T00:00:00Z"
GIT = shutil.which("git")
pytestmark = pytest.mark.skipif(GIT is None, reason="git unavailable")

LOCK = os.path.join(HERE, "golden", "inputs", "npm", "package-lock.json")


def _git(cwd, *args) -> str:
    return subprocess.run(
        [GIT, "-c", "user.name=t", "-c", "user.email=t@example.com",
         "-c", "init.defaultBranch=main", *args], cwd=cwd, check=True,
        capture_output=True, text=True,
        env={**os.environ, "GIT_CONFIG_GLOBAL": os.devnull,
             "GIT_CONFIG_NOSYSTEM": "1"}).stdout.strip()


@pytest.fixture
def remote(tmp_path):
    """A bare repository: main's first commit holds the npm golden
    lockfile (tagged v1), its second a requirements.txt too; branch
    `feature` drops the lockfile and pins another requirement →
    (file:// URL, {"first": main's first commit})."""
    work = tmp_path / "work-tree"
    work.mkdir()
    _git(work, "init", "-q")
    shutil.copy(LOCK, work / "package-lock.json")
    _git(work, "add", "-A")
    _git(work, "commit", "-q", "-m", "one")
    first = _git(work, "rev-parse", "HEAD")
    _git(work, "tag", "v1")
    (work / "requirements.txt").write_text("flask==2.2.2\n")
    _git(work, "add", "-A")
    _git(work, "commit", "-q", "-m", "two")
    _git(work, "checkout", "-q", "-b", "feature")
    (work / "package-lock.json").unlink()
    (work / "requirements.txt").write_text("Jinja2==2.10\n")
    _git(work, "add", "-A")
    _git(work, "commit", "-q", "-m", "three")
    _git(work, "checkout", "-q", "main")
    bare = tmp_path / "remote.git"
    _git(tmp_path, "clone", "-q", "--bare", str(work), str(bare))
    return f"file://{bare}", {"first": first}


@pytest.fixture
def clones(tmp_path, monkeypatch):
    """The temporary directory the clones land in, the clock fixed and
    a working directory of the CLIs' own."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    for k in [k for k in os.environ if k.startswith("TRIVY_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", NOW)
    return tmp


def _left(tmp) -> list:
    """The clones left in the temporary directory (other things land
    there too, the JAX package's native build for one)."""
    return [n for n in os.listdir(tmp) if n.startswith("trivy-repo-")]


def _run(main, argv, out) -> int:
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv + ["--output", str(out)])


def run_both(argv, tmp_path) -> tuple:
    outs = {}
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        out = tmp_path / f"{who}.json"
        extra = ["--cache-dir", str(tmp_path / f"{who}-cache")]
        if who == "port":
            extra += ["--device", "cpu"]
        assert _run(main, argv + extra, out) == 0, who
        outs[who] = out.read_bytes()
    return outs["port"], outs["ref"]


@pytest.mark.parametrize("ref", ["default", "branch", "tag", "commit"])
def test_remote_repo_like_reference(ref, remote, clones, tmp_path):
    url, commits = remote
    flags = {"default": [], "branch": ["--branch", "feature"],
             "tag": ["--tag", "v1"],
             "commit": ["--commit", commits["first"]]}[ref]
    port, ref_out = run_both(["repo", url, *flags, "--db", DB,
                              "--list-all-pkgs"], tmp_path)
    assert port == ref_out
    doc = json.loads(port)
    assert doc["ArtifactName"] == url
    assert doc["ArtifactType"] == "repository"
    targets = {r["Target"] for r in doc["Results"]}
    want = {"default": {"package-lock.json", "requirements.txt"},
            "branch": {"requirements.txt"},
            "tag": {"package-lock.json"},
            "commit": {"package-lock.json"}}[ref]
    assert targets == want
    assert _left(clones) == []


def test_remote_repo_parallel_and_table(remote, clones, tmp_path):
    url, _ = remote
    port, ref = run_both(["repo", url, "--db", DB, "--parallel", "4",
                          "--format", "table"], tmp_path)
    assert port == ref and b"package-lock.json" in port
    assert _left(clones) == []


def test_looks_like_url_like_reference():
    for target in ("https://github.com/a/b", "http://x/y", "git://h/r",
                   "ssh://git@h/r", "file:///tmp/r", "git@github.com:a/b",
                   "github.com/a/b", "./local", "a:b", "user@host",
                   "C:/path", ""):
        assert port_git.looks_like_url(target) == \
            ref_git.looks_like_url(target), target


@pytest.mark.parametrize("case", ["ref_on_local_path", "not_a_url",
                                  "failing_clone", "missing_ref"])
def test_refusals_like_reference(case, remote, clones, tmp_path):
    url, _ = remote
    argv = {"ref_on_local_path": ["repo", str(tmp_path), "--tag", "v1"],
            "not_a_url": ["repo", "no/such/dir"],
            "failing_clone": ["repo", f"file://{tmp_path}/none.git"],
            "missing_ref": ["repo", url, "--branch", "nope"]}[case]
    codes = []
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        extra = ["--db", DB, "--cache-dir", str(tmp_path / who)]
        if who == "port":
            extra += ["--device", "cpu"]
        with pytest.raises(SystemExit) as e:
            _run(main, argv + extra, tmp_path / f"{who}.json")
        codes.append(e.value.code)
    assert codes[0] == codes[1]
    assert isinstance(codes[0], str)   # a message: exit code 1
    if case == "not_a_url":
        assert codes[0] == "no such path: no/such/dir"
    elif case == "ref_on_local_path":
        assert codes[0].startswith("--branch/--tag/--commit apply to")
    else:
        assert codes[0].startswith("git clone ") and " failed: " in codes[0]
    assert _left(clones) == []


def test_clone_cleanup_removes_the_checkout(remote, clones):
    url, commits = remote
    dest, cleanup = port_git.clone_repo(url, commit=commits["first"])
    assert os.path.dirname(dest) == str(clones)
    assert os.path.exists(os.path.join(dest, "package-lock.json"))
    assert not os.path.exists(os.path.join(dest, "requirements.txt"))
    cleanup()
    assert _left(clones) == []
