"""The port's Rekor client (rekor.py), executable analyzer
(fanal/analyzers/executable.py) and unpackaged post-handler
(fanal/handlers.py UnpackagedHandler), and `image --sbom-sources rekor`,
held against the JAX package on the CPU:

  * tests/test_attestation_rekor.py: TestAttestation and TestRekor
    through test_torch_mirror's twins (each value equal to the
    reference's at tolerance 0), the two CLI cases against the port
    alone, on `--device cpu`;
  * tests/test_unpackaged.py, every case, against the port alone (the
    handler's Rekor URL is process state);
  * both fakes of those files are the port's fanal.fixtures.FakeRekor,
    logging the files' attestations for every digest;
  * both CLIs byte-equal on `image --input ... --sbom-sources rekor`:
    an unpackaged binary whose digest Rekor knows, the image's own
    digest (the remote-SBOM shortcut), and a Rekor that answers 500
    (both fall back to analysis); with the analyzer group's cache keys
    equal; and `fs`/`rootfs`, which take no --sbom-sources in either
    CLI."""

import contextlib
import io
import json
import os

import pytest

import trivy_tpu.cli as ref_cli
from helpers import ALPINE_OS_RELEASE, APK_INSTALLED, make_image
from test_torch_mirror import PORT, load_mirror, port_cases, run_case, \
    twin_cases
from trivy_tpu.fanal import handlers as ref_handlers
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.fanal import handlers as port_handlers
from trivy_tpu_torch.fanal.fixtures import FakeRekor, intoto_envelope, \
    sha256_hex

HERE = os.path.dirname(os.path.abspath(__file__))
DB = os.path.join(HERE, "fixtures", "db", "*.yaml")
NOW = "2026-10-17T00:00:00Z"

ATT = load_mirror("test_attestation_rekor.py", PORT)
UNP = load_mirror("test_unpackaged.py", PORT)


@pytest.fixture(autouse=True)
def _handlers_off():
    yield
    port_handlers.configure_post_handlers(rekor_url="")
    ref_handlers.configure_post_handlers(rekor_url="")


@pytest.fixture()
def rekor_server():
    """test_attestation_rekor.py's fake: its CycloneDX envelope for any
    digest."""
    with FakeRekor(default=ATT.make_envelope(ATT.CDX)) as fake:
        yield f"http://127.0.0.1:{fake.port}"


class _Seen:
    """test_unpackaged.py's `_FakeRekor.hits`: the digests the fake was
    asked for."""
    hits: list = []


@pytest.fixture()
def rekor_url():
    """test_unpackaged.py's fake: its Go-binary SBOM for any digest."""
    with FakeRekor(default=UNP._envelope(UNP.GOBINARY_CDX)) as fake:
        _Seen.hits = fake.searches
        yield f"http://127.0.0.1:{fake.port}"


# ---- the JAX gate files, case by case -----------------------------------

_CLI_CASES = ("test_sbom_command_accepts_attestation",
              "test_image_rekor_sbom_source")


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_attestation_rekor.py", keep=lambda c: c not in _CLI_CASES))
def test_attestation_rekor_case_like_reference(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_attestation_rekor.py", keep=lambda c: c in _CLI_CASES,
    subs=[("from trivy_tpu_torch import cli",
           "from trivy_tpu_torch import __main__ as cli"),
          ('"--list-all-pkgs"])',
           '"--list-all-pkgs", "--device", "cpu", "--cache-dir", '
           'str(tmp_path / "c")])'),
          ('"--rekor-url", rekor_server])',
           '"--rekor-url", rekor_server, "--device", "cpu", '
           '"--cache-dir", str(tmp_path / "c")])')]))
def test_attestation_rekor_cli_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_unpackaged.py", env={"_FakeRekor": _Seen}))
def test_unpackaged_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


def test_every_reference_case_is_accounted_for():
    assert len(port_cases("test_attestation_rekor.py")) == 9
    assert len(port_cases("test_unpackaged.py")) == 9


def test_executable_analyzer_like_reference():
    from trivy_tpu.fanal.analyzers import AnalyzerGroup as RefGroup
    from trivy_tpu.fanal.analyzers.executable import \
        ExecutableAnalyzer as RefExe
    from trivy_tpu_torch.fanal.analyzers import AnalyzerGroup
    from trivy_tpu_torch.fanal.analyzers.executable import \
        ExecutableAnalyzer
    port, ref = ExecutableAnalyzer(), RefExe()
    for path, content in (("usr/bin/a", b"\x7fELF" + b"\0" * 60),
                          ("bin/b.exe", b"MZ\x90\x00rest"),
                          ("bin/c", b"\xcf\xfa\xed\xfe" + b"x" * 9),
                          ("bin/d", b"#!/bin/sh\n"), ("bin/e.json", b"{}"),
                          ("bin/f", b"")):
        assert port.required(path, len(content)) == \
            ref.required(path, len(content))
        got, want = port.analyze(path, content), ref.analyze(path, content)
        assert (got and got.digests) == (want and want.digests)
    # the analyzer enters the cache keys as the JAX package's does
    for enabled in ((), ("executable",), ("executable", "license-file")):
        assert AnalyzerGroup(enabled=enabled).versions() == \
            RefGroup(enabled=enabled).versions()


# ---- the CLI ----------------------------------------------------------

@pytest.fixture()
def work(tmp_path, monkeypatch):
    d = tmp_path / "work"
    d.mkdir()
    monkeypatch.chdir(d)
    for k in [k for k in os.environ if k.startswith("TRIVY_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", NOW)
    return d


ELF = b"\x7fELF\x02\x01\x01" + b"\0" * 57 + b"payload-of-an-unpackaged-tool"
# the SBOM Rekor holds for the binary: npm and pypi packages of the
# fixture DB, at vulnerable versions; the handler adds its first
# application, the npm one
TOOL_CDX = {"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
    {"type": "library", "name": "lodash", "version": "4.17.20",
     "purl": "pkg:npm/lodash@4.17.20"},
    {"type": "library", "name": "requests", "version": "2.30.0",
     "purl": "pkg:pypi/requests@2.30.0"}]}


def _image(tmp_path) -> str:
    img = str(tmp_path / "img.tar")
    make_image(img, [{"etc/os-release": ALPINE_OS_RELEASE,
                      "lib/apk/db/installed": APK_INSTALLED},
                     {"usr/local/bin/tool": ELF,
                      "usr/local/bin/script": b"#!/bin/sh\necho\n"}])
    return img


def run_both(argv: list, tmp_path, tag: str) -> tuple:
    """`argv` through both CLIs in this process, each with its own cache
    dir and output file → (port bytes, reference bytes)."""
    outs = {}
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        out = tmp_path / f"{who}-{tag}.out"
        extra = ["--cache-dir", str(tmp_path / f"{who}-cache-{tag}"),
                 "--output", str(out)]
        if who == "port":
            extra += ["--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv + extra) == 0, who
        outs[who] = out.read_bytes()
    return outs["port"], outs["ref"]


def _digest(img: str) -> str:
    from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
    from trivy_tpu_torch.fanal.cache import MemoryCache
    return ImageArchiveArtifact(img, MemoryCache()).image_digest()


@pytest.mark.parametrize("fmt,walk", [("json", "pipelined"),
                                      ("table", "pipelined"),
                                      ("json", "serial")])
def test_image_unpackaged_binary_like_reference(fmt, walk, work, tmp_path):
    """The binary's digest reaches the handler from the ingest
    pipeline's batched analyzers and from the serial walk alike."""
    img = _image(tmp_path)
    tool = "sha256:" + sha256_hex(ELF)
    serial = ["--ingest-serial"] if walk == "serial" else []
    with FakeRekor({tool: intoto_envelope(TOOL_CDX)}) as fake:
        port, ref = run_both(
            ["image", "--input", img, "--db", DB, "--format", fmt,
             "--list-all-pkgs", "--sbom-sources", "rekor", "--rekor-url",
             f"http://127.0.0.1:{fake.port}", *serial], tmp_path,
            fmt + walk)
        # each CLI: the image's digest, then the one binary's
        assert fake.searches == [_digest(img), tool] * 2
    assert port == ref
    if fmt == "json":
        doc = json.loads(port)
        assert doc["ArtifactType"] == "container_image"
        node = [r for r in doc["Results"] if r.get("Type") == "node-pkg"]
        assert [[v["VulnerabilityID"] for v in r["Vulnerabilities"]]
                for r in node] == [["CVE-2021-23337"]]


def test_image_remote_sbom_shortcut_like_reference(work, tmp_path):
    img = _image(tmp_path)
    digest = _digest(img)
    envelope = intoto_envelope(ATT.CDX, subject_digest=digest)
    with FakeRekor({digest: envelope}) as fake:
        port, ref = run_both(
            ["image", "--input", img, "--db", DB, "--list-all-pkgs",
             "--sbom-sources", "rekor", "--rekor-url",
             f"http://127.0.0.1:{fake.port}"], tmp_path, "sbom")
        assert fake.searches == [digest, digest]
    assert port == ref
    doc = json.loads(port)
    assert doc["ArtifactType"] == "cyclonedx"
    assert doc["ArtifactName"] == img


def test_image_rekor_failure_falls_back_like_reference(work, tmp_path):
    img = _image(tmp_path)
    with FakeRekor(default=intoto_envelope(TOOL_CDX)) as fake:
        fake.fail = 500
        port, ref = run_both(
            ["image", "--input", img, "--db", DB, "--sbom-sources",
             "rekor", "--rekor-url", f"http://127.0.0.1:{fake.port}"],
            tmp_path, "down")
        assert len(fake.searches) == 0
    assert port == ref
    doc = json.loads(port)
    assert doc["ArtifactType"] == "container_image"
    assert not [r for r in doc["Results"] if r.get("Type") == "node-pkg"]
    # the analysis alone, without --sbom-sources: the same report
    plain, _ = run_both(["image", "--input", img, "--db", DB], tmp_path,
                        "plain")
    assert plain == port


@pytest.mark.parametrize("command", ["fs", "rootfs"])
def test_tree_scans_take_no_sbom_sources_like_reference(command, work,
                                                        tmp_path,
                                                        monkeypatch):
    """Neither CLI gives fs or rootfs --sbom-sources: the same usage
    error (the programs' names differ); from TRIVY_SBOM_SOURCES the
    setting reaches neither, and the reports are byte-equal with no
    Rekor asked."""
    root = tmp_path / "tree"
    (root / "etc").mkdir(parents=True)
    (root / "etc" / "os-release").write_bytes(ALPINE_OS_RELEASE)
    (root / "usr" / "bin").mkdir(parents=True)
    (root / "usr" / "bin" / "tool").write_bytes(ELF)
    (root / "package-lock.json").write_text(json.dumps({
        "lockfileVersion": 3, "packages": {
            "": {"name": "app"},
            "node_modules/lodash": {"version": "4.17.20"}}}))
    errs = []
    for main in (cli.main, ref_cli.main):
        err = io.StringIO()
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(err):
            main([command, str(root), "--sbom-sources", "rekor"])
        # the error, after each parser's own program name
        errs.append((e.value.code, err.getvalue().strip().splitlines()[-1]
                     .split(": error: ", 1)[1]))
    assert errs[0] == errs[1] == \
        (2, "unrecognized arguments: --sbom-sources rekor")
    with FakeRekor(default=intoto_envelope(TOOL_CDX)) as fake:
        monkeypatch.setenv("TRIVY_SBOM_SOURCES", "rekor")
        monkeypatch.setenv("TRIVY_REKOR_URL",
                           f"http://127.0.0.1:{fake.port}")
        port, ref = run_both([command, str(root), "--db", DB], tmp_path,
                             command)
        assert fake.searches == []
    assert port == ref
