"""The port's installed-package analyzers against the JAX package's, on
the same bytes (tolerance 0): Go binaries, jars (nested pom.properties,
the Java DB's sha1 and artifact-id lookups, the file-name heuristic,
duplicates), node_modules package.json, gemspecs, conda-meta and
cargo-auditable Rust binaries, malformed input included; the Java DB
built in a temporary directory against none; and the port's binary
byte builders read back by the JAX package's parsers."""

import hashlib
import io
import json
import zipfile

import pytest

import trivy_tpu.fanal.analyzers as ref_an
from trivy_tpu import javadb as ref_javadb
from trivy_tpu.fanal.analyzers.binaries import \
    executable_candidate as ref_executable_candidate
from trivy_tpu.fanal.analyzers.binaries import \
    parse_go_buildinfo as ref_parse_go
from trivy_tpu.fanal.analyzers.lockfiles_extra import \
    parse_rust_audit as ref_parse_rust
from trivy_tpu_torch import javadb as port_javadb
from trivy_tpu_torch.fanal import analyzers as port_an
from trivy_tpu_torch.fanal.analyzers.binaries import (executable_candidate,
                                                      parse_go_buildinfo)
from trivy_tpu_torch.fanal.analyzers.lockfiles_extra import (
    _elf_section, parse_rust_audit)
from trivy_tpu_torch.fanal.fixtures import go_binary_bytes, rust_audit_elf

INDIVIDUAL = port_an.INDIVIDUAL_PKG_ANALYZERS
PORT_GROUP = port_an.AnalyzerGroup()
REF_GROUP = ref_an.AnalyzerGroup()


def _result_json(r):
    if r is None:
        return None
    return {"applications": [a.to_json() for a in r.applications],
            "package_infos": [p.to_json() for p in r.package_infos]}


def _one(group, name):
    (a,) = [a for a in group.analyzers if a.name == name]
    return a


def make_jar(entries=None) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("META-INF/MANIFEST.MF", "Manifest-Version: 1.0\n")
        for name, content in (entries or {}).items():
            z.writestr(name, content)
    return buf.getvalue()


LOG4J_POM = {"META-INF/maven/org.apache.logging.log4j/log4j-core/"
             "pom.properties": "groupId=org.apache.logging.log4j\n"
                               "artifactId=log4j-core\nversion=2.14.1\n"}
SHADED = {"META-INF/maven/com.dep/inner/pom.properties":
          "groupId=com.dep\nartifactId=inner\nversion=3.1\n",
          "META-INF/maven/com.dep/inner2/pom.properties":
          "# comment\ngroupId=com.dep\nartifactId=inner\nversion=3.1\n",
          "META-INF/maven/x/y/pom.properties": "groupId=x\nversion=1\n"}
GO_DEPS = [("golang.org/x/text", "v0.3.7"),
           ("github.com/gin-gonic/gin", "v1.7.7"),
           ("golang.org/x/text", "v0.3.7"),
           ("example.com/local", "(devel)"),
           ("github.com/docker/distribution", "v2.7.1+incompatible")]
RUST_PKGS = [
    {"name": "myapp", "version": "0.1.0", "source": "local",
     "kind": "runtime"},
    {"name": "serde", "version": "1.0.160", "source": "crates.io",
     "kind": "runtime"},
    {"name": "cc", "version": "1.0.0", "source": "crates.io",
     "kind": "build"},
    {"name": "ammonia", "version": "2.0.0", "source": "crates.io"}]
GEMSPEC = b'''Gem::Specification.new do |s|
  s.name = "rails".freeze
  s.version = "7.0.4"
  s.name = "other"
end
'''

# (analyzer, path, bytes)
CASES = [
    ("gobinary", "usr/local/bin/app", go_binary_bytes(GO_DEPS)),
    ("gobinary", "app", go_binary_bytes([("a.b/c", "v1.0.0-rc.1")])),
    ("gobinary", "usr/bin/tool", b"\x7fELF" + b"\x00" * 200),
    ("gobinary", "opt/x/tool.exe", b"MZ\x90\x00" + b"\x00" * 60),
    ("gobinary", "usr/bin/script", b"#!/bin/sh\necho hi\n"),
    ("gobinary", "usr/bin/cut",
     go_binary_bytes(GO_DEPS)[:120]),                       # truncated
    ("jar", "app/lib/log4j-core-2.14.1.jar", make_jar(LOG4J_POM)),
    ("jar", "app/lib/log4j-core-2.15.0.jar", make_jar(LOG4J_POM)),
    ("jar", "lib/commons-io-2.8.0.jar", make_jar()),
    ("jar", "lib/uber.war", make_jar(SHADED)),
    ("jar", "lib/noversion.jar", make_jar()),
    ("jar", "lib/spring-core-5.3.0-sources.jar", make_jar()),
    ("jar", "lib/broken-1.0.jar", b"PK\x03\x04 not a zip"),
    ("node-pkg", "app/node_modules/lodash/package.json",
     b'{"name": "lodash", "version": "4.17.19", "license": "MIT"}'),
    ("node-pkg", "node_modules/@s/p/package.json",
     b'{"name": "@s/p", "version": "1.0.0", '
     b'"license": {"type": "ISC"}}'),
    ("node-pkg", "node_modules/n/package.json",
     b'{"name": "n", "version": 3}'),
    ("node-pkg", "node_modules/bad/package.json", b"{"),
    ("gemspec", "usr/local/bundle/specifications/rails-7.0.4.gemspec",
     GEMSPEC),
    ("gemspec", "gems/specifications/q-1.gemspec",
     b"s.name = 'q'\ns.version = '1.0'.freeze\n"),
    ("gemspec", "gems/specifications/none.gemspec", b"nothing here\n"),
    ("conda-pkg", "opt/conda/conda-meta/numpy-1.24.0-py39.json",
     b'{"name": "numpy", "version": "1.24.0", "license": "BSD-3-Clause"}'),
    ("conda-pkg", "opt/conda/conda-meta/bad.json", b"{"),
    ("conda-pkg", "opt/conda/conda-meta/nover.json", b'{"name": "x"}'),
    ("rustbinary", "usr/local/bin/myapp", rust_audit_elf(RUST_PKGS)),
    ("rustbinary", "usr/local/bin/rootonly",
     rust_audit_elf(RUST_PKGS[:1])),
    ("rustbinary", "usr/local/bin/plain", b"\x7fELF" + b"\x00" * 200),
    ("rustbinary", "usr/local/bin/bigend",
     b"\x7fELF\x02\x02" + b"\x00" * 100),
]


@pytest.fixture(autouse=True)
def no_java_db():
    yield
    port_javadb.set_db(None)
    ref_javadb.set_db(None)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}:{c[1]}" for c in CASES])
def test_binary_analyzer_matches_reference(case):
    name, path, content = CASES[case]
    port, ref = _one(PORT_GROUP, name), _one(REF_GROUP, name)
    assert name in INDIVIDUAL
    assert port.version == ref.version
    assert port.required(path, len(content)) == \
        ref.required(path, len(content)) is True
    assert _result_json(port.analyze(path, content)) == \
        _result_json(ref.analyze(path, content))


def _java_db_entries():
    jar = make_jar()
    return [("com.example", "lib", "2.0.1",
             hashlib.sha1(make_jar()).hexdigest(), "jar"),
            ("com.example", "uber", "9.9",
             hashlib.sha1(make_jar(SHADED)).hexdigest(), "jar"),
            ("commons-io", "commons-io", "2.8.0", "11" * 20, "jar"),
            ("javax.servlet", "jstl", "1.2", "22" * 20, "jar"),
            ("javax.servlet", "jstl", "1.2", "33" * 20, "jar"),
            ("jstl", "jstl", "1.2", "44" * 20, "jar"),
            ("jstl", "jstl", "1.2", "55" * 20, "pom")], jar


@pytest.mark.parametrize("with_db", [False, True], ids=["no_db", "db"])
@pytest.mark.parametrize("path,entries", [
    ("app/lib.jar", None),
    ("lib/commons-io-2.8.0.jar", None),
    ("lib/jstl-1.2.jar", {"META-INF/x.txt": "x"}),
    ("lib/uber-1.0.jar", SHADED),
    ("lib/log4j-core-2.14.1.jar", LOG4J_POM),
])
def test_jar_with_java_db_matches_reference(tmp_path, with_db, path,
                                            entries):
    """The jar analyzer with a Java DB built in tmp_path by each package
    (sha1 hit, artifact-id vote, none) and with no DB."""
    rows, _ = _java_db_entries()
    if with_db:
        port_javadb.set_db(port_javadb.build_db(
            str(tmp_path / "port" / "j.db"), rows))
        ref_javadb.set_db(ref_javadb.build_db(
            str(tmp_path / "ref" / "j.db"), rows))
    jar = make_jar(entries)
    port = _one(PORT_GROUP, "jar").analyze(path, jar)
    ref = _one(REF_GROUP, "jar").analyze(path, jar)
    assert _result_json(port) == _result_json(ref)


def test_java_db_lookups_match_reference(tmp_path):
    rows, jar = _java_db_entries()
    port = port_javadb.build_db(str(tmp_path / "a" / "j.db"), rows)
    ref = ref_javadb.build_db(str(tmp_path / "b" / "j.db"), rows)
    digest = hashlib.sha1(jar).hexdigest()
    for db in (port, ref):
        assert db.search_by_sha1(digest) == ("com.example", "lib", "2.0.1")
        assert db.search_by_sha1("00" * 20) is None
        assert db.search_by_artifact_id("jstl", "1.2") == "javax.servlet"
        assert db.search_by_artifact_id("nope", "1.0") == ""
    port.close()
    ref.close()
    cache = tmp_path / "cache"
    port_javadb.build_db(port_javadb.db_path(str(cache)), rows).close()
    assert port_javadb.init(cache_dir=str(cache)) is port_javadb.get_db()
    assert port_javadb.get_db().search_by_sha1(digest)[1] == "lib"
    assert port_javadb.init(path=str(tmp_path / "missing.db")) is None
    assert port_javadb.get_db() is None


@pytest.mark.parametrize("deps", [
    GO_DEPS, [], [("k8s.io/api", "v0.27.1")],
    [(f"example.com/m{i:03d}", f"v1.{i}.0") for i in range(150)]])
def test_go_binary_bytes_parse_like_reference(deps):
    elf = go_binary_bytes(deps)
    assert parse_go_buildinfo(elf) == ref_parse_go(elf)
    go_version, got = ref_parse_go(elf)
    assert go_version == "go1.21.5"
    assert got == [(n, v[1:]) for n, v in deps if v != "(devel)"]


@pytest.mark.parametrize("pkgs", [
    RUST_PKGS, [], [{"name": f"crate{i}", "version": f"0.{i}.1",
                     "source": "crates.io", "kind": "runtime"}
                    for i in range(60)]])
def test_rust_audit_elf_parses_like_reference(pkgs):
    elf = rust_audit_elf(pkgs)
    assert parse_rust_audit(elf) == ref_parse_rust(elf)
    assert ref_parse_rust(elf) == [
        (p["name"], p["version"], p.get("source") == "local")
        for p in pkgs if p.get("kind") != "build"]
    assert _elf_section(elf, ".none") is None


@pytest.mark.parametrize("content", [
    b"", b"\x7fELF", b"\x7fELF\x01\x01" + b"\x00" * 60,
    b"\x7fELF\x02\x01" + b"\x00" * 34 + b"\xff" * 30,
    b"\xff Go buildinf:" + b"\x08\x02" + b"\x00" * 16 + b"\xff\xff",
    b"\xff Go buildinf:" + b"\x08\x00" + b"\x00" * 40])
def test_binary_parsers_refuse_like_reference(content):
    assert parse_go_buildinfo(content) == ref_parse_go(content)
    assert parse_rust_audit(content) == ref_parse_rust(content)


@pytest.mark.parametrize("path", [
    "usr/bin/app", "app", "opt/tool.bin", "srv/x/y", "bin/run.sh",
    "usr/local/lib/libz.so", "home/u/app/server", "a.exe"])
def test_executable_candidate_matches_reference(path):
    assert executable_candidate(path) == ref_executable_candidate(path)


def test_individual_packages_aggregate_like_reference():
    """Two node-pkg apps merge into one result; a lockfile app stays."""
    import trivy_tpu.types as RT
    from trivy_tpu.fanal.applier import apply_layers as ref_apply
    from trivy_tpu_torch import types as PT
    from trivy_tpu_torch.fanal.applier import apply_layers

    def blob(T):
        return T.BlobInfo(applications=[
            T.Application(type=t, file_path=f, packages=[
                T.Package(name=n, version=v, file_path=f)])
            for t, f, n, v in [
                ("node-pkg", "b/package.json", "b", "2"),
                ("node-pkg", "a/package.json", "a", "1"),
                ("jar", "x.jar", "g:x", "1.0"),
                ("gobinary", "bin/app", "m", "1.0"),
                ("npm", "package-lock.json", "c", "3")]])
    port = apply_layers([blob(PT)])
    ref = ref_apply([blob(RT)])
    assert [a.to_json() for a in port.applications] == \
        [a.to_json() for a in ref.applications]
    assert json.dumps([(a.type, len(a.packages))
                       for a in port.applications]) == json.dumps(
        [["gobinary", 1], ["npm", 1], ["jar", 1], ["node-pkg", 2]])
