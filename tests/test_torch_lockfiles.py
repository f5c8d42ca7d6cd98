"""The port's language lockfile analyzers against the JAX package's, on
the same bytes (tolerance 0: packages, ids, flags, graph edges and line
Locations are strings, booleans and integers): every lockfile analyzer
of lockfiles.py, lockfiles_extra.py and the pip requirements analyzer,
on the inline cases of the JAX package's own tests, on malformed input,
and on the vendored golden inputs walked as the `fs`, `repo` and
`rootfs` commands walk them."""

import json
import os

import pytest

import trivy_tpu.fanal.analyzers as ref_an
import trivy_tpu.fanal.walker as ref_walker
from trivy_tpu.jsonpos import parse as ref_json_parse
from trivy_tpu_torch.fanal import analyzers as port_an
from trivy_tpu_torch.fanal import walker as port_walker
from trivy_tpu_torch.jsonpos import JSONPosError
from trivy_tpu_torch.jsonpos import parse as port_json_parse

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_INPUTS = os.path.join(HERE, "golden", "inputs")

PORT_GROUP = port_an.AnalyzerGroup()
PORT_NAMES = {a.name for a in PORT_GROUP.analyzers
              + PORT_GROUP.post_analyzers}
# the JAX package's analyzers that the port has not ported (executable)
# and the opt-in ones stay off on both sides
REF_OFF = tuple((set(ref_an.all_analyzers()) | set(ref_an._POST_REGISTRY))
                - PORT_NAMES)
REF_GROUP = ref_an.AnalyzerGroup(disabled=REF_OFF)


def _result_json(r):
    """The fields both packages' AnalysisResult carry, as JSON."""
    if r is None:
        return None
    return {"os": r.os.to_json() if r.os else None,
            "package_infos": [p.to_json() for p in r.package_infos],
            "applications": [a.to_json() for a in r.applications],
            "system_installed_files": list(r.system_installed_files)}


def _one(group, name):
    (a,) = [a for a in group.analyzers + group.post_analyzers
            if a.name == name]
    return a


def _npm_v3() -> bytes:
    return json.dumps({
        "name": "demo", "lockfileVersion": 3,
        "packages": {
            "": {"name": "demo", "version": "1.0.0",
                 "dependencies": {"lodash": "^4"},
                 "devDependencies": {"jest": "^29"}},
            "node_modules/lodash": {"version": "4.17.20"},
            "node_modules/jest": {"version": "29.0.0", "dev": True,
                                  "dependencies": {"@scope/pkg": "^2"}},
            "node_modules/@scope/pkg": {"version": "2.0.0"},
            "node_modules/jest/node_modules/@scope/pkg": {
                "version": "2.1.0", "dev": True},
        }}, indent=2).encode()


def _npm_v1() -> bytes:
    return json.dumps({
        "dependencies": {
            "lodash": {"version": "4.17.11"},
            "express": {"version": "4.18.0", "requires": {"qs": "^6"},
                        "dependencies": {"qs": {"version": "6.10.0"}}},
            "chai": {"version": "4.3.0", "dev": True,
                     "requires": {"lodash": "^4"}},
        }}, indent=2).encode()


YARN_CLASSIC = b'''# yarn lockfile v1

lodash@^4.17.0:
  version "4.17.19"
  resolved "https://registry.example/lodash"

"@babel/core@^7.0.0":
  version "7.20.0"
  dependencies:
    lodash "^4.17.0"
'''

YARN_BERRY = b"""\
# This file is generated by running "yarn install"

"asap@npm:~2.0.6":
  version: 2.0.6
  resolution: "asap@npm:2.0.6"

"promise@npm:^8.0.3":
  version: 8.0.3
  resolution: "promise@npm:8.0.3"
  dependencies:
    asap: ~2.0.6
"""

PNPM = b'''lockfileVersion: '6.0'
packages:
  /lodash@4.17.21:
    resolution: {integrity: sha512-x}
  /@scope/a@1.2.3(react@18.0.0):
    resolution: {integrity: sha512-y}
    dev: true
  /left-pad/1.3.0:
    resolution: {integrity: sha512-z}
'''

GO_MOD = b'''module example.com/app

go 1.21

require (
\tgolang.org/x/text v0.3.7
\tgithub.com/pkg/errors v0.9.1 // indirect
)

require github.com/stretchr/testify v1.8.0
'''

GO_MOD_OLD = b'''module example.com/old

go 1.15

require github.com/docker/distribution v2.7.1+incompatible
'''

GO_SUM = b'''github.com/docker/distribution v2.7.1+incompatible h1:a=
github.com/docker/distribution v2.7.1+incompatible/go.mod h1:b=
golang.org/x/net v0.0.0-20200822124328-c89045814202/go.mod h1:c=
golang.org/x/net v0.0.0-20210226172049-e18ecbb05110 h1:d=
'''

CARGO = b'''version = 3

[[package]]
name = "serde"
version = "1.0.150"

[[package]]
name = "tokio"
version = "1.21.2"
dependencies = ["serde"]
'''

POETRY = b'''[[package]]
name = "flask"
version = "2.2.2"
category = "main"

[package.dependencies]
Werkzeug = ">=2.2.2"

[[package]]
name = "werkzeug"
version = "2.2.2"
category = "main"

[[package]]
name = "pytest"
version = "7.2.0"
category = "dev"
'''

PYPROJECT = b'''[tool.poetry.dependencies]
python = "^3.9"
Flask = "^2.2"
'''

GEMFILE = b'''GEM
  remote: https://rubygems.org/
  specs:
    rails (7.0.4)
      actionpack (= 7.0.4)
    nokogiri (1.13.9)

GIT
  remote: https://github.com/x/y.git
  specs:
    gitgem (0.1.0)

PLATFORMS
  ruby

DEPENDENCIES
  rails
'''

COMPOSER_LOCK = json.dumps({
    "packages": [
        {"name": "monolog/monolog", "version": "v2.8.0",
         "license": ["MIT"], "require": {"psr/log": "^1"}},
        {"name": "psr/log", "version": "1.1.4", "license": "MIT"}],
    "packages-dev": [{"name": "phpunit/phpunit", "version": "9.5.0"}],
}, indent=4).encode()

POM = b"""<?xml version="1.0"?>
<project xmlns="http://maven.apache.org/POM/4.0.0">
  <groupId>com.example</groupId>
  <artifactId>app</artifactId>
  <version>1.0.0</version>
  <properties><guava.ver>31.1-jre</guava.ver></properties>
  <dependencyManagement><dependencies>
    <dependency><groupId>org.m</groupId><artifactId>managed</artifactId>
      <version>3.2</version></dependency>
  </dependencies></dependencyManagement>
  <dependencies>
    <dependency>
      <groupId>com.google.guava</groupId>
      <artifactId>guava</artifactId>
      <version>${guava.ver}</version>
    </dependency>
    <dependency>
      <groupId>junit</groupId><artifactId>junit</artifactId>
      <version>4.13</version><scope>test</scope>
    </dependency>
    <dependency>
      <groupId>org.x</groupId><artifactId>unresolved</artifactId>
      <version>${missing.prop}</version>
    </dependency>
    <dependency>
      <groupId>org.m</groupId><artifactId>managed</artifactId>
    </dependency>
    <dependency>
      <groupId>org.r</groupId><artifactId>ranged</artifactId>
      <version>[1.0,2.0)</version>
    </dependency>
  </dependencies>
</project>"""

POM_CHILD = b"""<project>
  <parent><groupId>org.p</groupId><artifactId>parent</artifactId>
    <version>2.5</version></parent>
  <artifactId>child</artifactId>
  <dependencies>
    <dependency><groupId>org.p</groupId><artifactId>sib</artifactId>
      <version>${project.version}</version></dependency>
  </dependencies>
</project>"""

NUGET_LOCK = json.dumps({"version": 1, "dependencies": {
    "net6.0": {
        "Newtonsoft.Json": {"type": "Direct", "resolved": "13.0.1",
                            "dependencies": {"X": "1.0"}},
        "X": {"type": "Transitive", "resolved": "1.0.0"},
        "MyProj": {"type": "Project"},
    }}}, indent=2).encode()

NUGET_CONFIG = (b'<?xml version="1.0"?><packages>'
                b'<package id="A" version="2.1" />'
                b'<package id="Dev" version="1.0" '
                b'developmentDependency="true"/>'
                b'</packages>')

DOTNET_DEPS = json.dumps({"libraries": {
    "App/1.0.0": {"type": "project"},
    "Serilog/2.10.0": {"type": "package"},
    "Bad": {"type": "package"},
}}, indent=2).encode()

PACKAGES_PROPS = (b"<Project><ItemGroup>"
                  b'<PackageVersion Include="PkgA" Version="3.2.1" />'
                  b'<PackageVersion Include="Var" Version="$(VersionProp)" />'
                  b'<PackageReference Update="PkgB" Version="1.0" />'
                  b"</ItemGroup></Project>")

CONAN_V1 = json.dumps({"graph_lock": {"nodes": {
    "0": {"ref": "root/0.1", "requires": ["1"]},
    "1": {"ref": "zlib/1.2.13#rev", "requires": ["2"]},
    "2": {"ref": "bzip2/1.0.8"},
}}}, indent=2).encode()

CONAN_V2 = json.dumps({"version": "0.5",
                       "requires": ["openssl/3.1.0#abc%123"],
                       "build_requires": ["cmake/3.27.0"]}).encode()

MIX = b'''%{
  "phoenix": {:hex, :phoenix, "1.7.2", "cafe", [:mix], [], "hexpm", "sum"},
  "gitdep": {:git, "https://github.com/x/y.git", "abcdef", []},
}
'''

SWIFT_V1 = json.dumps({"version": 1, "object": {"pins": [
    {"package": "NIO",
     "repositoryURL": "https://github.com/apple/swift-nio.git",
     "state": {"version": "2.41.0"}}]}}, indent=2).encode()

SWIFT_V2 = json.dumps({"version": 2, "pins": [
    {"identity": "vapor", "location": "https://github.com/vapor/vapor.git",
     "state": {"branch": "main"}}]}, indent=2).encode()

PODFILE = b"""PODS:
  - Alamofire (5.6.2)
  - Moya/Core (15.0.0):
    - Alamofire (~> 5.6)
DEPENDENCIES:
  - Moya (~> 15.0)
"""

PUBSPEC = b"""packages:
  http:
    dependency: "direct main"
    version: "0.13.5"
  path:
    dependency: transitive
    version: "1.8.2"
"""

JULIA = b"""julia_version = "1.9.0"
manifest_format = "2.0"

[[deps.JSON]]
uuid = "682c06a0-de6a-54ab-a142-c8b1cf79cde6"
version = "0.21.4"

[[deps.Unicode]]
uuid = "4ec0a83e-493e-50e2-b9ac-8f72acf5a8f5"
"""

JULIA_OLD = b"""[[Example]]
uuid = "7876af07-990d-54b4-ab0e-23690620f79a"
version = "0.5.3"

[[Base64]]
uuid = "2a0f44e3-6c83-55bd-87e4-b1978d98bd5f"
"""

REQUIREMENTS = b"""# pinned
Flask==2.2.2
requests >= 2.0
Werkzeug == 0.15.0
-r other.txt
"""

# (analyzer, path, bytes): the single-file lockfile analyzers, the JAX
# package's test inputs and edge cases, then malformed input for each
CASES = [
    ("pnpm", "pnpm-lock.yaml", PNPM),
    ("cargo", "rust/Cargo.lock", CARGO),
    ("pipenv", "Pipfile.lock", json.dumps(
        {"default": {"requests": {"version": "==2.28.1"},
                     "unpinned": {"version": "*"}},
         "develop": {"black": {"version": "==22.10.0"}}},
        indent=4).encode()),
    ("bundler", "Gemfile.lock", GEMFILE),
    ("pom", "app/pom.xml", POM),
    ("pom", "pom.xml", POM_CHILD),
    ("pom", "lib/x.pom", b"<notproject/>"),
    ("gradle-lockfile", "proj/gradle.lockfile",
     b"# comment\norg.springframework:spring-core:5.3.21=classpath\n"
     b"empty=\n"),
    ("nuget", "obj/packages.lock.json", NUGET_LOCK),
    ("nuget", "packages.config", NUGET_CONFIG),
    ("dotnet-deps", "app/App.deps.json", DOTNET_DEPS),
    ("packages-props", "src/Directory.Packages.props", PACKAGES_PROPS),
    ("conan", "conan.lock", CONAN_V1),
    ("conan", "v2/conan.lock", CONAN_V2),
    ("mix-lock", "mix.lock", MIX),
    ("swift", "Package.resolved", SWIFT_V1),
    ("swift", "v2/Package.resolved", SWIFT_V2),
    ("cocoapods", "Podfile.lock", PODFILE),
    ("pub", "pubspec.lock", PUBSPEC),
    ("julia", "Manifest.toml", JULIA),
    ("julia", "old/Manifest.toml", JULIA_OLD),
    ("pip", "requirements.txt", REQUIREMENTS),
    # malformed input: each analyzer declines it
    ("pnpm", "bad/pnpm-lock.yaml", b"packages: [unclosed"),
    ("pnpm", "list/pnpm-lock.yaml", b"- a\n- b\n"),
    ("cargo", "bad/Cargo.lock", b"[[package]\nname ="),
    ("pipenv", "bad/Pipfile.lock", b'{"default": {'),
    ("pipenv", "list/Pipfile.lock", b"[1, 2]"),
    ("bundler", "bad/Gemfile.lock", b"\x00\xff not a lockfile\n"),
    ("pom", "bad/pom.xml", b"<project><dependencies>"),
    ("gradle-lockfile", "bad/gradle.lockfile", b"no colons here\n"),
    ("nuget", "bad/packages.lock.json", b'{"dependencies": ['),
    ("nuget", "bad/packages.config", b"<packages"),
    ("dotnet-deps", "bad/App.deps.json", b"{'single': 'quotes'}"),
    ("packages-props", "bad/Packages.props", b"<Project"),
    ("conan", "bad/conan.lock", b'{"graph_lock": '),
    ("mix-lock", "bad/mix.lock", b"%{ not elixir"),
    ("swift", "bad/Package.resolved", b"[]"),
    ("cocoapods", "bad/Podfile.lock", b"PODS: [\n"),
    ("pub", "bad/pubspec.lock", b"packages: {http: ["),
    ("julia", "bad/Manifest.toml", b"[[deps.X]\n"),
    ("pip", "bad/requirements.txt", b"not a pin\n"),
]

# (post-analyzer, {path: bytes}): the multi-file lockfile analyzers
POST_CASES = [
    ("npm", {"app/package-lock.json": _npm_v3(),
             "app/node_modules/lodash/package.json":
                 b'{"name": "lodash", "version": "4.17.20", '
                 b'"license": "MIT"}',
             "app/node_modules/jest/package.json":
                 b'{"name": "jest", "version": "29.0.0", '
                 b'"licenses": [{"type": "MIT"}, {"type": "BSD"}]}',
             "app/node_modules/bad/package.json": b"{"}),
    ("npm", {"package-lock.json": _npm_v1()}),
    ("npm", {"package-lock.json": b'{"lockfileVersion": 2, "packages": ['}),
    ("npm", {"package-lock.json": b"[]",
             "vendor/node_modules/x/package-lock.json": _npm_v1()}),
    ("yarn", {"yarn.lock": YARN_CLASSIC}),
    ("yarn", {"web/yarn.lock": YARN_CLASSIC,
              "web/package.json": b'{"dependencies": {"@babel/core": '
                                  b'"^7.0.0"}}',
              "web/node_modules/lodash/package.json":
                  b'{"name": "lodash", "version": "4.17.19", '
                  b'"license": {"type": "MIT"}}'}),
    ("yarn", {"yarn.lock": YARN_BERRY,
              "package.json": b'{"devDependencies": {"promise": '
                              b'"^8.0.3"}}'}),
    ("yarn", {"yarn.lock": b"\x00\x01garbage", "package.json": b"{"}),
    ("gomod", {"go.mod": GO_MOD}),
    ("gomod", {"old/go.mod": GO_MOD_OLD, "old/go.sum": GO_SUM}),
    ("gomod", {"go.mod": b"module x\n\nrequire (\n)\n", "go.sum": b"x"}),
    ("poetry", {"poetry.lock": POETRY, "pyproject.toml": PYPROJECT}),
    ("poetry", {"poetry.lock": POETRY}),
    ("poetry", {"poetry.lock": b"[[package]\n", "pyproject.toml": b"="}),
    ("composer", {"composer.lock": COMPOSER_LOCK,
                  "composer.json": b'{"require": {"monolog/monolog": '
                                   b'"^2"}}'}),
    ("composer", {"composer.lock": COMPOSER_LOCK}),
    ("composer", {"composer.lock": b'{"packages": [',
                  "composer.json": b"[]"}),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}:{c[1]}" for c in CASES])
def test_lockfile_analyzer_matches_reference(case):
    name, path, content = CASES[case]
    port, ref = _one(PORT_GROUP, name), _one(REF_GROUP, name)
    assert port.version == ref.version
    assert port.required(path, len(content)) == \
        ref.required(path, len(content)) is True
    assert _result_json(port.analyze(path, content)) == \
        _result_json(ref.analyze(path, content))


@pytest.mark.parametrize("case", range(len(POST_CASES)),
                         ids=[f"{c[0]}:{i}" for i, c in
                              enumerate(POST_CASES)])
def test_post_analyzer_matches_reference(case):
    name, files = POST_CASES[case]
    port, ref = _one(PORT_GROUP, name), _one(REF_GROUP, name)
    assert port.version == ref.version
    wanted = {p: c for p, c in files.items() if ref.required(p, len(c))}
    assert {p for p in files if port.required(p, len(files[p]))} == \
        set(wanted)
    assert _result_json(port.post_analyze(wanted)) == \
        _result_json(ref.post_analyze(wanted))


def _golden_dirs():
    return sorted(d for d in os.listdir(GOLDEN_INPUTS)
                  if os.path.isdir(os.path.join(GOLDEN_INPUTS, d)))


# the analyzer sets each command disables (trivy_tpu/cli.py:975-986)
COMMANDS = {
    "fs": port_an.INDIVIDUAL_PKG_ANALYZERS,
    "repo": port_an.INDIVIDUAL_PKG_ANALYZERS + port_an.OS_ANALYZERS,
    "rootfs": port_an.LOCKFILE_ANALYZERS,
}


@pytest.mark.parametrize("command", sorted(COMMANDS))
@pytest.mark.parametrize("input_dir", _golden_dirs())
def test_golden_inputs_walk_like_reference(input_dir, command):
    """Each vendored golden input tree walked through the command's
    analyzer set: the same blob, Locations and post-analyzers included,
    and the same secret candidates."""
    root = os.path.join(GOLDEN_INPUTS, input_dir)
    off = COMMANDS[command]
    port = port_walker.walk_fs(root, port_an.AnalyzerGroup(disabled=off),
                               collect_secrets=True)
    ref = ref_walker.walk_fs(root, ref_an.AnalyzerGroup(
        disabled=tuple(off) + REF_OFF), collect_secrets=True)
    assert port.secret_files == ref.secret_files
    assert port_walker.blob_info(port).to_json() == \
        ref_walker.blob_info(ref).to_json()


def test_registry_matches_reference():
    assert port_an.INDIVIDUAL_PKG_ANALYZERS == \
        ref_an.INDIVIDUAL_PKG_ANALYZERS
    assert port_an.LOCKFILE_ANALYZERS == ref_an.LOCKFILE_ANALYZERS
    assert port_an.OS_ANALYZERS == ref_an.OS_ANALYZERS
    assert PORT_GROUP.versions() == REF_GROUP.versions()
    # every JAX analyzer the default group leaves out is one ROADMAP
    # defers (executable A5) or the opt-in license-file one
    assert set(REF_OFF) == {"license-file", "executable"}
    full = ("license-file",)
    assert port_an.AnalyzerGroup(enabled=full).versions() == \
        ref_an.AnalyzerGroup(disabled=tuple(set(REF_OFF) - set(full)),
                             enabled=full).versions()


JSON_DOCS = [
    b'{\n  "a": 1,\n  "b": {\n    "c": [1, 2.5e3, true, null]\n  }\n}',
    b'\xef\xbb\xbf{"u": "\\u00e9\\ud83d\\ude00\\n", "e": {}, "l": []}',
    b'[\n {"x": "y"},\n\n {"z": -0.5}\n]',
]
BAD_JSON = [b"", b"{", b'{"a" 1}', b'{"a": 1,}', b"[1 2]", b'"\\u12"',
            b'{"a": 1} x', b"nul"]


@pytest.mark.parametrize("doc", JSON_DOCS + BAD_JSON)
def test_jsonpos_matches_reference(doc):
    """Values and every member's line span, or the same refusal."""
    def spans(v):
        if isinstance(v, dict):
            return {"spans": dict(v.spans),
                    "items": {k: spans(x) for k, x in v.items()}}
        if isinstance(v, list):
            return {"spans": list(v.spans), "items": [spans(x) for x in v]}
        return v
    try:
        want = spans(ref_json_parse(doc))
    except ValueError as e:
        with pytest.raises(JSONPosError) as got:
            port_json_parse(doc)
        assert str(got.value) == str(e)
        return
    assert spans(port_json_parse(doc)) == want
