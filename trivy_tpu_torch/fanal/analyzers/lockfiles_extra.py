"""Second wave of language analyzers, the port's copy of the JAX
package's fanal/analyzers/lockfiles_extra.py: JVM poms/gradle, .NET, conda,
conan, elixir hex, swift/cocoapods, dart pub, julia, rust binaries.

Mirrors the reference parsers under pkg/dependency/parser/{java/pom,
gradle/lockfile, nuget/{lock,config,packagesprops}, dotnet/core_deps,
conda/meta, c/conan, hex/mix, swift/{swift,cocoapods}, dart/pub,
julia/manifest, rust/binary} and their pkg/fanal/analyzer/language
wrappers. The pom parser is the offline subset: in-file properties,
parent gav inheritance, no remote repository resolution.
"""

from __future__ import annotations

import json
import re
import struct
import tomllib
import xml.etree.ElementTree as ET
import zlib
from typing import Optional

from ... import types as T
from ...jsonpos import JSONPosError
from ...jsonpos import parse as json_parse
from . import AnalysisResult, Analyzer, register
from .binaries import executable_candidate
from .lockfiles import _app, _pkg, dep_id


def _loc(span) -> list:
    """(start_line, end_line) → Locations list (report shape)."""
    return [{"StartLine": span[0], "EndLine": span[1]}]


# ----------------------------------------------------------------- Java

def _strip_ns(root):
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


_PROP_RE = re.compile(r"\$\{([^}]+)\}")


@register
class PomAnalyzer(Analyzer):
    """pom.xml (pkg/dependency/parser/java/pom/parse.go, offline
    subset: no remote parent/import resolution)."""
    name = "pom"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith("pom.xml") or path.endswith(".pom")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            root = _strip_ns(ET.fromstring(content))
        except ET.ParseError:
            return None
        if root.tag != "project":
            return None

        props = {}
        parent = root.find("parent")
        parent_gav = {}
        if parent is not None:
            for k in ("groupId", "artifactId", "version"):
                v = parent.findtext(k) or ""
                parent_gav[k] = v
                props[f"parent.{k}"] = v
                props[f"project.parent.{k}"] = v
        for k in ("groupId", "artifactId", "version"):
            v = root.findtext(k) or parent_gav.get(k, "")
            props[f"project.{k}"] = v
            props[f"pom.{k}"] = v
            props[k] = props.get(k, v)
        props_el = root.find("properties")
        if props_el is not None:
            for child in props_el:
                props[child.tag] = (child.text or "").strip()

        def resolve(s: str, depth=0) -> str:
            if not s or depth > 8:
                return s or ""
            return _PROP_RE.sub(
                lambda m: resolve(props.get(m.group(1), ""), depth + 1),
                s).strip()

        # dependencyManagement pins versions for version-less deps
        managed = {}
        dm = root.find("dependencyManagement/dependencies")
        if dm is not None:
            for dep in dm.findall("dependency"):
                g = resolve(dep.findtext("groupId") or "")
                a = resolve(dep.findtext("artifactId") or "")
                v = resolve(dep.findtext("version") or "")
                if g and a and v:
                    managed[f"{g}:{a}"] = v

        pkgs = []
        deps_el = root.find("dependencies")
        for dep in (deps_el.findall("dependency")
                    if deps_el is not None else []):
            scope = (dep.findtext("scope") or "").strip()
            if scope in ("test", "provided", "system"):
                continue
            g = resolve(dep.findtext("groupId") or "")
            a = resolve(dep.findtext("artifactId") or "")
            v = resolve(dep.findtext("version") or "")
            name = f"{g}:{a}"
            if not v:
                v = managed.get(name, "")
            if not g or not a or not v or "${" in v or "[" in v:
                continue  # unresolved property or version range
            pkgs.append(_pkg(name, v, ltype="pom"))
        # the module itself is also reported when fully resolved, with
        # its direct dependencies as graph edges (java/pom parse.go)
        g = resolve(props["project.groupId"])
        a = resolve(props["project.artifactId"])
        v = resolve(props["project.version"])
        if g and a and v and "${" not in v:
            module = _pkg(f"{g}:{a}", v, ltype="pom")
            module.depends_on = sorted(p.id for p in pkgs)
            pkgs.insert(0, module)
        return _app("pom", path, pkgs)


@register
class GradleLockAnalyzer(Analyzer):
    """gradle.lockfile: `group:artifact:version=classpaths` lines; all
    entries are indirect (no way to tell direct deps)."""
    name = "gradle-lockfile"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith(".lockfile") and "gradle" in \
            path.rsplit("/", 1)[-1]

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        pkgs = []
        for line in content.decode(errors="replace").splitlines():
            line = line.strip()
            if line.startswith("#"):
                continue
            parts = line.split(":")
            if len(parts) != 3:
                continue
            version = parts[2].split("=")[0]
            pkgs.append(_pkg(f"{parts[0]}:{parts[1]}", version,
                             indirect=True, ltype="gradle"))
        return _app("gradle", path, pkgs)


# ----------------------------------------------------------------- .NET

@register
class NuGetLockAnalyzer(Analyzer):
    """packages.lock.json (nuget/lock/parse.go): targets → package
    entries; type Project is the module itself, type!=Direct →
    indirect."""
    name = "nuget"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        base = path.rsplit("/", 1)[-1]
        return base in ("packages.lock.json", "packages.config")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        if path.endswith("packages.config"):
            return self._config(path, content)
        try:
            doc = json_parse(content)
        except (JSONPosError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        seen = {}
        for target in (doc.get("dependencies") or {}).values():
            if not isinstance(target, dict):
                continue
            spans = getattr(target, "spans", {})
            for name, entry in target.items():
                if not isinstance(entry, dict) or \
                        entry.get("type") == "Project":
                    continue
                version = entry.get("resolved", "")
                if not version:
                    continue
                p = _pkg(name, version,
                         indirect=entry.get("type") != "Direct")
                p.depends_on = [f"{d}@{v}" for d, v in sorted(
                    (entry.get("dependencies") or {}).items())]
                if name in spans:
                    p.locations = _loc(spans[name])
                seen[(name, version)] = p
        return _app("nuget", path, list(seen.values()))

    @staticmethod
    def _config(path, content):
        try:
            root = _strip_ns(ET.fromstring(content))
        except ET.ParseError:
            return None
        pkgs = []
        for el in root.findall("package"):
            if el.get("developmentDependency") in ("true", "True"):
                continue
            name, version = el.get("id", ""), el.get("version", "")
            if name and version:
                pkgs.append(_pkg(name, version))
        return _app("nuget", path, pkgs)


@register
class DotNetDepsAnalyzer(Analyzer):
    """*.deps.json (dotnet/core_deps): libraries with type=package."""
    name = "dotnet-deps"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith(".deps.json")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            doc = json_parse(content)
        except (JSONPosError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        libs = doc.get("libraries") or {}
        spans = getattr(libs, "spans", {})
        pkgs = []
        for name_ver, lib in libs.items():
            if not isinstance(lib, dict) or \
                    (lib.get("type") or "").lower() != "package":
                continue
            parts = name_ver.split("/")
            if len(parts) != 2:
                continue
            # the reference core-deps parser leaves ID empty
            # (dotnet/core_deps/parse.go — no dependency.ID call)
            pkgs.append(T.Package(
                name=parts[0], version=parts[1],
                locations=_loc(spans[name_ver])
                if name_ver in spans else []))
        return _app("dotnet-core", path, pkgs)


@register
class PackagesPropsAnalyzer(Analyzer):
    """Directory.Packages.props / *Packages.props central package
    management (nuget/packagesprops): PackageVersion/PackageReference
    items; $(var) entries are skipped (no variable resolution info)."""
    name = "packages-props"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        base = path.rsplit("/", 1)[-1].lower()
        return base.endswith("packages.props")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            root = _strip_ns(ET.fromstring(content))
        except ET.ParseError:
            return None
        pkgs = []
        for group in root.findall("ItemGroup"):
            for el in list(group.findall("PackageReference")) + \
                    list(group.findall("PackageVersion")):
                name = (el.get("Include") or el.get("Update") or "").strip()
                version = (el.get("Version") or "").strip()
                if not name or not version:
                    continue
                if name.startswith("$(") or version.startswith("$("):
                    continue
                pkgs.append(_pkg(name, version))
        return _app("packages-props", path, pkgs)


# ---------------------------------------------------------------- conda

@register
class CondaMetaAnalyzer(Analyzer):
    """conda-meta/<pkg>.json environment metadata (conda/meta) —
    an individual-package type aggregated under 'Conda'."""
    name = "conda-pkg"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return "conda-meta/" in path and path.endswith(".json")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            doc = json.loads(content)
        except json.JSONDecodeError:
            return None
        name, version = doc.get("name"), doc.get("version")
        if not name or not version or not isinstance(name, str) \
                or not isinstance(version, str):
            return None
        # the reference conda meta parser leaves ID empty
        pkg = T.Package(name=name, version=version)
        pkg.file_path = path
        lic = doc.get("license")
        if isinstance(lic, str) and lic:
            pkg.licenses = [lic]
        return _app("conda-pkg", path, [pkg])


# ---------------------------------------------------------------- conan

_CONAN_REF = re.compile(r"^(?P<name>[^/@#]+)/(?P<version>[^/@#]+)")


@register
class ConanLockAnalyzer(Analyzer):
    """conan.lock: v1 graph_lock.nodes (node 0 = root; its requires are
    the direct deps) and v2 flat `requires` lists."""
    name = "conan"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.rsplit("/", 1)[-1] == "conan.lock"

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            doc = json_parse(content)
        except (JSONPosError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        pkgs = []
        graph = (doc.get("graph_lock") or {}).get("nodes")
        if graph:  # v1
            spans = getattr(graph, "spans", {})
            direct = set((graph.get("0") or {}).get("requires") or [])
            # node index → package id, for the dependency graph
            ids = {}
            for idx, node in graph.items():
                m = _CONAN_REF.match(node.get("ref") or "")
                if m and idx != "0":
                    ids[idx] = dep_id("conan", m.group("name"),
                                      m.group("version"))
            for idx, node in graph.items():
                m = _CONAN_REF.match(node.get("ref") or "")
                if not m or idx == "0":
                    continue
                p = _pkg(m.group("name"), m.group("version"),
                         indirect=idx not in direct,
                         ltype="conan")
                p.depends_on = [
                    ids[r] for r in (node.get("requires") or [])
                    if r in ids]
                if idx in spans:
                    p.locations = _loc(spans[idx])
                pkgs.append(p)
        else:  # v2: all entries indirect-unknown, kept as direct
            for section in ("requires", "build_requires",
                            "python_requires"):
                for ref in doc.get(section) or []:
                    m = _CONAN_REF.match(ref)
                    if m:
                        pkgs.append(_pkg(m.group("name"),
                                         m.group("version"),
                                         ltype="conan"))
        return _app("conan", path, pkgs)


# ------------------------------------------------------------ elixir hex

_MIX_LINE = re.compile(
    r'^"(?P<name>[^"]+)":\s*\{:(?P<mgr>\w+),\s*:"?(?P<pkg>[^,"]+)"?,\s*'
    r'"(?P<version>[^"]+)"')


@register
class MixLockAnalyzer(Analyzer):
    """mix.lock (hex/mix): `"name": {:hex, :name, "version", ...}`
    entries; git deps (no version) are skipped."""
    name = "mix-lock"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.rsplit("/", 1)[-1] == "mix.lock"

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        pkgs = []
        for ln, line in enumerate(
                content.decode(errors="replace").splitlines(), start=1):
            m = _MIX_LINE.match(line.strip())
            if m and m.group("mgr") == "hex":
                p = _pkg(m.group("name"), m.group("version"))
                p.locations = _loc((ln, ln))
                pkgs.append(p)
        return _app("hex", path, pkgs)


# ---------------------------------------------------------------- swift

@register
class SwiftAnalyzer(Analyzer):
    """Package.resolved v1/v2 (swift/swift): names are the repository
    URL without scheme/.git; branch substitutes a missing version."""
    name = "swift"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.rsplit("/", 1)[-1] == "Package.resolved"

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            doc = json_parse(content)
        except (JSONPosError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        ver = doc.get("version", 1)
        pins = (doc.get("object") or {}).get("pins") \
            if ver == 1 else doc.get("pins")
        spans = getattr(pins, "spans", [])
        pkgs = []
        for i, pin in enumerate(pins or []):
            loc = pin.get("repositoryURL") if ver == 1 \
                else pin.get("location")
            name = (loc or "").removeprefix("https://").removesuffix(
                ".git")
            state = pin.get("state") or {}
            version = state.get("version") or state.get("branch") or ""
            if name and version:
                p = _pkg(name, version)
                if i < len(spans):
                    p.locations = _loc(spans[i])
                pkgs.append(p)
        return _app("swift", path, pkgs)


_POD_DEP = re.compile(r"^(?P<name>\S+)(?:\s+\((?P<version>[^)]+)\))?$")


@register
class CocoaPodsAnalyzer(Analyzer):
    """Podfile.lock (swift/cocoapods): PODS entries `Name (1.2.3)`,
    optionally mapping to child dependency names."""
    name = "cocoapods"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.rsplit("/", 1)[-1] == "Podfile.lock"

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        import yaml
        try:
            doc = yaml.safe_load(content)
        except yaml.YAMLError:
            return None
        if not isinstance(doc, dict):
            return None
        pkgs = {}
        children = {}
        for pod in doc.get("PODS") or []:
            if isinstance(pod, str):
                entries = [(pod, [])]
            elif isinstance(pod, dict):
                entries = [(k, v or []) for k, v in pod.items()]
            else:
                continue
            for spec, childs in entries:
                m = _POD_DEP.match(spec)
                if not m or not m.group("version"):
                    continue
                name = m.group("name")
                pkgs[name] = _pkg(name, m.group("version"))
                children[name] = [c.split()[0] for c in childs
                                  if isinstance(c, str)]
        for name, childs in children.items():
            deps = [f"{c}@{pkgs[c].version}" for c in childs if c in pkgs]
            if deps:
                pkgs[name].depends_on = sorted(deps)
        return _app("cocoapods", path, list(pkgs.values()))


# ------------------------------------------------------------------ dart

@register
class PubAnalyzer(Analyzer):
    """pubspec.lock (dart/pub): all packages kept (dev-transitivity is
    ambiguous); 'transitive' marks indirect."""
    name = "pub"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.rsplit("/", 1)[-1] == "pubspec.lock"

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        import yaml
        try:
            doc = yaml.safe_load(content)
        except yaml.YAMLError:
            return None
        if not isinstance(doc, dict):
            return None
        pkgs = []
        for name, dep in (doc.get("packages") or {}).items():
            if not isinstance(dep, dict):
                continue
            version = str(dep.get("version") or "")
            if not version:
                continue
            pkgs.append(_pkg(name, version,
                             indirect=dep.get("dependency") == "transitive"))
        return _app("pub", path, pkgs)


# ----------------------------------------------------------------- julia

@register
class JuliaManifestAnalyzer(Analyzer):
    """Manifest.toml (julia/manifest): new format nests packages under
    [[deps.Name]]; stdlib packages without a version get the manifest's
    julia_version (or are skipped on old manifests without one)."""
    name = "julia"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        base = path.rsplit("/", 1)[-1]
        return base in ("Manifest.toml", "JuliaManifest.toml")

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        try:
            doc = tomllib.loads(content.decode(errors="replace"))
        except (tomllib.TOMLDecodeError, UnicodeDecodeError):
            return None
        julia_version = doc.get("julia_version", "")
        deps = doc.get("deps")
        if not isinstance(deps, dict):  # old flat format: {Name: [...]}
            deps = {k: v for k, v in doc.items()
                    if isinstance(v, list) and k not in ("deps",)}
        pkgs = []
        for name, entries in deps.items():
            if not isinstance(entries, list):
                continue
            for entry in entries:
                if not isinstance(entry, dict):
                    continue
                version = entry.get("version") or julia_version
                if not version:
                    continue
                uuid = entry.get("uuid", "")
                p = _pkg(name, version)
                if uuid:
                    p.id = f"{uuid}@{version}"
                pkgs.append(p)
        return _app("julia", path, pkgs)


# ------------------------------------------------------------ rust binary

def _elf_section(content: bytes, wanted: str) -> Optional[bytes]:
    """Minimal ELF64/ELF32 section lookup (little-endian)."""
    if content[:4] != b"\x7fELF" or len(content) < 64:
        return None
    is64 = content[4] == 2
    le = content[5] == 1
    if not le:
        return None
    if is64:
        shoff, = struct.unpack_from("<Q", content, 0x28)
        shentsize, shnum, shstrndx = struct.unpack_from(
            "<HHH", content, 0x3A)
    else:
        shoff, = struct.unpack_from("<I", content, 0x20)
        shentsize, shnum, shstrndx = struct.unpack_from(
            "<HHH", content, 0x2E)
    if shoff == 0 or shnum == 0 or shstrndx >= shnum:
        return None

    def sh(i):
        base = shoff + i * shentsize
        if is64:
            name, _, _, _, off, size = struct.unpack_from(
                "<IIQQQQ", content, base)
        else:
            name, _, _, _, off, size = struct.unpack_from(
                "<IIIIII", content, base)
        return name, off, size

    try:
        _, stroff, strsize = sh(shstrndx)
        strtab = content[stroff:stroff + strsize]
        for i in range(shnum):
            name_off, off, size = sh(i)
            end = strtab.find(b"\x00", name_off)
            if strtab[name_off:end].decode(errors="replace") == wanted:
                return content[off:off + size]
    except (struct.error, IndexError, ValueError):
        return None
    return None


def parse_rust_audit(content: bytes):
    """cargo-auditable data: zlib-compressed JSON in the `.dep-v0`
    section ({packages:[{name,version,source,kind,dependencies}]})."""
    section = _elf_section(content, ".dep-v0")
    if not section:
        return []
    try:
        doc = json.loads(zlib.decompress(section))
    except (zlib.error, json.JSONDecodeError):
        return []
    out = []
    for p in doc.get("packages") or []:
        name, version = p.get("name"), p.get("version")
        if not name or not version:
            continue
        # the root crate has source "local"; runtime deps only
        if p.get("kind") == "build":
            continue
        out.append((name, version, p.get("source") == "local"))
    return out


@register
class RustBinaryAnalyzer(Analyzer):
    """Executables built with cargo-auditable (rust/binary)."""
    name = "rustbinary"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return executable_candidate(path)

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        deps = parse_rust_audit(content)
        if not deps:
            return None
        pkgs = [T.Package(id=f"{n}@{v}", name=n, version=v,
                          file_path=path)
                for n, v, is_root in sorted(set(deps)) if not is_root]
        if not pkgs:
            return None
        return AnalysisResult(applications=[
            T.Application(type="rustbinary", file_path=path,
                          packages=pkgs)])
