"""Language lockfile analyzers, the port's copy of the JAX package's
fanal/analyzers/lockfiles.py.

Mirrors the reference's post-analyzers under pkg/fanal/analyzer/language
and parsers under pkg/dependency/parser: each lockfile type maps to an
Application with its resolved package set. Dev dependencies are flagged
(reference filters them unless --include-dev-deps)."""

from __future__ import annotations

import json
import re
import tomllib
from typing import Optional

from ... import types as T
from ...jsonpos import JSONPosError, SpanDict
from ...jsonpos import parse as json_parse
from . import AnalysisResult, Analyzer, PostAnalyzer, register, register_post


def _app(app_type: str, path: str, pkgs: list) -> Optional[AnalysisResult]:
    if not pkgs:
        return None
    pkgs.sort(key=lambda p: (p.name, p.version))
    return AnalysisResult(applications=[
        T.Application(type=app_type, file_path=path, packages=pkgs)])


def dep_id(ltype: str, name: str, version: str) -> str:
    """Package ID with the per-language separator (reference
    pkg/dependency/id.go:12-36: ':' for jar/pom/gradle, '/' for conan,
    'v'-prefixed for go modules, '@' otherwise)."""
    if not version:
        return name
    if ltype in ("jar", "pom", "gradle", "sbt"):
        return f"{name}:{version}"
    if ltype == "conan":
        return f"{name}/{version}"
    if ltype in ("gomod", "gobinary") and not version.startswith("v"):
        return f"{name}@v{version}"
    return f"{name}@{version}"


def _pkg(name: str, version: str, dev: bool = False,
         indirect: bool = False, ltype: str = "") -> T.Package:
    return T.Package(id=dep_id(ltype, name, version), name=name,
                     version=version, dev=dev, indirect=indirect)


def _pkgjson_license(doc: dict):
    """license field of a package.json: string, {type}, or legacy
    licenses array (pkg/dependency/parser/nodejs/packagejson)."""
    lic = doc.get("license")
    if isinstance(lic, dict):
        lic = lic.get("type")
    if not lic and isinstance(doc.get("licenses"), list):
        types_ = [entry.get("type") for entry in doc["licenses"]
                  if isinstance(entry, dict) and entry.get("type")]
        lic = ", ".join(types_) if types_ else None
    return lic


@register_post
class NpmLockAnalyzer(PostAnalyzer):
    """package-lock.json v1/v2/v3 with line locations, dependency graph,
    dev flags, and license lookup from node_modules package.json files
    (pkg/fanal/analyzer/language/nodejs/npm/npm.go PostAnalyze +
    pkg/dependency/parser/nodejs/npm/parse.go)."""
    name = "npm"
    version = 2

    def required(self, path: str, size: int = -1) -> bool:
        parts = path.split("/")
        base = parts[-1]
        # lockfiles inside node_modules are vendored copies (npm.go:90-99)
        if base == "package-lock.json" and "node_modules" not in parts:
            return True
        # package.json only from node_modules — the license source
        if base == "package.json" and "node_modules" in parts:
            return True
        return False

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        licenses: dict[str, str] = {}
        for path, content in files.items():
            if path.split("/")[-1] != "package.json":
                continue
            try:
                doc = json.loads(content)
            except json.JSONDecodeError:
                continue
            lic = _pkgjson_license(doc)
            if lic and doc.get("name") and doc.get("version"):
                licenses[f"{doc['name']}@{doc['version']}"] = lic
        apps = []
        for path in sorted(files):
            if path.split("/")[-1] != "package-lock.json":
                continue
            app = self._parse_lock(path, files[path], licenses)
            if app is not None:
                apps.append(app)
        return AnalysisResult(applications=apps) if apps else None

    def _parse_lock(self, path: str, content: bytes,
                    licenses: dict) -> Optional[T.Application]:
        try:
            doc = json_parse(content)
        except (JSONPosError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        if doc.get("lockfileVersion") == 1 or \
                ("packages" not in doc and "dependencies" in doc):
            entries = self._parse_v1(doc)
        else:
            entries = self._parse_v2(doc)
        # UniqueLibraries merge: first entry wins; a non-dev duplicate
        # clears Dev; locations accumulate sorted (parser/utils.go)
        merged: dict[str, T.Package] = {}
        deps_of: dict[str, list] = {}
        for e in entries:
            pid = e.id
            got = merged.get(pid)
            if got is None:
                merged[pid] = e
            else:
                got.dev = got.dev and e.dev
                got.indirect = got.indirect and e.indirect
                got.locations = sorted(
                    got.locations + e.locations,
                    key=lambda l: (l["StartLine"], l["EndLine"]))
            if e.depends_on and pid not in deps_of:
                deps_of[pid] = sorted(set(e.depends_on))
        pkgs = []
        for pid, p in merged.items():
            p.depends_on = deps_of.get(pid, [])
            if pid in licenses:
                p.licenses = [licenses[pid]]
            pkgs.append(p)
        if not pkgs:
            return None
        pkgs.sort(key=lambda p: (p.name, p.version))
        return T.Application(type="npm", file_path=path, packages=pkgs)

    def _entry(self, name, version, span, dev, indirect, depends):
        p = _pkg(name, version, dev=dev, indirect=indirect)
        p.locations = [{"StartLine": span[0], "EndLine": span[1]}]
        p.depends_on = depends
        return p

    def _parse_v1(self, doc) -> list:
        """Nested `dependencies` tree; every package Indirect (the v1
        schema can't distinguish direct deps; parse.go parseV1)."""
        out = []

        def walk(deps, versions):
            versions = dict(versions)
            for name, info in deps.items():
                if isinstance(info, dict) and info.get("version"):
                    versions[name] = info["version"]
            for name, info in deps.items():
                if not isinstance(info, dict):
                    continue
                ver = info.get("version")
                if not ver:
                    continue
                span = deps.spans.get(name, (0, 0)) \
                    if isinstance(deps, SpanDict) else (0, 0)
                depends = []
                nested = info.get("dependencies") or {}
                for req_name in (info.get("requires") or {}):
                    if isinstance(nested.get(req_name), dict) and \
                            nested[req_name].get("version"):
                        depends.append(
                            f"{req_name}@{nested[req_name]['version']}")
                    elif req_name in versions:
                        depends.append(f"{req_name}@{versions[req_name]}")
                out.append(self._entry(name, ver, span,
                                       dev=bool(info.get("dev")),
                                       indirect=True, depends=depends))
                if nested:
                    walk(nested, versions)

        walk(doc.get("dependencies") or SpanDict(), {})
        return out

    def _parse_v2(self, doc) -> list:
        """Flat `packages` map keyed by install path (parse.go parseV2)."""
        packages = doc.get("packages") or {}
        root = packages.get("") or {}
        direct = set()
        for name in list(root.get("dependencies") or []) + \
                list(root.get("optionalDependencies") or []) + \
                list(root.get("devDependencies") or []):
            p = f"node_modules/{name}"
            if p in packages:
                direct.add(p)
        out = []
        for pkg_path, info in packages.items():
            if not pkg_path.startswith("node_modules") or \
                    not isinstance(info, dict):
                continue
            version = info.get("version")
            if not version:
                continue
            name = info.get("name") or \
                pkg_path.rsplit("node_modules/", 1)[-1]
            span = packages.spans.get(pkg_path, (0, 0)) \
                if isinstance(packages, SpanDict) else (0, 0)
            depends = []
            wants = dict(info.get("dependencies") or {})
            wants.update(info.get("optionalDependencies") or {})
            for dep_name in wants:
                dep_id = self._resolve_v2(pkg_path, dep_name, packages)
                if dep_id:
                    depends.append(dep_id)
            out.append(self._entry(
                name, version, span, dev=bool(info.get("dev")),
                indirect=pkg_path not in direct, depends=depends))
        return out

    @staticmethod
    def _resolve_v2(pkg_path: str, dep_name: str, packages) -> str:
        """Nearest-node_modules version resolution (parse.go
        findDependsOn)."""
        parts = (pkg_path + "/node_modules").split("/")
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] != "node_modules":
                continue
            cand = "/".join(parts[:i + 1] + [dep_name])
            info = packages.get(cand)
            if isinstance(info, dict) and info.get("version"):
                return f"{dep_name}@{info['version']}"
        return ""


_YARN_VER = re.compile(r'^\s{2}version:?\s+"?([^"\s]+)"?')
_YARN_HEAD = re.compile(r'^"?((?:@[^@/"]+\/)?[^@/"]+)@')


def _yarn_entries(text: str):
    """Parse yarn.lock (classic + berry) into entries:
    {patterns, name, version, deps{name: range}, span (start, end)}."""
    entries = []
    cur = None
    in_deps = False
    for ln, line in enumerate(text.splitlines(), start=1):
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if not line.startswith(" "):  # entry head
            cur = {"patterns": [], "name": "", "version": "",
                   "deps": {}, "start": ln, "end": ln}
            entries.append(cur)
            in_deps = False
            for raw in line.rstrip().rstrip(":").split(","):
                pat = raw.strip().strip('"')
                m = _YARN_HEAD.match(pat)
                if m:
                    cur["patterns"].append(pat)
                    cur["name"] = m.group(1)
            continue
        if cur is None:
            continue
        cur["end"] = ln
        s = line.strip()
        if _YARN_VER.match(line):
            cur["version"] = _YARN_VER.match(line).group(1)
            in_deps = False
        elif s.startswith("dependencies:"):
            in_deps = True
        elif in_deps and line.startswith("    "):
            # classic `name "range"` / berry `name: range`
            m = re.match(
                r'^\s+"?([^"\s:]+)"?:?\s+"?([^"]+?)"?\s*$', line)
            if m:
                cur["deps"][m.group(1)] = m.group(2)
        elif not line.startswith("    "):
            in_deps = False
    return [e for e in entries if e["name"] and e["version"]]


@register_post
class YarnLockAnalyzer(PostAnalyzer):
    """yarn.lock + root package.json + node_modules licenses
    (pkg/fanal/analyzer/language/nodejs/yarn/yarn.go PostAnalyze):
    package.json's dependencies/devDependencies classify the lock
    entries by walking the graph — packages reachable only from
    devDependencies are Dev (excluded unless --include-dev-deps),
    non-direct packages are Indirect; entries carry their lock line
    spans and licenses resolved from node_modules package.json files."""
    name = "yarn"
    version = 2

    def required(self, path: str, size: int = -1) -> bool:
        parts = path.split("/")
        base = parts[-1]
        if base == "yarn.lock" and "node_modules" not in parts:
            return True
        # package.json both at the root (dep classification) and in
        # node_modules (license source)
        return base == "package.json"

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        licenses: dict[str, str] = {}
        for path, content in files.items():
            parts = path.split("/")
            if parts[-1] != "package.json" or "node_modules" not in parts:
                continue
            try:
                doc = json.loads(content)
            except json.JSONDecodeError:
                continue
            lic = _pkgjson_license(doc)
            if lic and doc.get("name") and doc.get("version"):
                licenses[f"{doc['name']}@{doc['version']}"] = lic
        apps = []
        for path in sorted(files):
            if not path.endswith("yarn.lock") or \
                    "node_modules" in path.split("/"):
                continue
            app = self._parse_lock(path, files[path], files, licenses)
            if app is not None:
                apps.extend(app.applications)
        return AnalysisResult(applications=apps) if apps else None

    def _parse_lock(self, path: str, content: bytes, files: dict,
                    licenses: dict) -> Optional[AnalysisResult]:
        entries = _yarn_entries(content.decode(errors="replace"))
        by_pattern = {}
        for e in entries:
            for pat in e["patterns"]:
                by_pattern[pat] = e
                # berry pins protocols into patterns ("p@npm:^8.0.3");
                # package.json and classic dep lines use bare ranges
                if "@npm:" in pat:
                    by_pattern.setdefault(pat.replace("@npm:", "@", 1), e)
        # root package.json next to the lock classifies the graph
        pj = path[:-len("yarn.lock")] + "package.json"
        prod_roots, dev_roots = [], []
        if pj in files:
            try:
                doc = json.loads(files[pj])
                prod_roots = [f"{n}@{r}" for n, r in
                              (doc.get("dependencies") or {}).items()]
                dev_roots = [f"{n}@{r}" for n, r in
                             (doc.get("devDependencies") or {}).items()]
            except json.JSONDecodeError:
                pass

        def walk(roots):
            seen = set()
            stack = [by_pattern[p] for p in roots if p in by_pattern]
            while stack:
                e = stack.pop()
                key = id(e)
                if key in seen:
                    continue
                seen.add(key)
                for dn, dr in e["deps"].items():
                    nxt = by_pattern.get(f"{dn}@{dr}") or \
                        by_pattern.get(f"{dn}@npm:{dr}")
                    if nxt is not None:
                        stack.append(nxt)
            return seen

        prod = walk(prod_roots)
        dev = walk(dev_roots) - prod
        direct = {id(by_pattern[p]) for p in prod_roots + dev_roots
                  if p in by_pattern}
        classify = bool(prod_roots or dev_roots)

        pkgs, seen_ids = [], set()
        for e in entries:
            pid = f"{e['name']}@{e['version']}"
            if pid in seen_ids:
                continue
            seen_ids.add(pid)
            p = _pkg(e["name"], e["version"],
                     dev=classify and id(e) in dev,
                     indirect=classify and id(e) not in direct)
            p.locations = [{"StartLine": e["start"],
                            "EndLine": e["end"]}]
            if pid in licenses:
                p.licenses = [licenses[pid]]
            p.depends_on = sorted(
                f"{d['name']}@{d['version']}"
                for d in (by_pattern.get(f"{dn}@{dr}")
                          or by_pattern.get(f"{dn}@npm:{dr}")
                          for dn, dr in e["deps"].items())
                if d is not None)
            pkgs.append(p)
        return _app("yarn", path, pkgs)


@register
class PnpmLockAnalyzer(Analyzer):
    """pnpm-lock.yaml, pkg/dependency/parser/nodejs/pnpm."""
    name = "pnpm"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith("pnpm-lock.yaml")

    def analyze(self, path, content):
        import yaml
        try:
            doc = yaml.safe_load(content)
        except yaml.YAMLError:
            return None
        if not isinstance(doc, dict):
            return None
        pkgs = []
        for key, info in (doc.get("packages") or {}).items():
            key = key.lstrip("/").split("(", 1)[0]  # drop peer-dep suffix
            # "name@version" (v6+) or "name/version" (v5)
            if "@" in key[1:]:
                name, _, ver = key.rpartition("@")
            else:
                name, _, ver = key.rpartition("/")
            if name and ver:
                pkgs.append(_pkg(name, ver,
                                 dev=bool((info or {}).get("dev"))))
        return _app("pnpm", path, pkgs)


_GOMOD_REQ = re.compile(
    r"^\s*(?:require\s+)?([\w./~\-]+\.[\w./~\-]+)\s+v(\S+)(\s*//\s*indirect)?")


@register_post
class GoModAnalyzer(PostAnalyzer):
    """go.mod (+ go.sum for pre-1.17 modules) —
    pkg/fanal/analyzer/language/golang/mod/mod.go: modules below Go 1.17
    don't record the full graph in go.mod, so the sibling go.sum's
    entries are merged in as indirect deps (mergeGoSum:238-261). Package
    IDs keep the Go-style v prefix (dependency/id.go:21-27) while the
    Version field drops it."""
    name = "gomod"
    version = 2

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith(("go.mod", "go.sum"))

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        apps = []
        for path in sorted(files):
            if not path.endswith("go.mod"):
                continue
            pkgs, _go_version = self._parse_mod(files[path])
            if _go_below_117(pkgs):
                sum_path = path[:-len("go.mod")] + "go.sum"
                if sum_path in files:
                    self._merge_sum(pkgs, files[sum_path])
            if pkgs:
                plist = sorted(pkgs.values(),
                               key=lambda p: (p.name, p.version))
                apps.append(T.Application(type="gomod", file_path=path,
                                          packages=plist))
        return AnalysisResult(applications=apps) if apps else None

    @staticmethod
    def _gopkg(name: str, version: str, indirect: bool) -> T.Package:
        return T.Package(id=f"{name}@v{version}", name=name,
                         version=version, indirect=indirect)

    def _parse_mod(self, content: bytes):
        pkgs: dict[str, T.Package] = {}
        go_version = ""
        in_block = False
        for line in content.decode(errors="replace").splitlines():
            s = line.strip()
            if s.startswith("go "):
                go_version = s.split()[1] if len(s.split()) > 1 else ""
                continue
            if s.startswith("require ("):
                in_block = True
                continue
            if in_block and s == ")":
                in_block = False
                continue
            if in_block or s.startswith("require "):
                m = _GOMOD_REQ.match(line)
                if m:
                    pkgs[m.group(1)] = self._gopkg(
                        m.group(1), m.group(2), bool(m.group(3)))
        return pkgs, go_version

    def _merge_sum(self, pkgs: dict, content: bytes) -> None:
        """go.sum lines: `module vVERSION[/go.mod] hash`; sorted, so the
        last non-/go.mod entry per module wins (sum/parse.go)."""
        sums: dict[str, str] = {}
        for line in content.decode(errors="replace").splitlines():
            f = line.split()
            if len(f) < 2:
                continue
            ver = f[1]
            if ver.startswith("v"):
                ver = ver[1:]
            ver = ver.removesuffix("/go.mod")
            sums[f[0]] = ver
        for name, ver in sums.items():
            if name not in pkgs:
                pkgs[name] = self._gopkg(name, ver, indirect=True)


def _go_below_117(pkgs: dict) -> bool:
    """Pre-1.17 go.mod files don't carry `// indirect` marks, so the
    absence of any indirect-marked dep is the signal to merge go.sum
    (reference mod.go:228-236 lessThanGo117 — NOT the `go` directive)."""
    return not any(p.indirect for p in pkgs.values())


@register
class CargoLockAnalyzer(Analyzer):
    """Cargo.lock (pkg/dependency/parser/rust/cargo)."""
    name = "cargo"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith("Cargo.lock")

    def analyze(self, path, content):
        try:
            doc = tomllib.loads(content.decode(errors="replace"))
        except tomllib.TOMLDecodeError:
            return None
        pkgs = [_pkg(p["name"], p["version"])
                for p in doc.get("package", [])
                if p.get("name") and p.get("version")]
        return _app("cargo", path, pkgs)


@register_post
class PoetryLockAnalyzer(PostAnalyzer):
    """poetry.lock + sibling pyproject.toml
    (pkg/fanal/analyzer/language/python/poetry/poetry.go PostAnalyze +
    pkg/dependency/parser/python/poetry): the lock's per-package
    [package.dependencies] build the DependsOn graph; pyproject's
    [tool.poetry.dependencies] mark direct packages (everything else
    is Indirect)."""
    name = "poetry"
    version = 2

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith(("poetry.lock", "pyproject.toml"))

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        apps = []
        for path in sorted(files):
            if not path.endswith("poetry.lock"):
                continue
            try:
                doc = tomllib.loads(files[path].decode(errors="replace"))
            except tomllib.TOMLDecodeError:
                continue
            direct = None
            pyproject = path[:-len("poetry.lock")] + "pyproject.toml"
            if pyproject in files:
                try:
                    pp = tomllib.loads(
                        files[pyproject].decode(errors="replace"))
                    deps = ((pp.get("tool") or {}).get("poetry") or {}) \
                        .get("dependencies") or {}
                    direct = {_normalize_pep503(n) for n in deps
                              if n.lower() != "python"}
                except tomllib.TOMLDecodeError:
                    pass
            # installed version per (normalized) name for graph edges
            installed = {}
            for p in doc.get("package", []):
                if p.get("name") and p.get("version"):
                    installed[_normalize_pep503(p["name"])] = \
                        (p["name"], p["version"])
            pkgs = []
            for p in doc.get("package", []):
                if not (p.get("name") and p.get("version")):
                    continue
                dev = p.get("category") == "dev"
                pkg = _pkg(p["name"], p["version"], dev=dev)
                norm = _normalize_pep503(p["name"])
                if direct is not None:
                    pkg.indirect = norm not in direct
                dep_ids = []
                for dn in (p.get("dependencies") or {}):
                    hit = installed.get(_normalize_pep503(dn))
                    if hit:
                        dep_ids.append(f"{hit[0]}@{hit[1]}")
                pkg.depends_on = sorted(dep_ids)
                pkgs.append(pkg)
            app = _app("poetry", path, pkgs)
            if app is not None:
                apps.extend(app.applications)
        return AnalysisResult(applications=apps) if apps else None


def _normalize_pep503(name: str) -> str:
    """PEP 503 name normalization (python/poetry/parse.go uses the
    packaging normalization for graph edges)."""
    return re.sub(r"[-_.]+", "-", name).lower()


@register
class PipenvLockAnalyzer(Analyzer):
    """Pipfile.lock (pkg/dependency/parser/python/pipenv)."""
    name = "pipenv"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith("Pipfile.lock")

    def analyze(self, path, content):
        try:
            doc = json_parse(content)
        except (JSONPosError, ValueError):
            return None
        if not isinstance(doc, dict):
            return None
        pkgs = []
        for section, dev in (("default", False), ("develop", True)):
            members = doc.get(section) or {}
            spans = getattr(members, "spans", {})
            for name, info in members.items():
                ver = (info or {}).get("version", "")
                if ver.startswith("=="):
                    # the reference pipenv parser leaves ID empty
                    # (python/pipenv/parse.go — no dependency.ID)
                    p = T.Package(name=name, version=ver[2:], dev=dev)
                    if name in spans:
                        p.locations = [{"StartLine": spans[name][0],
                                        "EndLine": spans[name][1]}]
                    pkgs.append(p)
        return _app("pipenv", path, pkgs)


_GEMLOCK_SPEC = re.compile(r"^    ([^\s(]+) \(([^)]+)\)$")


@register
class GemfileLockAnalyzer(Analyzer):
    """Gemfile.lock (pkg/dependency/parser/ruby/bundler)."""
    name = "bundler"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith("Gemfile.lock")

    def analyze(self, path, content):
        pkgs = []
        in_gem = False
        for line in content.decode(errors="replace").splitlines():
            if line in ("GEM", "GIT", "PATH"):
                in_gem = line == "GEM"
                continue
            if line and not line.startswith(" "):
                in_gem = False
                continue
            if in_gem:
                m = _GEMLOCK_SPEC.match(line)
                if m:
                    pkgs.append(_pkg(m.group(1), m.group(2)))
        return _app("bundler", path, pkgs)


@register_post
class ComposerLockAnalyzer(PostAnalyzer):
    """composer.lock + sibling composer.json
    (pkg/fanal/analyzer/language/php/composer/composer.go PostAnalyze +
    pkg/dependency/parser/php/composer): per-package line spans,
    licenses, a DependsOn graph from each package's `require` (edges
    only to packages present in the lock), and Indirect for packages
    outside composer.json's require."""
    name = "composer"
    version = 2

    def required(self, path: str, size: int = -1) -> bool:
        base = path.rsplit("/", 1)[-1]
        # vendored composer files describe other projects
        # (composer.go:27-33 skips vendor/)
        if "/vendor/" in f"/{path}":
            return False
        return base in ("composer.lock", "composer.json")

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        apps = []
        for path in sorted(files):
            if not path.endswith("composer.lock"):
                continue
            try:
                doc = json_parse(files[path])
            except (JSONPosError, ValueError):
                continue
            if not isinstance(doc, dict):
                continue
            direct = None
            cj = path[:-len("composer.lock")] + "composer.json"
            if cj in files:
                try:
                    direct = set(json.loads(files[cj]).get("require")
                                 or {})
                except (json.JSONDecodeError, AttributeError):
                    pass
            installed = {}
            for section in ("packages", "packages-dev"):
                for p in doc.get(section) or []:
                    if p.get("name") and p.get("version"):
                        installed[p["name"]] = \
                            f'{p["name"]}@{p["version"].lstrip("v")}'
            pkgs = []
            for section, dev in (("packages", False),
                                 ("packages-dev", True)):
                plist = doc.get(section) or []
                spans = getattr(plist, "spans", [])
                for i, p in enumerate(plist):
                    if not (p.get("name") and p.get("version")):
                        continue
                    pkg = _pkg(p["name"], p["version"].lstrip("v"),
                               dev=dev)
                    if direct is not None:
                        pkg.indirect = p["name"] not in direct
                    lic = p.get("license")
                    if isinstance(lic, list):
                        pkg.licenses = list(lic)
                    elif isinstance(lic, str) and lic:
                        pkg.licenses = [lic]
                    pkg.depends_on = sorted(
                        installed[dn] for dn in (p.get("require") or {})
                        if dn in installed and dn != p["name"])
                    if i < len(spans):
                        pkg.locations = [{"StartLine": spans[i][0],
                                          "EndLine": spans[i][1]}]
                    pkgs.append(pkg)
            app = _app("composer", path, pkgs)
            if app is not None:
                apps.extend(app.applications)
        return AnalysisResult(applications=apps) if apps else None
