"""Rego check engine (reference pkg/iac/rego).

Loads `.rego` modules (custom checks, shared libs, ignore policies),
retrieves static metadata (`# METADATA` annotations with a `custom`
block, or the legacy `__rego_metadata__` rule — reference
pkg/iac/rego/metadata.go), filters by input selectors, evaluates the
enforced rules (deny*/warn*/violation* — scanner.go:404 isEnforcedRule)
against parsed config documents, and converts results (string / cause
object with msg/startline/endline — result.go parseResult) into
DetectedMisconfiguration records. The port's copy of the JAX package's
iac/rego; every evaluation goes through Interpreter.query, which holds
the interpreter's lock, so one scanner serves the pipeline's walker
threads.
"""

from __future__ import annotations

import os

from ... import types as T
from ..core import Check, build_misconf, ignored_ids_by_line, is_ignored
from .builtins import RSet, UNDEF, unfreeze
from .eval import Interpreter
from .parser import Module, RegoSyntaxError, parse_module

BUILTIN_NAMESPACES = {"builtin", "defsec", "appshield"}
DEFAULT_USER_NAMESPACES = {"user", "custom"}


def _enforced(name: str) -> bool:
    return name in ("deny", "warn", "violation") or \
        name.startswith(("deny_", "warn_", "violation_"))


class RegoError(Exception):
    pass


def load_modules_from_paths(paths) -> list[Module]:
    """Load .rego files/directories (skipping *_test.rego, like the
    reference's load.go)."""
    mods = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".rego") and not \
                            f.endswith("_test.rego"):
                        mods.append(_load_file(os.path.join(root, f)))
        elif p.endswith(".rego"):
            mods.append(_load_file(p))
    return mods


def _load_file(path) -> Module:
    with open(path, encoding="utf-8", errors="replace") as f:
        src = f.read()
    try:
        return parse_module(src, path=path)
    except RegoSyntaxError as e:
        raise RegoError(f"failed to parse {path}: {e}") from e


def load_data_from_paths(paths) -> dict:
    """Data documents from JSON/YAML files (reference dataDirs)."""
    import json
    data: dict = {}
    for p in paths or []:
        files = []
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names))
        else:
            files = [p]
        for fp in files:
            try:
                with open(fp, encoding="utf-8") as f:
                    if fp.endswith(".json"):
                        doc = json.load(f)
                    elif fp.endswith((".yaml", ".yml")):
                        import yaml
                        doc = yaml.safe_load(f)
                    else:
                        continue
            except Exception:
                continue
            if isinstance(doc, dict):
                _merge(data, doc)
    return data


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


class StaticMetadata:
    def __init__(self):
        self.id = "N/A"
        self.avd_id = ""
        self.title = ""
        self.short_code = ""
        self.description = ""
        self.severity = "UNKNOWN"
        self.recommended_actions = ""
        self.url = ""
        self.selectors: list[str] = []
        self.provider = ""
        self.service = "general"


def retrieve_metadata(interp: Interpreter, mod: Module) -> StaticMetadata:
    """METADATA annotation first, legacy __rego_metadata__ rule second
    (reference MetadataRetriever.RetrieveMetadata)."""
    sm = StaticMetadata()
    meta = dict(mod.metadata or {})
    legacy = None
    if any(r.name == "__rego_metadata__" for r in mod.rules):
        # through query(), which holds the interpreter's lock: the
        # pipeline's walker threads share one custom-check scanner
        v = interp.query(".".join(mod.package) + ".__rego_metadata__")
        if isinstance(v, dict):
            legacy = v
    custom = meta.get("custom") or {}
    src = {}
    if legacy:
        src.update(legacy)
    if custom:
        src.update(custom)
    sm.id = str(src.get("id", meta.get("id", sm.id)))
    sm.avd_id = str(src.get("avd_id", src.get("aliases", [""])[0]
                            if isinstance(src.get("aliases"), list)
                            else ""))
    sm.title = str(meta.get("title", src.get("title", "")))
    sm.description = str(meta.get("description",
                                  src.get("description", "")))
    sm.severity = str(src.get("severity", "UNKNOWN")).upper()
    sm.short_code = str(src.get("short_code", ""))
    sm.recommended_actions = str(
        src.get("recommended_actions", src.get("recommended_action", "")))
    urls = meta.get("related_resources") or []
    if urls and isinstance(urls, list):
        first = urls[0]
        sm.url = first.get("ref", "") if isinstance(first, dict) \
            else str(first)
    inp = src.get("input") or {}
    sels = inp.get("selector") or []
    for s in sels:
        if isinstance(s, dict) and "type" in s:
            t = str(s["type"])
            sm.selectors.append("cloud" if t == "defsec" else t)
    svc = src.get("service")
    if svc:
        sm.service = str(svc)
    prov = src.get("provider")
    if prov:
        sm.provider = str(prov)
    return sm


def _applicable(sm: StaticMetadata, file_type: str) -> bool:
    if not sm.selectors:
        return True
    aliases = {file_type}
    if file_type in ("yaml", "json", "kubernetes"):
        aliases.add("kubernetes")
    return bool(aliases & set(sm.selectors))


# the process default rego evaluation trace sink (reference --trace /
# rego.WithTrace), set via set_rego_trace; a scan carries its own in
# misconf.MisconfSettings
_TRACE_SINK = None
# a trace argument left at this takes the process default; None traces
# nothing
PROCESS_DEFAULT = object()


def set_rego_trace(sink) -> None:
    """sink(event, rule_path, depth) or None to disable."""
    global _TRACE_SINK
    _TRACE_SINK = sink


def rego_trace():
    return _TRACE_SINK


class RegoChecksScanner:
    """Holds user modules + data and scans parsed config docs."""

    def __init__(self, modules: list[Module], data: dict | None = None,
                 namespaces=None, trace=PROCESS_DEFAULT):
        """trace: the sink of the rule evaluations (None: none); left
        out, the process default (set_rego_trace)."""
        self.all_modules = modules
        self.namespaces = set(namespaces or []) | DEFAULT_USER_NAMESPACES
        self.interp = Interpreter(
            modules, data=data,
            trace=_TRACE_SINK if trace is PROCESS_DEFAULT else trace)

    @classmethod
    def from_paths(cls, check_paths, data_paths=None, namespaces=None,
                   trace=PROCESS_DEFAULT):
        return cls(load_modules_from_paths(check_paths),
                   data=load_data_from_paths(data_paths),
                   namespaces=namespaces, trace=trace)

    def check_modules(self):
        for m in self.all_modules:
            if m.package and m.package[0] in self.namespaces:
                yield m

    def has_exceptions(self) -> bool:
        return any(
            m.package == ("namespace", "exceptions") or
            any(r.name == "exception" for r in m.rules)
            for m in self.all_modules)

    def _exc_interp(self, all_namespaces):
        """Interpreter with `data.namespaces` bound to every evaluated
        check namespace (the document the reference's scanner supplies
        to namespace-exception policies)."""
        key = tuple(sorted(all_namespaces))
        cache = getattr(self, "_exc_interps", None)
        if cache is None:
            cache = self._exc_interps = {}
        if key not in cache:
            cache[key] = Interpreter(
                self.all_modules,
                data={**self.interp.base_data,
                      "namespaces": list(key)})
        return cache[key]

    def is_namespace_ignored(self, namespace: str, input_doc,
                             all_namespaces) -> bool:
        """`data.namespace.exceptions.exception[_] == <ns>` evaluated
        with the input (reference exceptions.go isNamespaceIgnored)."""
        if not any(m.package == ("namespace", "exceptions")
                   for m in self.all_modules):
            return False
        try:
            val = self._exc_interp(all_namespaces).query(
                "namespace.exceptions.exception", input_doc=input_doc)
        except Exception:
            return False
        items = val.to_list() if isinstance(val, RSet) else \
            val if isinstance(val, list) else []
        return namespace in {str(x) for x in items}

    def is_rule_ignored(self, namespace: str, rule_name: str,
                        input_doc) -> bool:
        """`endswith(<ruleName>, data.<ns>.exception[_][_])` with the
        input (reference exceptions.go isRuleIgnored): the exception
        rule yields LISTS of rule-name suffixes; '' matches every
        rule."""
        pkg = tuple(namespace.split("."))
        if not any(m.package == pkg and
                   any(r.name == "exception" for r in m.rules)
                   for m in self.all_modules):
            return False
        try:
            val = self.interp.query(namespace + ".exception",
                                    input_doc=input_doc)
        except Exception:
            return False
        if val is UNDEF or val in (False, None):
            return False
        groups = val.to_list() if isinstance(val, RSet) else \
            val if isinstance(val, list) else [val]
        for group in groups:
            suffixes = group if isinstance(group, (list, tuple)) \
                else [group]
            for s in suffixes:
                if isinstance(s, str) and rule_name.endswith(s):
                    return True
        return False

    def is_ignored(self, namespace: str, rule_name: str, input_doc,
                   all_namespaces) -> bool:
        return self.is_namespace_ignored(
            namespace, input_doc, all_namespaces) or \
            self.is_rule_ignored(namespace, rule_name, input_doc)

    def scan_docs(self, file_type: str, path: str, docs,
                  text: str = "", extra_namespaces=None):
        """Evaluate every applicable module × enforced rule × doc.

        docs: list of parsed documents (each a plain JSON-like value).
        extra_namespaces: full namespace universe for data.namespaces
        (builtin + custom) when the caller knows it.
        → (failures, successes, exceptions) in the shared misconf
        shape."""
        failures: list[T.DetectedMisconfiguration] = []
        successes = 0
        exceptions = 0
        src_lines = text.splitlines() if text else []
        ignores = ignored_ids_by_line(text) if text else {}
        seen_pkgs = set()
        # loop-invariants: both scan every module, hoist out of the
        # per-doc-per-rule evaluation
        check_exceptions = self.has_exceptions()
        all_ns = extra_namespaces or \
            sorted(".".join(m.package) for m in self.check_modules())
        for mod in self.check_modules():
            # one evaluation per package: rules merge across modules
            # sharing a package (OPA compiles them into one document)
            if mod.package in seen_pkgs:
                continue
            seen_pkgs.add(mod.package)
            sm = self._package_metadata(mod)
            if not _applicable(sm, file_type):
                continue
            check = Check(
                id=sm.id, avd_id=sm.avd_id or sm.id,
                title=sm.title or sm.id,
                severity=sm.severity if sm.severity != "UNKNOWN"
                else "MEDIUM",
                description=sm.description,
                resolution=sm.recommended_actions,
                provider=sm.provider, service=sm.service,
                namespace=".".join(mod.package))
            rule_names = [n for n in self.interp.rule_names(mod.package)
                          if _enforced(n)]
            ns = ".".join(mod.package)
            module_failed = False
            module_excepted = False
            for doc in docs:
                for rname in rule_names:
                    # rego exceptions run for every namespace, custom
                    # ones included (reference scanner.go isIgnored)
                    if check_exceptions and \
                            self.is_ignored(ns, rname, doc, all_ns):
                        module_excepted = True
                        continue
                    for msg, rng in self._apply_rule(mod, rname, doc):
                        if is_ignored(ignores, check, rng[0]):
                            continue
                        module_failed = True
                        failures.append(build_misconf(
                            check, file_type, msg, rng, src_lines))
            if rule_names and not module_failed:
                if module_excepted:
                    exceptions += 1
                else:
                    successes += 1
        return failures, successes, exceptions

    def _package_metadata(self, mod: Module) -> StaticMetadata:
        """Metadata for a package: the annotated module wins when several
        modules share the package."""
        best = None
        for m in self.all_modules:
            if m.package != mod.package:
                continue
            sm = retrieve_metadata(self.interp, m)
            if sm.id != "N/A":
                return sm
            if best is None:
                best = sm
        return best or retrieve_metadata(self.interp, mod)

    def _apply_rule(self, mod: Module, rname: str, doc):
        path = ".".join(mod.package) + "." + rname
        try:
            val = self.interp.query(path, input_doc=doc)
        except Exception:
            return
        if val is UNDEF or val is False or val is None:
            return
        default_rng = _doc_range(doc)
        if isinstance(val, RSet):
            items = val.to_list()
        elif isinstance(val, list):
            items = val
        elif val is True:
            yield "Rego policy resulted in DENY", default_rng
            return
        else:
            items = [val]
        for item in items:
            yield _parse_result(item, default_rng)


def _doc_range(doc):
    if isinstance(doc, dict):
        md = doc.get("__defsec_metadata")
        if isinstance(md, dict):
            try:
                return (int(md.get("startline", 0)),
                        int(md.get("endline", 0)))
            except Exception:
                pass
    return (0, 0)


def _parse_result(item, default_rng):
    """String / cause-object / [obj, msg] array → (msg, range)
    (reference result.go parseResult)."""
    item = unfreeze(item)
    if isinstance(item, str):
        return item, default_rng
    if isinstance(item, list):
        msg = ""
        rng = default_rng
        for sub in item:
            if isinstance(sub, str):
                msg = sub
            elif isinstance(sub, dict):
                m, rng = _parse_cause(sub, default_rng)
                if m:
                    msg = m
        return msg or "Rego policy resulted in DENY", rng
    if isinstance(item, dict):
        msg, rng = _parse_cause(item, default_rng)
        return msg or "Rego policy resulted in DENY", rng
    return "Rego policy resulted in DENY", default_rng


def _parse_cause(cause, default_rng):
    msg = str(cause.get("msg", ""))
    start, end = default_rng
    if "startline" in cause:
        start = _int(cause["startline"])
    if "endline" in cause:
        end = _int(cause["endline"])
    md = cause.get("__defsec_metadata")
    if isinstance(md, dict):
        if "startline" in md:
            start = _int(md["startline"])
        if "endline" in md:
            end = _int(md["endline"])
    return msg, (start, max(start, end))


def _int(v):
    try:
        return int(float(v))
    except Exception:
        return 0
