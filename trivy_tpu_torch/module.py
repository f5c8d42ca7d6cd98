"""Extension modules (reference pkg/module: WASM analyzers and post-scan
hooks; module.go Register:411, PostScan:478).

The reference compiles modules to WASM and runs them under wazero; here
a module is a Python file in `<home>/modules/*.py` (`TRIVY_TPU_HOME`,
default `~/.trivy-tpu`, the same home the JAX package reads, so one
install serves both CLIs). A module may use torch, never jax. Its API
mirrors the WASM one (examples/module/spring4shell):

    name = "spring4shell"            # module identity
    version = 1                      # enters the cache keys
    # per-file analyzer half (optional)
    required_files = [r"\\.jar$"]     # regexes over file paths
    def analyze(path, content): ...  # → dict, a custom resource's Data
    # post-scan half (optional)
    post_scan_spec = {"action": "update", "ids": ["CVE-2022-22965"]}
    def post_scan(results): ...      # → mutated results list

Actions: insert (the hook gets and returns every result), update (the
hook gets the findings with the listed IDs and returns their
replacements), delete (the listed IDs are removed): serialize.PostScanSpec.
A module that raises in `analyze` or `post_scan` is skipped for that
file or scan, as in the reference: it is the user's code.
"""

from __future__ import annotations

import importlib.util
import os
import re

from .log import logger


class LoadedModule:
    def __init__(self, pymod, path: str):
        self.pymod = pymod
        self.path = path
        self.name = getattr(pymod, "name", os.path.basename(path))
        self.version = getattr(pymod, "version", 1)
        pats = getattr(pymod, "required_files", [])
        self.required_res = [re.compile(p) for p in pats]
        self.analyze = getattr(pymod, "analyze", None)
        self.post_scan = getattr(pymod, "post_scan", None)
        self.post_scan_spec = getattr(pymod, "post_scan_spec", {}) or {}

    def required(self, path: str) -> bool:
        return any(r.search(path) for r in self.required_res)


_loaded: list[LoadedModule] = []


def modules_dir() -> str:
    base = os.environ.get("TRIVY_TPU_HOME") or \
        os.path.join(os.path.expanduser("~"), ".trivy-tpu")
    return os.path.join(base, "modules")


def load_modules(dir_: str | None = None) -> list[LoadedModule]:
    """Import every .py in the modules dir and register its hooks
    (reference module.go NewManager + Register)."""
    global _loaded
    _loaded = []
    root = dir_ or modules_dir()
    if not os.path.isdir(root):
        return _loaded
    for fname in sorted(os.listdir(root)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        fpath = os.path.join(root, fname)
        try:
            spec = importlib.util.spec_from_file_location(
                f"trivy_tpu_torch_module_{fname[:-3]}", fpath)
            pymod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(pymod)
        except Exception as e:  # noqa: BLE001 — user module code
            logger.warning("failed to load module %s: %s", fpath, e)
            continue
        _loaded.append(LoadedModule(pymod, fpath))
    _register_analyzers()
    return _loaded


def loaded_modules() -> list[LoadedModule]:
    return _loaded


def clear_modules() -> None:
    global _loaded
    _loaded = []
    _register_analyzers()


def _register_analyzers() -> None:
    """Expose the modules' analyze() hooks through the analyzer registry
    (the WASM modules register into the same registry, module.go:411)."""
    from .fanal.analyzers import set_module_analyzers
    set_module_analyzers([m for m in _loaded if m.analyze])


def apply_post_scan(results: list) -> list:
    """Run the post-scan hooks over a target's results (reference
    post.Scan, called at pkg/scanner/local/scan.go:162)."""
    for m in _loaded:
        if m.post_scan is None:
            continue
        action = str(m.post_scan_spec.get("action", "")).lower()
        ids = set(m.post_scan_spec.get("ids", []))
        try:
            if action in ("update", "delete") and ids:
                relevant = _findings_with_ids(results, ids)
                out = m.post_scan(relevant)
                _apply_updates(results, out or [], ids,
                               delete=(action == "delete"))
            else:
                out = m.post_scan(results)
                if out is not None:
                    results = out
        except Exception as e:  # noqa: BLE001 — user module code
            logger.warning("module %s post_scan failed: %s", m.name, e)
    return results


def _findings_with_ids(results, ids):
    out = []
    for res in results:
        vulns = [v for v in res.vulnerabilities
                 if v.vulnerability_id in ids]
        if vulns:
            out.append({"target": res.target, "vulnerabilities": vulns})
    return out


def _apply_updates(results, updated, ids, delete: bool):
    if delete:
        for res in results:
            res.vulnerabilities = [
                v for v in res.vulnerabilities
                if v.vulnerability_id not in ids]
        return
    # update: the module's versions replace the matching findings
    by_key = {}
    for entry in updated:
        for v in entry.get("vulnerabilities", []):
            by_key[(entry.get("target", ""), v.vulnerability_id,
                    v.pkg_name)] = v
    for res in results:
        res.vulnerabilities = [
            by_key.get((res.target, v.vulnerability_id, v.pkg_name), v)
            for v in res.vulnerabilities]
