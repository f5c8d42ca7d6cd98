"""Result filtering (reference pkg/result/filter.go Filter:39): the
severity floor, the status filter, the ignore file and the rego ignore
policy, applied per result after detection, before reporting. The
port's copy of the JAX package's result/filter.py."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from .. import types as T
from .ignore import IgnoreFile

log = logging.getLogger(__name__)


@dataclass
class FilterOptions:
    severities: list = field(default_factory=lambda: list(T.SEVERITIES))
    ignore_statuses: list = field(default_factory=list)
    ignore_unfixed: bool = False
    ignore_file: Optional[IgnoreFile] = None
    policy_file: str = ""   # rego ignore policy (reference applyPolicy)


class IgnorePolicy:
    """`--ignore-policy policy.rego`: a rego module whose `ignore` rule
    decides, per finding, whether it is suppressed (reference
    pkg/result/filter.go:242 applyPolicy querying data.trivy.ignore)."""

    def __init__(self, path: str):
        from ..iac.rego import rego_trace
        from ..iac.rego.eval import Interpreter
        from ..iac.rego.parser import parse_module
        with open(path, encoding="utf-8") as f:
            mod = parse_module(f.read(), path=path)
        self.interp = Interpreter([mod], trace=rego_trace())
        self.pkg = ".".join(mod.package)

    _warned = False

    def ignore(self, finding_doc: dict) -> bool:
        try:
            v = self.interp.query(f"{self.pkg}.ignore", finding_doc)
        except Exception as e:
            if not self._warned:
                log.warning("ignore policy evaluation failed (policy has "
                            "no effect): %s", e)
                self._warned = True
            return False
        return v is True


def filter_results(results: list[T.Result],
                   opts: FilterOptions) -> list[T.Result]:
    sev = set(opts.severities)
    policy = IgnorePolicy(opts.policy_file) if opts.policy_file else None
    for res in results:
        res.vulnerabilities = [
            v for v in res.vulnerabilities
            if _keep_vuln(v, res, sev, opts) and not (
                policy and policy.ignore(v.to_json()))]
        res.secrets = [
            s for s in res.secrets
            if s.severity in sev and not _ignored(
                opts, "secrets", s.rule_id, res.target) and not (
                policy and policy.ignore(s.to_json()))]
        res.misconfigurations = [
            m for m in res.misconfigurations
            if m.severity in sev and not _ignored(
                opts, "misconfigurations", m.id, res.target) and not (
                policy and policy.ignore(m.to_json()))]
    # OS- and language-package results stay even when empty, and so do
    # the license groups (reference scan.go:302-360)
    return [r for r in results if not r.is_empty() or r.clazz in
            (T.ResultClass.OS_PKGS, T.ResultClass.LANG_PKGS,
             T.ResultClass.LICENSE, T.ResultClass.LICENSE_FILE)]


def _keep_vuln(v: T.DetectedVulnerability, res: T.Result, sev: set,
               opts: FilterOptions) -> bool:
    if v.severity not in sev:
        return False
    if opts.ignore_unfixed and not v.fixed_version:
        return False
    if v.status and v.status in opts.ignore_statuses:
        return False
    return not _ignored(opts, "vulnerabilities", v.vulnerability_id,
                        v.pkg_path or res.target)


def _ignored(opts: FilterOptions, section: str, fid: str, path: str) -> bool:
    if opts.ignore_file is None or not fid:
        return False
    return opts.ignore_file.match(section, fid, path)
