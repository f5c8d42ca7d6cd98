"""Result filtering (reference pkg/result/filter.go Filter:39): the
severity floor, the status filter and the ignore file, applied per
result after detection, before reporting.

The port's copy of the JAX package's result/filter.py without
`IgnorePolicy`: a rego ignore policy needs the rego interpreter, which
is not ported, so the CLI refuses `--ignore-policy`."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .. import types as T
from .ignore import IgnoreFile


@dataclass
class FilterOptions:
    severities: list = field(default_factory=lambda: list(T.SEVERITIES))
    ignore_statuses: list = field(default_factory=list)
    ignore_unfixed: bool = False
    ignore_file: Optional[IgnoreFile] = None


def filter_results(results: list[T.Result],
                   opts: FilterOptions) -> list[T.Result]:
    sev = set(opts.severities)
    for res in results:
        res.vulnerabilities = [v for v in res.vulnerabilities
                               if _keep_vuln(v, res, sev, opts)]
        res.secrets = [
            s for s in res.secrets
            if s.severity in sev and not _ignored(
                opts, "secrets", s.rule_id, res.target)]
        res.misconfigurations = [
            m for m in res.misconfigurations
            if m.severity in sev and not _ignored(
                opts, "misconfigurations", m.id, res.target)]
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
