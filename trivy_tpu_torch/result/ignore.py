""".trivyignore and .trivyignore.yaml (reference pkg/result/ignore.go).

A plain file lists one finding ID per line, with `#` comments, and after
the ID an optional `exp:YYYY-MM-DD` expiry and path globs; its entries
apply to every finding class. A YAML file has one section per class
(vulnerabilities, misconfigurations, secrets, licenses) whose entries
carry `id`, `paths`, `expired_at` and `statement`. An entry past its
expiry date ignores nothing."""

from __future__ import annotations

import datetime as dt
import fnmatch
from dataclasses import dataclass, field
from typing import Optional

SECTIONS = ("vulnerabilities", "misconfigurations", "secrets", "licenses")


@dataclass
class IgnoreEntry:
    id: str
    paths: list = field(default_factory=list)
    expired_at: Optional[dt.date] = None
    statement: str = ""

    def matches(self, finding_id: str, path: str = "",
                today: Optional[dt.date] = None) -> bool:
        if self.id != finding_id:
            return False
        if self.expired_at is not None and \
                (today or dt.date.today()) > self.expired_at:
            return False
        if self.paths:
            return any(fnmatch.fnmatch(path, p) for p in self.paths)
        return True


@dataclass
class IgnoreFile:
    vulnerabilities: list = field(default_factory=list)
    misconfigurations: list = field(default_factory=list)
    secrets: list = field(default_factory=list)
    licenses: list = field(default_factory=list)

    def match(self, section: str, finding_id: str, path: str = "") -> bool:
        return any(e.matches(finding_id, path)
                   for e in getattr(self, section))


def parse_ignore_file(path: str) -> IgnoreFile:
    if path.endswith((".yaml", ".yml")):
        return _parse_yaml(path)
    return _parse_plain(path)


def _parse_plain(path: str) -> IgnoreFile:
    out = IgnoreFile()
    with open(path) as f:
        for line in f:
            fields = line.split("#", 1)[0].split()
            if not fields:
                continue
            entry = IgnoreEntry(id=fields[0])
            for tok in fields[1:]:
                if tok.startswith("exp:"):
                    entry.expired_at = dt.date.fromisoformat(tok[4:])
                else:
                    entry.paths.append(tok)
            for section in SECTIONS:
                getattr(out, section).append(entry)
    return out


def _parse_yaml(path: str) -> IgnoreFile:
    import yaml
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    out = IgnoreFile()
    for section in SECTIONS:
        for item in doc.get(section) or []:
            entry = IgnoreEntry(id=item.get("id", ""),
                                paths=item.get("paths") or [],
                                statement=item.get("statement", ""))
            if item.get("expired_at"):
                entry.expired_at = dt.date.fromisoformat(
                    str(item["expired_at"]))
            getattr(out, section).append(entry)
    return out
