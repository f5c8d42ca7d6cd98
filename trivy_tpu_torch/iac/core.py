"""Shared IaC check model and result assembly.

Reference counterparts: pkg/iac/scan (Result/Rule model),
pkg/iac/ignore (inline ignore comments), and the rego metadata blocks of
trivy-checks that carry id/avd_id/severity/resolution.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .. import types as T


@dataclass
class Check:
    """One policy: metadata + a function evaluated against parsed input.

    The function signature is scanner-specific; it yields
    (message, (start_line, end_line)) per failure occurrence, or nothing
    when the check passes.
    """
    id: str
    avd_id: str
    title: str
    severity: str
    description: str = ""
    resolution: str = ""
    provider: str = ""
    service: str = "general"
    namespace: str = ""
    fn: object = None


def build_misconf(check: Check, file_type: str, message: str,
                  rng: tuple[int, int], src_lines: list[str],
                  status: str = "FAIL") -> T.DetectedMisconfiguration:
    """Assemble a DetectedMisconfiguration with cause-code lines the way
    the reference renders rego results (pkg/misconf/scanner.go
    ResultsToMisconf + pkg/iac/scan code extraction)."""
    start, end = rng
    m = T.DetectedMisconfiguration(
        type=file_type,
        id=check.id,
        avd_id=check.avd_id,
        title=check.title,
        description=check.description,
        message=message,
        namespace=check.namespace or f"builtin.{file_type}.{check.id}",
        resolution=check.resolution,
        severity=check.severity,
        primary_url=f"https://avd.aquasec.com/misconfig/{check.id.lower()}",
        status=status,
    )
    if start > 0:
        end = min(max(end, start), len(src_lines)) if src_lines else end
        code_lines = []
        for n in range(start, min(end, start + 10 - 1) + 1):
            content = src_lines[n - 1] if n - 1 < len(src_lines) else ""
            code_lines.append(T.CodeLine(
                number=n, content=content, is_cause=True,
                first_cause=(n == start), last_cause=(n == end),
                highlighted=content))
        m.cause_metadata = T.CauseMetadata(
            provider=check.provider, service=check.service,
            start_line=start, end_line=end,
            code=T.Code(lines=code_lines))
    else:
        m.cause_metadata = T.CauseMetadata(
            provider=check.provider, service=check.service)
    return m


_IGNORE_RE = re.compile(
    r"(?:#|//)\s*trivy:ignore:([A-Za-z0-9-]+)")


def ignored_ids_by_line(text: str) -> dict[int, set[str]]:
    """Inline ignore comments (reference pkg/iac/ignore/parse.go):
    `#trivy:ignore:AVD-XXX-0001` suppresses findings caused on the same
    line or the line immediately below the comment."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        for m in _IGNORE_RE.finditer(line):
            ident = m.group(1).upper()
            stripped = line[:m.start()].strip()
            target = i if stripped else i + 1
            out.setdefault(target, set()).add(ident)
    return out


def is_ignored(ignores: dict[int, set[str]], check: Check,
               start_line: int) -> bool:
    ids = ignores.get(start_line)
    if not ids:
        return False
    wanted = {check.id.upper(), check.avd_id.upper(), "*"}
    return bool(ids & wanted)


def run_checks(checks: list[Check], file_type: str, text: str,
               call, src_lines=None):
    """Drive a check list: `call(check)` yields (message, range) failures.
    → (failures, successes) applying inline ignores."""
    if src_lines is None:
        src_lines = text.splitlines()
    ignores = ignored_ids_by_line(text)
    failures: list[T.DetectedMisconfiguration] = []
    successes = 0
    for check in checks:
        found = list(call(check))
        kept = [(msg, rng) for msg, rng in found
                if not is_ignored(ignores, check, rng[0])]
        if not kept:
            successes += 1
            continue
        for msg, rng in kept:
            failures.append(
                build_misconf(check, file_type, msg, rng, src_lines))
    return failures, successes
