"""License scanning (reference pkg/licensing): the port's copy of the
JAX package's module.

Package-declared licenses are categorized and reported as the
reference's default mode does (scanLicenses,
pkg/scanner/local/scan.go:280); `--license-full` adds the full-text
classification of license files (`classify_license_file`, a
distinctive-phrase scorer in place of google/licenseclassifier).

Category → severity mapping follows pkg/licensing/scanner.go:23."""

from __future__ import annotations

from . import types as T

CATEGORY_SEVERITY = {
    "forbidden": "CRITICAL",
    "restricted": "HIGH",
    "reciprocal": "MEDIUM",
    "notice": "LOW",
    "permissive": "LOW",
    "unencumbered": "LOW",
    "unknown": "UNKNOWN",
}

# Classification of common SPDX ids into google/licenseclassifier-style
# categories (pkg/licensing/category data).
_CATEGORIES = {
    "forbidden": {"AGPL-1.0", "AGPL-3.0", "AGPL-3.0-only",
                  "AGPL-3.0-or-later", "CC-BY-NC-1.0", "CC-BY-NC-2.0",
                  "CC-BY-NC-3.0", "CC-BY-NC-4.0", "CC-BY-NC-ND-4.0",
                  "CC-BY-NC-SA-4.0", "Commons-Clause", "WTFPL"},
    "restricted": {"GPL-1.0", "GPL-2.0", "GPL-2.0-only", "GPL-2.0+",
                   "GPL-2.0-or-later", "GPL-3.0", "GPL-3.0-only",
                   "GPL-3.0-or-later", "LGPL-2.0", "LGPL-2.1",
                   "LGPL-2.1-only", "LGPL-2.1-or-later", "LGPL-3.0",
                   "LGPL-3.0-only", "LGPL-3.0-or-later", "CC-BY-ND-4.0",
                   "CC-BY-SA-4.0", "NPL-1.0", "NPL-1.1", "OSL-3.0",
                   "QPL-1.0", "Sleepycat"},
    "reciprocal": {"MPL-1.0", "MPL-1.1", "MPL-2.0", "EPL-1.0", "EPL-2.0",
                   "CDDL-1.0", "CDDL-1.1", "CPL-1.0", "APSL-2.0",
                   "Ruby", "OSL-1.0", "IPL-1.0", "ErlPL-1.1"},
    "notice": {"Apache-2.0", "Apache-1.1", "Apache-1.0", "MIT", "BSD-2-Clause",
               "BSD-3-Clause", "BSD-4-Clause", "ISC", "Artistic-1.0",
               "Artistic-2.0", "Zlib", "PSF-2.0", "Python-2.0", "NCSA",
               "OpenSSL", "PHP-3.0", "PHP-3.01", "W3C", "X11", "Xnet",
               "AFL-3.0", "BSL-1.0", "CC-BY-4.0", "FTL", "LPL-1.02",
               "MS-PL", "Unicode-DFS-2015", "Unicode-DFS-2016",
               "UPL-1.0"},
    "unencumbered": {"CC0-1.0", "Unlicense", "0BSD", "blessing"},
    "permissive": set(),
}

_NORMALIZE = {
    "apache 2.0": "Apache-2.0", "apache2": "Apache-2.0",
    "apache-2": "Apache-2.0", "apache license 2.0": "Apache-2.0",
    "asl 2.0": "Apache-2.0", "apache software license": "Apache-2.0",
    "mit license": "MIT", "the mit license": "MIT",
    "bsd": "BSD-3-Clause", "new bsd license": "BSD-3-Clause",
    "bsd license": "BSD-3-Clause", "bsd-3": "BSD-3-Clause",
    "gplv2": "GPL-2.0", "gplv2+": "GPL-2.0-or-later",
    "gplv3": "GPL-3.0", "gplv3+": "GPL-3.0-or-later",
    "lgplv2": "LGPL-2.0", "lgplv2+": "LGPL-2.1-or-later",
    "lgplv3": "LGPL-3.0",
    "public domain": "Unlicense", "zlib/libpng license": "Zlib",
    "mpl 2.0": "MPL-2.0",
}


def normalize(name: str) -> str:
    return _NORMALIZE.get(name.strip().lower(), name.strip())


def categorize(name: str) -> str:
    n = normalize(name)
    for cat, names in _CATEGORIES.items():
        if n in names:
            return cat
    return "unknown"


def scan_license_name(name: str, categories: dict | None = None
                      ) -> tuple[str, str]:
    """→ (category, severity) for a RAW license name — the reference's
    licensing.Scanner.Scan does no normalization ("MIT License" is
    unknown, "MIT" is notice; scan.go:292)."""
    cat = _custom_category(name, categories)
    if cat is None:
        cat = "unknown"
        for c, names in _CATEGORIES.items():
            if name in names:
                cat = c
                break
    return cat, CATEGORY_SEVERITY.get(cat, "UNKNOWN")


def scan_packages(detail_packages: list, applications: list,
                  categories: dict | None = None) -> list[T.DetectedLicense]:
    """Declared-license scan over OS packages + applications.

    `categories` optionally overrides category membership per the
    --license-* flags (reference pkg/flag/license_flags.go)."""
    out: list[T.DetectedLicense] = []

    def _emit(pkg: T.Package, file_path: str = ""):
        for lic in pkg.licenses:
            cat, sev = scan_license_name(lic, categories)
            out.append(T.DetectedLicense(
                severity=sev, category=cat, pkg_name=pkg.name,
                file_path=file_path or pkg.file_path,
                name=lic, confidence=1.0,
            ))

    for pkg in detail_packages:
        _emit(pkg)
    for app in applications:
        for pkg in app.packages:
            _emit(pkg, app.file_path)
    return out


def _custom_category(name: str, categories: dict | None):
    if not categories:
        return None
    for cat, names in categories.items():
        if name in names:
            return cat
    return None


# ---- full-text classification (reference pkg/licensing/classifier.go
# via google/licenseclassifier; here: distinctive-phrase scoring) ------

# Distinctive phrases per license, drawn from the canonical public
# texts. A phrase "hits" when present in the normalized input; the
# confidence is the hit fraction. Phrases are chosen to be mutually
# discriminative (e.g. only Apache-2.0 contains "grant of patent
# license"; only GPL-3.0 has "basic permissions").
_CLASSIFY_PHRASES = {
    "MIT": [
        "permission is hereby granted free of charge",
        "to deal in the software without restriction",
        "the above copyright notice and this permission notice shall "
        "be included in all copies",
        "the software is provided as is without warranty of any kind",
    ],
    "Apache-2.0": [
        "apache license",
        "grant of patent license",
        "grant of copyright license",
        "unless required by applicable law or agreed to in writing",
        "limitations under the license",
    ],
    "GPL-3.0": [
        "gnu general public license",
        "version 3",
        "basic permissions",
        "protecting users legal rights from anti circumvention law",
        "conveying non source forms",
    ],
    "GPL-2.0": [
        "gnu general public license",
        "version 2",
        "the licenses for most software are designed to take away",
        "we protect your rights with two steps",
    ],
    "LGPL-2.1": [
        "gnu lesser general public license",
        "version 2 1",
        "when we speak of free software we are referring to freedom",
    ],
    "BSD-3-Clause": [
        "redistribution and use in source and binary forms",
        "redistributions of source code must retain the above "
        "copyright notice",
        "neither the name of",
        "this software is provided by the copyright holders and "
        "contributors as is",
    ],
    "BSD-2-Clause": [
        "redistribution and use in source and binary forms",
        "redistributions in binary form must reproduce the above "
        "copyright notice",
        "this software is provided by the copyright holders and "
        "contributors as is",
    ],
    "ISC": [
        "permission to use copy modify and or distribute this "
        "software for any purpose",
        "the software is provided as is and the author disclaims all "
        "warranties",
    ],
    "MPL-2.0": [
        "mozilla public license",
        "version 2 0",
        "means covered software of that particular contributor",
        "source code form",
    ],
    "Unlicense": [
        "this is free and unencumbered software released into the "
        "public domain",
        "anyone is free to copy modify publish use compile sell or "
        "distribute this software",
    ],
}

import re as _re

_NORM_RE = _re.compile(r"[^a-z0-9]+")


def _normalize_text(text: str) -> str:
    return " " + _NORM_RE.sub(" ", text.lower()).strip() + " "


def classify_text(text: str, confidence_level: float = 0.6):
    """→ (license name, confidence) of the best-scoring license, or
    None below the threshold (Classify's confidenceLevel gate,
    classifier.go:35-58)."""
    norm = _normalize_text(text)
    best = None
    for name, phrases in _CLASSIFY_PHRASES.items():
        hits = sum(1 for p in phrases if " " + p + " " in norm)
        conf = hits / len(phrases)
        # tie-break: BSD-3 over BSD-2 and GPL-3 over GPL-2 need full
        # distinctive coverage, so strictly-greater keeps the more
        # specific match when it scores higher
        if conf > confidence_level and \
                (best is None or conf > best[1]):
            best = (name, conf)
    return best


LICENSE_FILE_NAMES = {
    "license", "license.txt", "license.md", "licence", "licence.txt",
    "copying", "copying.txt", "notice", "copyright",
}


def classify_license_file(path: str, content: bytes,
                          confidence_level: float = 0.6
                          ) -> list[T.DetectedLicense]:
    """File-level classification for --license-full → DetectedLicense
    findings (reference pkg/fanal/analyzer/licensing → Classify)."""
    base = path.rsplit("/", 1)[-1].lower()
    if base not in LICENSE_FILE_NAMES:
        return []
    text = content.decode("utf-8", errors="replace")
    hit = classify_text(text, confidence_level)
    if hit is None:
        return []
    name, conf = hit
    cat = categorize(name)
    return [T.DetectedLicense(
        severity=CATEGORY_SEVERITY.get(cat, "UNKNOWN"),
        category=cat, file_path=path, name=name,
        confidence=round(conf, 2),
        link=f"https://spdx.org/licenses/{name}.html")]
