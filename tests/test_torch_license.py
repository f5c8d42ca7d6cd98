"""The port's license scanning held against the JAX package's, on the CPU:

- `license_expr`: the inputs of every case of tests/test_license_expr.py
  through both packages' `parse`, `render`, `normalize`,
  `normalize_for_spdx` and `normalize_pkg_licenses`, as one parametrised
  test; the trees, strings and errors must be equal;
- `licensing`: `normalize`, `categorize`, `scan_license_name`,
  `classify_text` and `classify_license_file` on the same names and
  texts;
- the CLI: `rootfs|fs --scanners vuln,license [--license-full]` on the
  conda and npm golden inputs, and on copies of them with license files,
  byte-equal to the JAX CLI's report with the clock fixed."""

import contextlib
import dataclasses
import io
import os
import shutil

import pytest

import trivy_tpu.cli as ref_cli
from trivy_tpu import license_expr as ref_expr
from trivy_tpu import licensing as ref_lic
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import license_expr as port_expr
from trivy_tpu_torch import licensing as port_lic

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")
GOLD_DB = os.path.join(GOLD, "db", "*.yaml")
NOW = "2021-08-25T12:20:30Z"

# the inputs of tests/test_license_expr.py, one per case there
EXPRESSIONS = [
    "Public Domain",
    "DocumentRef-spdx-tool-1.2:LicenseRef-MIT-Style-2",
    "Public ._-+",
    "A+B",
    "Public Domain AND ( GPLv2+ or AFL ) AND "
    "LGPLv2+ with distribution exceptions",
    "Public Domain AND ( GPLv2+ or AFL AND ( CC0 or LGPL1.0) )",
    "Public Domain AND ( GPLv2+ ",
    "A WITH exc AND B",
    "A WITH B WITH C",
    "GPL-2.0",
    "GPL-2.0+",
    "MIT+",
    "MIT or BSD-3-Clause",
    "The MIT License",
    "A:B c",
    "Café 1.0",
    "",
    "( MIT",
    "MIT )",
    "AND MIT",
]
PKG_LICENSES = [
    ["GPL-3.0-with-autoconf-exception"],
    ["MIT", "Apache-2.0"],
    [],
    ["GPL-2.0"],
    ["LGPLv2+"],
    ["Public Domain", "GPLv2+"],
    ["MIT OR (Apache-2.0"],
]


def _tree(e):
    """An expression tree as plain data (class name and fields)."""
    if dataclasses.is_dataclass(e):
        return (type(e).__name__,
                {f.name: _tree(getattr(e, f.name))
                 for f in dataclasses.fields(e)})
    return e


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return (type(e).__name__, str(e))


def _expr_calls(mod, lic_mod, case):
    kind, value = case
    if kind == "pkg":
        return [_outcome(mod.normalize_pkg_licenses, value)]
    return [
        _outcome(lambda s: _tree(mod.parse(s)), value),
        _outcome(lambda s: mod.parse(s).render(), value),
        _outcome(mod.normalize, value),
        _outcome(lambda s: mod.normalize(s, lic_mod.normalize,
                                         mod.normalize_for_spdx,
                                         plus_fn=lic_mod.normalize), value),
        _outcome(mod.normalize_for_spdx, value),
    ]


CASES = [("expr", e) for e in EXPRESSIONS] + \
    [("pkg", p) for p in PKG_LICENSES]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_license_expr_parity(case):
    assert _expr_calls(port_expr, port_lic, case) == \
        _expr_calls(ref_expr, ref_lic, case)


NAMES = ["MIT", "MIT License", "the mit license", "Apache-2.0",
         "apache 2.0", "ASL 2.0", "GPL-2.0", "GPL-2.0+", "gplv2+",
         "LGPL-2.1-only", "lgplv2+", "AGPL-3.0", "WTFPL", "MPL-2.0",
         "mpl 2.0", "CC0-1.0", "Unlicense", "public domain", "BSD",
         "Ruby", "Sleepycat", "", "  MIT  ", "Proprietary",
         "MIT OR Apache-2.0"]


@pytest.mark.parametrize("name", NAMES)
def test_licensing_names_parity(name):
    for fn in ("normalize", "categorize", "scan_license_name"):
        assert getattr(port_lic, fn)(name) == getattr(ref_lic, fn)(name)
    custom = {"forbidden": {"MIT"}, "notice": {"GPL-2.0"}}
    assert port_lic.scan_license_name(name, custom) == \
        ref_lic.scan_license_name(name, custom)


MIT_TEXT = """MIT License

Permission is hereby granted, free of charge, to any person obtaining a
copy of this software, to deal in the Software without restriction.
The above copyright notice and this permission notice shall be included
in all copies or substantial portions of the Software.
THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND."""

APACHE_TEXT = """Apache License, Version 2.0
2. Grant of Copyright License. 3. Grant of Patent License.
Unless required by applicable law or agreed to in writing, software
distributed under the License is distributed on an "AS IS" BASIS.
See the License for the specific language governing permissions and
limitations under the License."""

BSD3_TEXT = """Redistribution and use in source and binary forms, with or
without modification, are permitted. Redistributions of source code must
retain the above copyright notice. Redistributions in binary form must
reproduce the above copyright notice. Neither the name of the copyright
holder nor the names of its contributors may be used. THIS SOFTWARE IS
PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS IS"."""

TEXTS = [MIT_TEXT, APACHE_TEXT, BSD3_TEXT, "nothing to see here",
         MIT_TEXT[:60], ""]


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_classify_parity(text):
    for level in (0.6, 0.3, 0.9):
        assert port_lic.classify_text(text, level) == \
            ref_lic.classify_text(text, level)
    for path in ("LICENSE", "pkg/COPYING.txt", "src/main.c"):
        got = port_lic.classify_license_file(path, text.encode())
        want = ref_lic.classify_license_file(path, text.encode())
        assert [li.to_json() for li in got] == \
            [li.to_json() for li in want]


def run_both(argv, tmp_path) -> tuple:
    """Both CLIs in this process with their own cache dirs → the two
    reports' bytes."""
    outs = {}
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        out = str(tmp_path / f"{who}.json")
        extra = ["--cache-dir", str(tmp_path / f"{who}-cache")]
        if who == "port":
            extra += ["--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv + ["--output", out] + extra) == 0
        with open(out, "rb") as f:
            outs[who] = f.read()
    return outs["port"], outs["ref"]


@pytest.fixture
def fixed_clock(tmp_path, monkeypatch):
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", NOW)
    return tmp_path


def _with_license_files(src: str, dst: str) -> str:
    shutil.copytree(src, dst)
    files = {"LICENSE": MIT_TEXT, "vendor/a/COPYING": APACHE_TEXT,
             "vendor/b/LICENSE.md": BSD3_TEXT, "NOTICE": "no license"}
    for rel, text in files.items():
        path = os.path.join(dst, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return dst


@pytest.mark.parametrize("command,name,extra,files", [
    ("rootfs", "conda", [], False),
    ("rootfs", "conda", ["--license-full"], True),
    ("fs", "npm", [], False),
    ("fs", "npm", ["--license-full"], True),
    ("fs", "npm", ["--license-full", "--format", "table"], True),
])
def test_license_scan_identical_to_reference(command, name, extra, files,
                                             fixed_clock):
    target = os.path.join(GOLD, "inputs", name)
    if files:
        target = _with_license_files(target,
                                     str(fixed_clock / "target"))
    port, ref = run_both([command, target, "--db", GOLD_DB, "--scanners",
                          "vuln,license", *extra], fixed_clock)
    assert port == ref
    if files and "--format" not in extra:
        assert b"Loose File License(s)" in port and b'"MIT"' in port


def test_licenses_alias_and_license_only_scan(fixed_clock):
    """`--scanners licenses` is the reference's alias; a license-only
    scan loads no table."""
    target = os.path.join(GOLD, "inputs", "npm")
    port, ref = run_both(["fs", target, "--scanners", "licenses",
                          "--db", str(fixed_clock / "missing.npz")],
                         fixed_clock)
    assert port == ref
