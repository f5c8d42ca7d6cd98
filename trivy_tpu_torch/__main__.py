"""Command line of the port:

    python -m trivy_tpu_torch image --input ARCHIVE --db SPEC [...]
    python -m trivy_tpu_torch rootfs DIR --db SPEC [...]
    python -m trivy_tpu_torch fs DIR --db SPEC [...]
    python -m trivy_tpu_torch repo DIR --db SPEC [...]

Mirrors `python -m trivy_tpu.cli image --input`, `rootfs`, `fs` and
`repo` (a local path) for the scanners `vuln` and `secret`, with the
JSON format: the report is the same byte for byte, apart from CreatedAt,
on every target whose contents the ported analyzers cover. `image` reads
docker-save and OCI-layout archives (plain or gzip layers, whiteouts,
opaque dirs). The analyzers cover OS releases of every family the
detector knows, the apk, dpkg and rpm package databases, the language
lockfiles (npm, yarn, pnpm, gomod, cargo, poetry, pipenv, pip, bundler,
composer, pom, gradle, nuget, dotnet, packages-props, conan, mix, swift,
cocoapods, pub, julia) and installed packages (Python, conda, Go and
Rust binaries, jars, node_modules, gems). Each command disables the
analyzers the reference disables for it (run.go:167-224): image and
rootfs the lockfiles, fs the installed packages, repo the installed
packages and the OS. Registry, daemon and containerd image sources and
remote repositories are not ported. Runs on CUDA unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse
import datetime as dt
import glob
import json
import os
import sys

from . import javadb
from . import types as T
from .db import AdvisoryTable, build_table
from .db.fixtures import load_fixture_files
from .device import resolve_device
from .fanal.analyzers import (INDIVIDUAL_PKG_ANALYZERS, LOCKFILE_ANALYZERS,
                              OS_ANALYZERS, AnalyzerGroup)
from .fanal.artifact import FilesystemArtifact, ImageArchiveArtifact
from .fanal.cache import MemoryCache, open_cache
from .fanal.walker import DEFAULT_SECRET_CONFIG
from .report import build_report, write_report
from .scanner import LocalScanner, filter_results

_SCANNER_ALIASES = {"vulnerability": "vuln", "secrets": "secret"}
SUPPORTED_SCANNERS = ("vuln", "secret")


def load_table(spec: str) -> AdvisoryTable:
    """--db: a columnar .npz saved by either package, or a fixture YAML
    glob."""
    if spec.endswith(".npz"):
        return AdvisoryTable.load(spec)
    paths = sorted(glob.glob(spec)) or [spec]
    advisories, details, sources = load_fixture_files(paths)
    return build_table(advisories, details,
                       aux={"Red Hat CPE": sources["Red Hat CPE"]}
                       if "Red Hat CPE" in sources else None)


def normalize_scanners(spec: str) -> tuple:
    out = tuple(_SCANNER_ALIASES.get(s.strip(), s.strip())
                for s in spec.split(",") if s.strip())
    unknown = [s for s in out if s not in SUPPORTED_SCANNERS]
    if unknown:
        raise SystemExit(f"--scanners: not supported by this port: "
                         f"{','.join(unknown)}")
    return out


def launch_counts() -> dict:
    """Kernel launches in this process, by kernel."""
    from .ops.join import csr_join_compact_cuda, csr_join_cuda
    from .ops.shiftor import shiftor_cuda
    return {"shiftor": shiftor_cuda.launches,
            "csr_join": csr_join_cuda.launches,
            "csr_join_compact": csr_join_compact_cuda.launches}


def _scan(args, make_artifact, cache, artifact_type: str,
          disabled: tuple, name: str = "") -> int:
    """The steps every command shares: the artifact's walk into the
    cache, the scan from the cache, filtering and the report.
    make_artifact(cache, group, scanners, device) → the artifact."""
    device = resolve_device(args.device)
    scanners = normalize_scanners(args.scanners)
    if "vuln" in scanners and not args.db:
        raise SystemExit("--db is required for vulnerability scanning "
                         "(a fixture YAML glob or a columnar .npz)")
    table = load_table(args.db) if "vuln" in scanners else build_table([])
    javadb.init(path=args.java_db)
    art = make_artifact(cache, AnalyzerGroup(disabled=disabled), scanners,
                        device)
    ref = art.inspect()
    if name:
        ref.name = name
    results, os_info = LocalScanner(cache, table, device).scan(
        ref.name, ref.id, ref.blob_ids,
        T.ScanOptions(scanners=scanners,
                      list_all_packages=args.list_all_pkgs,
                      include_dev_deps=args.include_dev_deps,
                      pkg_types=tuple(args.pkg_types.split(","))))
    report = build_report(
        ref.name, artifact_type, filter_results(results), os_info,
        metadata=ref.image_metadata,
        created_at=dt.datetime.now(dt.timezone.utc).isoformat())
    write_report(report, args.format, sys.stdout)
    if args.debug_launches:
        secrets = art.secret_scanner
        print(json.dumps({
            "launches": launch_counts(),
            "prefilter_path": dict(secrets.prefilter_path)
            if secrets is not None else {}}), file=sys.stderr)
    return 0


def cmd_image(args) -> int:
    if not args.input:
        raise SystemExit("--input <archive> is required: this port scans "
                         "archives")

    def artifact(cache, group, scanners, device):
        from .secret import SecretScanner
        return ImageArchiveArtifact(
            args.input, cache, group=group, scanners=scanners,
            secret_scanner=SecretScanner(device=device)
            if "secret" in scanners else None,
            skip_files=args.skip_files, skip_dirs=args.skip_dirs)
    cache = open_cache("fs", args.cache_dir) if args.cache_dir \
        else open_cache("memory")
    # lockfile analyzers are off for image scans (run.go:167)
    return _scan(args, artifact, cache, T.ArtifactType.CONTAINER_IMAGE,
                 LOCKFILE_ANALYZERS, name=args.image_name)


def cmd_fs(args) -> int:
    """rootfs, fs and repo (a local path): one tree as one blob, with the
    analyzers the reference disables per command (run.go:167-224)."""
    if args.command == "rootfs":
        disabled = LOCKFILE_ANALYZERS
        artifact_type = T.ArtifactType.FILESYSTEM
    elif args.command == "repo":
        if not os.path.exists(args.target):
            raise SystemExit(f"{args.target}: no such path; remote "
                             f"repositories are not ported")
        disabled = INDIVIDUAL_PKG_ANALYZERS + OS_ANALYZERS
        artifact_type = T.ArtifactType.REPOSITORY
        args.pkg_types = "library"  # repo scans only language packages
    else:
        disabled = INDIVIDUAL_PKG_ANALYZERS
        artifact_type = T.ArtifactType.FILESYSTEM

    def artifact(cache, group, scanners, device):
        secrets, secret_cfg = _secret_scanner(args, scanners, device)
        return FilesystemArtifact(
            args.target, cache, group=group, scanners=scanners,
            secret_scanner=secrets, secret_config_path=secret_cfg,
            skip_files=_rel_globs(args.skip_files, args.target),
            skip_dirs=_rel_globs(args.skip_dirs, args.target))
    return _scan(args, artifact, MemoryCache(), artifact_type, disabled)


def _rel_globs(globs, root: str) -> tuple:
    """--skip-files/--skip-dirs take paths relative to the current
    directory or to the scan root; → root-relative globs. Only a path
    that exists inside the root is rewritten, so a root-relative glob
    given from a subdirectory survives."""
    out = []
    root_abs = os.path.abspath(root)
    for g in globs:
        g_abs = os.path.abspath(g)
        if g_abs.startswith(root_abs + os.sep) and os.path.exists(g_abs):
            g = os.path.relpath(g_abs, root_abs).replace(os.sep, "/")
        out.append(g)
    return tuple(out)


def _secret_scanner(args, scanners, device):
    """→ (SecretScanner or None, the walk-relative path of the rule
    file). Rules come from --secret-config when that file exists
    (reference pkg/fanal/secret/scanner.go ParseConfig); the file itself,
    compared by path and not by name (secret.go:137), is not scanned."""
    from .secret import SecretScanner
    from .secret.rules import load_secret_config
    if "secret" not in scanners:
        return None, DEFAULT_SECRET_CONFIG
    cfg = args.secret_config
    if not cfg:
        return SecretScanner(device=device), DEFAULT_SECRET_CONFIG
    rel = os.path.relpath(os.path.abspath(cfg), os.path.abspath(args.target))
    outside = rel == ".." or rel.startswith(".." + os.sep)
    walk_cfg = "" if outside else rel.replace(os.sep, "/")
    if not os.path.exists(cfg):
        return SecretScanner(device=device), walk_cfg
    rules, allow, exclude = load_secret_config(cfg)
    return SecretScanner(rules=rules, allow_rules=allow,
                         exclude_regexes=exclude, device=device), walk_cfg


def _common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--db", default="",
                   help="advisory DB: columnar .npz or fixture YAML glob")
    p.add_argument("--scanners", default="vuln",
                   help="comma-separated, of: vuln, secret")
    p.add_argument("--format", "-f", default="json", choices=["json"])
    p.add_argument("--list-all-pkgs", action="store_true",
                   help="list every package in the report, and keep "
                        "language-package results without findings")
    p.add_argument("--skip-files", action="append", default=[],
                   help="glob of files to leave out (repeatable)")
    p.add_argument("--skip-dirs", action="append", default=[],
                   help="glob of directories to leave out (repeatable)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no automatic "
                        "fallback to the CPU")
    p.add_argument("--debug-launches", action="store_true",
                   help="print the kernels' launch counts and the secret "
                        "prefilter paths as JSON on stderr")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="trivy_tpu_torch",
        description="Vulnerability (OS and language packages) and secret "
                    "scanning of image archives, root filesystems and "
                    "source trees, with the advisory join and the secret "
                    "prefilter on CUDA.")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser(
        "image", help="scan a docker-save or OCI-layout image archive")
    p.add_argument("image_name", nargs="?", default="",
                   help="name to report for the archive; an image name "
                        "alone is refused, since registry, daemon and "
                        "containerd sources are not ported")
    p.add_argument("--input", default="",
                   help="docker-save or OCI-layout tarball to scan")
    p.add_argument("--cache-dir", default="",
                   help="layer cache directory (FS cache); without it "
                        "the cache lives in memory for this scan only")
    _common_flags(p)
    p.set_defaults(func=cmd_image, include_dev_deps=False,
                   pkg_types="os,library", java_db="")
    for name, what in (("rootfs", "a root filesystem tree"),
                       ("fs", "a directory tree, with its lockfiles"),
                       ("repo", "a local repository checkout (language "
                                "packages only)")):
        p = sub.add_parser(name, help=f"scan {what}")
        p.add_argument("target")
        p.add_argument("--secret-config", default=DEFAULT_SECRET_CONFIG,
                       help="secret rules file; the file itself is never "
                            "scanned")
        p.add_argument("--include-dev-deps", action="store_true",
                       help="keep the dev dependencies of lockfiles")
        p.add_argument("--pkg-types", default="os,library",
                       help="comma-separated package types to detect, of: "
                            "os, library")
        p.add_argument("--java-db", default="",
                       help="a local trivy-java.db (jar sha1 → GAV); "
                            "without it jars are named by pom.properties "
                            "and file name")
        _common_flags(p)
        p.set_defaults(func=cmd_fs)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
