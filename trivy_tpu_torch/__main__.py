"""Command line of the port:

    python -m trivy_tpu_torch image --input ARCHIVE --db SPEC [...]
    python -m trivy_tpu_torch rootfs DIR --db SPEC [...]

Mirrors `python -m trivy_tpu.cli image --input` and `rootfs` for the
scanners `vuln` and `secret`, with the JSON format: the report is the
same byte for byte, apart from CreatedAt, on every target whose contents
the ported analyzers cover. `image` reads docker-save and OCI-layout
archives (plain or gzip layers, whiteouts, opaque dirs); the analyzers
cover OS releases of every family the detector knows (Alpine, Debian,
Ubuntu, the rpm families, Red Hat/CentOS with their build info), the
apk, dpkg and rpm package databases, and installed Python packages.
Registry, daemon and containerd image sources are not ported. Runs on
CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import datetime as dt
import glob
import json
import sys

from . import types as T
from .db import AdvisoryTable, build_table
from .db.fixtures import load_fixture_files
from .device import resolve_device
from .fanal.analyzers import LOCKFILE_ANALYZERS, AnalyzerGroup
from .fanal.artifact import FilesystemArtifact, ImageArchiveArtifact
from .fanal.cache import MemoryCache, open_cache
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
          name: str = "") -> int:
    """The steps both commands share: the artifact's walk into the
    cache, the scan from the cache, filtering and the report."""
    from .secret import SecretScanner
    device = resolve_device(args.device)
    scanners = normalize_scanners(args.scanners)
    if "vuln" in scanners and not args.db:
        raise SystemExit("--db is required for vulnerability scanning "
                         "(a fixture YAML glob or a columnar .npz)")
    table = load_table(args.db) if "vuln" in scanners else build_table([])
    secrets = SecretScanner(device=device) if "secret" in scanners else None
    # lockfile analyzers are off for image and rootfs scans (run.go:167)
    ref = make_artifact(cache, AnalyzerGroup(disabled=LOCKFILE_ANALYZERS),
                        scanners, secrets).inspect()
    if name:
        ref.name = name
    results, os_info = LocalScanner(cache, table, device).scan(
        ref.name, ref.id, ref.blob_ids,
        T.ScanOptions(scanners=scanners,
                      list_all_packages=args.list_all_pkgs))
    report = build_report(
        ref.name, artifact_type, filter_results(results), os_info,
        metadata=ref.image_metadata,
        created_at=dt.datetime.now(dt.timezone.utc).isoformat())
    write_report(report, args.format, sys.stdout)
    if args.debug_launches:
        print(json.dumps({
            "launches": launch_counts(),
            "prefilter_path": dict(secrets.prefilter_path)
            if secrets is not None else {}}), file=sys.stderr)
    return 0


def cmd_image(args) -> int:
    if not args.input:
        raise SystemExit("--input <archive> is required: this port scans "
                         "archives")

    def artifact(cache, group, scanners, secrets):
        return ImageArchiveArtifact(
            args.input, cache, group=group, scanners=scanners,
            secret_scanner=secrets, skip_files=args.skip_files,
            skip_dirs=args.skip_dirs)
    cache = open_cache("fs", args.cache_dir) if args.cache_dir \
        else open_cache("memory")
    return _scan(args, artifact, cache, T.ArtifactType.CONTAINER_IMAGE,
                 name=args.image_name)


def cmd_rootfs(args) -> int:
    def artifact(cache, group, scanners, secrets):
        return FilesystemArtifact(args.target, cache, group=group,
                                  scanners=scanners, secret_scanner=secrets)
    return _scan(args, artifact, MemoryCache(), T.ArtifactType.FILESYSTEM)


def _common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--db", default="",
                   help="advisory DB: columnar .npz or fixture YAML glob")
    p.add_argument("--scanners", default="vuln",
                   help="comma-separated, of: vuln, secret")
    p.add_argument("--format", "-f", default="json", choices=["json"])
    p.add_argument("--list-all-pkgs", action="store_true",
                   help="list every package in the report, and keep "
                        "language-package results without findings")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no automatic "
                        "fallback to the CPU")
    p.add_argument("--debug-launches", action="store_true",
                   help="print the kernels' launch counts and the secret "
                        "prefilter paths as JSON on stderr")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="trivy_tpu_torch",
        description="Vulnerability (OS and Python packages) and secret "
                    "scanning of image archives and root filesystems, "
                    "with the advisory join and the secret prefilter "
                    "on CUDA.")
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
    p.add_argument("--skip-files", action="append", default=[],
                   help="glob of files to leave out (repeatable)")
    p.add_argument("--skip-dirs", action="append", default=[],
                   help="glob of directories to leave out (repeatable)")
    _common_flags(p)
    p.set_defaults(func=cmd_image)
    p = sub.add_parser("rootfs", help="scan a root filesystem tree")
    p.add_argument("target")
    _common_flags(p)
    p.set_defaults(func=cmd_rootfs)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
