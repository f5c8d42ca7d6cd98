"""Command line: `python -m trivy_tpu_torch rootfs <dir> --db <spec>`.

Mirrors `python -m trivy_tpu.cli rootfs` for the scanners this port
covers (vuln on Alpine-family OS packages, secret): the JSON report is
the same byte for byte, apart from CreatedAt. Runs on CUDA unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import datetime as dt
import glob
import json
import os
import sys

from . import types as T
from .db import AdvisoryTable, build_table
from .db.fixtures import load_fixture_files
from .device import resolve_device
from .fanal.analyzers import AnalyzerGroup
from .fanal.walker import blob_info, walk_fs
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


def cmd_rootfs(args) -> int:
    from .secret import SecretScanner
    device = resolve_device(args.device)
    scanners = normalize_scanners(args.scanners)
    if "vuln" in scanners and not args.db:
        raise SystemExit("--db is required for vulnerability scanning "
                         "(a fixture YAML glob or a columnar .npz)")
    table = load_table(args.db) if "vuln" in scanners else build_table([])
    secrets = SecretScanner(device=device) if "secret" in scanners else None

    scan = walk_fs(args.target, AnalyzerGroup(),
                   collect_secrets=secrets is not None)
    blob = blob_info(scan)
    if secrets is not None and scan.secret_files:
        blob.secrets = secrets.scan_files(scan.secret_files)
    name = os.path.abspath(args.target).rstrip("/")
    results, os_info = LocalScanner(table, device).scan(
        name, blob, T.ScanOptions(scanners=scanners))
    report = build_report(
        name, T.ArtifactType.FILESYSTEM, filter_results(results), os_info,
        created_at=dt.datetime.now(dt.timezone.utc).isoformat())
    write_report(report, args.format, sys.stdout)
    if args.debug_launches:
        print(json.dumps({
            "launches": launch_counts(),
            "prefilter_path": dict(secrets.prefilter_path)
            if secrets is not None else {}}), file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="trivy_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("rootfs", help="scan a root filesystem tree")
    p.add_argument("target")
    p.add_argument("--db", default="",
                   help="advisory DB: columnar .npz or fixture YAML glob")
    p.add_argument("--scanners", default="vuln",
                   help="comma-separated: vuln,secret")
    p.add_argument("--format", "-f", default="json", choices=["json"])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no automatic "
                        "fallback to the CPU")
    p.add_argument("--debug-launches", action="store_true",
                   help="print the kernels' launch counts and the secret "
                        "prefilter paths as JSON on stderr")
    p.set_defaults(func=cmd_rootfs)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
