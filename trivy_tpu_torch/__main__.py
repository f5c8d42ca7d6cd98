"""Command line of the port:

    python -m trivy_tpu_torch image --input ARCHIVE [...]
    python -m trivy_tpu_torch rootfs DIR [...]
    python -m trivy_tpu_torch fs DIR [...]          (alias: filesystem)
    python -m trivy_tpu_torch repo DIR [...]        (alias: repository)
    python -m trivy_tpu_torch sbom FILE [...]
    python -m trivy_tpu_torch convert REPORT.json --format F [...]

Mirrors `python -m trivy_tpu.cli` for these commands and the scanners
`vuln`, `secret` and `license`: the same flags (`--severity`,
`--ignore-unfixed`, `--ignore-status`, `--ignorefile` or the working
directory's `.trivyignore.yaml`/`.trivyignore`, `--vex`, `--exit-code`,
`--output`, `--cache-dir`, `--db`, `--config`, ...), each also read from
a `TRIVY_*` env var and from `trivy.yaml` (flagcfg), and the same reports
in the json, table, sarif, template, github, cosign-vuln, cyclonedx and
spdx-json formats, byte for byte apart from CreatedAt.
`TRIVY_TPU_FAKE_NOW` fixes the clock of the detection (EOSL, Ubuntu ESM)
and of CreatedAt, and `TRIVY_TPU_FAKE_UUID` the serial numbers of SBOM
output, as in the reference.

`sbom` scans a CycloneDX JSON, SPDX JSON or tag-value document, bare or
in an in-toto attestation (DSSE envelope); a malformed or over-budget
document gives an "Ingest Degradations" result, not an error.
`--scanners license` reports the packages' declared licenses, and
`--license-full` also classifies license files.

`--db` takes a fixture YAML glob, a columnar `.npz` saved by either
package, or a `trivy.db` BoltDB file, flattened once into a `.npz` memo
beside it. Without `--db` the DB is pulled from `--db-repository` into
`<cache-dir>/db/` when the cached one will not do (`--skip-db-update`:
use the cached one as it is), then flattened.

`image` reads docker-save and OCI-layout archives (`--input`), or an
image by name from the sources of `--image-src` in order: the docker
and podman daemons' sockets, a containerd store, and a registry, whose
layers stream into the walk. Image layers walk through the ingest
pipeline (`--ingest-*` budgets; `--ingest-serial` walks them one by
one); a hostile layer becomes an "Ingest Degradations" result. Remote
repositories are not ported. Each command
disables the analyzers the reference disables for it (run.go:167-224):
image and rootfs the lockfiles, fs the installed packages, repo the
installed packages and the OS; fs and repo also the in-image `sbom`
analyzer. Runs on CUDA unless `--device cpu` is given; `--device` and
`--debug-launches` come from the command line only. Not ported, and
refused: `--ignore-policy` (rego, ROADMAP A4) and `--sbom-sources rekor`
(ROADMAP A5).
"""

from __future__ import annotations

import argparse
import datetime as dt
import glob
import json
import os
import sys
import tempfile
import time

from . import __version__, javadb
from . import types as T
from .db import AdvisoryTable, build_table
from .db.download import DEFAULT_REPO, DBError, ensure_db, flatten_db
from .db.fixtures import load_fixture_files
from .device import resolve_device
from .fanal.analyzers import (INDIVIDUAL_PKG_ANALYZERS, LOCKFILE_ANALYZERS,
                              OS_ANALYZERS, AnalyzerGroup)
from .fanal.artifact import FilesystemArtifact, ImageArchiveArtifact
from .fanal.cache import MemoryCache, open_cache
from .fanal.walker import DEFAULT_SECRET_CONFIG
from .flagcfg import apply_flag_sources, generate_default_config
from .report import build_report, write_report
from .report.writer import SBOM_FORMATS, render_json_report
from .result import FilterOptions, filter_results, parse_ignore_file
from .scanner import LocalScanner

_SCANNER_ALIASES = {"vulnerability": "vuln", "secrets": "secret",
                    "licenses": "license"}
SUPPORTED_SCANNERS = ("vuln", "secret", "license")
DEFAULT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                                 "trivy-tpu")
FORMATS = ["json", "table", "sarif", "cyclonedx", "spdx-json", "template",
           "github", "cosign-vuln"]


def load_table(spec: str, cache_dir: str = "", repository: str = "",
               skip_update: bool = False,
               stats: dict | None = None) -> AdvisoryTable:
    """--db: a columnar .npz saved by either package, a trivy.db (through
    its flatten memo), or a fixture YAML glob; with none, the DB of
    `<cache_dir>/db/`, pulled from `repository` when it will not do.
    `stats` (a dict) receives the download, flatten or load figures."""
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    if not spec:
        try:
            table, flat = ensure_db(cache_dir or ".",
                                    repository or DEFAULT_REPO,
                                    skip_update=skip_update)
        except DBError as e:
            raise SystemExit(
                f"DB unavailable: {e}\n"
                "(pass --db with a trivy.db file, columnar .npz, or "
                "fixture YAML glob when the registry is unreachable)") \
                from None
        stats.update(flat, source="db-repository", rows=len(table),
                     table_s=time.perf_counter() - t0)
        return table
    if spec.endswith(".db"):
        table, flat = flatten_db(spec)
        stats.update(flat)
    elif spec.endswith(".npz"):
        table = AdvisoryTable.load(spec)
    else:
        paths = sorted(glob.glob(spec)) or [spec]
        advisories, details, sources = load_fixture_files(paths)
        table = build_table(advisories, details,
                            aux={"Red Hat CPE": sources["Red Hat CPE"]}
                            if "Red Hat CPE" in sources else None)
    stats.update(source=spec, rows=len(table),
                 table_s=time.perf_counter() - t0)
    return table


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


def fake_now() -> dt.datetime | None:
    """The clock `TRIVY_TPU_FAKE_NOW` pins (ISO 8601), as the reference's
    test harness injects one (cli.py:668); None for the wall clock."""
    raw = os.environ.get("TRIVY_TPU_FAKE_NOW", "")
    return dt.datetime.fromisoformat(raw.replace("Z", "+00:00")) \
        if raw else None


def _refuse_unported(args) -> None:
    if "rekor" in getattr(args, "sbom_sources", ""):
        raise SystemExit("--sbom-sources rekor needs the Rekor client and "
                         "the executable analyzer, which are not ported "
                         "yet (ROADMAP A5)")
    if args.ignore_policy:
        raise SystemExit("--ignore-policy needs the rego interpreter, "
                         "which is not ported yet (ROADMAP A4)")


def _scan(args, make_artifact, cache_for, artifact_type: str,
          disabled: tuple, name: str = "") -> int:
    """The steps every scan command shares (reference
    _scan_common_inner, cli.py:648-719): the artifact's walk into the
    cache, the scan from the cache, VEX, the filters, the report and the
    exit code. make_artifact(cache, group, scanners, device) → the
    artifact; cache_for() → the cache, opened once the device is
    known. An empty artifact_type takes the artifact's own (sbom)."""
    t_scan = time.perf_counter()
    _refuse_unported(args)
    device = resolve_device(args.device)
    scanners = normalize_scanners(args.scanners)
    table_stats: dict = {}
    table = load_table(args.db, cache_dir=args.cache_dir,
                       repository=args.db_repository,
                       skip_update=args.skip_db_update,
                       stats=table_stats) \
        if "vuln" in scanners else build_table([])
    javadb.init(cache_dir=args.cache_dir, path=args.java_db)
    cache = cache_for()
    # license files are classified only under --license-full
    group = AnalyzerGroup(disabled=disabled, enabled=("license-file",)
                          if args.license_full else ())
    art = make_artifact(cache, group, scanners, device)
    t_inspect = time.perf_counter()
    ref = art.inspect()
    inspect_s = time.perf_counter() - t_inspect
    if name:
        ref.name = name
    now = fake_now()
    results, os_info = LocalScanner(cache, table, device).scan(
        ref.name, ref.id, ref.blob_ids,
        T.ScanOptions(scanners=scanners,
                      # SBOM output lists every package (reference
                      # run.go forces ListAllPkgs for SBOM formats)
                      list_all_packages=args.list_all_pkgs
                      or args.format in SBOM_FORMATS,
                      include_dev_deps=args.include_dev_deps,
                      pkg_types=tuple(args.pkg_types.split(","))),
        now=now)
    if args.vex:
        from .vex import apply_vex, load_vex_file
        apply_vex(results, load_vex_file(args.vex))
    results = filter_results(results, FilterOptions(
        severities=[s.strip().upper() for s in args.severity.split(",")],
        ignore_unfixed=args.ignore_unfixed,
        ignore_statuses=[s for s in args.ignore_status.split(",") if s],
        ignore_file=parse_ignore_file(args.ignorefile)
        if args.ignorefile else _auto_ignore_file()))
    report = build_report(
        ref.name, artifact_type or ref.type, results, os_info,
        metadata=ref.image_metadata,
        created_at=(now or dt.datetime.now(dt.timezone.utc)).isoformat())
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        write_report(report, args.format, out, template=args.template,
                     app_version=__version__)
    finally:
        if args.output:
            out.close()
    if args.debug_launches:
        # the table load's figures, the artifact's inspect (the walk, or
        # an SBOM's decode), the whole command after start-up and how the
        # layers walked, then the launch counts as the last line
        print(json.dumps({"table": table_stats, "inspect_s": inspect_s,
                          "scan_s": time.perf_counter() - t_scan,
                          "ingest": getattr(art, "ingest_figures", {})}),
              file=sys.stderr)
        secrets = getattr(art, "secret_scanner", None)
        print(json.dumps({
            "launches": launch_counts(),
            "prefilter_path": dict(secrets.prefilter_path)
            if secrets is not None else {}}), file=sys.stderr)
    if args.exit_code and any(r.vulnerabilities or r.secrets
                              or r.misconfigurations for r in results):
        return args.exit_code
    return 0


def _auto_ignore_file():
    """The working directory's ignore file, when --ignorefile is not
    given (reference cli.py:722)."""
    for cand in (".trivyignore.yaml", ".trivyignore"):
        if os.path.exists(cand):
            return parse_ignore_file(cand)
    return None


IMAGE_SOURCES = ("docker", "containerd", "podman", "remote")
_INGEST_FLAG_FIELDS = ("walkers", "analyzers", "max_file_bytes",
                       "max_layer_bytes", "max_members",
                       "layer_deadline_ms", "max_inflight_bytes",
                       "tenant_walker_share", "tenant_byte_share")


def _ingest_options(args):
    """The ingest pipeline's options from the --ingest-* flags, also
    installed as the process default (reference cli.py:770)."""
    from .fanal.pipeline import IngestOptions, set_default_ingest
    opts = IngestOptions(
        enabled=not args.ingest_serial,
        **{f: getattr(args, "ingest_" + f) for f in _INGEST_FLAG_FIELDS})
    set_default_ingest(opts)
    return opts


def _acquire_image(args) -> tuple:
    """An image name through the sources of --image-src, strictly in
    their order (reference image.go:42-56, cli.py:801-880) → (source,
    what its artifact needs, a temporary archive to remove or None)."""
    if not args.image_name:
        raise SystemExit("image name or --input <archive> required")
    sources = [s.strip() for s in args.image_src.split(",") if s.strip()]
    unknown = [s for s in sources if s not in IMAGE_SOURCES]
    if unknown or not sources:
        raise SystemExit(
            f"unknown --image-src {','.join(unknown or ['(empty)'])!r}"
            " (valid: docker, containerd, podman, remote)")
    errors = []
    for src in sources:
        if src == "containerd":
            from .fanal.containerd import ContainerdError, ContainerdStore
            store = ContainerdStore()
            try:
                if not store.available():
                    raise ContainerdError(
                        f"no containerd store at {store.root}")
                return src, (store, store.resolve(args.image_name)), None
            except ContainerdError as e:
                errors.append(f"containerd: {e}")
        elif src in ("docker", "podman"):
            from .fanal.daemon import DaemonError, save_from_any_daemon
            fd, tmp = tempfile.mkstemp(suffix=".tar")
            os.close(fd)
            try:
                save_from_any_daemon(args.image_name, tmp, sources=(src,))
                return src, tmp, tmp
            except DaemonError as e:
                errors.append(f"{src}: {e}")
                os.unlink(tmp)
        else:
            from .oci import OCIError, default_client, parse_ref
            try:
                # the client and manifest serve the artifact too (one
                # token handshake)
                client = default_client()
                return src, (client, client.manifest(
                    parse_ref(args.image_name),
                    args.platform or "linux/amd64")), None
            except OCIError as e:
                errors.append(f"remote: {e}")
    raise SystemExit("image acquisition failed: " + "; ".join(errors))


def cmd_image(args) -> int:
    """An image archive (--input), or an image by name from the first
    source of --image-src that has it."""
    from .oci import OCIError
    resolve_device(args.device)   # before any source is tried
    _refuse_unported(args)
    source, target, tmp = ("archive", args.input, None) if args.input \
        else _acquire_image(args)
    platform = args.platform or "linux/amd64"
    try:
        ingest = _ingest_options(args)

        def artifact(cache, group, scanners, device):
            secrets, secret_cfg = _secret_scanner(args, scanners, device)
            kw = dict(group=group, scanners=scanners,
                      secret_scanner=secrets, secret_config_path=secret_cfg,
                      skip_files=args.skip_files, skip_dirs=args.skip_dirs)
            if source == "remote":
                from .fanal.artifact import RegistryArtifact
                client, manifest = target
                return RegistryArtifact(
                    args.image_name, cache, platform=platform,
                    client=client, manifest=manifest, ingest=ingest, **kw)
            if source == "containerd":
                from .fanal.containerd import ContainerdArtifact
                store, resolved = target
                return ContainerdArtifact(
                    args.image_name, cache, platform=platform, store=store,
                    target=resolved, **kw)
            return ImageArchiveArtifact(target, cache, ingest=ingest, **kw)
        # lockfile analyzers are off for image scans (run.go:167)
        return _scan(args, artifact,
                     lambda: open_cache("fs", args.cache_dir),
                     T.ArtifactType.CONTAINER_IMAGE, LOCKFILE_ANALYZERS,
                     name=args.image_name)
    except OCIError as e:
        if source != "remote":
            raise
        raise SystemExit(f"image acquisition failed: remote: {e}") \
            from None
    finally:
        if tmp is not None:
            os.unlink(tmp)


def cmd_sbom(args) -> int:
    """An SBOM document as the artifact (reference cli.py:1129): no walk,
    an in-memory cache, and the report typed by the document's format."""
    from .sbom.artifact import SBOMArtifact

    def artifact(cache, group, scanners, device):
        with open(args.target, "rb") as f:
            return SBOMArtifact(f.read(), cache, name=args.target)
    return _scan(args, artifact, MemoryCache, "", ())


def cmd_fs(args) -> int:
    """rootfs, fs and repo (a local path): one tree as one blob, with the
    analyzers the reference disables per command (run.go:167-224)."""
    if args.command == "rootfs":
        disabled = LOCKFILE_ANALYZERS
        artifact_type = T.ArtifactType.FILESYSTEM
    elif args.command in ("repo", "repository"):
        if not os.path.exists(args.target):
            raise SystemExit(f"{args.target}: no such path; remote "
                             f"repositories are not ported")
        disabled = INDIVIDUAL_PKG_ANALYZERS + OS_ANALYZERS + ("sbom",)
        artifact_type = T.ArtifactType.REPOSITORY
        args.pkg_types = "library"  # repo scans only language packages
    else:
        disabled = INDIVIDUAL_PKG_ANALYZERS + ("sbom",)
        artifact_type = T.ArtifactType.FILESYSTEM

    def artifact(cache, group, scanners, device):
        secrets, secret_cfg = _secret_scanner(args, scanners, device,
                                              root=args.target)
        return FilesystemArtifact(
            args.target, cache, group=group, scanners=scanners,
            secret_scanner=secrets, secret_config_path=secret_cfg,
            skip_files=_rel_globs(args.skip_files, args.target),
            skip_dirs=_rel_globs(args.skip_dirs, args.target),
            # SPDX records each lockfile's sha1 (reference FileChecksum)
            file_checksum=args.format == "spdx-json")
    return _scan(args, artifact, MemoryCache, artifact_type, disabled)


def cmd_convert(args) -> int:
    """A saved JSON report in another format (reference cli.py:1137),
    with no table load and no scan."""
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        render_json_report(args.report, args.format, out,
                           template=args.template)
    finally:
        if args.output:
            out.close()
    return 0


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


def _secret_scanner(args, scanners, device, root: str = ""):
    """→ (SecretScanner or None, the walk-relative path of the rule
    file). Rules come from --secret-config when that file exists
    (reference pkg/fanal/secret/scanner.go ParseConfig); the file itself,
    compared by path and not by name (secret.go:137), is not scanned.
    With a root (fs, rootfs, repo) the path is made relative to it; an
    image's layers are matched against the path as given."""
    from .secret import SecretScanner
    from .secret.rules import load_secret_config
    if "secret" not in scanners:
        return None, DEFAULT_SECRET_CONFIG
    cfg = args.secret_config
    if not cfg:
        return SecretScanner(device=device), DEFAULT_SECRET_CONFIG
    walk_cfg = cfg
    if root:
        rel = os.path.relpath(os.path.abspath(cfg), os.path.abspath(root))
        outside = rel == ".." or rel.startswith(".." + os.sep)
        walk_cfg = "" if outside else rel.replace(os.sep, "/")
    if not os.path.exists(cfg):
        return SecretScanner(device=device), walk_cfg
    rules, allow, exclude = load_secret_config(cfg)
    return SecretScanner(rules=rules, allow_rules=allow,
                         exclude_regexes=exclude, device=device), walk_cfg


def _scan_flags(p: argparse.ArgumentParser) -> None:
    """The reference's scan flags (cli.py:25-99) that the port serves,
    with their defaults, and the port's own --device and
    --debug-launches."""
    p.add_argument("--config", "-c", default="",
                   help="trivy.yaml config file (flag > TRIVY_* env > "
                        "file > default)")
    p.add_argument("--scanners", "--security-checks", default="vuln",
                   help="comma-separated, of: vuln, secret, license")
    p.add_argument("--format", "-f", default="json", choices=FORMATS)
    p.add_argument("--template", "-t", default="",
                   help="output template ('...' inline or @path)")
    p.add_argument("--output", "-o", default="",
                   help="write the report to this file")
    p.add_argument("--severity", "-s", default=",".join(T.SEVERITIES))
    p.add_argument("--ignore-unfixed", action="store_true")
    p.add_argument("--ignore-status", default="",
                   help="comma-separated statuses to hide")
    p.add_argument("--ignorefile", default="",
                   help="ignore file; without it .trivyignore.yaml or "
                        ".trivyignore in the working directory")
    p.add_argument("--vex", default="",
                   help="OpenVEX, CycloneDX VEX or CSAF file")
    p.add_argument("--list-all-pkgs", action="store_true",
                   help="list every package in the report, and keep "
                        "language-package results without findings")
    p.add_argument("--include-dev-deps", action="store_true",
                   help="keep the dev dependencies of lockfiles")
    p.add_argument("--secret-config", default=DEFAULT_SECRET_CONFIG,
                   help="secret rules file; the file itself is never "
                        "scanned")
    p.add_argument("--license-full", action="store_true",
                   help="also classify license FILES by full text "
                        "(LICENSE/COPYING/NOTICE)")
    p.add_argument("--skip-files", action="append", default=[],
                   help="glob of files to leave out (repeatable)")
    p.add_argument("--skip-dirs", action="append", default=[],
                   help="glob of directories to leave out (repeatable)")
    p.add_argument("--exit-code", type=int, default=0,
                   help="exit with this code when findings survive the "
                        "filters")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                   help="the layer cache of image scans, the cached "
                        "db/trivy.db and javadb/trivy-java.db")
    p.add_argument("--db", default="",
                   help="advisory DB: a trivy.db (BoltDB) file, a "
                        "columnar .npz, or a fixture YAML glob; without "
                        "it <cache-dir>/db/trivy.db")
    p.add_argument("--db-repository", default=DEFAULT_REPO,
                   help="OCI repository the DB is pulled from when "
                        "--db is not given")
    p.add_argument("--skip-db-update", action="store_true",
                   help="use the cached DB without checking freshness")
    p.add_argument("--pkg-types", default="os,library",
                   help="comma-separated package types to detect, of: "
                        "os, library")
    p.add_argument("--ignore-policy", default="",
                   help="refused: a rego ignore policy needs the rego "
                        "interpreter, not ported yet")
    p.add_argument("--java-db", default="",
                   help="a local trivy-java.db (jar sha1 → GAV); "
                        "defaults to <cache-dir>/javadb/trivy-java.db "
                        "when present")
    # the ingest pipeline of image sources: budgets bind as the layer
    # tar streams; a trip gives an annotated partial result
    p.add_argument("--ingest-serial", action="store_true",
                   help="walk layers one by one through the serial "
                        "walker (equal results on well-formed input; no "
                        "budgets, no containment)")
    p.add_argument("--ingest-walkers", type=int, default=0,
                   help="concurrent per-layer walkers (0 = auto: one "
                        "per core, max 8)")
    p.add_argument("--ingest-analyzers", type=int, default=0,
                   help="analyzer pool width for batched dispatch "
                        "(0 = auto)")
    p.add_argument("--ingest-max-file-bytes", type=int, default=128 << 20,
                   help="per-file content cap; larger members are "
                        "skipped with an annotation (default 128MiB)")
    p.add_argument("--ingest-max-layer-bytes", type=int, default=2 << 30,
                   help="per-layer decompressed byte cap, enforced "
                        "mid-stream (default 2GiB)")
    p.add_argument("--ingest-max-members", type=int, default=200000,
                   help="per-layer tar member cap (default 200000)")
    p.add_argument("--ingest-layer-deadline-ms", type=float,
                   default=120000.0,
                   help="per-layer walk deadline; a wedged walk trips "
                        "the ingest walk breaker and the layer degrades "
                        "to an annotated partial (default 120000)")
    p.add_argument("--ingest-max-inflight-bytes", type=int,
                   default=256 << 20,
                   help="pipeline-wide cap on file content in the "
                        "analysis window (default 256MiB)")
    p.add_argument("--ingest-tenant-walker-share", type=float, default=1.0,
                   help="largest share of the walker pool one tenant may "
                        "hold (1.0 = off); untenanted work, every CLI "
                        "scan, is exempt")
    p.add_argument("--ingest-tenant-byte-share", type=float, default=1.0,
                   help="largest share of the in-flight byte window one "
                        "tenant may hold (1.0 = off)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no automatic "
                        "fallback to the CPU, and no env or config key")
    p.add_argument("--debug-launches", action="store_true",
                   help="print the table load's figures and the "
                        "inspect and scan times, then the kernels' launch "
                        "counts and the secret prefilter paths, as JSON "
                        "lines on stderr")


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False everywhere: flagcfg tells explicit flags by
    # exact match, so prefix abbreviations must not parse
    ap = argparse.ArgumentParser(
        prog="trivy_tpu_torch", allow_abbrev=False,
        description="Vulnerability (OS and language packages), secret "
                    "and license scanning of image archives, root "
                    "filesystems, source trees and SBOMs, with the "
                    "advisory join and the secret prefilter on CUDA.")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser(
        "image", help="scan a container image by name, or an archive")
    p.add_argument("image_name", nargs="?", default="",
                   help="the image (from the sources of --image-src), or "
                        "the name to report for --input")
    p.add_argument("--input", default="",
                   help="docker-save or OCI-layout tarball to scan")
    p.add_argument("--platform", default="",
                   help="os/arch for registry pulls (default linux/amd64)")
    p.add_argument("--image-src", default=",".join(IMAGE_SOURCES),
                   help="image source fallback order "
                        "(docker,containerd,podman,remote)")
    p.add_argument("--sbom-sources", default="",
                   help="refused: external SBOM sources (rekor) are not "
                        "ported yet")
    _scan_flags(p)
    p.set_defaults(func=cmd_image)
    for name, aliases, what in (
            ("filesystem", ["fs"], "a directory tree, with its lockfiles"),
            ("rootfs", [], "a root filesystem tree"),
            ("repository", ["repo"], "a local repository checkout "
                                     "(language packages only)")):
        p = sub.add_parser(name, aliases=aliases, help=f"scan {what}")
        p.add_argument("target")
        _scan_flags(p)
        p.set_defaults(func=cmd_fs)
    p = sub.add_parser("sbom", help="scan an SBOM (CycloneDX or SPDX, bare "
                                    "or in an in-toto attestation)")
    p.add_argument("target")
    _scan_flags(p)
    p.set_defaults(func=cmd_sbom)
    p = sub.add_parser("convert", help="re-render a saved JSON report")
    p.add_argument("report")
    p.add_argument("--format", "-f", default="table",
                   choices=["json", "table", "sarif", "template", "github",
                            "cosign-vuln"])
    p.add_argument("--template", "-t", default="")
    p.add_argument("--output", "-o", default="")
    p.set_defaults(func=cmd_convert)
    for sp in sub.choices.values():
        sp.allow_abbrev = False
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    parser = build_parser()
    if argv and argv[0] == "--generate-default-config":
        print(generate_default_config(parser))
        return 0
    args = parser.parse_args(argv)
    # flag > TRIVY_* env > trivy.yaml > default (reference pkg/flag)
    args = apply_flag_sources(args, parser, argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
