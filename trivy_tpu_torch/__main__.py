"""Command line of the port:

    python -m trivy_tpu_torch image --input ARCHIVE [...]
    python -m trivy_tpu_torch rootfs DIR [...]
    python -m trivy_tpu_torch fs DIR [...]          (alias: filesystem)
    python -m trivy_tpu_torch repo DIR|URL [...]    (alias: repository)
    python -m trivy_tpu_torch vm DISK|ebs:SNAPSHOT [...]
    python -m trivy_tpu_torch sbom FILE [...]
    python -m trivy_tpu_torch convert REPORT.json --format F [...]
    python -m trivy_tpu_torch server --listen HOST:PORT --db DB [...]
    python -m trivy_tpu_torch version               (or --version)

Mirrors `python -m trivy_tpu.cli` for these commands and the scanners
`vuln`, `secret`, `license` and `misconfig` (aliases `config`,
`misconfiguration`): the same flags (`--severity`,
`--ignore-unfixed`, `--ignore-status`, `--ignorefile` or the working
directory's `.trivyignore.yaml`/`.trivyignore`, `--vex`, `--exit-code`,
`--output`, `--cache-dir`, `--db`, `--config`, ...), each also read from
a `TRIVY_*` env var and from `trivy.yaml` (flagcfg), and the same reports
in the json, table, sarif, template, github, cosign-vuln, cyclonedx and
spdx-json formats, byte for byte apart from CreatedAt.
`TRIVY_TPU_FAKE_NOW` fixes the clock of the detection (EOSL, Ubuntu ESM)
and of CreatedAt, and `TRIVY_TPU_FAKE_UUID` the serial numbers of SBOM
output, as in the reference.

`--scanners misconfig` scans Dockerfiles, Kubernetes manifests and Helm
charts (directories and packaged .tgz; `--helm-set`, `--helm-values`)
with the built-in checks, and any YAML, JSON or TOML file with user rego
checks (`--config-check`, `--config-data`, `--check-namespaces`, the
rule and namespace exceptions; `--rego-trace`); `--file-patterns
type:regex` routes more files to an analyzer; `--ignore-policy` takes a
rego file whose `ignore` rule drops findings; `--compliance SPEC`
(`--report summary|all`) writes the spec's control report instead of
the scan report. CloudFormation templates, Terraform modules (with
their tfvars), Terraform plan JSON and Azure ARM templates are scanned
with the AWS, Google, Azure and other provider checks. Each scan carries
its misconfig settings (misconf.MisconfSettings) on its own analyzer
group and options, so scans in one process do not share them.

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
one); a hostile layer becomes an "Ingest Degradations" result.
`repo` takes a local checkout, or a URL that it clones with the host's
`git` (`--branch`, `--tag`, `--commit`) and scans as a checkout named by
the URL. `vm` reads a raw disk image (a bare ext4 filesystem, or one
behind an MBR or GPT partition table), a monolithic-sparse VMDK, or an
EBS snapshot (`ebs:snap-…`, over the EBS direct APIs) without mounting
it. `--parallel N` reads the files of an fs, rootfs or repo tree with N
threads; the report does not depend on N. Each command disables the
analyzers the reference disables for it (run.go:167-252): image, rootfs
and vm the lockfiles, fs the installed packages, repo the installed
packages and the OS; fs, repo and vm also the in-image `sbom`
analyzer. Runs on CUDA unless `--device cpu` is given; `--device` and
`--debug-launches` come from the command line only.

`image --cache-backend` keeps the layer cache in `fs` (default, under
`--cache-dir`), `memory`, a shared Redis (`redis://[:pw@]host:port[/db]`)
or a shared S3 bucket (`s3://bucket[/prefix]?region=..[&endpoint=..]`,
sigv4-signed with the AWS_* credentials), with the JAX package's keys,
so either package reads the other's entries; the other scan commands
take the flag and keep their in-memory cache, as the reference's do.
`image --sbom-sources rekor [--rekor-url URL]` first asks Rekor for an
SBOM attestation of the image's digest and scans that SBOM in place of
the image; without one it analyzes the image, and asks Rekor for an
SBOM of each unpackaged ELF, Mach-O or PE binary (the opt-in
`executable` analyzer and the unpackaged post-handler), adding the
SBOM's first application under the binary's path. A Rekor failure is
logged, and the scan goes on without it, as in the reference.

`--trace FILE` writes a Chrome trace-event JSON of the scan's spans
(walk, analyzers, secret prefilter and confirm, query building, the
detect phases, result assembly; open it in Perfetto), and
`--profile-dir DIR` a torch.profiler capture of the scan (trace.json
and a trivy-tpu-profile/1 manifest.json with the kernels seen and the
card's busy ms); neither changes the report.

`server` serves the Twirp scan and cache routes of the JAX package's
server (server/listen.py) with the table on the card and detectd merging
concurrent scans' launches; clients analyze on their side and send
blobs (server/client.py). SIGTERM or SIGINT drains it. It serves the
JAX server's observability surface: `/metrics`, the token-gated
`/debug/traces`, `/debug/incidents`, `/debug/perf`, `/debug/profile`
and `/debug/costs` pages, and the `--trace`, `--incident-dir`,
`--slow-trace-ms`, `--slo-latency-ms`, `--profile-auto-burn`,
`--profile-cooldown-s` and `--ingest-tenant-*` flags, and the
detection-result memo with its post-swap sweep (`--memo-backend off|fs|
memory|redis://...|s3://...`, `--redetect-concurrency N`), its layer
cache in any backend of `--cache-backend`, and the streamed advisory
table (`--table-stream-slices N`, `--table-device-budget-mb MB`,
`--[no-]stream-prefetch`): a table over the budget never lives whole on
the card but streams through a double-buffered pair of resident slices
(parallel/stream.py), and multi-device detection (`--mesh-devices N`,
`--mesh-db-shards S`): the join sharded over a dp×db mesh of the
server's device type, one kernel launch per cell (parallel/mesh.py).
The JAX server's meshguard, breaker and failpoint flags are refused
with their reason (SERVER_REFUSED).

`router` (fleet/router.py) runs the scan router in front of N `server`
replicas (`--replica URL`, repeatable): a consistent-hash ring over the
artifacts, one fault domain per replica with /healthz readmission, and
the router's /healthz, /version, /metrics and token-gated /debug pages;
`--trace FILE` writes the fleet's assembled trace at shutdown. It loads
no table and takes no `--device`; its replicas run on the card unless
given `--device cpu`. Its `--failpoint` is refused as the server's is.
"""

from __future__ import annotations

import argparse
import contextlib
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
from .misconf import MisconfSettings
from .report import build_report, write_report
from .report.writer import SBOM_FORMATS, render_json_report
from .result import FilterOptions, filter_results, parse_ignore_file
from .scanner import LocalScanner

_SCANNER_ALIASES = {"vulnerability": "vuln", "misconfiguration": "misconfig",
                    "config": "misconfig", "secrets": "secret",
                    "licenses": "license"}
SUPPORTED_SCANNERS = ("vuln", "secret", "license", "misconfig")
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


def _misconf_settings(args):
    """The scan's user rego checks, helm value overrides and rego trace
    sink from its flags (reference cli.py:735-760)."""
    from .iac.helm import HelmRenderError
    from .misconf import MisconfSettings

    def sink(event, rule_path, depth):
        print(f"TRACE {'  ' * depth}{event} {rule_path}", file=sys.stderr)
    try:
        return MisconfSettings.from_flags(
            args.config_check, data_paths=args.config_data,
            namespaces=[s.strip() for s in args.check_namespaces.split(",")
                        if s.strip()],
            helm_sets=args.helm_set, helm_values_files=args.helm_values,
            trace=sink if args.rego_trace else None)
    except HelmRenderError as e:
        raise SystemExit(str(e)) from None


def _scan(args, *rest, **kw) -> int:
    """_scan_inner under `--trace` (every span of the command, the walk
    included, recorded and written to the file at the end) and
    `--profile-dir` (a torch.profiler capture of the scan, through the
    profiler's one-at-a-time exclusivity, reference cli.py:636-643)."""
    with contextlib.ExitStack() as stack:
        if args.trace:
            from .obs import COLLECTOR, write_chrome_trace

            def write_trace():
                COLLECTOR.disable()
                write_chrome_trace(args.trace)
                print(f"graftscope trace written to {args.trace}",
                      file=sys.stderr)
            COLLECTOR.enable()
            stack.callback(write_trace)
        if args.profile_dir:
            from .obs.perf import PROF
            stack.enter_context(PROF.capture_dir(
                args.profile_dir, device=resolve_device(args.device).type))
        return _scan_inner(args, *rest, **kw)


def _scan_inner(args, make_artifact, cache_for, artifact_type: str,
                disabled: tuple, name: str = "", misconf=None) -> int:
    """The steps every scan command shares (reference
    _scan_common_inner, cli.py:648-719): the artifact's walk into the
    cache, the scan from the cache, VEX, the filters, the report and the
    exit code. make_artifact(cache, group, scanners, device) → the
    artifact; cache_for() → the cache, opened once the device is
    known. An empty artifact_type takes the artifact's own (sbom).
    misconf: the scan's MisconfSettings (none for sbom)."""
    from .fanal.handlers import configure_post_handlers
    t_scan = time.perf_counter()
    device = resolve_device(args.device)
    scanners = normalize_scanners(args.scanners)
    if misconf is None:
        misconf = MisconfSettings()
    # license files are classified only under --license-full; binaries
    # are digested, and their SBOMs asked of Rekor, only under
    # --sbom-sources rekor (reference run.go:464-523)
    enabled = ("license-file",) if args.license_full else ()
    rekor = _rekor_url(args)
    if rekor:
        enabled += ("executable",)
    configure_post_handlers(rekor_url=rekor)
    try:
        group = AnalyzerGroup(
            disabled=disabled, enabled=enabled,
            file_patterns=tuple(args.file_patterns), misconf=misconf)
    except ValueError as e:  # a bad "type:regex"
        raise SystemExit(f"--file-patterns: {e}") from None
    table_stats: dict = {}
    table = load_table(args.db, cache_dir=args.cache_dir,
                       repository=args.db_repository,
                       skip_update=args.skip_db_update,
                       stats=table_stats) \
        if "vuln" in scanners else build_table([])
    javadb.init(cache_dir=args.cache_dir, path=args.java_db)
    cache = cache_for()
    art = make_artifact(cache, group, scanners, device)
    t_inspect = time.perf_counter()
    ref = art.inspect()
    inspect_s = time.perf_counter() - t_inspect
    if name:
        ref.name = name
    now = fake_now()
    options = T.ScanOptions(scanners=scanners,
                            # SBOM output lists every package (reference
                            # run.go forces ListAllPkgs for SBOM formats)
                            list_all_packages=args.list_all_pkgs
                            or args.format in SBOM_FORMATS,
                            include_dev_deps=args.include_dev_deps,
                            pkg_types=tuple(args.pkg_types.split(",")))
    results, os_info = LocalScanner(cache, table, device).scan(
        ref.name, ref.id, ref.blob_ids, options, now=now)
    if args.vex:
        from .vex import apply_vex, load_vex_file
        apply_vex(results, load_vex_file(args.vex))
    results = filter_results(results, FilterOptions(
        severities=[s.strip().upper() for s in args.severity.split(",")],
        ignore_unfixed=args.ignore_unfixed,
        ignore_statuses=[s for s in args.ignore_status.split(",") if s],
        ignore_file=parse_ignore_file(args.ignorefile)
        if args.ignorefile else _auto_ignore_file(),
        policy_file=args.ignore_policy,
        policy_trace=misconf.trace))
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.compliance:
            _write_compliance(args, results, out)
        else:
            report = build_report(
                ref.name, artifact_type or ref.type, results, os_info,
                metadata=ref.image_metadata,
                created_at=(now or dt.datetime.now(dt.timezone.utc)
                            ).isoformat())
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


def _write_compliance(args, results, out) -> None:
    """--compliance SPEC: the spec's control report in place of the scan
    report, as a summary table or JSON (--report all is JSON too)."""
    from .compliance import build_compliance_report, get_spec, \
        write_compliance
    if args.format not in ("json", "table"):
        raise SystemExit(f"--compliance supports --format json/table, "
                         f"not {args.format}")
    write_compliance(
        build_compliance_report(get_spec(args.compliance), results),
        mode=args.report, fmt=args.format, output=out)


def _rekor_url(args) -> str:
    """The Rekor server to ask, under `--sbom-sources rekor` (image
    only), else ""."""
    if "rekor" in getattr(args, "sbom_sources", ""):
        return args.rekor_url
    return ""


class _RemoteSBOMArtifact:
    """An image artifact behind the remote-SBOM shortcut (reference
    remote_sbom.go:92, cli.py:924-940): inspect() asks Rekor for an SBOM
    attestation of the image's digest and, when there is one, scans that
    SBOM in place of the image; otherwise, or when Rekor fails (logged),
    it inspects the image. Every other attribute is the image
    artifact's."""

    def __init__(self, art, cache, rekor_url: str, name: str):
        self.art, self.cache = art, cache
        self.rekor_url, self.name = rekor_url, name

    def __getattr__(self, attr):
        return getattr(self.art, attr)

    def inspect(self):
        from .log import logger
        from .rekor import RekorError, fetch_sbom_statement
        from .sbom.io import decode_sbom_doc
        try:
            st = fetch_sbom_statement(self.rekor_url,
                                      self.art.image_digest())
            if st is not None:
                doc = st.sbom_document()
                if isinstance(doc, dict):
                    return decode_sbom_doc(doc, self.cache, name=self.name)
        except (RekorError, ValueError) as e:
            logger.warning("rekor SBOM lookup failed, falling back to "
                           "analysis: %s", e)
        return self.art.inspect()


def _check_cache_backend(backend: str) -> None:
    """Exit on a --cache-backend spelling open_cache does not take, in
    the JAX CLI's words, before the (slow) table load."""
    from .fanal.cache import known_backend
    if not known_backend(backend):
        raise SystemExit(f"--cache-backend: unknown cache backend "
                         f"{backend!r} (fs | memory | redis://... | "
                         f"s3://...)")


def _cache_for(args):
    """→ the opener of the scan's layer cache from --cache-backend
    (reference initCache, run.go:344; cli.py:789)."""
    _check_cache_backend(args.cache_backend)
    return lambda: open_cache(args.cache_backend, args.cache_dir)


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
    misconf = _misconf_settings(args)
    cache_for = _cache_for(args)
    source, target, tmp = ("archive", args.input, None) if args.input \
        else _acquire_image(args)
    platform = args.platform or "linux/amd64"
    rekor = _rekor_url(args)
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
                art = RegistryArtifact(
                    args.image_name, cache, platform=platform,
                    client=client, manifest=manifest, ingest=ingest, **kw)
            elif source == "containerd":
                from .fanal.containerd import ContainerdArtifact
                store, resolved = target
                art = ContainerdArtifact(
                    args.image_name, cache, platform=platform, store=store,
                    target=resolved, **kw)
            else:
                art = ImageArchiveArtifact(target, cache, ingest=ingest,
                                           **kw)
            if rekor:
                return _RemoteSBOMArtifact(art, cache, rekor, args.input)
            return art
        # lockfile analyzers are off for image scans (run.go:167); a
        # remote SBOM's report keeps the SBOM's artifact type
        return _scan(args, artifact, cache_for,
                     "" if rekor else T.ArtifactType.CONTAINER_IMAGE,
                     LOCKFILE_ANALYZERS, name=args.image_name,
                     misconf=misconf)
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
    misconf = _misconf_settings(args)
    if args.command == "rootfs":
        disabled = LOCKFILE_ANALYZERS
        artifact_type = T.ArtifactType.FILESYSTEM
    elif args.command in ("repo", "repository"):
        disabled = INDIVIDUAL_PKG_ANALYZERS + OS_ANALYZERS + ("sbom",)
        artifact_type = T.ArtifactType.REPOSITORY
        args.pkg_types = "library"  # repo scans only language packages
    else:
        disabled = INDIVIDUAL_PKG_ANALYZERS + ("sbom",)
        artifact_type = T.ArtifactType.FILESYSTEM

    target, name, cleanup = args.target, "", None
    if args.command in ("repo", "repository"):
        target, name, cleanup = _repo_checkout(args)

    def artifact(cache, group, scanners, device):
        secrets, secret_cfg = _secret_scanner(args, scanners, device,
                                              root=target)
        return FilesystemArtifact(
            target, cache, group=group, scanners=scanners,
            secret_scanner=secrets, secret_config_path=secret_cfg,
            skip_files=_rel_globs(args.skip_files, target),
            skip_dirs=_rel_globs(args.skip_dirs, target),
            # SPDX records each lockfile's sha1 (reference FileChecksum)
            file_checksum=args.format == "spdx-json",
            parallel=args.parallel)
    try:
        return _scan(args, artifact, MemoryCache, artifact_type, disabled,
                     name=name, misconf=misconf)
    finally:
        if cleanup is not None:
            cleanup()


def _repo_checkout(args) -> tuple:
    """`repo`'s target (reference cli.py:987-1012, git.go
    tryRemoteRepo): a local path as it is, or a URL cloned into a
    temporary checkout → (the tree to scan, the name to report or "",
    the clone's cleanup or None)."""
    from .fanal.gitrepo import GitError, clone_repo, looks_like_url
    refs = (args.branch, args.tag, args.commit)
    if os.path.exists(args.target):
        if any(refs):
            raise SystemExit(
                "--branch/--tag/--commit apply to remote repository URLs, "
                "not local paths (check out the ref locally instead)")
        return args.target, "", None
    if not looks_like_url(args.target):
        raise SystemExit(f"no such path: {args.target}")
    resolve_device(args.device)   # before the clone
    try:
        checkout, cleanup = clone_repo(args.target, branch=args.branch,
                                       tag=args.tag, commit=args.commit)
    except GitError as e:
        raise SystemExit(str(e)) from None
    return checkout, args.target, cleanup


def cmd_vm(args) -> int:
    """A VM disk image or EBS snapshot as one blob (reference cli.py:1105,
    run.go:252 ScanVM): the lockfile and `sbom` analyzers off, an
    in-memory cache."""
    from .fanal.artifact import VMArtifact
    misconf = _misconf_settings(args)

    def artifact(cache, group, scanners, device):
        secrets, secret_cfg = _secret_scanner(args, scanners, device)
        return VMArtifact(args.target, cache, group=group,
                          scanners=scanners, secret_scanner=secrets,
                          secret_config_path=secret_cfg)
    return _scan(args, artifact, MemoryCache, T.ArtifactType.VM,
                 LOCKFILE_ANALYZERS + ("sbom",), misconf=misconf)


def cmd_version(args) -> int:
    """`version` (reference cli.py:1544), as `--version` prints it."""
    print(f"trivy-tpu {__version__}")
    return 0


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


_MESHGUARD = ("the port has no meshguard: a mesh keeps every device it "
              "was built with, and a failed cell launch fails the "
              "requests it carried (ROADMAP A, not ported by the north "
              "star)")
_GUARD = ("the port has no breaker, watchdog or failpoints: a failed "
          "launch or fetch fails the requests it carried (ROADMAP A, "
          "not ported by the north star)")
_NO_FAILPOINTS = ("the port has no failpoints, and the router no "
                  "rpc.route site (ROADMAP A, not ported by the north "
                  "star)")
# the JAX server's flags that the port refuses, and why
SERVER_REFUSED = {
    "mesh_min_devices": _MESHGUARD, "mesh_rebuild_cooldown_ms": _MESHGUARD,
    "mesh_probe_timeout_ms": _MESHGUARD, "mesh_hosts": _MESHGUARD,
    "mesh_host_loss_window_ms": _MESHGUARD,
    "failpoint": _GUARD, "breaker_fail_threshold": _GUARD,
    "breaker_reset_ms": _GUARD, "detect_dispatch_timeout_ms": _GUARD,
}


def _refuse_server_flags(args) -> None:
    """Exit naming the ROADMAP item of each refused flag given (on the
    command line, in TRIVY_* env or in trivy.yaml)."""
    given = [d for d in SERVER_REFUSED if getattr(args, d, None)
             is not None]
    if given:
        raise SystemExit("server: " + "; ".join(
            f"--{d.replace('_', '-')}: {SERVER_REFUSED[d]}"
            for d in given))
    # the backends' spellings, before the (slow) table load
    from .fleet.memo import known_backend
    _check_cache_backend(args.cache_backend)
    memo = args.memo_backend
    if not known_backend(memo):
        raise SystemExit(f"--memo-backend: unknown memo backend "
                         f"{memo!r} (off | fs | memory | redis://... | "
                         f"s3://...)")


def cmd_server(args) -> int:
    """The scan server (reference cli.py:1153): the table on the card,
    detectd merging concurrent scans' launches, until SIGTERM or SIGINT
    drains it. A multi-process job (TRIVY_TPU_DIST_*) is joined first,
    as in the reference."""
    from .detect.redetect import RedetectOptions
    from .detect.sched import SchedOptions
    from .parallel.multihost import maybe_init_distributed, process_info
    from .parallel.stream import StreamOptions
    from .resilience import AdmissionOptions
    from .server.listen import LaunchRecord, MeshOptions, serve
    if maybe_init_distributed(device=args.device):
        from .log import logger
        rank, world = process_info()
        logger.info("joined multi-host job: process %d/%d", rank, world)
    _refuse_server_flags(args)
    device = resolve_device(args.device)
    _configure_watch(args)
    # the ingest defaults (the tenant shares) for walks run in the
    # server's requests
    from .fanal.pipeline import IngestOptions, set_default_ingest
    set_default_ingest(IngestOptions(
        tenant_walker_share=args.ingest_tenant_walker_share,
        tenant_byte_share=args.ingest_tenant_byte_share))
    table = load_table(args.db, cache_dir=args.cache_dir,
                       repository=args.db_repository,
                       skip_update=args.skip_db_update)
    host, _, port = args.listen.rpartition(":")
    record = LaunchRecord() if args.debug_launches else None
    state = serve(
        host or "0.0.0.0", int(port), table, cache_dir=args.cache_dir,
        token=args.token, cache_backend=args.cache_backend,
        detect_opts=SchedOptions(
            coalesce_wait_ms=args.detect_coalesce_wait_ms,
            max_pairs_in_flight=args.detect_max_inflight_pairs,
            warmup=args.detect_warmup, dedup=args.detect_dedup,
            prefetch=args.stream_prefetch,
            tenant_max_share=args.detect_tenant_max_share),
        admission=AdmissionOptions(
            max_active=args.admit_max_active,
            max_queue=args.admit_max_queue,
            queue_timeout_ms=args.admit_queue_ms,
            tenant_max_active=args.admit_tenant_max_active,
            tenant_max_queue=args.admit_tenant_max_queue,
            tenant_rate=args.admit_tenant_rate),
        drain_grace_s=args.drain_grace_ms / 1e3, device=device,
        launch_record=record, trace_path=args.trace,
        memo_backend=args.memo_backend,
        redetect_opts=RedetectOptions(
            concurrency=max(args.redetect_concurrency, 0)),
        stream_opts=StreamOptions(
            device_budget_mb=args.table_device_budget_mb,
            slices=args.table_stream_slices),
        mesh_opts=MeshOptions(devices=args.mesh_devices,
                              db_shards=args.mesh_db_shards))
    if record is not None:
        # after the drain: the launches by kernel (the dense and the
        # compacted route), what the merged dispatches carried, and a
        # few of them saved for a check against the plain join
        os.makedirs(args.cache_dir, exist_ok=True)
        path = os.path.join(args.cache_dir, "merged-launches.npz")
        st = state.scanner.sched.stats
        print(json.dumps({
            "launches": launch_counts(),
            "detectd": {**st,
                        "batches_per_dispatch":
                            st["batches"] / max(st["dispatches"], 1),
                        "dedup_ratio":
                            st["launched_pairs"] / max(st["pairs"], 1)},
            "merged_record": path,
            "merged_recorded": record.save(path)}), file=sys.stderr)
    return 0


def cmd_router(args) -> int:
    """The scan router (reference cli.py:1249): consistent-hashes
    artifacts across the `server` replicas, with a fault domain each.
    Clients point at it as at one server. It loads no table and never
    touches the card."""
    from .fleet import ReplicaOptions, RouterOptions, serve_router
    from .resilience import RetryPolicy
    if args.failpoint is not None:
        raise SystemExit(f"router: --failpoint: {_NO_FAILPOINTS}")
    if not args.replicas:
        raise SystemExit("router needs at least one --replica URL")
    # the router never uses a card: hide them from this process, so that
    # nothing here (torch.profiler's CUPTI start-up in a /debug/profile
    # capture initializes CUDA even for host activity) can open a card
    # or hold card memory
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _configure_watch(args)
    opts = RouterOptions(
        vnodes=args.ring_vnodes,
        replica_timeout_s=args.replica_timeout_ms / 1e3,
        token=args.token,
        retry=RetryPolicy(attempts=max(1, args.route_retries),
                          base_delay_s=0.05, max_delay_s=1.0,
                          budget_s=10.0),
        replica=ReplicaOptions(
            fail_threshold=args.replica_fail_threshold,
            reset_timeout_ms=args.replica_reset_ms,
            probe_interval_ms=args.replica_probe_interval_ms,
            probe_timeout_ms=args.replica_probe_timeout_ms))
    host, _, port = args.listen.rpartition(":")
    serve_router(host or "0.0.0.0", int(port), args.replicas, opts,
                 trace_path=args.trace,
                 drain_grace_s=args.drain_grace_ms / 1e3)
    return 0


def _configure_watch(args) -> None:
    """The flight recorder, SLO and profiler flags onto the process
    singletons (reference cli.py:190-201)."""
    from .obs import PROF, RECORDER, SLO
    RECORDER.configure(incident_dir=args.incident_dir or None,
                       slow_trace_ms=args.slow_trace_ms)
    SLO.configure(latency_threshold_ms=args.slo_latency_ms)
    PROF.configure(cooldown_s=args.profile_cooldown_s,
                   auto_burn_threshold=args.profile_auto_burn)


def _watch_flags(p: argparse.ArgumentParser) -> None:
    """The flight recorder, SLO and profiler flags of the server and the
    router (reference cli.py:163-187)."""
    p.add_argument("--incident-dir", default="",
                   help="flight-recorder incident snapshots and live "
                        "profiles land here (default: "
                        "$TRIVY_TPU_INCIDENT_DIR or "
                        "<tmp>/trivy-tpu-incidents), listed at "
                        "/debug/incidents")
    p.add_argument("--slow-trace-ms", type=float, default=1000.0,
                   help="the flight recorder pins traces whose root span "
                        "takes longer, so slow requests survive ring "
                        "churn (default 1000)")
    p.add_argument("--slo-latency-ms", type=float, default=2000.0,
                   help="the scan-latency threshold of the p99 objective "
                        "(default 2000)")
    p.add_argument("--profile-auto-burn", type=float, default=0.0,
                   help="short-window SLO burn rate at or above which one "
                        "live profile is captured into the incident dir "
                        "(cooldown-limited; 0 disables, the default)")
    p.add_argument("--profile-cooldown-s", type=float, default=30.0,
                   help="least time between live profile captures "
                        "(/debug/profile and the SLO trigger share it; "
                        "default 30)")


def _router_flags(p: argparse.ArgumentParser) -> None:
    """The JAX router's flags (trivy_tpu/cli.py:446-490); its
    --failpoint is refused."""
    p.add_argument("--listen", default="0.0.0.0:4953")
    p.add_argument("--replica", action="append", default=[],
                   metavar="URL", dest="replicas",
                   help="server replica base URL (repeatable; at least "
                        "one)")
    p.add_argument("--ring-vnodes", type=int, default=64,
                   help="virtual nodes per replica on the consistent-"
                        "hash ring (more: a smoother balance; default "
                        "64)")
    p.add_argument("--replica-timeout-ms", type=float, default=60000.0,
                   help="per-forward socket bound (further bounded by "
                        "the client's X-Trivy-Deadline-Ms)")
    p.add_argument("--replica-fail-threshold", type=int, default=3,
                   help="routed-RPC failures that open one replica's "
                        "fault domain (default 3)")
    p.add_argument("--replica-reset-ms", type=float, default=2000.0,
                   help="how long a domain stays open before a /healthz "
                        "probe may readmit the replica (default 2000)")
    p.add_argument("--replica-probe-interval-ms", type=float,
                   default=200.0,
                   help="readmission loop cadence (default 200)")
    p.add_argument("--replica-probe-timeout-ms", type=float,
                   default=2000.0,
                   help="/healthz probe bound (default 2000)")
    p.add_argument("--route-retries", type=int, default=3,
                   help="ring walks when every replica sheds or fails "
                        "(default 3)")
    p.add_argument("--trace", default="", metavar="FILE",
                   help="at shutdown, pull every replica's "
                        "/debug/traces fragment and write ONE assembled "
                        "Chrome trace of the fleet to FILE")
    p.add_argument("--token", default="",
                   help="Trivy-Token gating the router's /debug pages "
                        "(the scan routes relay the client's token for "
                        "the replicas to check)")
    p.add_argument("--drain-grace-ms", type=float, default=10000.0,
                   help="SIGTERM/SIGINT: stop admitting (503 + "
                        "Retry-After), let the forwards in flight finish "
                        "for up to this long, then close (default "
                        "10000)")
    _watch_flags(p)
    p.add_argument("--failpoint", action="append", default=None,
                   help="refused: " + _NO_FAILPOINTS)


def _server_flags(p: argparse.ArgumentParser) -> None:
    """The JAX server's flags (trivy_tpu/cli.py:262-445) that the port
    serves, and the ones it refuses (SERVER_REFUSED, default None)."""
    p.add_argument("--listen", default="0.0.0.0:4954")
    p.add_argument("--db", default="",
                   help="advisory DB: a trivy.db, a columnar .npz or a "
                        "fixture YAML glob; without it <cache-dir>/db/")
    p.add_argument("--db-repository", default=DEFAULT_REPO)
    p.add_argument("--skip-db-update", action="store_true")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR)
    p.add_argument("--token", default="",
                   help="require this Trivy-Token header on every POST")
    p.add_argument("--cache-backend", default="fs",
                   help="fs | memory | redis://host:port[/db] | "
                        "s3://bucket[/prefix] — point every replica "
                        "of a fleet at one shared redis/s3 URL")
    p.add_argument("--memo-backend", default="off",
                   help="the detection-result memo, keyed by (blob "
                        "digest, db version): off (default) | fs | "
                        "memory | redis://... | s3://...")
    p.add_argument("--redetect-concurrency", type=int, default=2,
                   help="redetectd: blobs replayed in parallel by the "
                        "sweep after a DB swap (0 disables it; the sweep "
                        "yields to queued scans; default 2)")
    p.add_argument("--detect-coalesce-wait-ms", type=float, default=2.0,
                   help="detectd: how long pending requests gather while "
                        "a dispatch is in flight")
    p.add_argument("--detect-max-inflight-pairs", type=int,
                   default=1 << 22,
                   help="detectd: padded pairs in flight on the card "
                        "before dispatches wait")
    p.add_argument("--detect-warmup", action="store_true",
                   help="launch the join once per rung of the pair "
                        "ladder at start")
    p.add_argument("--detect-dedup", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="collapse duplicate query triples across merged "
                        "requests into one launch")
    p.add_argument("--detect-tenant-max-share", type=float, default=1.0,
                   help="largest share of a merged round's pair budget "
                        "one tenant may fill while others wait (1.0 = "
                        "off)")
    p.add_argument("--table-device-budget-mb", type=float, default=0.0,
                   help="card memory for resident advisory slices; a "
                        "table over it streams through a double-buffered "
                        "slice pair (0 = 35%% of the card's memory)")
    p.add_argument("--table-stream-slices", type=int, default=0,
                   help="stream the advisory table through N hash-range "
                        "slices whatever the budget (0 = size from "
                        "--table-device-budget-mb)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard the join over a dp×db mesh of the first N "
                        "devices of --device's type (-1 = all of them; 0 "
                        "= one device, the default); one kernel launch "
                        "per mesh cell")
    p.add_argument("--mesh-db-shards", type=int, default=1,
                   help="preferred advisory-table shard width on the "
                        "mesh's db axis, fitted to the largest valid "
                        "factorization of the device count")
    p.add_argument("--stream-prefetch", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="while a dispatch runs, warm the advisory slices "
                        "the queued requests will touch (streamed tables "
                        "only; --no-stream-prefetch disables)")
    p.add_argument("--admit-max-active", type=int, default=0,
                   help="concurrent Scan RPCs; 0 = unbounded")
    p.add_argument("--admit-max-queue", type=int, default=16,
                   help="Scans that may wait beyond --admit-max-active "
                        "before shedding 429 + Retry-After")
    p.add_argument("--admit-queue-ms", type=float, default=1000.0,
                   help="longest wait of one Scan in the admission queue")
    p.add_argument("--admit-tenant-max-active", type=int, default=0)
    p.add_argument("--admit-tenant-max-queue", type=int, default=0)
    p.add_argument("--admit-tenant-rate", type=float, default=0.0)
    p.add_argument("--drain-grace-ms", type=float, default=10000.0,
                   help="SIGTERM/SIGINT: how long the requests in flight "
                        "may finish before the server closes")
    p.add_argument("--trace", default="", metavar="FILE",
                   help="record every span for the server's lifetime and "
                        "write the Chrome trace-event JSON to FILE at "
                        "shutdown")
    _watch_flags(p)
    p.add_argument("--ingest-tenant-walker-share", type=float, default=1.0,
                   help="largest share of the walker pool one tenant may "
                        "hold (1.0 = off)")
    p.add_argument("--ingest-tenant-byte-share", type=float, default=1.0,
                   help="largest share of the in-flight byte window one "
                        "tenant may hold (1.0 = off)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; there is no automatic "
                        "fallback to the CPU")
    p.add_argument("--debug-launches", action="store_true",
                   help="after the drain, print the launches by kernel "
                        "and route and detectd's merged dispatches as "
                        "JSON on stderr, and save a few merged dispatches "
                        "to <cache-dir>/merged-launches.npz")
    for dest in SERVER_REFUSED:
        flag = "--" + dest.replace("_", "-")
        if dest == "failpoint":
            p.add_argument(flag, action="append", default=None,
                           help="refused: " + SERVER_REFUSED[dest])
        else:
            p.add_argument(flag, default=None,
                           help="refused: " + SERVER_REFUSED[dest])


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
                   help="comma-separated, of: vuln, secret, license, "
                        "misconfig (alias config)")
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
    p.add_argument("--parallel", type=int, default=1,
                   help="file readers of fs, rootfs and repo walks "
                        "(reference walker --parallel); the report does "
                        "not depend on it")
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
    p.add_argument("--cache-backend", default="fs",
                   help="fs | memory | redis://host:port[/db] | "
                        "s3://bucket[/prefix]?region=..[&endpoint=..]: "
                        "the layer cache of image scans")
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
                   help="rego file whose `ignore` rule decides, per "
                        "finding, whether it is suppressed")
    # misconfiguration scanning: user rego checks, helm values, routing
    p.add_argument("--config-check", action="append", default=[],
                   help="custom rego check file or directory (repeatable)")
    p.add_argument("--config-data", action="append", default=[],
                   help="rego data file or directory (repeatable)")
    p.add_argument("--check-namespaces", default="",
                   help="more rego namespaces to evaluate (comma-separated)")
    p.add_argument("--rego-trace", action="store_true",
                   help="print rego rule-evaluation traces to stderr")
    p.add_argument("--trace", default="", metavar="FILE",
                   help="write a Chrome trace-event JSON of the scan's "
                        "spans (walk, analyzers, secret prefilter, query "
                        "building, the detect phases, assembly) to FILE; "
                        "open it in Perfetto or chrome://tracing")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler capture of the scan to "
                        "this directory (trace.json, manifest.json)")
    p.add_argument("--helm-set", action="append", default=[],
                   help="helm value override key=value (repeatable)")
    p.add_argument("--helm-values", action="append", default=[],
                   help="helm values file override (repeatable)")
    p.add_argument("--file-patterns", action="append", default=[],
                   help='route files to an analyzer: "type:regex" '
                        "(repeatable)")
    p.add_argument("--compliance", default="",
                   help="compliance spec id (docker-cis-1.6.0, k8s-cis, "
                        "k8s-nsa, ...) or @path/to/spec.yaml; its control "
                        "report replaces the scan report")
    p.add_argument("--report", default="summary",
                   choices=["summary", "all"],
                   help="compliance report mode")
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
        description="Vulnerability (OS and language packages), secret, "
                    "license and misconfiguration scanning of images, "
                    "root filesystems, source trees, VM disks and SBOMs, "
                    "with the advisory join and the secret prefilter on "
                    "CUDA.")
    ap.add_argument("--version", action="version",
                    version=f"trivy-tpu {__version__}")
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
                   help="comma-separated external SBOM sources (rekor)")
    p.add_argument("--rekor-url", default="https://rekor.sigstore.dev")
    _scan_flags(p)
    p.set_defaults(func=cmd_image)
    for name, aliases, what in (
            ("filesystem", ["fs"], "a directory tree, with its lockfiles"),
            ("rootfs", [], "a root filesystem tree"),
            ("repository", ["repo"], "a local checkout or a remote git "
                                     "repository (language packages "
                                     "only)")):
        p = sub.add_parser(name, aliases=aliases, help=f"scan {what}")
        p.add_argument("target")
        if name == "repository":
            p.add_argument("--branch", default="",
                           help="remote branch to clone")
            p.add_argument("--tag", default="", help="remote tag to clone")
            p.add_argument("--commit", default="",
                           help="remote commit to check out (full clone)")
        _scan_flags(p)
        p.set_defaults(func=cmd_fs)
    p = sub.add_parser("sbom", help="scan an SBOM (CycloneDX or SPDX, bare "
                                    "or in an in-toto attestation)")
    p.add_argument("target")
    _scan_flags(p)
    p.set_defaults(func=cmd_sbom)
    p = sub.add_parser("vm", help="scan a VM disk image (raw, MBR, GPT, "
                                  "sparse VMDK) or an EBS snapshot")
    p.add_argument("target", help="disk image path or ebs:<snapshot-id>")
    _scan_flags(p)
    p.set_defaults(func=cmd_vm)
    p = sub.add_parser("convert", help="re-render a saved JSON report")
    p.add_argument("report")
    p.add_argument("--format", "-f", default="table",
                   choices=["json", "table", "sarif", "template", "github",
                            "cosign-vuln"])
    p.add_argument("--template", "-t", default="")
    p.add_argument("--output", "-o", default="")
    p.set_defaults(func=cmd_convert)
    p = sub.add_parser("server", help="run the scan server")
    _server_flags(p)
    p.set_defaults(func=cmd_server)
    p = sub.add_parser("router", help="run the scan router in front of N "
                                      "server replicas")
    _router_flags(p)
    p.set_defaults(func=cmd_router)
    sub.add_parser("version", help="print version").set_defaults(
        func=cmd_version)
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
