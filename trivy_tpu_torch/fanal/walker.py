"""Walkers: enumerate the files of a layer tar or a directory tree, feed
them to the analyzer group, and collect secret-scan candidates so the
secret engine runs once, batched, per artifact instead of per file.

Mirrors pkg/fanal/walker/tar.go (whiteout handling: a basename prefix
``.wh.`` marks a deletion, ``.wh..wh..opq`` marks the directory opaque),
walker/fs.go (its files read by a pool of `--parallel` threads), and
the secret-candidate gates of pkg/fanal/analyzer/secret/secret.go. Every
walk merges its files in archive or sorted path order."""

from __future__ import annotations

import hashlib
import os
import re
import tarfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .. import types as T
from .analyzers import AnalysisResult, AnalyzerGroup
from .handlers import post_handle

WH_PREFIX = ".wh."
OPAQUE_MARKER = ".wh..wh..opq"

# secret-candidate gates (pkg/fanal/analyzer/secret/secret.go:27-41,115-140)
MAX_SECRET_SIZE = 10 * 1024 * 1024
MIN_SECRET_SIZE = 10
_SKIP_EXTS = {
    ".jpg", ".png", ".gif", ".doc", ".pdf", ".bin", ".svg", ".socket",
    ".deb", ".rpm", ".zip", ".gz", ".gzip", ".tar", ".pyc",
}
_SKIP_FILES = {"go.mod", "go.sum", "package-lock.json", "yarn.lock",
               "pnpm-lock.yaml", "Pipfile.lock", "Gemfile.lock"}
_SKIP_DIRS = {".git", "node_modules"}

# default --secret-config location: the rule file itself is never
# scanned (secret.go:137-140 compares the walked path against the
# configured path)
DEFAULT_SECRET_CONFIG = "trivy-secret.yaml"


def secret_candidate(path: str, size: int,
                     config_path: str = DEFAULT_SECRET_CONFIG) -> bool:
    if size < MIN_SECRET_SIZE or size > MAX_SECRET_SIZE:
        return False
    parts = path.split("/")
    if any(d in _SKIP_DIRS for d in parts[:-1]):
        return False
    base = parts[-1]
    if base in _SKIP_FILES or (config_path and path == config_path):
        return False
    _, ext = os.path.splitext(base)
    return ext.lower() not in _SKIP_EXTS


def looks_binary(content: bytes) -> bool:
    return b"\x00" in content[:8000]


@dataclass
class BlobScan:
    """Result of walking one blob (a layer or a filesystem snapshot).

    `errors`/`partial` carry the ingest pipeline's degradations: a layer
    that tripped a budget, errored or timed out holds structured
    per-stage annotations (ingest.ingest_error) and is marked partial.
    The serial walker never sets either."""
    result: AnalysisResult
    whiteout_files: list = field(default_factory=list)
    opaque_dirs: list = field(default_factory=list)
    secret_files: list = field(default_factory=list)  # [(path, bytes)]
    post_files: dict = field(default_factory=dict)    # path -> bytes
    errors: list = field(default_factory=list)        # [ingest_error]
    partial: bool = False


def _parent_dirs(path: str):
    parts = path.split("/")[:-1]
    for i in range(1, len(parts) + 1):
        yield "/".join(parts[:i])


def classify_member(member: tarfile.TarInfo, group: AnalyzerGroup,
                    collect_secrets: bool, secret_config_path: str,
                    skip_files: tuple, skip_dir_globs: tuple):
    """One tar member's routing, shared by the serial walker and the
    ingest pipeline so the two cannot drift → (kind, path, wants): kind
    is 'skip', 'opaque', 'whiteout' or 'file', and wants (file only) is
    the (analyze, post, secret) triple. Globs must already be normalized
    (normalize_skip_globs); the file at `secret_config_path` is never a
    secret candidate."""
    path = _norm_rel(member.name)
    if not path:
        return ("skip", "", None)
    if skip_files and skip_match(path, skip_files):
        return ("skip", path, None)
    if skip_dir_globs and any(skip_match(d, skip_dir_globs)
                              for d in _parent_dirs(path)):
        return ("skip", path, None)
    dirname, base = os.path.split(path)
    if base == OPAQUE_MARKER:
        return ("opaque", dirname, None)
    if base.startswith(WH_PREFIX):
        return ("whiteout",
                os.path.join(dirname, base[len(WH_PREFIX):]), None)
    if not (member.isfile() or member.islnk()):
        return ("skip", path, None)
    wants = group.required(path, member.size)
    wants_post = group.post_required(path, member.size)
    wants_secret = collect_secrets and secret_candidate(
        path, member.size, secret_config_path)
    if not (wants or wants_post or wants_secret):
        return ("skip", path, None)
    return ("file", path, (wants, wants_post, wants_secret))


def walk_layer_tar(tf: tarfile.TarFile, group: AnalyzerGroup,
                   collect_secrets: bool = False, skip_files: tuple = (),
                   skip_dir_globs: tuple = (),
                   secret_config_path: str = DEFAULT_SECRET_CONFIG
                   ) -> BlobScan:
    """_walk_layer_tar_impl under its `fanal.walk_tar` span."""
    from ..obs import span
    with span("fanal.walk_tar") as sp:
        scan = _walk_layer_tar_impl(tf, group, collect_secrets,
                                    skip_files, skip_dir_globs,
                                    secret_config_path)
        sp.attrs.update(secret_files=len(scan.secret_files),
                        post_files=len(scan.post_files))
        return scan


def _walk_layer_tar_impl(tf: tarfile.TarFile, group: AnalyzerGroup,
                         collect_secrets: bool, skip_files: tuple,
                         skip_dir_globs: tuple,
                         secret_config_path: str) -> BlobScan:
    """Walk one layer's tar in archive order. --skip-files/--skip-dirs
    apply to layers too (reference walker.go CleanSkipPaths)."""
    skip_files = normalize_skip_globs(skip_files)
    skip_dir_globs = normalize_skip_globs(skip_dir_globs)
    scan = BlobScan(result=AnalysisResult())
    for member in tf:
        kind, path, wants3 = classify_member(
            member, group, collect_secrets, secret_config_path,
            skip_files, skip_dir_globs)
        if kind == "opaque":
            scan.opaque_dirs.append(path)
            continue
        if kind == "whiteout":
            scan.whiteout_files.append(path)
            continue
        if kind != "file":
            continue
        try:
            f = tf.extractfile(member)
        except tarfile.StreamError:
            # a stream-mode tar cannot seek back to a hardlink's target;
            # the target itself is analyzed under its own member
            continue
        if f is None:
            continue
        content = f.read()
        wants, wants_post, wants_secret = wants3
        if wants:
            group.analyze_file(path, content, scan.result)
        if wants_post:
            scan.post_files[path] = content
        if wants_secret and not looks_binary(content):
            scan.secret_files.append((path, content))
    group.post_analyze(scan.post_files, scan.result)
    return scan


def normalize_skip_globs(globs) -> tuple:
    """CleanSkipPaths: strip leading '/' so absolute-style flags match
    the walked relative paths."""
    return tuple(g.lstrip("/") for g in globs or ())


def skip_match(rel: str, globs: tuple) -> bool:
    """Reference doublestar semantics (utils.SkipPath): `*`/`?` never
    cross a path separator, `**` matches any number of segments."""
    return any(_skip_re(g).match(rel) is not None for g in globs)


def _skip_re(glob: str):
    out = []
    i, n = 0, len(glob)
    while i < n:
        c = glob[i]
        if c == "*":
            if glob.startswith("**", i):
                out.append(".*")
                i += 2
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out) + r"\Z")


def _norm_rel(path: str) -> str:
    """A member name → a safe relative path, or '' to skip it. Layer
    tars are outside input: a `..` segment must never reach the whiteout
    and opaque handling of the applier, where it would delete paths
    outside the shadowed subtree. One leading './' and any leading '/'
    are stripped, empty and '.' segments collapse, and any '..' segment
    rejects the name."""
    if path.startswith("./"):
        path = path[2:]
    parts = [p for p in path.lstrip("/").split("/") if p not in ("", ".")]
    if not parts or ".." in parts:
        return ""
    return "/".join(parts)


def walk_fs(root: str, group: AnalyzerGroup,
            collect_secrets: bool = False,
            secret_config_path: str = DEFAULT_SECRET_CONFIG,
            skip_files: tuple = (), skip_dir_globs: tuple = (),
            file_checksum: bool = False, parallel: int = 1) -> BlobScan:
    """_walk_fs_impl under its `fanal.walk_fs` span, whose `parallel`
    attribute is the reader count (`--parallel`, reference
    walker/fs.go:73-80)."""
    from ..obs import span
    with span("fanal.walk_fs", parallel=parallel) as sp:
        scan = _walk_fs_impl(root, group, collect_secrets,
                             secret_config_path, skip_files,
                             skip_dir_globs, file_checksum, parallel)
        sp.attrs.update(secret_files=len(scan.secret_files),
                        post_files=len(scan.post_files))
        return scan


def _walk_fs_impl(root: str, group: AnalyzerGroup, collect_secrets: bool,
                  secret_config_path: str, skip_files: tuple,
                  skip_dir_globs: tuple, file_checksum: bool,
                  parallel: int) -> BlobScan:
    """Walk a directory tree through the analyzers. The candidate files
    are read and analyzed by `parallel` threads when it is above 1, and
    their results merge in sorted path order, so the scan is the same
    for every count. The skip globs match root-relative paths; the
    walk-relative `secret_config_path` is never a secret candidate.
    With `file_checksum` (the SPDX formats), each package of an
    application file gets that file's sha1 as its digest."""
    scan = BlobScan(result=AnalysisResult())
    root = os.path.abspath(root)
    skip_files = normalize_skip_globs(skip_files)
    skip_dir_globs = normalize_skip_globs(skip_dir_globs)
    candidates = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != ".git"]
        reldir = os.path.relpath(dirpath, root).replace(os.sep, "/")
        if skip_dir_globs:
            # --skip-dirs matches walked relative paths (walker.go)
            dirnames[:] = [d for d in dirnames
                           if not skip_match(_norm_rel(f"{reldir}/{d}"),
                                             skip_dir_globs)]
        for fn in sorted(filenames):
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            if skip_files and skip_match(rel, skip_files):
                continue
            try:
                size = os.path.getsize(full)
            except OSError:
                continue
            wants = group.required(rel, size)
            wants_post = group.post_required(rel, size)
            wants_secret = collect_secrets and secret_candidate(
                rel, size, secret_config_path)
            if wants or wants_post or wants_secret:
                candidates.append((rel, full, wants, wants_post,
                                   wants_secret))

    def process(task):
        rel, full, wants, wants_post, wants_secret = task
        try:
            with open(full, "rb") as f:
                content = f.read()
        except OSError:
            return None  # permission errors skipped (walker/fs.go:24-33)
        result = None
        if wants:
            result = AnalysisResult()
            group.analyze_file(rel, content, result)
            if file_checksum:
                _stamp_sha1(result, rel, content)
        return (rel, result, content if wants_post else None,
                content if wants_secret and not looks_binary(content)
                else None)

    if parallel > 1 and len(candidates) > 1:
        with ThreadPoolExecutor(max_workers=parallel) as pool:
            outputs = list(pool.map(process, candidates))
    else:
        outputs = [process(t) for t in candidates]
    for rel, result, post, secret in sorted(
            (o for o in outputs if o is not None), key=lambda o: o[0]):
        if result is not None:
            scan.result.merge(result)
        if post is not None:
            scan.post_files[rel] = post
        if secret is not None:
            scan.secret_files.append((rel, secret))
    group.post_analyze(scan.post_files, scan.result)
    return scan


def _stamp_sha1(result: AnalysisResult, rel: str, content: bytes) -> None:
    """The reference's FileChecksum artifact option: SPDX output records
    the sha1 of the file each package came from."""
    digest = "sha1:" + hashlib.sha1(content).hexdigest()
    for app in result.applications:
        if app.file_path == rel:
            for pkg in app.packages:
                if not pkg.digest:
                    pkg.digest = digest


def blob_info(scan: BlobScan, diff_id: str = "",
              created_by: str = "") -> T.BlobInfo:
    """One walked blob → its BlobInfo, after the post-handlers."""
    r = scan.result
    bi = T.BlobInfo(
        diff_id=diff_id,
        created_by=created_by,
        opaque_dirs=sorted(scan.opaque_dirs),
        whiteout_files=sorted(scan.whiteout_files),
        os=r.os or T.OS(),
        repository=r.repository,
        package_infos=sorted(r.package_infos, key=lambda p: p.file_path),
        applications=sorted(r.applications, key=lambda a: a.file_path),
        misconfigurations=sorted(r.misconfigurations,
                                 key=lambda m: m.file_path),
        licenses=r.licenses,
        custom_resources=r.custom_resources,
        build_info=r.build_info,
        # the pipeline's annotations ride the BlobInfo and its cache
        # round trip into the report
        ingest_errors=list(scan.errors),
    )
    post_handle(r, bi)
    return bi
