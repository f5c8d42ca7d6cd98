"""Local scan driver: the orchestration the reference runs per target in
pkg/scanner/local/scan.go — ApplyLayers → OS/lang-package detection →
FillInfo → result assembly, with detection as batched device joins.

Same (target, artifact id, blob ids, options) → (results, os) contract
as the JAX package's LocalScanner: the blobs come from the cache, every
target's OS and per-application query batches are built on the host,
and ONE detect_many call joins them all (one join launch per batch).
Given SchedOptions (the server passes them), detection goes through
detectd instead, so concurrent scans' batches merge into shared
launches. Given StreamOptions whose plan engages (parallel/stream.py),
the detector streams the advisory table through a double-buffered
pair of resident slices; otherwise the resident BatchDetector serves,
as without them. Given a mesh (parallel/mesh.py, the server's
--mesh-devices), a MeshDetector serves instead, its join sharded over
the mesh's cells, streamed or resident by the same rule applied to its
per-device share of the table. Then come the results that need no
join: the ingest degradations, the misconfigurations, the secrets and,
under the license scanner, the license results.

With a memo (fleet/memo.py), each attributable unit (the OS batch, one
application's batch) whose (blob, db version) entry matches replays its
stored hits instead of joining; the live remainder joins and publishes
back. Under `resilience.blameless()` (redetectd's post-swap sweep) the
join takes the direct engine path, never a merged detectd dispatch.

Each scan_many call runs under one trace (unless the server already
stamped a per-RPC one) with the JAX package's spans: `scan`, and under
it `scan.apply_layers`, `scan.build_queries`, `scan.memo` (with a
memo), `scan.detect` and `scan.assemble_results`."""

from __future__ import annotations

import datetime as dt
from typing import TYPE_CHECKING, Optional

import torch

from . import types as T
from .db.table import AdvisoryTable
from .device import resolve_device
from .detect.engine import BatchDetector
from .detect.fill import fill_info
from .detect.langpkg import LangpkgScanner
from .detect.ospkg import OspkgScanner
from .fanal.applier import apply_layers
from .licensing import scan_license_name
from .module import apply_post_scan, loaded_modules
from .obs import cost as _cost
from .obs import ensure_trace, span
from .parallel.stream import StreamingDetector, StreamOptions, plan_slices
from .resilience import blameless_active

if TYPE_CHECKING:
    from .detect.sched import SchedOptions


class LocalScanner:
    def __init__(self, cache, table: AdvisoryTable,
                 device: str | torch.device | None = None,
                 sched: "SchedOptions | None" = None, memo=None,
                 stream: StreamOptions | None = None, mesh=None):
        self.cache = cache
        self.table = table
        # graftmemo: an open fleet.memo.MemoStore (None = no memo)
        self.memo = memo
        # graftstream: a table over the budget streams through resident
        # slices; one within it keeps the resident detector
        bounds = None
        if mesh is None and stream is not None:
            device = resolve_device(device)
            bounds = plan_slices(table, stream, device=device)
        if mesh is not None:
            from .parallel.mesh import MeshDetector
            self.detector = MeshDetector(table, mesh, stream=stream)
        elif bounds is not None:
            self.detector = StreamingDetector(table, stream, bounds=bounds,
                                              device=device)
        else:
            self.detector = BatchDetector(table, device=device)
        # detectd: the server's scans merge their batches' launches
        self.sched = None
        if sched is not None:
            from .detect.sched import DispatchScheduler
            self.sched = DispatchScheduler(self.detector, sched)
            if sched.warmup:
                self.detector.warmup()
        self.ospkg = OspkgScanner(self.detector)
        self.langpkg = LangpkgScanner(self.detector)

    def close(self) -> None:
        """Join detectd and the detector's fetch thread (idempotent).
        Owners that retire a scanner (the server's table swap and
        shutdown) call it."""
        if self.sched is not None:
            self.sched.close()
        self.detector.close()

    def scan(self, target: str, artifact_id: str, blob_ids: list[str],
             options: Optional[T.ScanOptions] = None,
             now: Optional[dt.datetime] = None
             ) -> tuple[list[T.Result], T.OS]:
        return self.scan_many([(target, artifact_id, blob_ids)],
                              options, now)[0]

    def scan_many(self, items: list[tuple[str, str, list[str]]],
                  options: Optional[T.ScanOptions] = None,
                  now: Optional[dt.datetime] = None
                  ) -> list[tuple[list[T.Result], T.OS]]:
        """Scan many targets with one detect_many call over all their
        query batches, under one trace."""
        with ensure_trace(), span("scan", targets=len(items)):
            return self._scan_many_traced(items, options, now)

    def _scan_many_traced(self, items, options, now):
        options = options or T.ScanOptions()
        details = []
        item_blobs = []   # per item: its BlobInfos, in blob_ids order
        with span("scan.apply_layers", targets=len(items)):
            for _target, artifact_id, blob_ids in items:
                blobs = []
                for bid in blob_ids:
                    blob = self.cache.get_blob(bid)
                    if blob is None:
                        raise KeyError(f"missing blob {bid} in cache "
                                       f"(artifact {artifact_id})")
                    blobs.append(blob)
                detail = apply_layers(blobs)
                # OS-independent packages without a detected OS report
                # Family "none" (reference local/scan.go:66-71)
                if not detail.os.detected and detail.packages:
                    detail.os = T.OS(family=T.OSFamily.NONE)
                # dev dependencies are removed unless --include-dev-deps
                # (reference local/scan.go:109-111 excludeDevDeps)
                if not options.include_dev_deps:
                    for app in detail.applications:
                        app.packages = [p for p in app.packages
                                        if not p.dev]
                details.append(detail)
                item_blobs.append(blobs)

        # phase 1: every query batch (host)
        units = []    # (item index, "os" | app, finish)
        batches = []
        with span("scan.build_queries") as sp:
            if T.Scanner.VULN in options.scanners:
                for idx, detail in enumerate(details):
                    if detail.os.detected and "os" in options.pkg_types:
                        qs, fin = self.ospkg.prepare(
                            detail.os, detail.repository,
                            detail.packages, now=now)
                        if fin is not None:  # family supported
                            units.append((idx, "os", fin))
                            batches.append(qs)
                    if "library" in options.pkg_types:
                        for app in sorted(detail.applications,
                                          key=lambda a: (a.file_path,
                                                         a.type)):
                            qs, fin = self.langpkg.prepare_app(app)
                            units.append((idx, app, fin))
                            batches.append(qs)
            sp.attrs.update(batches=len(batches),
                            queries=sum(len(b) for b in batches))

        # graftmemo: a unit whose (blob, db version) entry matches its
        # query digest replays its stored hits; the rest join live and
        # publish their hits back. A memo fault reads as a miss.
        session = None
        replayed: dict[int, list] = {}
        store_tokens: dict[int, tuple] = {}
        if self.memo is not None and units:
            from .fleet.memo import MemoSession
            session = MemoSession(self.memo, self.table.content_digest())
            with span("scan.memo", units=len(units)) as sp:
                for u_i, ((idx, unit, _fin), qs) in enumerate(
                        zip(units, batches)):
                    hits, token = session.consult(
                        unit, qs, details[idx], item_blobs[idx],
                        items[idx][2])
                    if hits is not None:
                        replayed[u_i] = hits
                    elif token is not None:
                        store_tokens[u_i] = token
                sp.attrs.update(replayed=len(replayed))
                # replays are work avoided, priced per replayed query
                if replayed:
                    _cost.note_work_avoided(
                        sum(len(batches[i]) for i in replayed))

        # phase 2: one detect_many over the live batches (device),
        # through detectd when the owner turned it on, except for
        # blameless (background) work, which never shares a merged
        # launch with live requests
        hit_lists: list = [replayed.get(i) for i in range(len(batches))]
        live = [i for i in range(len(batches)) if i not in replayed]
        if live:
            with span("scan.detect", batches=len(live)):
                detect = self.sched if self.sched is not None and \
                    not blameless_active() else self.detector
                live_hits = detect.detect_many([batches[i] for i in live])
            for u_i, hits in zip(live, live_hits):
                hit_lists[u_i] = hits
        if session is not None:
            for u_i, token in store_tokens.items():
                session.record(token, hit_lists[u_i])
            session.flush()

        # phase 3: per-target results (host)
        with span("scan.assemble_results"):
            return self._assemble_results(items, options, details, units,
                                          hit_lists)

    def _assemble_results(self, items, options, details, units,
                          hit_lists):
        vuln_results: dict[int, list[T.Result]] = {}
        for (idx, unit, finish), hits in zip(units, hit_lists):
            target = items[idx][0]
            detail = details[idx]
            if unit == "os":
                vulns, eosl = finish(hits)
                if eosl:
                    detail.os.eosl = True
                # a supported, detected OS always yields a result — even
                # with zero packages (ospkg/scan.go:42-69)
                keep = True
                res = self._vuln_result(
                    vulns, target=f"{target} ({detail.os.family} "
                                  f"{detail.os.name})",
                    clazz=T.ResultClass.OS_PKGS, rtype=detail.os.family,
                    packages=detail.packages, options=options)
            else:
                app = unit
                vulns = finish(hits)
                keep = bool(vulns) or options.list_all_packages
                res = self._vuln_result(
                    vulns,
                    target=app.file_path or PKG_TARGETS.get(app.type,
                                                            app.type),
                    clazz=T.ResultClass.LANG_PKGS, rtype=app.type,
                    packages=app.packages, options=options)
            if keep:
                vuln_results.setdefault(idx, []).append(res)

        return [(self._finish_item(details[idx], vuln_results.get(idx, []),
                                   options), details[idx].os)
                for idx in range(len(items))]

    @staticmethod
    def _finish_item(detail: T.ArtifactDetail, results: list,
                     options: T.ScanOptions) -> list[T.Result]:
        """The results after the vulnerability ones, in the reference's
        order: the ingest degradations, the misconfigurations (one per
        file, its failures sorted by id and message), the secrets, the
        licenses."""
        # a degraded analysis (a malformed or over-budget SBOM) says
        # what is missing and why, instead of under-reporting in silence
        if detail.ingest_errors:
            results.append(T.Result(
                target="Ingest Degradations", clazz=T.ResultClass.INGEST,
                ingest_errors=list(detail.ingest_errors)))
        if T.Scanner.MISCONF in options.scanners:
            for mc in detail.misconfigurations:
                if not mc.failures and not mc.successes and \
                        not mc.exceptions:
                    continue
                results.append(T.Result(
                    target=mc.file_path, clazz=T.ResultClass.CONFIG,
                    type=mc.file_type,
                    misconf_summary=T.MisconfSummary(
                        successes=mc.successes,
                        failures=len(mc.failures),
                        exceptions=mc.exceptions),
                    misconfigurations=sorted(
                        mc.failures, key=lambda f: (f.id, f.message))))
        if T.Scanner.SECRET in options.scanners:
            for sec in detail.secrets:
                results.append(T.Result(
                    target=sec.file_path, clazz=T.ResultClass.SECRET,
                    secrets=sec.findings))
        if T.Scanner.LICENSE in options.scanners:
            results.extend(_license_results(detail))
        # extension modules: their resources travel as one Custom result
        # (module.go PostScan:478), then the post-scan hooks (reference
        # post.Scan at pkg/scanner/local/scan.go:162)
        if loaded_modules():
            if detail.custom_resources:
                results.append(T.Result(
                    target="Custom", clazz=T.ResultClass.CUSTOM,
                    custom_resources=detail.custom_resources))
            results = apply_post_scan(results)
        return results

    def _vuln_result(self, vulns, target: str, clazz, rtype, packages,
                     options: T.ScanOptions) -> T.Result:
        """FillInfo enrichment, the severity sort, and the package list
        under --list-all-pkgs."""
        fill_info(vulns, self.table.details)
        vulns.sort(key=_vuln_sort_key)
        res = T.Result(target=target, clazz=clazz, type=rtype,
                       vulnerabilities=vulns)
        if options.list_all_packages:
            res.packages = sorted(packages,
                                  key=lambda p: (p.name, p.version))
        return res


def _license_results(detail: T.ArtifactDetail) -> list[T.Result]:
    """Reference scanLicenses (local/scan.go:280-360): one result for the
    OS packages, one per application and one for the loose license
    files, each emitted even when empty."""
    out = [T.Result(target="OS Packages", clazz=T.ResultClass.LICENSE,
                    licenses=[_declared(pkg, lic)
                              for pkg in detail.packages
                              for lic in pkg.licenses])]
    for app in detail.applications:
        out.append(T.Result(
            target=app.file_path or PKG_TARGETS.get(app.type, app.type),
            clazz=T.ResultClass.LICENSE,
            licenses=[_declared(lib, lic, lib.file_path or app.file_path)
                      for lib in app.packages for lic in lib.licenses]))
    out.append(T.Result(
        target="Loose File License(s)", clazz=T.ResultClass.LICENSE_FILE,
        licenses=sorted(detail.licenses,
                        key=lambda li: (li.file_path, li.name))))
    return out


def _declared(pkg: T.Package, lic: str,
              file_path: str = "") -> T.DetectedLicense:
    cat, sev = scan_license_name(lic)
    return T.DetectedLicense(severity=sev, category=cat, pkg_name=pkg.name,
                             name=lic, file_path=file_path, confidence=1.0)


# friendly targets for aggregated individual-package results
# (reference pkg/scanner/langpkg/scan.go:15-23)
PKG_TARGETS = {
    "python-pkg": "Python", "conda-pkg": "Conda", "gemspec": "Ruby",
    "node-pkg": "Node.js", "jar": "Java", "k8s": "Kubernetes",
    "kubernetes": "Kubernetes",
}


def _vuln_sort_key(v: T.DetectedVulnerability):
    """(pkg name, installed version, severity desc, vuln id, pkg path) —
    reference types.BySeverity (pkg/types/vulnerability.go:42-58)."""
    sev = T.SEVERITIES.index(v.severity) if v.severity in T.SEVERITIES else 0
    return (v.pkg_name, v.installed_version, -sev, v.vulnerability_id,
            v.pkg_path)
