"""Cluster scan orchestration, the port's copy of the JAX package's
k8s/scanner.py (reference pkg/k8s/scanner/scanner.go).

Enumerates the workloads, skips the duplicates a controller owns (a Pod
owned by a ReplicaSet is represented by its Deployment, as
trivy-kubernetes collapses owners), runs each resource through the
Kubernetes misconfiguration checks, and assembles per-resource Results
for the report and compliance layers. The workloads' images go through
one batched detection on the scan's device (scan_cluster_vulns)."""

from __future__ import annotations

import json

from .. import types as T
from ..iac.kubernetes import scan_kubernetes
from .client import WORKLOAD_KINDS, KubeClient, KubeError


def _owned(item: dict) -> bool:
    md = item.get("metadata", {})
    return bool(md.get("ownerReferences"))


def scan_resource_doc(doc: dict, namespace: str = "") -> T.Result:
    kind = doc.get("kind", "")
    name = doc.get("metadata", {}).get("name", "")
    ns = doc.get("metadata", {}).get("namespace", namespace)
    text = json.dumps(doc, indent=1).encode()
    failures, successes = scan_kubernetes(
        f"{name}.json", text, docs=[doc])
    return T.Result(
        target=f"{ns}/{kind}/{name}" if ns else f"{kind}/{name}",
        clazz=T.ResultClass.CONFIG,
        type="kubernetes",
        misconf_summary=T.MisconfSummary(
            successes=successes, failures=len(failures)),
        misconfigurations=sorted(
            failures, key=lambda f: (f.id, f.message)),
    )


def _workloads(client: KubeClient, namespace: str = "", kinds=None):
    """Yield (resource path, doc) per scannable workload: an absent API
    group (404) is skipped, auth and connection failures raise (they
    must never read as clean), and the Pods, ReplicaSets and Jobs that a
    controller owns collapse into their controllers."""
    for kind in (kinds or WORKLOAD_KINDS):
        try:
            items = client.list_workloads(kind, namespace)
        except KubeError as e:
            if e.code == 404:
                continue  # the API group is absent (old clusters)
            raise
        for item in items:
            if kind in ("Pod", "ReplicaSet", "Job") and _owned(item):
                continue
            md = item.get("metadata", {})
            ns = md.get("namespace", namespace)
            name = md.get("name", "")
            path = f"{ns}/{kind}/{name}" if ns else f"{kind}/{name}"
            yield path, item


def scan_cluster(client: KubeClient, namespace: str = "",
                 kinds=None) -> list[T.Result]:
    results = []
    for _path, item in _workloads(client, namespace, kinds):
        res = scan_resource_doc(item)
        if res.misconfigurations or \
                (res.misconf_summary and
                 res.misconf_summary.successes):
            results.append(res)
    return sorted(results, key=lambda r: r.target)


def _pod_spec(doc: dict) -> dict:
    """The pod template spec of any workload kind (trivy-kubernetes
    artifacts.FromResource navigates the same paths)."""
    kind = doc.get("kind", "")
    spec = doc.get("spec") or {}
    if kind == "Pod":
        return spec
    if kind == "CronJob":
        spec = ((spec.get("jobTemplate") or {}).get("spec")) or {}
    return ((spec.get("template") or {}).get("spec")) or {}


def workload_images(doc: dict) -> list[str]:
    """The unique container images of one workload: its containers,
    init and ephemeral containers (the reference's pkg/k8s/scanner
    collects the same sets through trivy-kubernetes artifacts)."""
    spec = _pod_spec(doc)
    out = []
    for key in ("containers", "initContainers", "ephemeralContainers"):
        for c in spec.get(key) or []:
            img = c.get("image")
            if img:
                out.append(img)
    return list(dict.fromkeys(out))


def _default_pull(image: str, dest: str):
    from ..oci import default_client, parse_ref
    default_client().pull_to_oci_tar(parse_ref(image), dest)


def device_fault(e: BaseException) -> bool:
    """Whether `e` is a kernel that failed to build or to launch, or an
    error of the CUDA runtime: these end the scan, where a failed pull
    or analysis only drops its image with a warning. Turned into a
    warning, a broken kernel would drop every image from a report that
    exits 0."""
    import torch

    from ..ops.kernels import KernelError
    cuda_errors = (KernelError, torch.cuda.OutOfMemoryError) + tuple(
        t for t in (getattr(torch, "AcceleratorError", None),) if t)
    return isinstance(e, cuda_errors) or (
        isinstance(e, RuntimeError) and "CUDA" in str(e))


def scan_cluster_vulns(client: KubeClient, cache, table,
                       namespace: str = "", kinds=None, pull=None,
                       scanners: tuple = ("vuln",), now=None,
                       list_all_packages: bool = False,
                       secret_scanner=None,
                       secret_config_path: str = "trivy-secret.yaml",
                       file_patterns: tuple = (),
                       scanner=None, device=None,
                       figures: dict | None = None) -> list[T.Result]:
    """Workload images scanned for vulnerabilities and secrets
    (reference pkg/k8s/scanner/scanner.go:104-121,163-175).

    The reference runs one image scan per workload image. Here every
    unique cluster image is pulled and analyzed on the host first (its
    secret rows through the shift-or prefilter on `device`), then the
    package queries of ALL images go through one LocalScanner.scan_many,
    whose detect_many launches the joins for the whole cluster at once.
    Each image's results are then fanned out to every workload that
    names the image. A failed pull or analysis drops its image with a
    warning, like the reference's per-image error resource; a kernel or
    CUDA fault raises (device_fault). `figures` (a dict) receives the
    counts of workloads and images and the seconds of the pulls, the
    analysis and the detection."""
    import dataclasses
    import os as _os
    import tempfile
    import time

    from ..fanal.analyzers import LOCKFILE_ANALYZERS, AnalyzerGroup
    from ..fanal.artifact import ImageArchiveArtifact
    from ..log import logger
    from ..scanner import LocalScanner

    pull = pull or _default_pull
    resources: list[tuple[str, str]] = []   # (resource path, image)
    for path, item in _workloads(client, namespace, kinds):
        for img in workload_images(item):
            resources.append((path, img))

    images = list(dict.fromkeys(img for _, img in resources))
    fig = {"workloads": len({path for path, _ in resources}),
           "images": len(images), "pull_s": 0.0, "inspect_s": 0.0}
    if "secret" in scanners and secret_scanner is None:
        from ..secret import SecretScanner
        # one scanner: the keyword bank is built and uploaded once
        secret_scanner = SecretScanner(device=device)
    refs = {}
    for img in images:
        tmp = tempfile.NamedTemporaryFile(suffix=".tar", delete=False)
        tmp.close()
        try:
            t0 = time.perf_counter()
            pull(img, tmp.name)
            t1 = time.perf_counter()
            fig["pull_s"] += t1 - t0
            # lockfile analyzers are disabled for images (run.go:464-523)
            art = ImageArchiveArtifact(
                tmp.name, cache, scanners=scanners,
                group=AnalyzerGroup(disabled=LOCKFILE_ANALYZERS,
                                    file_patterns=file_patterns),
                secret_scanner=secret_scanner,
                secret_config_path=secret_config_path)
            refs[img] = art.inspect()
            fig["inspect_s"] += time.perf_counter() - t1
        except Exception as e:  # a pull or an analysis: non-fatal
            if device_fault(e):
                raise
            logger.warning("failed to scan image %s: %s", img, e)
        finally:
            _os.unlink(tmp.name)

    ok_images = [img for img in images if img in refs]
    # a caller's scanner (over the same cache) shares one table upload
    # between the workload sweep and the node scan
    scanner = scanner or LocalScanner(cache, table, device)
    opts = T.ScanOptions(scanners=tuple(scanners),
                         list_all_packages=list_all_packages)
    t0 = time.perf_counter()
    scanned = scanner.scan_many(
        [(img, refs[img].id, refs[img].blob_ids) for img in ok_images],
        opts, now=now)
    fig.update(scanned_images=len(ok_images),
               detect_s=time.perf_counter() - t0)
    if figures is not None:
        figures.update(fig)
    per_image = {img: res for img, (res, _os_info)
                 in zip(ok_images, scanned)}

    out: list[T.Result] = []
    for path, img in resources:
        for res in per_image.get(img, []):
            out.append(dataclasses.replace(
                res, target=f"{path}/{res.target}"))
    return sorted(out, key=lambda r: r.target)


def build_kbom(client: KubeClient) -> dict:
    """KBOM: the cluster and its nodes as CycloneDX JSON (reference
    pkg/k8s/scanner/scanner.go clusterInfoToReportResources → the
    cyclonedx KBOM)."""
    version = {}
    try:
        version = client.version()
    except Exception:
        pass
    components = []
    try:
        for node in client.nodes():
            info = node.get("status", {}).get("nodeInfo", {})
            name = node.get("metadata", {}).get("name", "")
            components.append({
                "bom-ref": f"node:{name}",
                "type": "container",
                "name": name,
                "properties": [
                    {"name": "node-role", "value": "worker"},
                    {"name": "architecture",
                     "value": info.get("architecture", "")},
                    {"name": "kernel_version",
                     "value": info.get("kernelVersion", "")},
                    {"name": "operating_system",
                     "value": info.get("osImage", "")},
                    {"name": "kubelet_version",
                     "value": info.get("kubeletVersion", "")},
                ]})
    except Exception:
        pass
    return {
        "bomFormat": "CycloneDX",
        "specVersion": "1.5",
        "version": 1,
        "metadata": {
            "component": {
                "bom-ref": "cluster",
                "type": "platform",
                "name": "k8s.io/kubernetes",
                "version": version.get("gitVersion", ""),
            },
        },
        "components": components,
    }


def summary_table(results: list) -> str:
    """Namespace and resource summaries, one table per scanner with
    findings (the reference's pkg/k8s/report summary writer renders
    separate Misconfigurations, Vulnerabilities and Secrets sections)."""
    from ..report.tables import render_table
    sev_cols = ["CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"]
    head = ["Namespace", "Resource"] + [s[0] for s in sev_cols]

    def section(title, rows_of):
        rows = []
        for r in results:
            found = rows_of(r)
            if found is None:
                continue
            ns, _, rest = r.target.partition("/")
            counts = {s: 0 for s in sev_cols}
            for sev in found:
                counts[sev if sev in counts else "UNKNOWN"] += 1
            rows.append([ns, rest] + [str(counts[s]) for s in sev_cols])
        if not rows:
            return ""
        return render_table(f"Summary Report ({title})", head, rows)

    parts = [
        section("Misconfigurations",
                lambda r: [m.severity for m in r.misconfigurations]
                if r.misconfigurations or r.misconf_summary else None),
        section("Vulnerabilities",
                lambda r: [v.severity for v in r.vulnerabilities]
                if r.vulnerabilities else None),
        section("Secrets",
                lambda r: [s.severity for s in r.secrets]
                if r.secrets else None),
    ]
    return "\n".join(p for p in parts if p)
