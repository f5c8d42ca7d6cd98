"""Node infra assessment, the port's copy of the JAX package's
k8s/nodes.py: the node-collector analog.

Reference counterparts: pkg/k8s/commands/cluster.go:31-40 (the
`--components infra` path runs aquasecurity/node-collector as a Job on
every node through trivy-kubernetes ListArtifactAndNodeInfo) and
pkg/k8s/scanner/scanner.go:272-300 (NodeInfo resources: the kubelet and
container-runtime versions scanned for vulnerabilities, the collected
file permissions and flags run through the CIS node checks).

  collect_node_info  deploys the node-collector image as a Job pinned to
      one node (hostPID and read-only host mounts, the upstream
      manifest's shape), waits for its pod, parses its JSON log
      ({"info": {check: {"values": [...]}}}) and deletes the Job.
  scan_node_infra    evaluates the collected info against the CIS worker
      and master node checks (the KCV series).
  scan_node_vulns    scans every node's kubelet and runtime as
      application packages in ONE detect_many on the scan's
      LocalScanner: one join launch for the cluster's nodes, on the
      table the workload sweep already uploaded.
"""

from __future__ import annotations

import json
import time

from .. import types as T
from .client import KubeClient, KubeError

DEFAULT_COLLECTOR_IMAGE = "ghcr.io/aquasecurity/node-collector:0.3.1"

# (id, title, severity, info key, kind, expected)
# kind: perm  — values[0] must be numerically <= expected (octal)
#       owner — values[0] must equal expected
#       arg   — values[0] must equal expected (flag string)
NODE_CHECKS = [
    ("AVD-KCV-0069", "Kubelet service file permissions are restrictive",
     "HIGH", "kubeletServiceFilePermission", "perm", 0o600),
    ("AVD-KCV-0070", "Kubelet service file is owned by root:root",
     "HIGH", "kubeletServiceFileOwnership", "owner", "root:root"),
    ("AVD-KCV-0071", "Kubeconfig file permissions are restrictive",
     "HIGH", "kubeconfigFileExistsPermissions", "perm", 0o600),
    ("AVD-KCV-0073", "Kubelet config file permissions are restrictive",
     "HIGH", "kubeletConfFilePermissions", "perm", 0o600),
    ("AVD-KCV-0074", "Kubelet config file is owned by root:root",
     "HIGH", "kubeletConfFileOwnership", "owner", "root:root"),
    ("AVD-KCV-0075", "Kubelet anonymous auth is disabled",
     "CRITICAL", "kubeletAnonymousAuthArgumentSet", "arg", "false"),
    ("AVD-KCV-0076", "Kubelet authorization mode is not AlwaysAllow",
     "CRITICAL", "kubeletAuthorizationModeArgumentSet", "not-arg",
     "AlwaysAllow"),
    ("AVD-KCV-0077", "Kubelet client CA file is configured",
     "CRITICAL", "kubeletClientCaFileArgumentSet", "set", None),
    ("AVD-KCV-0078", "Kubelet read-only port is disabled",
     "HIGH", "kubeletReadOnlyPortArgumentSet", "arg", "0"),
    ("AVD-KCV-0079", "Kubelet streaming connection idle timeout is "
     "not disabled", "HIGH",
     "kubeletStreamingConnectionIdleTimeoutArgumentSet", "not-arg",
     "0"),
    ("AVD-KCV-0080", "Kubelet protects kernel defaults",
     "HIGH", "kubeletProtectKernelDefaultsArgumentSet", "arg", "true"),
    ("AVD-KCV-0081", "Kubelet makes iptables util chains",
     "HIGH", "kubeletMakeIptablesUtilChainsArgumentSet", "arg",
     "true"),
    ("AVD-KCV-0082", "Kubelet hostname-override is not set",
     "HIGH", "kubeletHostnameOverrideArgumentSet", "unset", None),
    ("AVD-KCV-0084", "Kubelet rotates client certificates",
     "HIGH", "kubeletRotateCertificatesArgumentSet", "arg", "true"),
    ("AVD-KCV-0085", "Kubelet rotates server certificates",
     "HIGH", "kubeletRotateKubeletServerCertificateArgumentSet",
     "arg", "true"),
    # master-node files (emitted only on control-plane nodes)
    ("AVD-KCV-0048", "API server spec file permissions are restrictive",
     "HIGH", "kubeAPIServerSpecFilePermission", "perm", 0o600),
    ("AVD-KCV-0050", "Controller manager spec file permissions are "
     "restrictive", "HIGH", "kubeControllerManagerSpecFilePermission",
     "perm", 0o600),
    ("AVD-KCV-0052", "Scheduler spec file permissions are restrictive",
     "HIGH", "kubeSchedulerSpecFilePermission", "perm", 0o600),
    ("AVD-KCV-0054", "Etcd spec file permissions are restrictive",
     "HIGH", "kubeEtcdSpecFilePermission", "perm", 0o600),
    ("AVD-KCV-0056", "Etcd data directory permissions are restrictive",
     "HIGH", "kubeEtcdDataDirectoryPermission", "perm", 0o700),
    ("AVD-KCV-0058", "PKI key file permissions are restrictive",
     "CRITICAL", "kubePKIKeyFilePermissions", "perm", 0o600),
]


def _job_manifest(node_name: str, namespace: str, image: str,
                  job_name: str, tolerations=None) -> dict:
    """The upstream node-collector Job shape: pinned to the node,
    hostPID, read-only host mounts of the config/PKI directories."""
    mounts = [
        ("var-lib-kubelet", "/var/lib/kubelet"),
        ("var-lib-etcd", "/var/lib/etcd"),
        ("etc-kubernetes", "/etc/kubernetes"),
        ("etc-systemd", "/etc/systemd"),
        ("lib-systemd", "/lib/systemd"),
        ("etc-cni-netd", "/etc/cni/net.d"),
    ]
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": job_name,
            "namespace": namespace,
            "labels": {"app": "trivy-tpu-node-collector",
                       "trivy-tpu.collector/node":
                           _node_label(node_name)},
        },
        "spec": {
            "backoffLimit": 1,
            "template": {
                "metadata": {
                    "labels": {"app": "trivy-tpu-node-collector",
                               "job-name": job_name},
                },
                "spec": {
                    "nodeName": node_name,
                    "hostPID": True,
                    "restartPolicy": "Never",
                    "tolerations": tolerations or [
                        {"operator": "Exists",
                         "effect": "NoSchedule"}],
                    "containers": [{
                        "name": "node-collector",
                        "image": image,
                        "args": ["k8s"],
                        "securityContext": {"readOnlyRootFilesystem":
                                            True},
                        "volumeMounts": [
                            {"name": n, "mountPath": p,
                             "readOnly": True} for n, p in mounts],
                    }],
                    "volumes": [
                        {"name": n,
                         "hostPath": {"path": p}} for n, p in mounts],
                },
            },
        },
    }


def _truncate_digest(name: str, max_len: int = 63) -> str:
    """Fit a name into a DNS-label/label-value budget: truncate and
    append a sha1[:8] digest of the FULL name so long cloud FQDNs
    sharing a prefix never collide."""
    import hashlib
    digest = hashlib.sha1(name.encode()).hexdigest()[:8]
    return name[:max_len - 9].rstrip("-.") + "-" + digest


def _node_label(node_name: str) -> str:
    """Label-value-safe node identifier (63-char cap). The
    authoritative node is spec.nodeName."""
    if len(node_name) <= 63:
        return node_name
    return _truncate_digest(node_name)


def _job_name(node_name: str) -> str:
    """Collector Job name, unique per node within the DNS label
    limit."""
    return _truncate_digest(f"node-collector-{node_name}")


def collect_node_info(client: KubeClient, node_name: str,
                      namespace: str = "trivy-temp",
                      image: str = DEFAULT_COLLECTOR_IMAGE,
                      timeout: float = 120.0,
                      poll_interval: float = 2.0,
                      tolerations=None) -> dict:
    """Run the collector Job on one node; → the parsed NodeInfo doc."""
    job_name = _job_name(node_name)
    client.create("apis/batch/v1", namespace, "jobs",
                  _job_manifest(node_name, namespace, image, job_name,
                                tolerations))
    try:
        deadline = time.monotonic() + timeout
        while True:
            pods = client.pods_by_label(namespace,
                                        f"job-name={job_name}")
            done = [p for p in pods
                    if p.get("status", {}).get("phase") == "Succeeded"]
            if done:
                name = done[0]["metadata"]["name"]
                out = client.pod_logs(namespace, name)
                try:
                    return json.loads(out)
                except ValueError:
                    raise KubeError(
                        f"node-collector output unparseable on "
                        f"{node_name}")
            # a Failed pod alone is not terminal: backoffLimit permits
            # a retry — only the Job's own Failed condition is final
            failed = [p for p in pods
                      if p.get("status", {}).get("phase") == "Failed"]
            if failed:
                try:
                    job = client.get(
                        f"/apis/batch/v1/namespaces/{namespace}"
                        f"/jobs/{job_name}")
                except KubeError:
                    job = {}
                conds = job.get("status", {}).get("conditions", [])
                if any(c.get("type") == "Failed"
                       and c.get("status") == "True" for c in conds):
                    raise KubeError(
                        f"node-collector failed on {node_name}")
            if time.monotonic() > deadline:
                raise KubeError(
                    f"node-collector timed out on {node_name}")
            time.sleep(poll_interval)
    finally:
        try:
            client.delete("apis/batch/v1", namespace, "jobs", job_name)
        except KubeError:
            pass


def _eval_check(kind, expected, values):
    if not values:
        # an emitted key with no values means "flag absent": that
        # satisfies unset-checks, fails set-checks, says nothing else
        if kind == "unset":
            return True
        if kind == "set":
            return False
        return None
    v = values[0]
    if kind == "perm":
        # the collector reports octal permissions as decimal-looking
        # values (600 means 0o600), whether int or string. Restrictive
        # means NO permission bit outside the allowed mask — a numeric
        # <= compare would pass modes like 577 (world-writable) against
        # 600 (383 < 384)
        try:
            have = int(str(v), 8)
        except (ValueError, TypeError):
            return None
        return (have & ~expected) == 0
    if kind == "owner":
        return v == expected
    if kind == "arg":
        return str(v).lower() == expected
    if kind == "not-arg":
        return str(v) != expected
    if kind == "set":
        return bool(str(v))
    if kind == "unset":
        return not str(v)
    return None


def scan_node_infra(node_info: dict, node_name: str) -> T.Result:
    """NodeInfo doc → Result with CIS node misconfigurations
    (reference scanner.go nodeInfo resources → k8s checks)."""
    info = node_info.get("info", {})
    failures = []
    successes = 0
    for id_, title, severity, key, kind, expected in NODE_CHECKS:
        entry = info.get(key)
        if entry is None:
            continue  # not applicable to this node type
        ok = _eval_check(kind, expected, entry.get("values", []))
        if ok is None:
            continue
        if ok:
            successes += 1
            continue
        m = T.DetectedMisconfiguration(
            type="Kubernetes Security Check",
            id=id_, avd_id=id_, title=title, severity=severity,
            message=f"Node '{node_name}' fails: {title}",
            namespace=f"builtin.kubernetes.{id_}",
            primary_url=("https://avd.aquasec.com/misconfig/"
                         + id_.lower()),
            status="FAIL",
        )
        m.cause_metadata = T.CauseMetadata(
            provider="Kubernetes", service="node")
        failures.append(m)
    return T.Result(
        target=node_name,
        clazz=T.ResultClass.CONFIG,
        type="node-info",
        misconf_summary=T.MisconfSummary(
            successes=successes, failures=len(failures)),
        misconfigurations=sorted(failures, key=lambda m: m.id),
    )


def _sanitize_version(v: str) -> str:
    return v.lstrip("v").split("+", 1)[0] if v else ""


def node_vuln_apps(node: dict) -> list[T.Application]:
    """A node's kubelet + container runtime as applications for the
    shared langpkg detection path (reference scanner.go:275-299)."""
    info = node.get("status", {}).get("nodeInfo", {})
    name = node.get("metadata", {}).get("name", "")
    apps = []
    kubelet = _sanitize_version(info.get("kubeletVersion", ""))
    if kubelet:
        apps.append(T.Application(
            type="kubernetes", file_path=name,
            packages=[T.Package(name="k8s.io/kubelet",
                                version=kubelet)]))
    runtime = info.get("containerRuntimeVersion", "")
    if "://" in runtime:
        rname, rver = runtime.split("://", 1)
        rmap = {"containerd": "github.com/containerd/containerd",
                "cri-o": "github.com/cri-o/cri-o",
                "docker": "github.com/moby/moby"}
        if rname in rmap:
            apps.append(T.Application(
                type="gobinary", file_path=name,
                packages=[T.Package(name=rmap[rname],
                                    version=_sanitize_version(rver))]))
    return apps


def scan_node_vulns(nodes: list[dict], scanner,
                    now=None) -> list[T.Result]:
    """kubelet/runtime vulnerabilities for every node through ONE
    batched dispatch on the caller's LocalScanner (shared device
    table)."""
    units, batches = [], []
    for node in nodes:
        for app in node_vuln_apps(node):
            qs, fin = scanner.langpkg.prepare_app(app)
            units.append((app, fin))
            batches.append(qs)
    if not batches:
        return []
    hit_lists = scanner.detector.detect_many(batches)
    out = []
    for (app, fin), hits in zip(units, hit_lists):
        vulns = fin(hits)
        if not vulns:
            continue
        out.append(scanner._vuln_result(
            vulns, target=app.file_path,
            clazz=T.ResultClass.LANG_PKGS, rtype=app.type,
            packages=app.packages, options=T.ScanOptions()))
    return sorted(out, key=lambda r: (r.target, r.type))


def node_excluded(node: dict, exclude_labels: dict) -> bool:
    """--exclude-nodes label=value pairs (reference
    trivyk8s.WithIgnoreLabels)."""
    labels = node.get("metadata", {}).get("labels", {})
    return any(labels.get(k) == v for k, v in exclude_labels.items())


def scan_infra(client: KubeClient, table=None, scanner=None,
               namespace: str = "trivy-temp",
               image: str = "", exclude_labels=None,
               scanners: tuple = ("misconfig",),
               collect=None, now=None) -> list[T.Result]:
    """The `--components infra` sweep: run the collector on every
    (non-excluded) node for CIS misconfigurations, and scan node
    kubelet/runtime components for vulnerabilities. Per-node collector
    failures degrade to a warning, like the reference's per-resource
    error artifacts."""
    from ..log import logger

    collect = collect or collect_node_info
    results: list[T.Result] = []
    nodes = []
    try:
        nodes = client.nodes()
    except KubeError as e:
        logger.warning("node enumeration failed: %s", e)
        return results
    nodes = [n for n in nodes
             if not node_excluded(n, exclude_labels or {})]
    if "misconfig" in scanners:
        for node in nodes:
            name = node.get("metadata", {}).get("name", "")
            try:
                info = collect(client, name, namespace=namespace,
                               image=image or DEFAULT_COLLECTOR_IMAGE)
            except KubeError as e:
                logger.warning("node collector on %s: %s", name, e)
                continue
            results.append(scan_node_infra(info, name))
    if "vuln" in scanners and scanner is not None:
        results += scan_node_vulns(nodes, scanner, now=now)
    return results
