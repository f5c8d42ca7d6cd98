"""A minimal Kubernetes REST client, the port's copy of the JAX
package's k8s/client.py (stdlib urllib over the kubeconfig's
credentials; reference pkg/k8s via trivy-kubernetes): the version, the
node and namespace lists, workload listing across the core, apps and
batch API groups, and the write and log calls of the node collector."""

from __future__ import annotations

import json
import ssl
import urllib.error
import urllib.request

from .kubeconfig import KubeConfig

# kind → (api_prefix, plural); namespaced workloads the scanner walks
WORKLOAD_KINDS = {
    "Pod": ("api/v1", "pods"),
    "Deployment": ("apis/apps/v1", "deployments"),
    "StatefulSet": ("apis/apps/v1", "statefulsets"),
    "DaemonSet": ("apis/apps/v1", "daemonsets"),
    "ReplicaSet": ("apis/apps/v1", "replicasets"),
    "Job": ("apis/batch/v1", "jobs"),
    "CronJob": ("apis/batch/v1", "cronjobs"),
}


class KubeError(RuntimeError):
    def __init__(self, msg: str, code: int = 0):
        super().__init__(msg)
        self.code = code


class KubeClient:
    def __init__(self, cfg: KubeConfig, timeout: float = 20.0):
        self.cfg = cfg
        self.timeout = timeout
        self._ctx = None
        if cfg.server.startswith("https"):
            ctx = ssl.create_default_context(
                cafile=cfg.ca_file or None)
            if cfg.insecure:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if cfg.client_cert_file:
                ctx.load_cert_chain(cfg.client_cert_file,
                                    cfg.client_key_file or None)
            self._ctx = ctx

    def get(self, path: str):
        return self._request("GET", path)

    def version(self) -> dict:
        return self.get("/version")

    def namespaces(self) -> list[str]:
        doc = self.get("/api/v1/namespaces")
        return [item["metadata"]["name"]
                for item in doc.get("items", [])]

    def nodes(self) -> list[dict]:
        return self.get("/api/v1/nodes").get("items", [])

    def list_workloads(self, kind: str, namespace: str = "") -> list[dict]:
        prefix, plural = WORKLOAD_KINDS[kind]
        path = f"/{prefix}/namespaces/{namespace}/{plural}" \
            if namespace else f"/{prefix}/{plural}"
        items = self.get(path).get("items", [])
        for item in items:
            # list items lack apiVersion and kind: restore them for
            # the scanner
            item.setdefault("kind", kind)
            item.setdefault(
                "apiVersion",
                "v1" if prefix == "api/v1" else
                prefix.split("/", 1)[1])
        return items

    # ---- the node collector's writes and logs ------------------------

    def _request(self, method: str, path: str, body=None,
                 raw: bool = False):
        url = self.cfg.server.rstrip("/") + "/" + path.lstrip("/")
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        if self.cfg.token:
            req.add_header("Authorization", f"Bearer {self.cfg.token}")
        req.add_header("Accept", "*/*" if raw else "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout,
                    context=self._ctx) as resp:
                out = resp.read()
                if raw:
                    return out.decode("utf-8", errors="replace")
                return json.loads(out) if out else {}
        except urllib.error.HTTPError as e:
            raise KubeError(f"{method} {path}: HTTP {e.code}",
                            code=e.code) from e
        except (urllib.error.URLError, OSError) as e:
            raise KubeError(f"{method} {path}: {e}") from e

    def create(self, prefix: str, namespace: str, plural: str,
               body: dict) -> dict:
        return self._request(
            "POST", f"/{prefix}/namespaces/{namespace}/{plural}", body)

    def delete(self, prefix: str, namespace: str, plural: str,
               name: str) -> None:
        self._request(
            "DELETE",
            f"/{prefix}/namespaces/{namespace}/{plural}/{name}"
            "?propagationPolicy=Background")

    def pods_by_label(self, namespace: str, selector: str) -> list[dict]:
        import urllib.parse as _p
        return self.get(
            f"/api/v1/namespaces/{namespace}/pods"
            f"?labelSelector={_p.quote(selector)}").get("items", [])

    def pod_logs(self, namespace: str, name: str) -> str:
        return self._request(
            "GET", f"/api/v1/namespaces/{namespace}/pods/{name}/log",
            raw=True)
