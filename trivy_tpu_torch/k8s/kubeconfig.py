"""kubeconfig parsing, the port's copy of the JAX package's
k8s/kubeconfig.py (the reference uses k8s.io/client-go; the same file
schema: clusters, contexts and users with a token, a client certificate
or insecure access)."""

from __future__ import annotations

import base64
import os
import tempfile
from dataclasses import dataclass, field

import yaml


@dataclass
class KubeConfig:
    server: str = ""
    token: str = ""
    ca_file: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    insecure: bool = False
    namespace: str = ""
    temp_files: list = field(default_factory=list)

    def cleanup(self):
        """Remove the inline credentials written to files: key material
        must not outlive the scan."""
        for path in self.temp_files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.temp_files = []


def _inline_to_file(cfg: KubeConfig, data_b64: str, suffix: str) -> str:
    raw = base64.b64decode(data_b64)
    f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    f.write(raw)
    f.close()
    cfg.temp_files.append(f.name)
    return f.name


def load_kubeconfig(path: str = "", context: str = "") -> KubeConfig:
    path = path or os.environ.get("KUBECONFIG", "") or \
        os.path.expanduser("~/.kube/config")
    with open(path, encoding="utf-8") as f:
        doc = yaml.safe_load(f) or {}
    ctx_name = context or doc.get("current-context", "")
    ctx = next((c["context"] for c in doc.get("contexts", [])
                if c.get("name") == ctx_name), None)
    if ctx is None:
        raise ValueError(f"context {ctx_name!r} not found in {path}")
    cluster = next((c["cluster"] for c in doc.get("clusters", [])
                    if c.get("name") == ctx.get("cluster")), {})
    user = next((u["user"] for u in doc.get("users", [])
                 if u.get("name") == ctx.get("user")), {})
    cfg = KubeConfig(
        server=cluster.get("server", ""),
        insecure=bool(cluster.get("insecure-skip-tls-verify")),
        namespace=ctx.get("namespace", ""))
    if cluster.get("certificate-authority"):
        cfg.ca_file = cluster["certificate-authority"]
    elif cluster.get("certificate-authority-data"):
        cfg.ca_file = _inline_to_file(
            cfg, cluster["certificate-authority-data"], ".crt")
    if user.get("token"):
        cfg.token = user["token"]
    elif user.get("tokenFile"):
        with open(user["tokenFile"], encoding="utf-8") as f:
            cfg.token = f.read().strip()
    if user.get("client-certificate"):
        cfg.client_cert_file = user["client-certificate"]
    elif user.get("client-certificate-data"):
        cfg.client_cert_file = _inline_to_file(
            cfg, user["client-certificate-data"], ".crt")
    if user.get("client-key"):
        cfg.client_key_file = user["client-key"]
    elif user.get("client-key-data"):
        cfg.client_key_file = _inline_to_file(
            cfg, user["client-key-data"], ".key")
    return cfg
