"""Kubernetes cluster scanning, the port's copy of the JAX package's k8s/
(reference pkg/k8s and the aquasecurity/trivy-kubernetes client).

A minimal REST client over the kubeconfig's credentials enumerates the
workloads of the core, apps and batch API groups; each workload's spec
goes through the Kubernetes misconfiguration checks, its images are
pulled, analyzed and scanned for vulnerabilities and secrets in one
batched detection (the secret prefilter and the join on the card), and
the node collector's findings and the nodes' kubelet and runtime
components join them (nodes.py). The outputs are the namespace and
resource summaries, the full report, a KBOM and the compliance specs."""

from .client import KubeClient  # noqa: F401
from .kubeconfig import KubeConfig, load_kubeconfig  # noqa: F401
from .scanner import scan_cluster  # noqa: F401
