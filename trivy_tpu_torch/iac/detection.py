"""Config file-type detection (reference pkg/iac/detection/detect.go).

Terraform by extension; YAML/JSON sniffed by content for CloudFormation
(Resources with AWS:: types / AWSTemplateFormatVersion) and Kubernetes
(apiVersion+kind), matching the reference's sniffers."""

from __future__ import annotations

import json


def _is_cfn(data) -> bool:
    if not isinstance(data, dict):
        return False
    if "AWSTemplateFormatVersion" in data:
        return True
    res = data.get("Resources")
    if isinstance(res, dict):
        for v in res.values():
            if isinstance(v, dict) and \
                    str(v.get("Type", "")).startswith("AWS::"):
                return True
    return False


def _is_k8s(data) -> bool:
    return isinstance(data, dict) and "apiVersion" in data and \
        "kind" in data


# full YAML/JSON composition is paid only for files that could be IaC:
# bounded size and containing a dialect marker somewhere in the bytes
# (a cheap substring scan, vs. the full position-aware parse)
MAX_SNIFF_SIZE = 3 * 1024 * 1024
_MARKERS = (b"apiVersion", b"AWSTemplateFormatVersion", b"Resources",
            b"planned_values", b"deploymentTemplate.json")


def sniff(path: str, content: bytes):
    """→ (file_type, parsed_docs | None).  The parsed documents are
    forwarded to the scanner so YAML/JSON is composed only once per file
    (the per-file analyzer otherwise pays two full parse passes)."""
    base = path.rsplit("/", 1)[-1].lower()
    if base == "dockerfile" or base.startswith("dockerfile.") or \
            base.endswith(".dockerfile"):
        return "dockerfile", None
    if base.endswith((".tf", ".tf.json")) or \
            base.endswith("terraform.tfvars"):
        return "terraform", None
    if len(content) > MAX_SNIFF_SIZE or \
            not any(m in content for m in _MARKERS):
        return "", None
    if base.endswith((".yaml", ".yml")):
        text = content.decode("utf-8", errors="replace")
        from .yamlpos import load_documents
        docs = load_documents(text)
        for doc in docs:
            if _is_cfn(doc):
                return "cloudformation", docs
            if _is_k8s(doc):
                return "kubernetes", docs
        return "", None
    if base.endswith(".json"):
        try:
            data = json.loads(content.decode("utf-8", errors="replace"))
        except Exception:
            return "", None
        docs = data if isinstance(data, list) else [data]
        for doc in docs:
            if _is_cfn(doc):
                return "cloudformation", docs
            if _is_k8s(doc):
                return "kubernetes", docs
            if _is_tfplan(doc):
                return "terraformplan", docs
            if _is_arm(doc):
                return "azure-arm", docs
        return "", None
    return "", None


def _is_arm(doc) -> bool:
    """ARM deployment template (reference pkg/iac/detection
    FileTypeAzureARM: $schema …/deploymentTemplate.json)."""
    return isinstance(doc, dict) and \
        "deploymentTemplate.json" in str(doc.get("$schema", ""))


def _is_tfplan(doc) -> bool:
    """terraform show -json output (reference pkg/iac/detection
    FileTypeTerraformPlanJSON: format_version + planned values)."""
    return isinstance(doc, dict) and "format_version" in doc and \
        ("planned_values" in doc or "resource_changes" in doc) and \
        "terraform_version" in doc
