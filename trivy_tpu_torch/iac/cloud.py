"""Adapted cloud state + AWS checks shared by the CloudFormation and
Terraform scanners.

The reference parses each IaC dialect into one typed cloud-state model
(pkg/iac/adapters → pkg/iac/providers) and evaluates the same rego
policies against it; this module is that shared half.  Resources are
normalized to Terraform resource-type names as the lingua franca, with
each attribute carrying its source range for cause metadata.  Check IDs
and severities follow the published AVD-AWS series (trivy-checks
avd.aquasec.com) so findings line up with the reference."""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from .core import Check


@dataclass
class Attr:
    value: object = None
    rng: tuple = (0, 0)


class Unknown:
    """A value the adapter could not resolve statically (cross-resource
    reference, runtime input).  Checks treat unknowns as passing, the
    same way the reference's rego sees undefined."""

    def __repr__(self):
        return "<unknown>"


UNKNOWN = Unknown()


@dataclass
class CloudResource:
    kind: str                 # terraform-style type, e.g. aws_s3_bucket
    name: str = ""
    attrs: dict = field(default_factory=dict)   # str -> Attr
    rng: tuple = (0, 0)
    path: str = ""            # source file (multi-file terraform modules)

    def get(self, key, default=None):
        a = self.attrs.get(key)
        if a is None or isinstance(a.value, Unknown):
            return default
        return a.value

    def val(self, key, default=None):
        """Raw attribute value — may be Unknown (missing → default)."""
        a = self.attrs.get(key)
        return default if a is None else a.value

    def attr_rng(self, key):
        a = self.attrs.get(key)
        return a.rng if a is not None and a.rng != (0, 0) else self.rng

    def known(self, key) -> bool:
        a = self.attrs.get(key)
        return a is not None and not isinstance(a.value, Unknown)

    def unknown(self, key) -> bool:
        a = self.attrs.get(key)
        return a is not None and isinstance(a.value, Unknown)


def sub_blocks(block, btype):
    """Nested blocks of `btype` inside an HCL block body."""
    return [b for b in block.body.blocks if b.type == btype]


def block_attr(module, block, key, default=None):
    """Evaluate one attribute of a nested block → (value, range).
    Unknown values pass through untouched so checks can treat them the
    way the reference's rego treats undefined — never firing."""
    attrs = module.eval_block_attrs(block)
    if key in attrs:
        return attrs[key]
    return default, (block.start, block.end)


AWS_CHECKS: list[Check] = []


def _aws(id_, title, severity, service, description="", resolution=""):
    def deco(fn):
        AWS_CHECKS.append(Check(
            id=id_, avd_id=id_, title=title, severity=severity,
            description=description, resolution=resolution,
            provider="AWS", service=service,
            namespace=f"builtin.aws.{service}.{id_}", fn=fn))
        return fn
    return deco


def _of(resources, kind):
    return [r for r in resources if r.kind == kind]


def _truthy(v):
    """Fires only on a KNOWN true — Unknown never satisfies a check."""
    if isinstance(v, Unknown):
        return False
    return v is True or v == "true" or v == "True" or v == 1


def _falsy(v):
    """Fires only on a KNOWN false/missing — Unknown passes, the way the
    reference's rego treats undefined values."""
    if isinstance(v, Unknown):
        return False
    return not _truthy(v)


# --- S3 -------------------------------------------------------------

def _pab_check(id_, title, description, resolution, pab_key, fragment):
    """The four S3 public-access-block checks share one body shape."""
    @_aws(id_, title, "HIGH", "s3", description, resolution)
    def check(resources):
        for r in _of(resources, "aws_s3_bucket"):
            if r.unknown("public_access_block"):
                continue
            pab = r.get("public_access_block")
            if pab is None:
                yield (f"Bucket '{r.name}' does not have a corresponding"
                       f" public access block.", r.rng)
            elif _falsy(pab.get(pab_key)):
                yield (f"Public access block for bucket '{r.name}' does "
                       f"not {fragment}",
                       r.attr_rng("public_access_block"))
    return check


_pab_check(
    "AVD-AWS-0086", "S3 Access block should block public ACLs",
    "S3 buckets should block public ACLs on buckets and any objects "
    "they contain.",
    "Enable blocking any PUT calls with a public ACL specified",
    "block_public_acls", "block public ACLs")
_pab_check(
    "AVD-AWS-0087", "S3 Access block should block public policy",
    "S3 bucket policy should have block public policy to prevent users "
    "from putting a policy that enable public access.",
    "Prevent policies that allow public access being PUT",
    "block_public_policy", "block public policies")
_pab_check(
    "AVD-AWS-0091", "S3 Access Block should Ignore Public Acl",
    "S3 buckets should ignore public ACLs on buckets and any objects "
    "they contain.",
    "Enable ignoring the application of public ACLs in PUT calls",
    "ignore_public_acls", "ignore public ACLs")
_pab_check(
    "AVD-AWS-0093", "S3 Access block should restrict public bucket to "
    "limit access",
    "S3 buckets should restrict public policies for the bucket.",
    "Limit the access to public buckets to only the owner or AWS "
    "Services (eg; CloudFront)",
    "restrict_public_buckets", "restrict public buckets")


@_aws("AVD-AWS-0088", "Unencrypted S3 bucket", "HIGH", "s3",
      "S3 Buckets should be encrypted to protect the data that is "
      "stored within them if access is compromised.",
      "Configure bucket encryption")
def _s3_encryption(resources):
    for r in _of(resources, "aws_s3_bucket"):
        if _falsy(r.val("encryption_enabled")):
            yield (f"Bucket '{r.name}' does not have encryption enabled",
                   r.attr_rng("encryption_enabled"))


@_aws("AVD-AWS-0089", "S3 Bucket Logging", "LOW", "s3",
      "Ensures S3 bucket logging is enabled for S3 buckets",
      "Add a logging block to the resource to enable access logging")
def _s3_logging(resources):
    for r in _of(resources, "aws_s3_bucket"):
        if _falsy(r.val("logging_enabled")) and \
                r.get("acl") != "log-delivery-write":
            yield (f"Bucket '{r.name}' does not have logging enabled",
                   r.rng)


@_aws("AVD-AWS-0090", "S3 Data should be versioned", "MEDIUM", "s3",
      "Versioning in Amazon S3 is a means of keeping multiple variants "
      "of an object in the same bucket.",
      "Enable versioning to protect against accidental/malicious "
      "removal or modification")
def _s3_versioning(resources):
    for r in _of(resources, "aws_s3_bucket"):
        if _falsy(r.val("versioning_enabled")):
            yield (f"Bucket '{r.name}' does not have versioning enabled",
                   r.rng)


@_aws("AVD-AWS-0092", "S3 Buckets not publicly accessible through ACL.",
      "HIGH", "s3",
      "Buckets should not have ACLs that allow public access",
      "Don't use canned ACLs or switch to private acl")
def _s3_public_acl(resources):
    for r in _of(resources, "aws_s3_bucket"):
        acl = r.get("acl")
        if acl in ("public-read", "public-read-write",
                   "website", "authenticated-read"):
            yield (f"Bucket '{r.name}' has a public ACL: '{acl}'.",
                   r.attr_rng("acl"))


# --- EC2 / VPC ------------------------------------------------------

def _cidr_public(c):
    c = str(c)
    return c in ("0.0.0.0/0", "::/0", "*")


@_aws("AVD-AWS-0107", "An ingress security group rule allows traffic "
      "from /0", "CRITICAL", "ec2",
      "Opening up ports to connect out to the public internet is "
      "generally to be avoided. You should restrict access to IP "
      "addresses or ranges that are explicitly required where possible.",
      "Set a more restrictive CIDR range")
def _sg_public_ingress(resources):
    for r in _of(resources, "aws_security_group"):
        for rule in r.get("ingress", []):
            for cidr in rule.get("cidrs", []):
                if _cidr_public(cidr):
                    yield (f"Security group rule allows ingress from "
                           f"public internet.", rule.get("rng", r.rng))


@_aws("AVD-AWS-0104", "An egress security group rule allows traffic "
      "to /0", "CRITICAL", "ec2",
      "Opening up ports to connect out to the public internet is "
      "generally to be avoided. You should restrict access to IP "
      "addresses or ranges that are explicitly required where possible.",
      "Set a more restrictive CIDR range")
def _sg_public_egress(resources):
    for r in _of(resources, "aws_security_group"):
        for rule in r.get("egress", []):
            for cidr in rule.get("cidrs", []):
                if _cidr_public(cidr):
                    yield (f"Security group rule allows egress to "
                           f"public internet.", rule.get("rng", r.rng))


@_aws("AVD-AWS-0099", "Missing description for security group.",
      "LOW", "ec2",
      "Security groups should include a description for auditing "
      "purposes.",
      "Add descriptions for all security groups")
def _sg_description(resources):
    for r in _of(resources, "aws_security_group"):
        if not r.get("description"):
            yield (f"Security group '{r.name}' does not have a "
                   f"description.", r.rng)


@_aws("AVD-AWS-0124", "Missing description for security group rule.",
      "LOW", "ec2",
      "Security group rules should include a description for auditing "
      "purposes.",
      "Add descriptions for all security groups rules")
def _sg_rule_description(resources):
    for r in _of(resources, "aws_security_group"):
        for key in ("ingress", "egress"):
            for rule in r.get(key, []):
                if not rule.get("description"):
                    yield ("Security group rule does not have a "
                           "description.", rule.get("rng", r.rng))


@_aws("AVD-AWS-0028", "aws_instance should activate session tokens "
      "for Instance Metadata Service.", "HIGH", "ec2",
      "IMDS v2 (Instance Metadata Service) introduced session "
      "authentication tokens which improve security when talking to "
      "IMDS.",
      "Enable HTTP token requirement for IMDS")
def _imds_tokens(resources):
    for r in _of(resources, "aws_instance"):
        if r.unknown("metadata_options"):
            continue
        mo = r.get("metadata_options")
        if mo is not None:
            tokens = mo.get("http_tokens")
            if isinstance(tokens, Unknown) or tokens == "required" or \
                    mo.get("http_endpoint") == "disabled":
                continue
        yield (f"Instance '{r.name}' does not require IMDS access "
               f"to require a token",
               r.attr_rng("metadata_options"))


@_aws("AVD-AWS-0131", "Instance with unencrypted block device.",
      "HIGH", "ec2",
      "Block devices should be encrypted to ensure sensitive data is "
      "held securely at rest.",
      "Turn on encryption for all block devices")
def _instance_block_device(resources):
    for r in _of(resources, "aws_instance"):
        rbd = r.get("root_block_device")
        if rbd is not None and _falsy(rbd.get("encrypted")):
            yield (f"Instance '{r.name}' root block device is not "
                   f"encrypted.", r.attr_rng("root_block_device"))
        for ebd in r.get("ebs_block_device", []):
            if _falsy(ebd.get("encrypted")):
                yield (f"Instance '{r.name}' EBS block device is not "
                       f"encrypted.", ebd.get("rng", r.rng))


@_aws("AVD-AWS-0026", "EBS volumes must be encrypted", "HIGH", "ebs",
      "By enabling encryption on EBS volumes you protect the volume, "
      "the disk I/O and any derived snapshots from compromise if "
      "intercepted.",
      "Enable encryption of EBS volumes")
def _ebs_encryption(resources):
    for r in _of(resources, "aws_ebs_volume"):
        if _falsy(r.val("encrypted")):
            yield (f"EBS volume '{r.name}' is not encrypted.", r.rng)


# --- RDS ------------------------------------------------------------

@_aws("AVD-AWS-0080", "RDS encryption has not been enabled at a DB "
      "Instance level.", "HIGH", "rds",
      "Encryption should be enabled for an RDS Database instances.",
      "Enable encryption for RDS instances")
def _rds_encryption(resources):
    for r in _of(resources, "aws_db_instance"):
        if _falsy(r.val("storage_encrypted")):
            yield (f"Instance '{r.name}' does not have storage "
                   f"encryption enabled.", r.rng)


@_aws("AVD-AWS-0077", "RDS Cluster and RDS instance should have backup "
      "retention longer than default 1 day", "MEDIUM", "rds",
      "RDS backup retention for clusters defaults to 1 day, this may "
      "not be enough to identify and respond to an issue.",
      "Explicitly set the retention period to greater than the default")
def _rds_backup_retention(resources):
    for kind in ("aws_db_instance", "aws_rds_cluster"):
        for r in _of(resources, kind):
            if r.known("replicate_source_db") or \
                    r.unknown("backup_retention_period"):
                continue
            period = r.get("backup_retention_period", 1)
            try:
                period = int(period)
            except (TypeError, ValueError):
                continue
            if period <= 1:
                yield (f"Instance '{r.name}' has very low backup "
                       f"retention period.",
                       r.attr_rng("backup_retention_period"))


@_aws("AVD-AWS-0180", "RDS Publicly Accessible", "HIGH", "rds",
      "Database resources should not publicly available. You should "
      "limit all access to the minimum that is required for your "
      "application to function.",
      "Set the database to not be publicly accessible")
def _rds_public(resources):
    for r in _of(resources, "aws_db_instance"):
        if _truthy(r.get("publicly_accessible")):
            yield (f"Instance '{r.name}' is exposed publicly.",
                   r.attr_rng("publicly_accessible"))


# --- CloudTrail / EFS / ELB ----------------------------------------

@_aws("AVD-AWS-0014", "Cloudtrail should be enabled in all regions "
      "when managing a trail", "MEDIUM", "cloudtrail",
      "When creating Cloudtrail in the AWS Management Console the trail "
      "is configured by default to be multi-region.",
      "Enable Cloudtrail in all regions")
def _trail_multiregion(resources):
    for r in _of(resources, "aws_cloudtrail"):
        if _falsy(r.val("is_multi_region_trail")):
            yield (f"Trail '{r.name}' is not enabled across all regions.",
                   r.rng)


@_aws("AVD-AWS-0016", "Cloudtrail log validation should be enabled to "
      "prevent tampering of log data", "HIGH", "cloudtrail",
      "Log validation should be activated on Cloudtrail logs to "
      "prevent the tampering of the underlying data in the S3 bucket.",
      "Turn on log validation for Cloudtrail")
def _trail_validation(resources):
    for r in _of(resources, "aws_cloudtrail"):
        if _falsy(r.val("enable_log_file_validation")):
            yield (f"Trail '{r.name}' does not have log validation "
                   f"enabled.", r.rng)


@_aws("AVD-AWS-0015", "Cloudtrail should be encrypted at rest to "
      "secure access to sensitive trail data", "HIGH", "cloudtrail",
      "Cloudtrail logs should be encrypted at rest to secure the "
      "sensitive data. Cloudtrail logs record all activity that occurs "
      "in the the account through API calls.",
      "Enable encryption at rest")
def _trail_cmk(resources):
    for r in _of(resources, "aws_cloudtrail"):
        if not r.unknown("kms_key_id") and \
                not r.get("kms_key_id"):
            yield (f"Trail '{r.name}' does not have a cmk set.", r.rng)


@_aws("AVD-AWS-0037", "EFS Encryption has not been enabled", "HIGH",
      "efs",
      "If your organization is subject to corporate or regulatory "
      "policies that require encryption of data and metadata at rest, "
      "we recommend creating a file system that is encrypted at rest.",
      "Enable encryption for EFS")
def _efs_encryption(resources):
    for r in _of(resources, "aws_efs_file_system"):
        if _falsy(r.val("encrypted")):
            yield (f"File system '{r.name}' is not encrypted.", r.rng)


@_aws("AVD-AWS-0053", "Load balancer is exposed to the internet.",
      "HIGH", "elb",
      "There are many scenarios in which you would want to expose a "
      "load balancer to the wider internet, but this check exists as a "
      "warning to prevent accidental exposure of internal assets.",
      "Switch to an internal load balancer or add a tfsec ignore")
def _elb_public(resources):
    for r in _of(resources, "aws_lb"):
        if r.get("load_balancer_type", "application") == "gateway":
            continue
        if _falsy(r.val("internal")):
            yield (f"Load balancer '{r.name}' is exposed publicly.",
                   r.rng)


@_aws("AVD-AWS-0052", "Load balancers should drop invalid headers",
      "HIGH", "elb",
      "Passing unknown or invalid headers through to the target poses "
      "a potential risk of compromise.",
      "Set drop_invalid_header_fields to true")
def _elb_invalid_headers(resources):
    for r in _of(resources, "aws_lb"):
        if r.get("load_balancer_type", "application") != "application":
            continue
        if _falsy(r.val("drop_invalid_header_fields")):
            yield (f"Application load balancer '{r.name}' is not set to "
                   f"drop invalid headers.", r.rng)


# --- IAM ------------------------------------------------------------

def _policy_docs(r):
    doc = r.get("policy_document")
    if isinstance(doc, str):
        try:
            doc = json.loads(doc)
        except Exception:
            return []
    return [doc] if isinstance(doc, dict) else []


@_aws("AVD-AWS-0057", "IAM policy should avoid use of wildcards and "
      "instead apply the principle of least privilege", "HIGH", "iam",
      "You should use the principle of least privilege when defining "
      "your IAM policies. This means you should specify each exact "
      "permission required without using wildcards, as this could "
      "cause the granting of access to certain undesired actions, "
      "resources and principals.",
      "Specify the exact permissions required, and to which resources "
      "they should apply instead of using wildcards.")
def _iam_wildcards(resources):
    for kind in ("aws_iam_policy", "aws_iam_role_policy",
                 "aws_iam_user_policy", "aws_iam_group_policy"):
        for r in _of(resources, kind):
            for doc in _policy_docs(r):
                stmts = doc.get("Statement", [])
                if isinstance(stmts, dict):
                    stmts = [stmts]
                for stmt in stmts:
                    if not isinstance(stmt, dict) or \
                            stmt.get("Effect", "Allow") != "Allow":
                        continue
                    actions = stmt.get("Action", [])
                    if isinstance(actions, str):
                        actions = [actions]
                    for a in actions:
                        if str(a).strip() == "*" or \
                                str(a).endswith(":*"):
                            yield (f"IAM policy document uses sensitive "
                                   f"action '{a}' on wildcarded resource"
                                   f" '{stmt.get('Resource', '*')}'",
                                   r.attr_rng("policy_document"))
                            break


# --- round-4 breadth: EKS / ECR / KMS / queues / caches / CDN -------

@_aws("AVD-AWS-0038", "EKS clusters should have control plane audit "
      "logging enabled", "MEDIUM", "eks",
      "Audit logs record API requests to the cluster control plane.",
      "Enable all control-plane log types in enabled_cluster_log_types")
def _eks_logging(resources):
    for r in _of(resources, "aws_eks_cluster"):
        if r.unknown("enabled_log_types"):
            continue
        logs = r.get("enabled_log_types") or []
        if any(not isinstance(x, str) for x in logs):
            continue   # an unresolved element could be "audit"
        if "audit" not in logs:
            yield (f"EKS cluster '{r.name}' has control plane audit "
                   f"logging disabled.", r.rng)


@_aws("AVD-AWS-0039", "EKS clusters should have secrets encryption "
      "enabled", "HIGH", "eks",
      "Secrets encryption protects Kubernetes secrets with a KMS key.",
      "Add an encryption_config block with a KMS key.")
def _eks_secrets(resources):
    for r in _of(resources, "aws_eks_cluster"):
        if _falsy(r.val("secrets_encrypted")):
            yield (f"EKS cluster '{r.name}' does not encrypt secrets.",
                   r.rng)


@_aws("AVD-AWS-0040", "EKS cluster endpoint should not be publicly "
      "accessible", "CRITICAL", "eks",
      "A public API endpoint exposes the control plane to the "
      "internet.",
      "Set endpoint_public_access = false or restrict the CIDRs.")
def _eks_public(resources):
    for r in _of(resources, "aws_eks_cluster"):
        if r.unknown("public_access_cidrs"):
            continue
        if _truthy(r.val("endpoint_public_access")) and \
                "0.0.0.0/0" in (r.get("public_access_cidrs") or
                                ["0.0.0.0/0"]):
            yield (f"EKS cluster '{r.name}' has a publicly accessible "
                   f"API endpoint.", r.attr_rng("endpoint_public_access"))


@_aws("AVD-AWS-0030", "ECR repositories should have image scanning "
      "enabled", "HIGH", "ecr",
      "Scan on push surfaces vulnerabilities before images deploy.",
      "Set image_scanning_configuration.scan_on_push = true.")
def _ecr_scanning(resources):
    for r in _of(resources, "aws_ecr_repository"):
        if _falsy(r.val("scan_on_push")):
            yield (f"ECR repository '{r.name}' does not scan images on "
                   f"push.", r.attr_rng("scan_on_push"))


@_aws("AVD-AWS-0031", "ECR repositories should have immutable tags",
      "HIGH", "ecr",
      "Mutable tags allow silently replacing a deployed image.",
      "Set image_tag_mutability = IMMUTABLE.")
def _ecr_immutable(resources):
    for r in _of(resources, "aws_ecr_repository"):
        if r.unknown("image_tag_mutability"):
            continue
        if r.get("image_tag_mutability", "MUTABLE") != "IMMUTABLE":
            yield (f"ECR repository '{r.name}' allows mutable tags.",
                   r.attr_rng("image_tag_mutability"))


@_aws("AVD-AWS-0065", "KMS keys should have rotation enabled", "MEDIUM",
      "kms",
      "Rotation bounds the blast radius of a compromised key.",
      "Set enable_key_rotation = true.")
def _kms_rotation(resources):
    for r in _of(resources, "aws_kms_key"):
        if r.get("key_usage", "ENCRYPT_DECRYPT") != "ENCRYPT_DECRYPT":
            continue  # signing keys cannot rotate
        if _falsy(r.val("enable_key_rotation")):
            yield (f"KMS key '{r.name}' does not have rotation "
                   f"enabled.", r.attr_rng("enable_key_rotation"))


@_aws("AVD-AWS-0096", "SQS queues should be encrypted", "HIGH", "sqs",
      "Queue messages may carry sensitive payloads.",
      "Set kms_master_key_id or sqs_managed_sse_enabled = true.")
def _sqs_encryption(resources):
    for r in _of(resources, "aws_sqs_queue"):
        if r.unknown("kms_master_key_id"):
            continue
        if not r.get("kms_master_key_id") and \
                _falsy(r.val("sqs_managed_sse_enabled")):
            yield (f"SQS queue '{r.name}' is not encrypted.", r.rng)


@_aws("AVD-AWS-0095", "SNS topics should be encrypted", "HIGH", "sns",
      "Topic messages may carry sensitive payloads.",
      "Set kms_master_key_id.")
def _sns_encryption(resources):
    for r in _of(resources, "aws_sns_topic"):
        if r.unknown("kms_master_key_id"):
            continue
        if not r.get("kms_master_key_id"):
            yield (f"SNS topic '{r.name}' is not encrypted.", r.rng)


@_aws("AVD-AWS-0024", "DynamoDB tables should have point-in-time "
      "recovery", "MEDIUM", "dynamodb",
      "PITR protects table data against accidental writes/deletes.",
      "Add a point_in_time_recovery block with enabled = true.")
def _dynamo_pitr(resources):
    for r in _of(resources, "aws_dynamodb_table"):
        if _falsy(r.val("pitr_enabled")):
            yield (f"DynamoDB table '{r.name}' does not have "
                   f"point-in-time recovery.", r.rng)


@_aws("AVD-AWS-0025", "DynamoDB tables should use customer-managed KMS "
      "keys", "LOW", "dynamodb",
      "Customer-managed keys allow rotation and revocation control.",
      "Add server_side_encryption with a kms_key_arn.")
def _dynamo_cmk(resources):
    for r in _of(resources, "aws_dynamodb_table"):
        if r.unknown("sse_kms_key"):
            continue
        if not r.get("sse_kms_key"):
            yield (f"DynamoDB table '{r.name}' is not encrypted with a "
                   f"customer-managed key.", r.rng)


@_aws("AVD-AWS-0010", "CloudFront distributions should have logging "
      "enabled", "MEDIUM", "cloudfront",
      "Access logs are the audit trail for content delivery.",
      "Add a logging_config block.")
def _cf_logging(resources):
    for r in _of(resources, "aws_cloudfront_distribution"):
        if _falsy(r.val("logging_enabled")):
            yield (f"CloudFront distribution '{r.name}' does not have "
                   f"logging enabled.", r.rng)


@_aws("AVD-AWS-0012", "CloudFront distributions should enforce HTTPS",
      "HIGH", "cloudfront",
      "allow-all viewer protocol policy serves content over plain "
      "HTTP.",
      "Set viewer_protocol_policy to redirect-to-https or https-only.")
def _cf_https(resources):
    for r in _of(resources, "aws_cloudfront_distribution"):
        for vp in r.get("viewer_policies", []):
            if vp.get("policy") == "allow-all":
                yield (f"CloudFront distribution '{r.name}' allows "
                       f"plain HTTP.", vp.get("rng", r.rng))


@_aws("AVD-AWS-0013", "CloudFront distributions should use a secure "
      "TLS policy", "HIGH", "cloudfront",
      "Old TLS protocol versions have known weaknesses.",
      "Set minimum_protocol_version to TLSv1.2_2021.")
def _cf_tls(resources):
    for r in _of(resources, "aws_cloudfront_distribution"):
        if r.unknown("minimum_protocol_version"):
            continue
        v = r.get("minimum_protocol_version", "TLSv1")
        if v not in ("TLSv1.2_2021",):
            yield (f"CloudFront distribution '{r.name}' allows TLS "
                   f"below the TLSv1.2_2021 policy.", r.rng)


@_aws("AVD-AWS-0083", "Redshift clusters should be encrypted", "HIGH",
      "redshift",
      "Warehouse data at rest should be encrypted.",
      "Set encrypted = true with a KMS key.")
def _redshift_encrypted(resources):
    for r in _of(resources, "aws_redshift_cluster"):
        if _falsy(r.val("encrypted")):
            yield (f"Redshift cluster '{r.name}' is not encrypted.",
                   r.rng)


@_aws("AVD-AWS-0084", "Redshift clusters should be deployed in a VPC",
      "HIGH", "redshift",
      "EC2-Classic deployment bypasses VPC network controls.",
      "Set cluster_subnet_group_name.")
def _redshift_vpc(resources):
    for r in _of(resources, "aws_redshift_cluster"):
        if r.unknown("subnet_group"):
            continue
        if not r.get("subnet_group"):
            yield (f"Redshift cluster '{r.name}' is not deployed in a "
                   f"VPC.", r.rng)


@_aws("AVD-AWS-0045", "ElastiCache replication groups should be "
      "encrypted at rest", "HIGH", "elasticache",
      "Cache contents may include session and credential data.",
      "Set at_rest_encryption_enabled = true.")
def _elasticache_rest(resources):
    for r in _of(resources, "aws_elasticache_replication_group"):
        if _falsy(r.val("at_rest_encryption_enabled")):
            yield (f"ElastiCache replication group '{r.name}' is not "
                   f"encrypted at rest.", r.rng)


@_aws("AVD-AWS-0046", "ElastiCache replication groups should encrypt "
      "traffic in transit", "HIGH", "elasticache",
      "Unencrypted cache traffic exposes payloads on the network.",
      "Set transit_encryption_enabled = true.")
def _elasticache_transit(resources):
    for r in _of(resources, "aws_elasticache_replication_group"):
        if _falsy(r.val("transit_encryption_enabled")):
            yield (f"ElastiCache replication group '{r.name}' does not "
                   f"encrypt traffic in transit.", r.rng)


@_aws("AVD-AWS-0066", "Lambda functions should have tracing enabled",
      "LOW", "lambda",
      "X-Ray tracing aids incident analysis of function behavior.",
      "Set tracing_config.mode to Active.")
def _lambda_tracing(resources):
    for r in _of(resources, "aws_lambda_function"):
        if r.unknown("tracing_mode"):
            continue
        if r.get("tracing_mode", "PassThrough") != "Active":
            yield (f"Lambda function '{r.name}' does not have tracing "
                   f"enabled.", r.rng)


@_aws("AVD-AWS-0017", "CloudWatch log groups should be encrypted with "
      "a customer-managed key", "LOW", "cloudwatch",
      "CloudWatch log data may contain sensitive information.",
      "Set kms_key_id on the log group.")
def _cloudwatch_cmk(resources):
    for r in _of(resources, "aws_cloudwatch_log_group"):
        if r.unknown("kms_key_id"):
            continue
        if not r.get("kms_key_id"):
            yield (f"Log group '{r.name}' is not encrypted with a "
                   f"customer-managed key.", r.rng)


_SECRET_ENV_RE = re.compile(
    r"(?i)(secret|password|passwd|token|api_?key|"
    r"access_?key(_?id)?|private_?key|credential)")


def _looks_secret_env(name: str) -> bool:
    return bool(_SECRET_ENV_RE.search(name))


@_aws("AVD-AWS-0036", "ECS task definitions should not hold plaintext "
      "secrets", "CRITICAL", "ecs",
      "Environment variables in task definitions are visible to "
      "anyone with read access to the task definition.",
      "Use SSM/Secrets Manager references instead of plaintext "
      "values.")
def _ecs_plain_secrets(resources):
    for r in _of(resources, "aws_ecs_task_definition"):
        if r.unknown("container_definitions"):
            continue
        raw = r.get("container_definitions")
        try:
            defs = json.loads(raw) if isinstance(raw, str) else raw
        except (TypeError, ValueError):
            continue
        for cdef in defs or []:
            if not isinstance(cdef, dict):
                continue
            for env in cdef.get("environment") or []:
                if isinstance(env, dict) and \
                        _looks_secret_env(str(env.get("name", ""))) \
                        and env.get("value"):
                    yield (f"Task definition '{r.name}' holds a "
                           f"plaintext secret in environment variable "
                           f"'{env.get('name')}'.",
                           r.attr_rng("container_definitions"))


@_aws("AVD-AWS-0054", "Load balancer listeners should not use plain "
      "HTTP", "CRITICAL", "elb",
      "Plain HTTP listeners expose traffic on the network.",
      "Use HTTPS (or redirect HTTP to HTTPS) on ALB listeners.")
def _elb_http_listener(resources):
    for r in _of(resources, "aws_lb_listener"):
        if r.unknown("protocol"):
            continue
        if r.get("protocol", "HTTP") != "HTTP":
            continue
        action = r.get("default_action") or {}
        atype = action.get("type")
        rproto = action.get("redirect_protocol")
        if isinstance(atype, Unknown) or isinstance(rproto, Unknown):
            continue  # unresolvable action: never fire
        if atype == "redirect" and str(rproto or "").upper() == "HTTPS":
            continue
        yield (f"Listener '{r.name}' uses plain HTTP.", r.rng)


@_aws("AVD-AWS-0132", "S3 encryption should use a customer-managed "
      "key", "HIGH", "s3",
      "CMKs give rotation and revocation control over bucket data.",
      "Set a KMS key in the bucket's server-side encryption "
      "configuration.")
def _s3_cmk(resources):
    for r in _of(resources, "aws_s3_bucket"):
        if r.unknown("sse_kms_key_id") or r.unknown("sse_algorithm"):
            continue
        if not _truthy(r.val("encryption_enabled")):
            continue  # AVD-AWS-0088 already covers no encryption
        # fire only when the adapter SAW the encryption config: an
        # explicit default-encryption rule without a KMS key, or a
        # live-walked algorithm that isn't aws:kms — a bare
        # "encryption on" marker stays silent
        explicit_no_key = ("sse_kms_key_id" in r.attrs
                           and not r.get("sse_kms_key_id"))
        algo = r.get("sse_algorithm")
        non_kms_algo = algo is not None and \
            "kms" not in str(algo).lower()
        if explicit_no_key or non_kms_algo:
            yield (f"Bucket '{r.name}' does not use a "
                   f"customer-managed key for encryption.", r.rng)


@_aws("AVD-AWS-0033", "ECR repositories should be encrypted with a "
      "customer-managed key", "LOW", "ecr",
      "Image layers may embed proprietary code and secrets.",
      "Set encryption_configuration with encryption_type = KMS.")
def _ecr_cmk(resources):
    for r in _of(resources, "aws_ecr_repository"):
        if r.unknown("encryption_type"):
            continue
        if r.attrs.get("encryption_type") is None:
            continue  # live walker doesn't fetch it; IaC adapters do
        if r.get("encryption_type", "AES256") != "KMS":
            yield (f"ECR repository '{r.name}' is not encrypted with "
                   f"a customer-managed key.", r.rng)


@_aws("AVD-AWS-0034", "ECS clusters should have container insights "
      "enabled", "LOW", "ecs",
      "Container insights surface resource and failure telemetry.",
      "Enable the containerInsights cluster setting.")
def _ecs_insights(resources):
    for r in _of(resources, "aws_ecs_cluster"):
        if r.unknown("container_insights"):
            continue
        if not _truthy(r.val("container_insights")):
            yield (f"ECS cluster '{r.name}' does not have container "
                   f"insights enabled.", r.rng)


@_aws("AVD-AWS-0001", "API Gateway stages should have access logging "
      "enabled", "MEDIUM", "api-gateway",
      "Stage access logs are the audit trail for API traffic.",
      "Configure access_log_settings on every stage.")
def _apigw_logging(resources):
    for r in _of(resources, "aws_api_gateway_stage"):
        if r.unknown("access_log_arn"):
            continue
        if not r.get("access_log_arn"):
            yield (f"API Gateway stage '{r.name}' does not have "
                   f"access logging enabled.", r.rng)


@_aws("AVD-AWS-0162", "CloudTrail trails should be integrated with "
      "CloudWatch Logs", "LOW", "cloudtrail",
      "CloudWatch integration enables near-real-time alerting on "
      "trail events.",
      "Set cloud_watch_logs_group_arn on the trail.")
def _trail_cloudwatch(resources):
    for r in _of(resources, "aws_cloudtrail"):
        if r.unknown("cloud_watch_logs_group_arn"):
            continue
        if not r.get("cloud_watch_logs_group_arn"):
            yield (f"Trail '{r.name}' is not integrated with "
                   f"CloudWatch Logs.", r.rng)


@_aws("AVD-AWS-0178", "VPCs should have flow logging enabled", "MEDIUM",
      "ec2",
      "Flow logs capture IP traffic metadata for forensics.",
      "Create a flow log for every VPC.")
def _vpc_flow_logs(resources):
    for r in _of(resources, "aws_vpc"):
        if _falsy(r.val("flow_logs_enabled")):
            yield (f"VPC '{r.name}' does not have flow logs enabled.",
                   r.rng)


@_aws("AVD-AWS-0173", "Default VPC security groups should restrict "
      "all traffic", "LOW", "ec2",
      "Rules on the default security group invite accidental "
      "exposure.",
      "Remove all rules from default security groups.")
def _default_sg(resources):
    for r in _of(resources, "aws_security_group"):
        if not _truthy(r.val("is_default")):
            continue  # set by the live walker / default-SG adapters
        if r.unknown("ingress") or r.unknown("egress"):
            continue
        if r.get("ingress") or r.get("egress"):
            yield ("Default security group has rules attached.",
                   r.rng)


# --- IAM account hygiene (CIS 1.x; reference trivy-aws iam checks) ---

def _pwpolicy(resources):
    for r in _of(resources, "aws_iam_password_policy"):
        yield r


@_aws("AVD-AWS-0056", "IAM password policy should prevent password "
      "reuse", "MEDIUM", "iam",
      "Reused passwords extend the life of a compromised credential.",
      "Set password_reuse_prevention to 5 or more.")
def _iam_pw_reuse(resources):
    for r in _pwpolicy(resources):
        if r.unknown("reuse_prevention"):
            continue
        if int(r.get("reuse_prevention") or 0) < 5:
            yield ("Password policy allows reusing recent passwords.",
                   r.rng)


@_aws("AVD-AWS-0058", "IAM password policy should require lowercase "
      "characters", "MEDIUM", "iam", "", "Require lowercase letters.")
def _iam_pw_lower(resources):
    for r in _pwpolicy(resources):
        if _falsy(r.val("require_lowercase")):
            yield ("Password policy does not require lowercase "
                   "characters.", r.rng)


@_aws("AVD-AWS-0059", "IAM password policy should require numbers",
      "MEDIUM", "iam", "", "Require numeric characters.")
def _iam_pw_numbers(resources):
    for r in _pwpolicy(resources):
        if _falsy(r.val("require_numbers")):
            yield ("Password policy does not require numbers.", r.rng)


@_aws("AVD-AWS-0060", "IAM password policy should require symbols",
      "MEDIUM", "iam", "", "Require symbol characters.")
def _iam_pw_symbols(resources):
    for r in _pwpolicy(resources):
        if _falsy(r.val("require_symbols")):
            yield ("Password policy does not require symbols.", r.rng)


@_aws("AVD-AWS-0061", "IAM password policy should require uppercase "
      "characters", "MEDIUM", "iam", "", "Require uppercase letters.")
def _iam_pw_upper(resources):
    for r in _pwpolicy(resources):
        if _falsy(r.val("require_uppercase")):
            yield ("Password policy does not require uppercase "
                   "characters.", r.rng)


@_aws("AVD-AWS-0062", "IAM password policy should expire passwords "
      "within 90 days", "MEDIUM", "iam", "",
      "Set max_password_age to 90 or less.")
def _iam_pw_age(resources):
    for r in _pwpolicy(resources):
        if r.unknown("max_age_days"):
            continue
        age = r.get("max_age_days")
        if not age or int(age) > 90:
            yield ("Password policy does not expire passwords within "
                   "90 days.", r.rng)


@_aws("AVD-AWS-0063", "IAM password policy should require a minimum "
      "length of 14", "MEDIUM", "iam", "",
      "Set minimum_password_length to 14 or more.")
def _iam_pw_length(resources):
    for r in _pwpolicy(resources):
        if r.unknown("minimum_length"):
            continue
        if int(r.get("minimum_length") or 0) < 14:
            yield ("Password policy minimum length is below 14.",
                   r.rng)


@_aws("AVD-AWS-0141", "The root account should have no access keys",
      "CRITICAL", "iam",
      "Root access keys grant unrestricted, unauditable API access.",
      "Delete all root access keys.")
def _iam_root_keys(resources):
    for r in _of(resources, "aws_iam_root"):
        if _truthy(r.val("access_keys_present")):
            yield ("The root account has active access keys.", r.rng)


@_aws("AVD-AWS-0142", "The root account should have MFA enabled",
      "CRITICAL", "iam",
      "A compromised root password alone must not grant access.",
      "Enable (hardware) MFA on the root account.")
def _iam_root_mfa(resources):
    for r in _of(resources, "aws_iam_root"):
        if r.unknown("mfa_enabled"):
            continue
        if _falsy(r.val("mfa_enabled")):
            yield ("The root account does not have MFA enabled.",
                   r.rng)


@_aws("AVD-AWS-0143", "IAM policies should be attached to groups or "
      "roles, not users", "LOW", "iam",
      "Per-user policies sprawl and escape review.",
      "Attach policies to groups/roles and add users to groups.")
def _iam_user_policies(resources):
    for r in _of(resources, "aws_iam_user"):
        if r.unknown("attached_policies"):
            continue
        if r.get("attached_policies"):
            yield (f"IAM user '{r.name}' has directly attached "
                   f"policies.", r.rng)


@_aws("AVD-AWS-0144", "Credentials unused for 90 days should be "
      "disabled", "MEDIUM", "iam",
      "Stale credentials widen the attack surface silently.",
      "Disable or remove unused passwords and access keys.")
def _iam_unused_creds(resources):
    for r in _of(resources, "aws_iam_user"):
        pw_days = r.get("password_last_used_days")
        if _truthy(r.val("has_console_password")) and \
                pw_days is not None and int(pw_days) > 90:
            yield (f"IAM user '{r.name}' has a console password "
                   f"unused for more than 90 days.", r.rng)
        for age in (r.get("key_unused_days") or []):
            if isinstance(age, int) and age > 90:
                yield (f"IAM user '{r.name}' has an access key unused "
                       f"for more than 90 days.", r.rng)
                break


@_aws("AVD-AWS-0145", "IAM users with console passwords should have "
      "MFA", "HIGH", "iam",
      "Console access without MFA is one phish away from takeover.",
      "Enable MFA for every console user.")
def _iam_user_mfa(resources):
    for r in _of(resources, "aws_iam_user"):
        if r.unknown("mfa_active"):
            continue
        if _truthy(r.val("has_console_password")) and \
                _falsy(r.val("mfa_active")):
            yield (f"IAM user '{r.name}' has console access without "
                   f"MFA.", r.rng)


@_aws("AVD-AWS-0146", "Access keys should be rotated every 90 days",
      "MEDIUM", "iam",
      "Long-lived keys accumulate exposure.",
      "Rotate access keys at least every 90 days.")
def _iam_key_rotation(resources):
    for r in _of(resources, "aws_iam_user"):
        for age in (r.get("access_key_ages_days") or []):
            if isinstance(age, int) and age > 90:
                yield (f"IAM user '{r.name}' has an access key older "
                       f"than 90 days.", r.rng)
                break


def run_aws_checks(resources, file_type, text):
    """→ (failures, successes) for adapted AWS resources."""
    from .core import run_checks

    def call(check):
        yield from check.fn(resources)

    return run_checks(AWS_CHECKS, file_type, text, call)
