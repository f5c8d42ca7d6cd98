"""CloudFormation template scanner (reference
pkg/iac/scanners/cloudformation + adapters/cloudformation).

Parses YAML (with intrinsic short forms) or JSON templates, resolves
Ref/Sub/Join against parameter defaults, adapts resources into the
shared cloud-state model, and runs the AVD-AWS checks."""

from __future__ import annotations

import json
import re

from .cloud import UNKNOWN, Attr, CloudResource, Unknown, run_aws_checks
from .yamlpos import PosDict, load_documents, value_range


def _params(template):
    out = {}
    params = template.get("Parameters")
    if isinstance(params, dict):
        for name, spec in params.items():
            if isinstance(spec, dict) and "Default" in spec:
                out[name] = spec["Default"]
    return out


_SUB_RE = re.compile(r"\$\{([^}]+)\}")


def _resolve(value, params, depth=0):
    """Evaluate CFN intrinsics to a concrete value or UNKNOWN."""
    if depth > 20:
        # self-referential parameter defaults (P: {Default: !Ref P})
        return UNKNOWN
    if isinstance(value, dict) and len(value) == 1:
        (key, arg), = value.items()
        if key == "Ref":
            if arg in params:
                return _resolve(params[arg], params, depth + 1)
            if isinstance(arg, str) and arg.startswith("AWS::"):
                return {"AWS::Region": "us-east-1",
                        "AWS::Partition": "aws",
                        "AWS::AccountId": "123456789012"}.get(arg, UNKNOWN)
            return UNKNOWN
        if key == "Fn::Sub":
            tmpl = arg[0] if isinstance(arg, list) and arg else arg
            if not isinstance(tmpl, str):
                return UNKNOWN
            ok = True

            def rep(m):
                nonlocal ok
                v = _resolve({"Ref": m.group(1)}, params, depth + 1)
                if isinstance(v, Unknown):
                    ok = False
                    return ""
                return str(v)
            out = _SUB_RE.sub(rep, tmpl)
            return out if ok else UNKNOWN
        if key == "Fn::Join":
            if isinstance(arg, list) and len(arg) == 2 and \
                    isinstance(arg[1], list):
                parts = [_resolve(p, params, depth + 1) for p in arg[1]]
                if all(not isinstance(p, Unknown) for p in parts):
                    return str(arg[0]).join(str(p) for p in parts)
            return UNKNOWN
        if key == "Condition" or key.startswith("Fn::"):
            # GetAtt/ImportValue/If/Select/FindInMap/... — not statically
            # resolvable here; unknown passes checks like rego undefined
            return UNKNOWN
    if isinstance(value, dict):
        return {k: _resolve(v, params, depth + 1)
                for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, params, depth + 1) for v in value]
    return value


_ACL_MAP = {
    "Private": "private", "PublicRead": "public-read",
    "PublicReadWrite": "public-read-write",
    "AuthenticatedRead": "authenticated-read",
    "LogDeliveryWrite": "log-delivery-write",
    "BucketOwnerRead": "bucket-owner-read",
    "BucketOwnerFullControl": "bucket-owner-full-control",
    "AwsExecRead": "aws-exec-read",
}


def _rng_of(resources_node, logical_id, props, key=None):
    if key is not None and isinstance(props, PosDict):
        r = value_range(props, key)
        if r != (0, 0):
            return r
    if isinstance(resources_node, PosDict):
        return value_range(resources_node, logical_id)
    return (0, 0)


def _sg_rules(props, key, params, res_rng):
    rules = []
    raw = props.get(key)
    if not isinstance(raw, list):
        return rules
    for i, rule in enumerate(raw):
        if not isinstance(rule, dict):
            continue
        rng = value_range(raw, i) if hasattr(raw, "item_lines") \
            else res_rng
        cidrs = []
        for ck in ("CidrIp", "CidrIpv6"):
            v = _resolve(rule.get(ck), params)
            if v is not None and not isinstance(v, Unknown):
                cidrs.append(v)
        rules.append({"cidrs": cidrs,
                      "description": _resolve(rule.get("Description"),
                                              params) or "",
                      "rng": rng})
    return rules


def adapt_cloudformation(template) -> list[CloudResource]:
    """CFN Resources → normalized CloudResource list."""
    params = _params(template)
    resources_node = template.get("Resources")
    if not isinstance(resources_node, dict):
        return []
    out = []
    for logical_id, body in resources_node.items():
        if not isinstance(body, dict):
            continue
        rtype = body.get("Type", "")
        props = body.get("Properties") or {}
        if not isinstance(props, dict):
            props = {}
        res_rng = _rng_of(resources_node, logical_id, None)

        def attr(key, norm=None, default_missing=None):
            """Adapt props[key] → Attr (resolved via intrinsics)."""
            if key not in props:
                return None
            v = _resolve(props[key], params)
            if norm is not None and not isinstance(v, Unknown):
                v = norm(v)
            return Attr(v, _rng_of(resources_node, logical_id, props, key))

        def put(res, name, a):
            if a is not None:
                res.attrs[name] = a

        if rtype == "AWS::S3::Bucket":
            r = CloudResource("aws_s3_bucket", logical_id, rng=res_rng)
            put(r, "acl", attr("AccessControl",
                               lambda v: _ACL_MAP.get(str(v), str(v))))
            if "BucketEncryption" in props:
                r.attrs["encryption_enabled"] = Attr(
                    True, _rng_of(resources_node, logical_id, props,
                                  "BucketEncryption"))
            vc = _resolve(props.get("VersioningConfiguration"), params)
            if isinstance(vc, dict):
                r.attrs["versioning_enabled"] = Attr(
                    vc.get("Status") == "Enabled",
                    _rng_of(resources_node, logical_id, props,
                            "VersioningConfiguration"))
            if "LoggingConfiguration" in props:
                r.attrs["logging_enabled"] = Attr(True)
            pab = _resolve(props.get("PublicAccessBlockConfiguration"),
                           params)
            pab_rng = _rng_of(resources_node, logical_id, props,
                              "PublicAccessBlockConfiguration")
            if isinstance(pab, dict):
                r.attrs["public_access_block"] = Attr({
                    "block_public_acls": pab.get("BlockPublicAcls"),
                    "block_public_policy": pab.get("BlockPublicPolicy"),
                    "ignore_public_acls": pab.get("IgnorePublicAcls"),
                    "restrict_public_buckets":
                        pab.get("RestrictPublicBuckets"),
                }, pab_rng)
            elif isinstance(pab, Unknown):
                r.attrs["public_access_block"] = Attr(UNKNOWN, pab_rng)
            out.append(r)

        elif rtype == "AWS::EC2::SecurityGroup":
            r = CloudResource("aws_security_group", logical_id,
                              rng=res_rng)
            put(r, "description", attr("GroupDescription"))
            r.attrs["ingress"] = Attr(_sg_rules(
                props, "SecurityGroupIngress", params, res_rng))
            r.attrs["egress"] = Attr(_sg_rules(
                props, "SecurityGroupEgress", params, res_rng))
            out.append(r)

        elif rtype == "AWS::EC2::Instance":
            r = CloudResource("aws_instance", logical_id, rng=res_rng)
            mo = _resolve(props.get("MetadataOptions"), params)
            mo_rng = _rng_of(resources_node, logical_id, props,
                             "MetadataOptions")
            if isinstance(mo, dict):
                r.attrs["metadata_options"] = Attr({
                    "http_tokens": mo.get("HttpTokens"),
                    "http_endpoint": mo.get("HttpEndpoint"),
                }, mo_rng)
            elif isinstance(mo, Unknown):
                r.attrs["metadata_options"] = Attr(UNKNOWN, mo_rng)
            bdm = _resolve(props.get("BlockDeviceMappings"), params)
            ebs_devices = []
            if isinstance(bdm, list):
                for m in bdm:
                    if isinstance(m, dict) and isinstance(
                            m.get("Ebs"), dict):
                        ebs_devices.append({
                            "encrypted": m["Ebs"].get("Encrypted"),
                            "rng": _rng_of(resources_node, logical_id,
                                           props, "BlockDeviceMappings")})
            if ebs_devices:
                # CFN has no root/extra split; treat first as root
                r.attrs["root_block_device"] = Attr(
                    ebs_devices[0],
                    _rng_of(resources_node, logical_id, props,
                            "BlockDeviceMappings"))
                r.attrs["ebs_block_device"] = Attr(ebs_devices[1:])
            out.append(r)

        elif rtype == "AWS::EC2::Volume":
            r = CloudResource("aws_ebs_volume", logical_id, rng=res_rng)
            put(r, "encrypted", attr("Encrypted"))
            out.append(r)

        elif rtype == "AWS::RDS::DBInstance":
            r = CloudResource("aws_db_instance", logical_id, rng=res_rng)
            put(r, "storage_encrypted", attr("StorageEncrypted"))
            put(r, "backup_retention_period",
                attr("BackupRetentionPeriod"))
            put(r, "publicly_accessible", attr("PubliclyAccessible"))
            put(r, "replicate_source_db",
                attr("SourceDBInstanceIdentifier"))
            out.append(r)

        elif rtype == "AWS::EFS::FileSystem":
            r = CloudResource("aws_efs_file_system", logical_id,
                              rng=res_rng)
            put(r, "encrypted", attr("Encrypted"))
            out.append(r)

        elif rtype == "AWS::CloudTrail::Trail":
            r = CloudResource("aws_cloudtrail", logical_id, rng=res_rng)
            put(r, "is_multi_region_trail", attr("IsMultiRegionTrail"))
            put(r, "enable_log_file_validation",
                attr("EnableLogFileValidation"))
            put(r, "kms_key_id", attr("KMSKeyId"))
            put(r, "cloud_watch_logs_group_arn",
                attr("CloudWatchLogsLogGroupArn"))
            out.append(r)

        elif rtype == "AWS::ElasticLoadBalancingV2::LoadBalancer":
            r = CloudResource("aws_lb", logical_id, rng=res_rng)
            scheme = _resolve(props.get("Scheme"), params)
            if scheme is not None:
                r.attrs["internal"] = Attr(
                    UNKNOWN if isinstance(scheme, Unknown)
                    else scheme == "internal",
                    _rng_of(resources_node, logical_id, props, "Scheme"))
            put(r, "load_balancer_type", attr("Type"))
            attrs_list = _resolve(props.get("LoadBalancerAttributes"),
                                  params)
            if isinstance(attrs_list, list):
                for a in attrs_list:
                    if isinstance(a, dict) and a.get("Key") == \
                            "routing.http.drop_invalid_header_fields." \
                            "enabled":
                        r.attrs["drop_invalid_header_fields"] = Attr(
                            str(a.get("Value")).lower() == "true")
            out.append(r)

        elif rtype in ("AWS::IAM::Policy", "AWS::IAM::ManagedPolicy"):
            r = CloudResource("aws_iam_policy", logical_id, rng=res_rng)
            put(r, "policy_document", attr("PolicyDocument"))
            out.append(r)

        elif rtype == "AWS::EKS::Cluster":
            r = CloudResource("aws_eks_cluster", logical_id,
                              rng=res_rng)
            logging = _resolve(props.get("Logging"), params)
            if isinstance(logging, Unknown):
                r.attrs["enabled_log_types"] = Attr(UNKNOWN)
            elif isinstance(logging, dict):
                types = []
                cl = logging.get("ClusterLogging")
                if isinstance(cl, dict):
                    for entry in cl.get("EnabledTypes") or []:
                        if isinstance(entry, dict):
                            # unresolved Type stays non-str so the
                            # audit check's element guard skips it
                            types.append(entry.get("Type"))
                r.attrs["enabled_log_types"] = Attr(types)
            enc = _resolve(props.get("EncryptionConfig"), params)
            if isinstance(enc, Unknown):
                r.attrs["secrets_encrypted"] = Attr(UNKNOWN)
            elif isinstance(enc, list):
                encrypted = any(
                    isinstance(e, dict) and
                    "SECRETS" in [str(x).upper() for x in
                                  (e.get("Resources") or [])]
                    for e in enc)
                r.attrs["secrets_encrypted"] = Attr(encrypted)
            vpc = _resolve(props.get("ResourcesVpcConfig"), params)
            # AWS default: the endpoint is public
            pub = True
            if isinstance(vpc, Unknown):
                pub = UNKNOWN
            elif isinstance(vpc, dict):
                pub = vpc.get("EndpointPublicAccess", True)
                cidrs = vpc.get("PublicAccessCidrs")
                if isinstance(cidrs, Unknown) or (
                        isinstance(cidrs, list) and
                        any(not isinstance(c, str) for c in cidrs)):
                    r.attrs["public_access_cidrs"] = Attr(UNKNOWN)
                elif isinstance(cidrs, list):
                    r.attrs["public_access_cidrs"] = Attr(cidrs)
            r.attrs["endpoint_public_access"] = Attr(pub)
            out.append(r)

        elif rtype == "AWS::ECR::Repository":
            r = CloudResource("aws_ecr_repository", logical_id,
                              rng=res_rng)
            scan_cfg = _resolve(props.get("ImageScanningConfiguration"),
                                params)
            if isinstance(scan_cfg, Unknown):
                r.attrs["scan_on_push"] = Attr(UNKNOWN)
            elif isinstance(scan_cfg, dict):
                # raw value: _truthy/_falsy handle string booleans
                r.attrs["scan_on_push"] = Attr(
                    scan_cfg.get("ScanOnPush"))
            put(r, "image_tag_mutability", attr("ImageTagMutability"))
            out.append(r)

        elif rtype == "AWS::KMS::Key":
            r = CloudResource("aws_kms_key", logical_id, rng=res_rng)
            put(r, "enable_key_rotation", attr("EnableKeyRotation"))
            put(r, "key_usage", attr("KeyUsage"))
            out.append(r)

        elif rtype == "AWS::SQS::Queue":
            r = CloudResource("aws_sqs_queue", logical_id, rng=res_rng)
            put(r, "kms_master_key_id", attr("KmsMasterKeyId"))
            put(r, "sqs_managed_sse_enabled", attr("SqsManagedSseEnabled"))
            out.append(r)

        elif rtype == "AWS::SNS::Topic":
            r = CloudResource("aws_sns_topic", logical_id, rng=res_rng)
            put(r, "kms_master_key_id", attr("KmsMasterKeyId"))
            out.append(r)

        elif rtype == "AWS::DynamoDB::Table":
            r = CloudResource("aws_dynamodb_table", logical_id,
                              rng=res_rng)
            pitr = _resolve(
                props.get("PointInTimeRecoverySpecification"), params)
            if isinstance(pitr, Unknown):
                r.attrs["pitr_enabled"] = Attr(UNKNOWN)
            else:
                r.attrs["pitr_enabled"] = Attr(
                    pitr.get("PointInTimeRecoveryEnabled")
                    if isinstance(pitr, dict) else False)
            sse = _resolve(props.get("SSESpecification"), params)
            if isinstance(sse, Unknown):
                r.attrs["sse_kms_key"] = Attr(UNKNOWN)
            else:
                r.attrs["sse_kms_key"] = Attr(
                    sse.get("KMSMasterKeyId", "")
                    if isinstance(sse, dict) else "")
            out.append(r)

        elif rtype == "AWS::Redshift::Cluster":
            r = CloudResource("aws_redshift_cluster", logical_id,
                              rng=res_rng)
            put(r, "encrypted", attr("Encrypted"))
            put(r, "subnet_group", attr("ClusterSubnetGroupName"))
            out.append(r)

        elif rtype == "AWS::ElastiCache::ReplicationGroup":
            r = CloudResource("aws_elasticache_replication_group",
                              logical_id, rng=res_rng)
            put(r, "at_rest_encryption_enabled",
                attr("AtRestEncryptionEnabled"))
            put(r, "transit_encryption_enabled",
                attr("TransitEncryptionEnabled"))
            out.append(r)

        elif rtype == "AWS::Lambda::Function":
            r = CloudResource("aws_lambda_function", logical_id,
                              rng=res_rng)
            tracing = _resolve(props.get("TracingConfig"), params)
            if isinstance(tracing, Unknown):
                r.attrs["tracing_mode"] = Attr(UNKNOWN)
            else:
                r.attrs["tracing_mode"] = Attr(
                    tracing.get("Mode", "PassThrough")
                    if isinstance(tracing, dict) else "PassThrough")
            out.append(r)

    return out


def scan_cloudformation(path: str, content: bytes, lines=None,
                        docs=None) -> tuple[list, int]:
    text = content.decode("utf-8", errors="replace")
    if docs is None:
        if path.endswith(".json"):
            try:
                template = json.loads(text)
            except Exception:
                return [], 0
            docs = [template]
        else:
            docs = load_documents(text)
    resources = []
    for doc in docs:
        if isinstance(doc, dict) and isinstance(doc.get("Resources"),
                                                dict):
            resources.extend(adapt_cloudformation(doc))
    if not resources:
        return [], 0
    return run_aws_checks(resources, "cloudformation", text)
