"""AWS account scanning, the port's copy of the JAX package's
cloud/aws.py (reference pkg/cloud/aws).

The client half: sigv4-signed requests, credentials from the arguments
or the AWS_* environment, an endpoint that an emulator can take over,
and the SDK's retries on throttling and server errors. The EBS snapshot
source of `vm` (fanal/vm.py EBSDevice) reads through it.

The account half: walkers over the live APIs that adapt each service's
responses into the shared cloud-state model (iac/cloud.CloudResource),
a cache of the adapted state per account and region in the JAX
package's file format (pkg/cloud/aws/cache/cache.go), so either package
reads the other's file, and `scan_account`, which evaluates the AVD-AWS
checks of the terraform and cloudformation scanners over that state, as
the reference reuses its iac rules over live accounts
(pkg/cloud/aws/scanner/scanner.go:29). Nothing here touches a device.

Services covered: s3, ec2 (security groups, instances, VPC flow logs),
ebs, rds, cloudtrail, efs, elb (v2), iam (customer-managed policies,
the account password policy, the root summary, per-user credential
hygiene), cloudfront, dynamodb, ecr, ecs, eks, kms, lambda, sns, sqs,
elasticache, redshift, api-gateway, and sts (account discovery).
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET

from .. import types as T
from ..iac.cloud import Attr, AWS_CHECKS, CloudResource
from ..iac.core import build_misconf
from ..log import logger
from .sigv4 import sign

SUPPORTED_SERVICES = ["s3", "ec2", "ebs", "rds", "cloudtrail",
                      "efs", "elb", "iam", "cloudfront", "dynamodb",
                      "ecr", "ecs", "eks", "kms", "lambda", "sns",
                      "sqs", "elasticache", "redshift", "api-gateway"]
# v2: cloudtrail carries cloud_watch_logs_group_arn; ec2 emits aws_vpc
# and the security group's is_default, so older caches must not load
CACHE_VERSION = 2


class AWSError(Exception):
    pass


class AWSClient:
    def __init__(self, region: str = "us-east-1", endpoint: str = "",
                 access_key: str = "", secret_key: str = "",
                 session_token: str = "", timeout: float = 30.0):
        self.region = region or "us-east-1"
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key or os.environ.get(
            "AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get(
            "AWS_SESSION_TOKEN", "")
        self.timeout = timeout
        if not self.access_key or not self.secret_key:
            raise AWSError(
                "AWS credentials not found (AWS_ACCESS_KEY_ID / "
                "AWS_SECRET_ACCESS_KEY)")

    def _service_url(self, service: str) -> str:
        if self.endpoint:
            return self.endpoint
        return f"https://{service}.{self.region}.amazonaws.com"

    def request(self, service: str, method: str = "GET", path: str = "/",
                query: dict | None = None, body: bytes = b"",
                headers: dict | None = None) -> bytes:
        query = query or {}
        url = self._service_url(service)
        parsed = urllib.parse.urlparse(url)
        signed = sign(method, parsed.netloc, path, query,
                      headers or {}, body, service, self.region,
                      self.access_key, self.secret_key,
                      self.session_token)
        qs = urllib.parse.urlencode(sorted(query.items()))
        full = f"{url}{path}" + (f"?{qs}" if qs else "")
        # throttling and transient server errors retry with backoff, as
        # the reference's SDK does
        last: Exception | None = None
        for attempt in range(3):
            req = urllib.request.Request(full, data=body or None,
                                         method=method, headers=signed)
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                detail = e.read()[:200]
                last = AWSError(
                    f"{service} {path}: HTTP {e.code}: {detail!r}")
                last.__cause__ = e
                if e.code not in (429, 500, 502, 503) and \
                        b"Throttling" not in detail:
                    raise last
            except Exception as e:
                raise AWSError(
                    f"{service} request failed: {e}") from e
            if attempt < 2:
                time.sleep(0.2 * (attempt + 1))
        raise last


def _xml(data: bytes) -> ET.Element:
    root = ET.fromstring(data)
    # strip namespaces for painless findall
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


def _txt(el, path, default=""):
    found = el.find(path)
    if found is None or not found.text:
        return default
    return found.text.strip() or default


# ---- service walkers → CloudResource state ---------------------------

def walk_s3(client: AWSClient) -> list[CloudResource]:
    out = []
    root = _xml(client.request("s3"))
    for b in root.findall(".//Bucket"):
        name = _txt(b, "Name")
        if not name:
            continue
        r = CloudResource("aws_s3_bucket", name)
        r.attrs["arn"] = Attr(f"arn:aws:s3:::{name}")
        for call, key in (
                ("versioning", "versioning"),
                ("logging", "logging"),
                ("encryption", "encryption"),
                ("publicAccessBlock", "public_access_block"),
                ("acl", "acl")):
            try:
                data = client.request("s3", path=f"/{name}",
                                      query={call: ""})
            except AWSError:
                continue
            doc = _xml(data)
            if call == "versioning":
                r.attrs["versioning_enabled"] = Attr(
                    _txt(doc, "Status") == "Enabled")
            elif call == "logging":
                r.attrs["logging_enabled"] = Attr(
                    doc.find(".//LoggingEnabled") is not None)
            elif call == "encryption":
                algo = _txt(doc, ".//SSEAlgorithm")
                r.attrs["encryption_enabled"] = Attr(bool(algo))
                r.attrs["sse_algorithm"] = Attr(algo)
            elif call == "publicAccessBlock":
                r.attrs["public_access_block"] = Attr({
                    "block_public_acls":
                        _txt(doc, ".//BlockPublicAcls") == "true",
                    "block_public_policy":
                        _txt(doc, ".//BlockPublicPolicy") == "true",
                    "ignore_public_acls":
                        _txt(doc, ".//IgnorePublicAcls") == "true",
                    "restrict_public_buckets":
                        _txt(doc, ".//RestrictPublicBuckets") == "true",
                })
            elif call == "acl":
                grants = []
                for g in doc.findall(".//Grant"):
                    uri = _txt(g, ".//URI")
                    perm = _txt(g, "Permission")
                    grants.append({"uri": uri, "permission": perm})
                public = any("AllUsers" in g["uri"] for g in grants)
                r.attrs["acl"] = Attr(
                    "public-read" if public else "private")
        out.append(r)
    return out


def walk_ec2(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "ec2", "DescribeSecurityGroups",
                            "2016-11-15"):
        out += _parse_sgs(doc)
    return out


def _parse_sgs(doc) -> list[CloudResource]:
    out = []
    for item in doc.findall(".//securityGroupInfo/item"):
        name = _txt(item, "groupName")
        r = CloudResource("aws_security_group", name)
        r.attrs["is_default"] = Attr(name == "default")
        r.attrs["description"] = Attr(_txt(item, "groupDescription"))
        ingress = []
        for perm in item.findall("ipPermissions/item"):
            for ip in perm.findall("ipRanges/item"):
                ingress.append({
                    "cidrs": [_txt(ip, "cidrIp")],
                    "description": _txt(ip, "description"),
                    "from_port": int(_txt(perm, "fromPort", "0") or 0),
                    "to_port": int(_txt(perm, "toPort", "0") or 0),
                })
        egress = []
        for perm in item.findall("ipPermissionsEgress/item"):
            for ip in perm.findall("ipRanges/item"):
                egress.append({
                    "cidrs": [_txt(ip, "cidrIp")],
                    "description": _txt(ip, "description"),
                })
        r.attrs["ingress"] = Attr(ingress)
        r.attrs["egress"] = Attr(egress)
        out.append(r)
    return out


def _query_api(client: AWSClient, service: str, action: str,
               version: str, extra: dict | None = None) -> ET.Element:
    """AWS query-protocol POST (ec2/rds/elbv2/iam style) → XML root."""
    fields = {"Action": action, "Version": version}
    fields.update(extra or {})
    body = urllib.parse.urlencode(fields).encode()
    return _xml(client.request(
        service, method="POST", body=body,
        headers={"content-type":
                 "application/x-www-form-urlencoded; charset=utf-8"}))


_MAX_PAGES = 100


def _paged_query(client: AWSClient, service: str, action: str,
                 version: str, extra: dict | None = None,
                 req_token: str = "NextToken",
                 resp_paths: tuple = (".//nextToken",)):
    """Yield every page of a query-protocol listing. Resources beyond
    the first page would otherwise be silently dropped — and then
    cached as complete account state for the TTL."""
    fields = dict(extra or {})
    for _ in range(_MAX_PAGES):
        doc = _query_api(client, service, action, version, fields)
        yield doc
        token = ""
        for p in resp_paths:
            token = _txt(doc, p)
            if token:
                break
        if not token:
            return
        fields[req_token] = token
    # a silent stop here would cache a truncated listing as complete
    logger.warning("aws %s %s: pagination stopped after %d pages; "
                   "listing may be incomplete", service, action,
                   _MAX_PAGES)


def walk_ec2_instances(client: AWSClient) -> list[CloudResource]:
    """DescribeInstances → aws_instance state (IMDSv2, root/EBS
    encryption feed the shared AVD-AWS checks)."""
    out = []
    for doc in _paged_query(client, "ec2", "DescribeInstances",
                            "2016-11-15"):
        out += _parse_instances(doc)
    return out


def _parse_instances(doc) -> list[CloudResource]:
    out = []
    for item in doc.findall(".//reservationSet/item/instancesSet/item"):
        iid = _txt(item, "instanceId")
        r = CloudResource("aws_instance", iid)
        mo = item.find("metadataOptions")
        if mo is not None:
            r.attrs["metadata_options"] = Attr({
                "http_tokens": _txt(mo, "httpTokens", "optional"),
                "http_endpoint": _txt(mo, "httpEndpoint", "enabled"),
            })
        out.append(r)
    return out


def walk_ebs(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "ec2", "DescribeVolumes",
                            "2016-11-15"):
        out += _parse_volumes(doc)
    return out


def _parse_volumes(doc) -> list[CloudResource]:
    out = []
    for item in doc.findall(".//volumeSet/item"):
        r = CloudResource("aws_ebs_volume", _txt(item, "volumeId"))
        r.attrs["encrypted"] = Attr(_txt(item, "encrypted") == "true")
        out.append(r)
    return out


def walk_rds(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "rds", "DescribeDBInstances",
                            "2014-10-31", req_token="Marker",
                            resp_paths=(".//Marker",)):
        out += _parse_dbs(doc)
    return out


def _parse_dbs(doc) -> list[CloudResource]:
    out = []
    for item in doc.findall(".//DBInstances/DBInstance"):
        name = _txt(item, "DBInstanceIdentifier")
        r = CloudResource("aws_db_instance", name)
        r.attrs["storage_encrypted"] = Attr(
            _txt(item, "StorageEncrypted") == "true")
        r.attrs["backup_retention_period"] = Attr(
            int(_txt(item, "BackupRetentionPeriod", "0") or 0))
        r.attrs["publicly_accessible"] = Attr(
            _txt(item, "PubliclyAccessible") == "true")
        if _txt(item, "ReadReplicaSourceDBInstanceIdentifier"):
            r.attrs["replicate_source_db"] = Attr(True)
        out.append(r)
    return out


def walk_cloudtrail(client: AWSClient) -> list[CloudResource]:
    """JSON API (x-amz-json-1.1): DescribeTrails."""
    raw = client.request(
        "cloudtrail", method="POST", body=b"{}",
        headers={"Content-Type": "application/x-amz-json-1.1",
                 "X-Amz-Target":
                     "com.amazonaws.cloudtrail.v20131101."
                     "CloudTrail_20131101.DescribeTrails"})
    out = []
    for t in json.loads(raw).get("trailList", []):
        r = CloudResource("aws_cloudtrail", t.get("Name", ""))
        r.attrs["is_multi_region_trail"] = Attr(
            bool(t.get("IsMultiRegionTrail")))
        r.attrs["enable_log_file_validation"] = Attr(
            bool(t.get("LogFileValidationEnabled")))
        if t.get("KmsKeyId"):
            r.attrs["kms_key_id"] = Attr(t["KmsKeyId"])
        r.attrs["cloud_watch_logs_group_arn"] = Attr(
            t.get("CloudWatchLogsLogGroupArn", ""))
        out.append(r)
    return out


def walk_efs(client: AWSClient) -> list[CloudResource]:
    """REST API: GET /2015-02-01/file-systems (Marker-paginated)."""
    out = []
    query = {}
    for _ in range(_MAX_PAGES):
        raw = client.request("elasticfilesystem",
                             path="/2015-02-01/file-systems",
                             query=query)
        body = json.loads(raw)
        for fs in body.get("FileSystems", []):
            r = CloudResource("aws_efs_file_system",
                              fs.get("FileSystemId", ""))
            r.attrs["encrypted"] = Attr(bool(fs.get("Encrypted")))
            out.append(r)
        marker = body.get("NextMarker")
        if not marker:
            break
        query = {"Marker": marker}
    else:
        logger.warning("aws efs: pagination stopped after %d pages; "
                       "listing may be incomplete", _MAX_PAGES)
    return out


def walk_elb(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "elasticloadbalancing",
                            "DescribeLoadBalancers", "2015-12-01",
                            req_token="Marker",
                            resp_paths=(".//NextMarker",)):
        out += _parse_lbs(client, doc)
    return out


def _parse_lbs(client: AWSClient, doc) -> list[CloudResource]:
    out = []
    for item in doc.findall(".//LoadBalancers/member"):
        name = _txt(item, "LoadBalancerName")
        arn = _txt(item, "LoadBalancerArn")
        r = CloudResource("aws_lb", name)
        r.attrs["internal"] = Attr(
            _txt(item, "Scheme") == "internal")
        r.attrs["load_balancer_type"] = Attr(
            _txt(item, "Type", "application"))
        try:
            attrs = _query_api(
                client, "elasticloadbalancing",
                "DescribeLoadBalancerAttributes", "2015-12-01",
                {"LoadBalancerArn": arn})
            for a in attrs.findall(".//Attributes/member"):
                if _txt(a, "Key") == \
                        "routing.http.drop_invalid_header_fields.enabled":
                    r.attrs["drop_invalid_header_fields"] = Attr(
                        _txt(a, "Value") == "true")
        except AWSError:
            pass
        out.append(r)
    return out


def walk_iam(client: AWSClient) -> list[CloudResource]:
    """Customer-managed policies (wildcard check) + account password
    policy, root-account summary, and per-user credential hygiene
    (CIS 1.x controls)."""
    out = []
    for doc in _paged_query(client, "iam", "ListPolicies",
                            "2010-05-08", {"Scope": "Local"},
                            req_token="Marker",
                            resp_paths=(".//Marker",)):
        out += _parse_policies(client, doc)
    out += _walk_iam_password_policy(client)
    out += _walk_iam_root(client)
    out += _walk_iam_users(client)
    return out


def _walk_iam_password_policy(client: AWSClient) -> list[CloudResource]:
    r = CloudResource("aws_iam_password_policy", "account")
    try:
        doc = _query_api(client, "iam", "GetAccountPasswordPolicy",
                         "2010-05-08")
    except AWSError as e:
        if "NoSuchEntity" in str(e):
            # no policy set at all: every requirement check fires
            r.attrs["reuse_prevention"] = Attr(0)
            r.attrs["require_lowercase"] = Attr(False)
            r.attrs["require_numbers"] = Attr(False)
            r.attrs["require_symbols"] = Attr(False)
            r.attrs["require_uppercase"] = Attr(False)
            r.attrs["max_age_days"] = Attr(0)
            r.attrs["minimum_length"] = Attr(0)
            return [r]
        raise
    p = doc.find(".//PasswordPolicy")
    if p is None:
        return []
    r.attrs["reuse_prevention"] = Attr(
        int(_txt(p, "PasswordReusePrevention", "0") or 0))
    r.attrs["require_lowercase"] = Attr(
        _txt(p, "RequireLowercaseCharacters") == "true")
    r.attrs["require_numbers"] = Attr(
        _txt(p, "RequireNumbers") == "true")
    r.attrs["require_symbols"] = Attr(
        _txt(p, "RequireSymbols") == "true")
    r.attrs["require_uppercase"] = Attr(
        _txt(p, "RequireUppercaseCharacters") == "true")
    r.attrs["max_age_days"] = Attr(
        int(_txt(p, "MaxPasswordAge", "0") or 0))
    r.attrs["minimum_length"] = Attr(
        int(_txt(p, "MinimumPasswordLength", "0") or 0))
    return [r]


def _walk_iam_root(client: AWSClient) -> list[CloudResource]:
    try:
        doc = _query_api(client, "iam", "GetAccountSummary",
                         "2010-05-08")
    except AWSError:
        return []
    summary = {}
    for e in doc.findall(".//SummaryMap/entry"):
        summary[_txt(e, "key")] = int(_txt(e, "value", "0") or 0)
    r = CloudResource("aws_iam_root", "root")
    r.attrs["access_keys_present"] = Attr(
        summary.get("AccountAccessKeysPresent", 0) > 0)
    r.attrs["mfa_enabled"] = Attr(
        summary.get("AccountMFAEnabled", 0) > 0)
    return [r]


def _days_since(iso: str) -> int | None:
    import datetime as dt
    if not iso:
        return None
    try:
        then = dt.datetime.fromisoformat(iso.replace("Z", "+00:00"))
    except ValueError:
        return None
    now = dt.datetime.now(dt.timezone.utc)
    return max(0, int((now - then).total_seconds() // 86400))


def _walk_iam_users(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "iam", "ListUsers", "2010-05-08",
                            req_token="Marker",
                            resp_paths=(".//Marker",)):
        for u in doc.findall(".//Users/member"):
            name = _txt(u, "UserName")
            r = CloudResource("aws_iam_user", name)
            pw_used = _days_since(_txt(u, "PasswordLastUsed"))
            if pw_used is not None:
                r.attrs["password_last_used_days"] = Attr(pw_used)
            try:
                _query_api(client, "iam", "GetLoginProfile",
                           "2010-05-08", {"UserName": name})
                r.attrs["has_console_password"] = Attr(True)
            except AWSError as e:
                if "NoSuchEntity" in str(e):
                    r.attrs["has_console_password"] = Attr(False)
            try:
                mfa = _query_api(client, "iam", "ListMFADevices",
                                 "2010-05-08", {"UserName": name})
                r.attrs["mfa_active"] = Attr(
                    mfa.find(".//MFADevices/member") is not None)
            except AWSError:
                pass
            try:
                keys = _query_api(client, "iam", "ListAccessKeys",
                                  "2010-05-08", {"UserName": name})
                ages, unused = [], []
                for k in keys.findall(
                        ".//AccessKeyMetadata/member"):
                    if _txt(k, "Status") != "Active":
                        continue
                    age = _days_since(_txt(k, "CreateDate"))
                    if age is not None:
                        ages.append(age)
                    kid = _txt(k, "AccessKeyId")
                    try:
                        lu = _query_api(
                            client, "iam", "GetAccessKeyLastUsed",
                            "2010-05-08", {"AccessKeyId": kid})
                        d = _days_since(_txt(
                            lu, ".//AccessKeyLastUsed/LastUsedDate"))
                        unused.append(d if d is not None
                                      else (age or 0))
                    except AWSError:
                        pass
                r.attrs["access_key_ages_days"] = Attr(ages)
                r.attrs["key_unused_days"] = Attr(unused)
            except AWSError:
                pass
            try:
                att = _query_api(client, "iam",
                                 "ListAttachedUserPolicies",
                                 "2010-05-08", {"UserName": name})
                r.attrs["attached_policies"] = Attr([
                    _txt(m, "PolicyName") for m in att.findall(
                        ".//AttachedPolicies/member")])
            except AWSError:
                pass
            out.append(r)
    return out


def _parse_policies(client: AWSClient, doc) -> list[CloudResource]:
    out = []
    for item in doc.findall(".//Policies/member"):
        arn = _txt(item, "Arn")
        name = _txt(item, "PolicyName")
        version = _txt(item, "DefaultVersionId", "v1")
        r = CloudResource("aws_iam_policy", name)
        try:
            vdoc = _query_api(client, "iam", "GetPolicyVersion",
                              "2010-05-08",
                              {"PolicyArn": arn, "VersionId": version})
            enc = _txt(vdoc, ".//Document")
            if enc:
                r.attrs["policy_document"] = Attr(
                    urllib.parse.unquote(enc))
        except AWSError:
            pass
        out.append(r)
    return out


def _json_api(client: AWSClient, service: str, target: str,
              payload: dict, version: str = "1.1") -> dict:
    """AWS JSON-protocol POST (cloudtrail/dynamodb/ecr/kms/ecs
    style)."""
    raw = client.request(
        service, method="POST",
        body=json.dumps(payload).encode(),
        headers={"Content-Type": f"application/x-amz-json-{version}",
                 "X-Amz-Target": target})
    return json.loads(raw or b"{}")


def walk_cloudfront(client: AWSClient) -> list[CloudResource]:
    """REST XML: ListDistributions + per-distribution config."""
    out = []
    marker = ""
    for _ in range(_MAX_PAGES):
        query = {"Marker": marker} if marker else {}
        doc = _xml(client.request("cloudfront",
                                  path="/2020-05-31/distribution",
                                  query=query))
        for item in doc.findall(".//DistributionSummary"):
            did = _txt(item, "Id")
            r = CloudResource("aws_cloudfront_distribution", did)
            r.attrs["minimum_protocol_version"] = Attr(_txt(
                item, ".//ViewerCertificate/MinimumProtocolVersion",
                "TLSv1"))
            policies = []
            for beh in ([item.find("DefaultCacheBehavior")]
                        + item.findall(".//CacheBehaviors/Items"
                                       "/CacheBehavior")):
                if beh is not None:
                    policies.append({"policy": _txt(
                        beh, "ViewerProtocolPolicy", "allow-all")})
            r.attrs["viewer_policies"] = Attr(policies)
            try:
                cfg = _xml(client.request(
                    "cloudfront",
                    path=f"/2020-05-31/distribution/{did}/config"))
                r.attrs["logging_enabled"] = Attr(
                    _txt(cfg, ".//Logging/Enabled") == "true")
            except AWSError:
                pass
            out.append(r)
        if _txt(doc, ".//IsTruncated") != "true":
            break
        marker = _txt(doc, ".//NextMarker")
        if not marker:
            break
    else:
        logger.warning("aws cloudfront: pagination stopped after %d "
                       "pages; listing may be incomplete", _MAX_PAGES)
    return out


def walk_dynamodb(client: AWSClient) -> list[CloudResource]:
    """JSON 1.0: ListTables → DescribeTable + ContinuousBackups."""
    out = []
    start = {}
    tgt = "DynamoDB_20120810"
    for _ in range(_MAX_PAGES):
        body = _json_api(client, "dynamodb", f"{tgt}.ListTables",
                         start, version="1.0")
        for name in body.get("TableNames", []):
            r = CloudResource("aws_dynamodb_table", name)
            try:
                t = _json_api(client, "dynamodb",
                              f"{tgt}.DescribeTable",
                              {"TableName": name}, version="1.0")
                sse = (t.get("Table") or {}).get("SSEDescription") or {}
                r.attrs["sse_kms_key"] = Attr(
                    sse.get("KMSMasterKeyArn", ""))
            except AWSError:
                pass
            try:
                b = _json_api(client, "dynamodb",
                              f"{tgt}.DescribeContinuousBackups",
                              {"TableName": name}, version="1.0")
                pitr = ((b.get("ContinuousBackupsDescription") or {})
                        .get("PointInTimeRecoveryDescription") or {})
                r.attrs["pitr_enabled"] = Attr(
                    pitr.get("PointInTimeRecoveryStatus") == "ENABLED")
            except AWSError:
                pass
            out.append(r)
        last = body.get("LastEvaluatedTableName")
        if not last:
            break
        start = {"ExclusiveStartTableName": last}
    else:
        logger.warning("aws dynamodb: pagination stopped after %d "
                       "pages; listing may be incomplete", _MAX_PAGES)
    return out


def walk_ecr(client: AWSClient) -> list[CloudResource]:
    out = []
    payload: dict = {}
    tgt = "AmazonEC2ContainerRegistry_V20150921.DescribeRepositories"
    for _ in range(_MAX_PAGES):
        body = _json_api(client, "ecr", tgt, payload)
        for repo in body.get("repositories", []):
            r = CloudResource("aws_ecr_repository",
                              repo.get("repositoryName", ""))
            scan = repo.get("imageScanningConfiguration") or {}
            r.attrs["scan_on_push"] = Attr(bool(scan.get("scanOnPush")))
            r.attrs["image_tag_mutability"] = Attr(
                repo.get("imageTagMutability", "MUTABLE"))
            out.append(r)
        token = body.get("nextToken")
        if not token:
            break
        payload = {"nextToken": token}
    else:
        logger.warning("aws ecr: pagination stopped after %d pages; "
                       "listing may be incomplete", _MAX_PAGES)
    return out


def walk_ecs(client: AWSClient) -> list[CloudResource]:
    out = []
    payload: dict = {}
    ns = "AmazonEC2ContainerServiceV20141113"
    for _ in range(_MAX_PAGES):
        body = _json_api(client, "ecs", f"{ns}.ListClusters", payload)
        arns = body.get("clusterArns", [])
        if arns:
            desc = _json_api(
                client, "ecs", f"{ns}.DescribeClusters",
                {"clusters": arns, "include": ["SETTINGS"]})
            for c in desc.get("clusters", []):
                r = CloudResource("aws_ecs_cluster",
                                  c.get("clusterName", ""))
                ci = next((s.get("value") for s in
                           c.get("settings", [])
                           if s.get("name") == "containerInsights"),
                          "disabled")
                r.attrs["container_insights"] = Attr(ci == "enabled")
                out.append(r)
        token = body.get("nextToken")
        if not token:
            break
        payload = {"nextToken": token}
    else:
        logger.warning("aws ecs: pagination stopped after %d pages; "
                       "listing may be incomplete", _MAX_PAGES)
    return out


def walk_eks(client: AWSClient) -> list[CloudResource]:
    """REST JSON: GET /clusters + GET /clusters/{name}."""
    out = []
    query: dict = {}
    for _ in range(_MAX_PAGES):
        body = json.loads(client.request("eks", path="/clusters",
                                         query=query))
        for name in body.get("clusters", []):
            r = CloudResource("aws_eks_cluster", name)
            try:
                c = json.loads(client.request(
                    "eks", path=f"/clusters/{name}")).get("cluster", {})
            except AWSError:
                out.append(r)
                continue
            types_on = [t for lg in (c.get("logging") or {})
                        .get("clusterLogging", [])
                        if lg.get("enabled")
                        for t in lg.get("types", [])]
            r.attrs["enabled_log_types"] = Attr(types_on)
            r.attrs["secrets_encrypted"] = Attr(
                bool(c.get("encryptionConfig")))
            vpc = c.get("resourcesVpcConfig") or {}
            r.attrs["endpoint_public_access"] = Attr(
                bool(vpc.get("endpointPublicAccess", True)))
            r.attrs["public_access_cidrs"] = Attr(
                vpc.get("publicAccessCidrs") or ["0.0.0.0/0"])
            out.append(r)
        token = body.get("nextToken")
        if not token:
            break
        query = {"nextToken": token}
    else:
        logger.warning("aws eks: pagination stopped after %d pages; "
                       "listing may be incomplete", _MAX_PAGES)
    return out


def walk_kms(client: AWSClient) -> list[CloudResource]:
    """JSON 1.1 TrentService: customer-managed keys + rotation."""
    out = []
    payload: dict = {}
    for _ in range(_MAX_PAGES):
        body = _json_api(client, "kms", "TrentService.ListKeys",
                         payload)
        for k in body.get("Keys", []):
            kid = k.get("KeyId", "")
            try:
                meta = _json_api(client, "kms",
                                 "TrentService.DescribeKey",
                                 {"KeyId": kid}).get("KeyMetadata", {})
            except AWSError:
                continue
            if meta.get("KeyManager") != "CUSTOMER":
                continue  # AWS-managed keys rotate automatically
            r = CloudResource("aws_kms_key", kid)
            r.attrs["key_usage"] = Attr(
                meta.get("KeyUsage", "ENCRYPT_DECRYPT"))
            try:
                rot = _json_api(client, "kms",
                                "TrentService.GetKeyRotationStatus",
                                {"KeyId": kid})
                r.attrs["enable_key_rotation"] = Attr(
                    bool(rot.get("KeyRotationEnabled")))
            except AWSError:
                pass
            out.append(r)
        if not body.get("Truncated"):
            break
        payload = {"Marker": body.get("NextMarker", "")}
    else:
        logger.warning("aws kms: pagination stopped after %d pages; "
                       "listing may be incomplete", _MAX_PAGES)
    return out


def walk_lambda(client: AWSClient) -> list[CloudResource]:
    out = []
    query: dict = {}
    for _ in range(_MAX_PAGES):
        body = json.loads(client.request(
            "lambda", path="/2015-03-31/functions/", query=query))
        for fn in body.get("Functions", []):
            r = CloudResource("aws_lambda_function",
                              fn.get("FunctionName", ""))
            r.attrs["tracing_mode"] = Attr(
                (fn.get("TracingConfig") or {})
                .get("Mode", "PassThrough"))
            out.append(r)
        marker = body.get("NextMarker")
        if not marker:
            break
        query = {"Marker": marker}
    else:
        logger.warning("aws lambda: pagination stopped after %d "
                       "pages; listing may be incomplete", _MAX_PAGES)
    return out


def walk_sns(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "sns", "ListTopics", "2010-03-31",
                            resp_paths=(".//NextToken",)):
        for t in doc.findall(".//Topics/member"):
            arn = _txt(t, "TopicArn")
            r = CloudResource("aws_sns_topic",
                              arn.rsplit(":", 1)[-1] or arn)
            try:
                attrs = _query_api(client, "sns", "GetTopicAttributes",
                                   "2010-03-31", {"TopicArn": arn})
                for e in attrs.findall(".//Attributes/entry"):
                    if _txt(e, "key") == "KmsMasterKeyId":
                        r.attrs["kms_master_key_id"] = Attr(
                            _txt(e, "value"))
            except AWSError:
                pass
            out.append(r)
    return out


def walk_sqs(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "sqs", "ListQueues", "2012-11-05",
                            resp_paths=(".//NextToken",)):
        for q in doc.findall(".//QueueUrl"):
            url = q.text or ""
            name = url.rstrip("/").rsplit("/", 1)[-1]
            r = CloudResource("aws_sqs_queue", name)
            try:
                attrs = _query_api(
                    client, "sqs", "GetQueueAttributes", "2012-11-05",
                    {"QueueUrl": url, "AttributeName.1": "All"})
                for e in attrs.findall(".//Attribute"):
                    k, v = _txt(e, "Name"), _txt(e, "Value")
                    if k == "KmsMasterKeyId":
                        r.attrs["kms_master_key_id"] = Attr(v)
                    elif k == "SqsManagedSseEnabled":
                        r.attrs["sqs_managed_sse_enabled"] = Attr(
                            v == "true")
            except AWSError:
                pass
            out.append(r)
    return out


def walk_elasticache(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "elasticache",
                            "DescribeReplicationGroups", "2015-02-02",
                            req_token="Marker",
                            resp_paths=(".//Marker",)):
        for g in doc.findall(".//ReplicationGroups/ReplicationGroup"):
            r = CloudResource("aws_elasticache_replication_group",
                              _txt(g, "ReplicationGroupId"))
            r.attrs["at_rest_encryption_enabled"] = Attr(
                _txt(g, "AtRestEncryptionEnabled") == "true")
            r.attrs["transit_encryption_enabled"] = Attr(
                _txt(g, "TransitEncryptionEnabled") == "true")
            out.append(r)
    return out


def walk_redshift(client: AWSClient) -> list[CloudResource]:
    out = []
    for doc in _paged_query(client, "redshift", "DescribeClusters",
                            "2012-12-01", req_token="Marker",
                            resp_paths=(".//Marker",)):
        for c in doc.findall(".//Clusters/Cluster"):
            r = CloudResource("aws_redshift_cluster",
                              _txt(c, "ClusterIdentifier"))
            r.attrs["encrypted"] = Attr(_txt(c, "Encrypted") == "true")
            r.attrs["subnet_group"] = Attr(
                _txt(c, "ClusterSubnetGroupName"))
            out.append(r)
    return out


def walk_apigateway(client: AWSClient) -> list[CloudResource]:
    """REST JSON: GET /restapis + per-API stages."""
    out = []
    query: dict = {}
    for _ in range(_MAX_PAGES):
        body = json.loads(client.request("apigateway",
                                         path="/restapis",
                                         query=query))
        for api in body.get("item", []):
            api_id = api.get("id", "")
            try:
                stages = json.loads(client.request(
                    "apigateway",
                    path=f"/restapis/{api_id}/stages"))
            except AWSError:
                continue
            for st in stages.get("item", []):
                name = f"{api.get('name', api_id)}/" \
                       f"{st.get('stageName', '')}"
                r = CloudResource("aws_api_gateway_stage", name)
                r.attrs["access_log_arn"] = Attr(
                    (st.get("accessLogSettings") or {})
                    .get("destinationArn", ""))
                r.attrs["xray_tracing_enabled"] = Attr(
                    bool(st.get("tracingEnabled")))
                out.append(r)
        pos = body.get("position")
        if not pos:
            break
        query = {"position": pos}
    else:
        logger.warning("aws api-gateway: pagination stopped after %d "
                       "pages; listing may be incomplete", _MAX_PAGES)
    return out


def walk_vpcs(client: AWSClient) -> list[CloudResource]:
    """DescribeVpcs + DescribeFlowLogs → per-VPC flow-log state."""
    logged = set()
    for doc in _paged_query(client, "ec2", "DescribeFlowLogs",
                            "2016-11-15"):
        for fl in doc.findall(".//flowLogSet/item"):
            logged.add(_txt(fl, "resourceId"))
    out = []
    for doc in _paged_query(client, "ec2", "DescribeVpcs",
                            "2016-11-15"):
        for v in doc.findall(".//vpcSet/item"):
            vid = _txt(v, "vpcId")
            r = CloudResource("aws_vpc", vid)
            r.attrs["is_default"] = Attr(
                _txt(v, "isDefault") == "true")
            r.attrs["flow_logs_enabled"] = Attr(vid in logged)
            out.append(r)
    return out


def _walk_ec2_all(client: AWSClient) -> list[CloudResource]:
    """ec2 service = security groups + instances + VPC flow-log
    state."""
    return walk_ec2(client) + walk_ec2_instances(client) + \
        walk_vpcs(client)


def get_account_id(client: AWSClient) -> str:
    try:
        doc = _query_api(client, "sts", "GetCallerIdentity",
                         "2011-06-15")
        return _txt(doc, ".//Account", "unknown")
    except AWSError:
        return "unknown"


WALKERS = {"s3": walk_s3, "ec2": _walk_ec2_all, "ebs": walk_ebs,
           "rds": walk_rds, "cloudtrail": walk_cloudtrail,
           "efs": walk_efs, "elb": walk_elb, "iam": walk_iam,
           "cloudfront": walk_cloudfront, "dynamodb": walk_dynamodb,
           "ecr": walk_ecr, "ecs": walk_ecs, "eks": walk_eks,
           "kms": walk_kms, "lambda": walk_lambda, "sns": walk_sns,
           "sqs": walk_sqs, "elasticache": walk_elasticache,
           "redshift": walk_redshift, "api-gateway": walk_apigateway}


# ---- account-state cache (pkg/cloud/aws/cache) ------------------------

def cache_path(cache_dir: str, provider: str, account: str,
               region: str) -> str:
    return os.path.join(cache_dir, "cloud", provider, account, region,
                        "data.json")


def save_state(path: str, resources: list[CloudResource]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = {"schema_version": CACHE_VERSION, "updated": time.time(),
           "resources": [{
               "kind": r.kind, "name": r.name,
               "attrs": {k: a.value for k, a in r.attrs.items()},
           } for r in resources]}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


def load_state(path: str, max_age_s: float) -> list[CloudResource] | None:
    if not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if doc.get("schema_version") != CACHE_VERSION:
        return None
    if max_age_s > 0 and time.time() - doc.get("updated", 0) > max_age_s:
        return None
    out = []
    for rj in doc.get("resources", []):
        r = CloudResource(rj.get("kind", ""), rj.get("name", ""))
        for k, v in (rj.get("attrs") or {}).items():
            r.attrs[k] = Attr(v)
        out.append(r)
    return out


# ---- scan entry -------------------------------------------------------

def scan_account(services: list[str], region: str = "us-east-1",
                 endpoint: str = "", cache_dir: str = "",
                 account: str = "", update_cache: bool = False,
                 max_cache_age_s: float = 24 * 3600,
                 ) -> tuple[list[T.Result], str]:
    """→ (results grouped per service, account_id)."""
    services = services or list(SUPPORTED_SERVICES)
    for s in services:
        if s not in WALKERS:
            raise AWSError(
                f"unsupported service {s!r} "
                f"(supported: {', '.join(SUPPORTED_SERVICES)})")
    client = AWSClient(region=region, endpoint=endpoint)
    if not account:
        account = get_account_id(client)
    cpath = cache_path(cache_dir or ".", "aws", account, region)
    resources = None
    if not update_cache:
        resources = load_state(cpath, max_cache_age_s)
    if resources is None:
        resources = []
        failed = False
        for s in services:
            try:
                resources.extend(WALKERS[s](client))
            except AWSError as e:
                failed = True
                logger.warning("aws %s walk failed: %s", s, e)
        # caching a partial walk would silently report no findings for the
        # failed service until the TTL expires — only cache complete state
        if not failed:
            save_state(cpath, resources)

    results: list[T.Result] = []
    by_service: dict[str, list] = {}
    for check in AWS_CHECKS:
        for item in check.fn(resources):
            msg, _rng = item
            m = build_misconf(check, "cloud", msg, (0, 0), [])
            by_service.setdefault(check.service, []).append(m)
    for svc in sorted(by_service):
        results.append(T.Result(
            target=f"arn:aws:{svc}:{region}:{account}",
            clazz=T.ResultClass.CONFIG, type="cloud",
            misconf_summary=T.MisconfSummary(
                failures=len(by_service[svc])),
            misconfigurations=sorted(by_service[svc],
                                     key=lambda m: (m.id, m.message)),
        ))
    return results, account
