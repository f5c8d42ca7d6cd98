"""Terraform module scanner (reference pkg/iac/scanners/terraform +
adapters/terraform, ~9k LoC of Go around hashicorp/hcl).

A module = all .tf files in one directory, evaluated together:
variable defaults (+terraform.tfvars overrides), locals to fixpoint,
then each resource body — with cross-resource references left Unknown —
adapted into the shared cloud-state model and run through the same
AVD-AWS checks as CloudFormation.  Split companion resources
(aws_s3_bucket_* / aws_security_group_rule) are joined to their parent
by the reference expression in their `bucket`/`security_group_id`
attribute, the way the reference's terraform adapter resolves block
references."""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import types as T
from .cloud import (AWS_CHECKS, UNKNOWN, Attr, CloudResource,
                    Unknown, block_attr)
from .core import build_misconf, ignored_ids_by_line, is_ignored
from .hcl import Block, HclError, Ref, Scope, evaluate, parse


@dataclass
class TfResource:
    type: str
    name: str
    block: Block
    path: str
    attrs: dict = field(default_factory=dict)    # name → (value, rng)
    raw: dict = field(default_factory=dict)      # name → AST expr

    def value(self, key, default=None):
        v = self.attrs.get(key)
        return default if v is None else v[0]

    def rng(self, key=None):
        if key is not None and key in self.attrs:
            return self.attrs[key][1]
        return (self.block.start, self.block.end)

    def blocks(self, btype):
        return [b for b in self.block.body.blocks if b.type == btype]


class TfModule:
    def __init__(self, files: dict[str, str]):
        """files: path → text for one directory's .tf/.tfvars files."""
        self.files = files
        self.bodies: dict[str, object] = {}
        self.variables: dict[str, object] = {}
        self.locals: dict[str, object] = {}
        self.resources: list[TfResource] = []
        self._load()

    def _load(self):
        tfvars = {}
        for path, text in sorted(self.files.items()):
            if path.endswith(".tfvars"):
                base = path.rsplit("/", 1)[-1]
                # terraform auto-loads only terraform.tfvars and
                # *.auto.tfvars; other var files need an explicit
                # -var-file and must not override defaults here
                if base != "terraform.tfvars" and \
                        not base.endswith(".auto.tfvars"):
                    continue
                try:
                    body = parse(text)
                except HclError:
                    continue
                scope = Scope()
                for a in body.attrs:
                    tfvars[a.name] = evaluate(a.expr, scope)
                continue
            try:
                self.bodies[path] = parse(text)
            except HclError:
                continue
        # variable defaults
        empty = Scope()
        for path, body in self.bodies.items():
            for b in body.blocks:
                if b.type == "variable" and b.labels:
                    default = UNKNOWN
                    for a in b.body.attrs:
                        if a.name == "default":
                            default = evaluate(a.expr, empty)
                    self.variables[b.labels[0]] = default
        self.variables.update(tfvars)
        # locals to fixpoint (handles local→local chains)
        local_exprs = {}
        for body in self.bodies.values():
            for b in body.blocks:
                if b.type == "locals":
                    for a in b.body.attrs:
                        local_exprs[a.name] = a.expr
        self.locals = {k: UNKNOWN for k in local_exprs}
        for _ in range(4):
            scope = self._scope()
            changed = False
            for k, expr in local_exprs.items():
                v = evaluate(expr, scope)
                if not _same(v, self.locals[k]):
                    self.locals[k] = v
                    changed = True
            if not changed:
                break
        # resources
        scope = self._scope()
        for path, body in self.bodies.items():
            for b in body.blocks:
                if b.type == "resource" and len(b.labels) >= 2:
                    res = TfResource(b.labels[0], b.labels[1], b, path)
                    for a in b.body.attrs:
                        res.attrs[a.name] = (
                            evaluate(a.expr, scope), (a.start, a.end))
                        res.raw[a.name] = a.expr
                    self.resources.append(res)

    def _scope(self):
        return Scope(variables=self.variables, locals_=self.locals)

    def eval_block_attrs(self, block: Block):
        """Evaluate a nested block's attributes, memoized per block:
        adapters fetch several keys from the same block and variables/
        locals are fixed after _load, so one evaluation suffices."""
        cache = getattr(self, "_block_attr_cache", None)
        if cache is None:
            cache = self._block_attr_cache = {}
        hit = cache.get(id(block))
        if hit is not None:
            return hit
        scope = self._scope()
        out = {a.name: (evaluate(a.expr, scope), (a.start, a.end))
               for a in block.body.attrs}
        cache[id(block)] = out
        return out


def _same(a, b):
    if isinstance(a, Unknown) and isinstance(b, Unknown):
        return True
    if isinstance(a, Unknown) or isinstance(b, Unknown):
        return False
    return a == b


def _ref_target(expr, rtype: str):
    """If expr references `<rtype>.<name>[...]`, return name."""
    if isinstance(expr, Ref) and len(expr.chain) >= 2 and \
            expr.chain[0] == rtype and isinstance(expr.chain[1], str):
        return expr.chain[1]
    return None


def _a(res: TfResource, key, out: CloudResource, name=None):
    if key in res.attrs:
        v, rng = res.attrs[key]
        out.attrs[name or key] = Attr(v, rng)


def _sse_kms_key(module, sse_block):
    """kms_master_key_id from an inline
    server_side_encryption_configuration → rule →
    apply_server_side_encryption_by_default chain."""
    return _sse_kms_key_from_rules(
        module, [b for b in sse_block.body.blocks
                 if b.type == "rule"])


def _sse_kms_key_from_rules(module, rule_blocks):
    for b in rule_blocks:
        for db in b.body.blocks:
            if db.type == "apply_server_side_encryption_by_default":
                attrs = module.eval_block_attrs(db)
                if "kms_master_key_id" in attrs:
                    return attrs["kms_master_key_id"][0]
                return ""  # explicit default-encryption, no CMK
    return None


def _block_val(module, res, btype, key):
    """First nested block's attr value, e.g. versioning.enabled."""
    for b in res.blocks(btype):
        attrs = module.eval_block_attrs(b)
        if key in attrs:
            return attrs[key][0], attrs[key][1]
        return None, (b.start, b.end)
    return None, None


def _sg_rules_from_blocks(module, res, btype):
    rules = []
    for b in res.blocks(btype):
        attrs = module.eval_block_attrs(b)
        cidrs = []
        for key in ("cidr_blocks", "ipv6_cidr_blocks"):
            v = attrs.get(key, (None, None))[0]
            if isinstance(v, list):
                cidrs.extend(x for x in v
                             if not isinstance(x, Unknown))
        desc = attrs.get("description", ("", None))[0]
        rules.append({"cidrs": cidrs,
                      "description": desc
                      if not isinstance(desc, Unknown) else "",
                      "rng": (b.start, b.end)})
    return rules


def adapt_terraform(module: TfModule) -> list[CloudResource]:
    out: list[CloudResource] = []
    buckets: dict[str, CloudResource] = {}
    groups: dict[str, CloudResource] = {}

    for res in module.resources:
        t = res.type
        cr = CloudResource(t, res.name, rng=res.rng(), path=res.path)

        if t == "aws_s3_bucket":
            _a(res, "acl", cr)
            v, rng = _block_val(module, res, "versioning", "enabled")
            if v is not None:
                cr.attrs["versioning_enabled"] = Attr(v, rng)
            if res.blocks("server_side_encryption_configuration"):
                b = res.blocks("server_side_encryption_configuration")[0]
                cr.attrs["encryption_enabled"] = Attr(
                    True, (b.start, b.end))
                kms = _sse_kms_key(module, b)
                if kms is not None:
                    cr.attrs["sse_kms_key_id"] = Attr(
                        kms, (b.start, b.end))
            if res.blocks("logging"):
                b = res.blocks("logging")[0]
                cr.attrs["logging_enabled"] = Attr(True,
                                                   (b.start, b.end))
            buckets[res.name] = cr
            out.append(cr)

        elif t == "aws_security_group":
            _a(res, "description", cr)
            cr.attrs["ingress"] = Attr(
                _sg_rules_from_blocks(module, res, "ingress"))
            cr.attrs["egress"] = Attr(
                _sg_rules_from_blocks(module, res, "egress"))
            groups[res.name] = cr
            out.append(cr)

        elif t == "aws_instance":
            mo, rng = {}, None
            for b in res.blocks("metadata_options"):
                attrs = module.eval_block_attrs(b)
                mo = {"http_tokens":
                      attrs.get("http_tokens", (None, None))[0],
                      "http_endpoint":
                      attrs.get("http_endpoint", (None, None))[0]}
                rng = (b.start, b.end)
            if rng is not None:
                cr.attrs["metadata_options"] = Attr(mo, rng)
            for b in res.blocks("root_block_device"):
                attrs = module.eval_block_attrs(b)
                cr.attrs["root_block_device"] = Attr(
                    {"encrypted":
                     attrs.get("encrypted", (None, None))[0]},
                    (b.start, b.end))
            ebds = []
            for b in res.blocks("ebs_block_device"):
                attrs = module.eval_block_attrs(b)
                ebds.append({"encrypted":
                             attrs.get("encrypted", (None, None))[0],
                             "rng": (b.start, b.end)})
            if ebds:
                cr.attrs["ebs_block_device"] = Attr(ebds)
            out.append(cr)

        elif t == "aws_ebs_volume":
            _a(res, "encrypted", cr)
            out.append(cr)

        elif t in ("aws_db_instance", "aws_rds_cluster"):
            _a(res, "storage_encrypted", cr)
            _a(res, "backup_retention_period", cr)
            _a(res, "publicly_accessible", cr)
            _a(res, "replicate_source_db", cr)
            out.append(cr)

        elif t == "aws_efs_file_system":
            _a(res, "encrypted", cr)
            out.append(cr)

        elif t == "aws_cloudtrail":
            _a(res, "is_multi_region_trail", cr)
            _a(res, "enable_log_file_validation", cr)
            _a(res, "kms_key_id", cr)
            _a(res, "cloud_watch_logs_group_arn", cr)
            out.append(cr)

        elif t in ("aws_lb", "aws_alb"):
            cr.kind = "aws_lb"
            _a(res, "internal", cr)
            _a(res, "load_balancer_type", cr)
            _a(res, "drop_invalid_header_fields", cr)
            out.append(cr)

        elif t in ("aws_iam_policy", "aws_iam_role_policy",
                   "aws_iam_user_policy", "aws_iam_group_policy"):
            _a(res, "policy", cr, "policy_document")
            out.append(cr)

        elif t == "aws_eks_cluster":
            logs = res.value("enabled_cluster_log_types")
            if not isinstance(logs, (list, Unknown)):
                logs = []
            cr.attrs["enabled_log_types"] = Attr(
                logs, res.rng("enabled_cluster_log_types"))
            encrypted = False
            for b in res.blocks("encryption_config"):
                enc_res, _ = block_attr(module, b, "resources", None)
                if isinstance(enc_res, Unknown):
                    encrypted = UNKNOWN
                elif isinstance(enc_res, list) and \
                        "secrets" in enc_res:
                    encrypted = True
            cr.attrs["secrets_encrypted"] = Attr(encrypted)
            pub, cidrs = True, None
            p_rng = cr.rng
            for b in res.blocks("vpc_config"):
                pub, p_rng = block_attr(module, b,
                                        "endpoint_public_access",
                                        True)
                c, _ = block_attr(module, b, "public_access_cidrs",
                                  None)
                if isinstance(c, Unknown) or (
                        isinstance(c, list) and
                        any(not isinstance(x, str) for x in c)):
                    cidrs = UNKNOWN   # unresolved: must not fire
                elif isinstance(c, list):
                    cidrs = [x for x in c if isinstance(x, str)]
            cr.attrs["endpoint_public_access"] = Attr(pub, p_rng)
            if cidrs is not None:
                cr.attrs["public_access_cidrs"] = Attr(cidrs)
            out.append(cr)

        elif t == "aws_ecr_repository":
            scan = False
            s_rng = cr.rng
            for b in res.blocks("image_scanning_configuration"):
                scan, s_rng = block_attr(module, b, "scan_on_push",
                                            False)
            cr.attrs["scan_on_push"] = Attr(scan, s_rng)
            _a(res, "image_tag_mutability", cr)
            enc, e_rng = _block_val(module, res,
                                    "encryption_configuration",
                                    "encryption_type")
            cr.attrs["encryption_type"] = Attr(
                enc if enc is not None else "AES256",
                e_rng or cr.rng)
            out.append(cr)

        elif t == "aws_cloudwatch_log_group":
            _a(res, "kms_key_id", cr)
            out.append(cr)

        elif t == "aws_ecs_task_definition":
            _a(res, "container_definitions", cr)
            out.append(cr)

        elif t == "aws_ecs_cluster":
            ci, c_rng = None, cr.rng
            for b in res.blocks("setting"):
                attrs = module.eval_block_attrs(b)
                if attrs.get("name", (None, None))[0] == \
                        "containerInsights":
                    v = attrs.get("value", (None, None))[0]
                    ci = v if isinstance(v, Unknown) else \
                        (v == "enabled")
                    c_rng = (b.start, b.end)
            if ci is not None:
                cr.attrs["container_insights"] = Attr(ci, c_rng)
            else:
                cr.attrs["container_insights"] = Attr(False, cr.rng)
            out.append(cr)

        elif t == "aws_lb_listener":
            _a(res, "protocol", cr)
            action = {}
            a_rng = cr.rng
            for b in res.blocks("default_action"):
                attrs = module.eval_block_attrs(b)
                action["type"] = attrs.get("type", (None, None))[0]
                a_rng = (b.start, b.end)
                for rb in b.body.blocks:
                    if rb.type == "redirect":
                        rattrs = module.eval_block_attrs(rb)
                        # keep Unknown as Unknown — the check must
                        # not fire on unresolvable values
                        action["redirect_protocol"] = rattrs.get(
                            "protocol", ("", None))[0]
            if action:
                cr.attrs["default_action"] = Attr(action, a_rng)
            out.append(cr)

        elif t == "aws_kms_key":
            _a(res, "enable_key_rotation", cr)
            _a(res, "key_usage", cr)
            out.append(cr)

        elif t == "aws_sqs_queue":
            _a(res, "kms_master_key_id", cr)
            _a(res, "sqs_managed_sse_enabled", cr)
            out.append(cr)

        elif t == "aws_sns_topic":
            _a(res, "kms_master_key_id", cr)
            out.append(cr)

        elif t == "aws_dynamodb_table":
            pitr = False
            for b in res.blocks("point_in_time_recovery"):
                pitr, _ = block_attr(module, b, "enabled", False)
            cr.attrs["pitr_enabled"] = Attr(pitr)
            kms = ""
            for b in res.blocks("server_side_encryption"):
                kms, _ = block_attr(module, b, "kms_key_arn", "")
            cr.attrs["sse_kms_key"] = Attr(kms)
            out.append(cr)

        elif t == "aws_cloudfront_distribution":
            cr.attrs["logging_enabled"] = Attr(
                bool(res.blocks("logging_config")))
            policies = []
            for btype in ("default_cache_behavior",
                          "ordered_cache_behavior"):
                for b in res.blocks(btype):
                    vp, rng = block_attr(module, b,
                                            "viewer_protocol_policy",
                                            "")
                    if isinstance(vp, str) and vp:
                        policies.append({"policy": vp, "rng": rng})
            cr.attrs["viewer_policies"] = Attr(policies)
            mpv = "TLSv1"
            for b in res.blocks("viewer_certificate"):
                default_cert, _ = block_attr(
                    module, b, "cloudfront_default_certificate", False)
                mpv, _ = block_attr(module, b,
                                    "minimum_protocol_version",
                                    "TLSv1")
                if default_cert is True:
                    mpv = "TLSv1"   # default cert caps the policy
            cr.attrs["minimum_protocol_version"] = Attr(mpv)
            out.append(cr)

        elif t == "aws_redshift_cluster":
            _a(res, "encrypted", cr)
            _a(res, "cluster_subnet_group_name", cr, "subnet_group")
            out.append(cr)

        elif t == "aws_elasticache_replication_group":
            _a(res, "at_rest_encryption_enabled", cr)
            _a(res, "transit_encryption_enabled", cr)
            out.append(cr)

        elif t == "aws_lambda_function":
            mode = "PassThrough"
            for b in res.blocks("tracing_config"):
                mode, _ = block_attr(module, b, "mode", "PassThrough")
            cr.attrs["tracing_mode"] = Attr(mode)
            out.append(cr)

    # second pass: companion resources joined to their parent
    for res in module.resources:
        t = res.type
        if t == "aws_s3_bucket_public_access_block":
            target = _ref_target(res.raw.get("bucket"), "aws_s3_bucket")
            parent = buckets.get(target)
            if parent is not None:
                parent.attrs["public_access_block"] = Attr({
                    "block_public_acls": res.value("block_public_acls"),
                    "block_public_policy":
                        res.value("block_public_policy"),
                    "ignore_public_acls":
                        res.value("ignore_public_acls"),
                    "restrict_public_buckets":
                        res.value("restrict_public_buckets"),
                }, res.rng())
        elif t == "aws_s3_bucket_server_side_encryption_configuration":
            target = _ref_target(res.raw.get("bucket"), "aws_s3_bucket")
            parent = buckets.get(target)
            if parent is not None:
                parent.attrs["encryption_enabled"] = Attr(
                    True, res.rng())
                kms = _sse_kms_key_from_rules(module,
                                              res.blocks("rule"))
                if kms is not None:
                    parent.attrs["sse_kms_key_id"] = Attr(
                        kms, res.rng())
        elif t == "aws_s3_bucket_versioning":
            target = _ref_target(res.raw.get("bucket"), "aws_s3_bucket")
            parent = buckets.get(target)
            if parent is not None:
                v, rng = _block_val(module, res,
                                    "versioning_configuration", "status")
                enabled = UNKNOWN if isinstance(v, Unknown) else \
                    (v == "Enabled")
                parent.attrs["versioning_enabled"] = Attr(
                    enabled, rng or res.rng())
        elif t == "aws_s3_bucket_logging":
            target = _ref_target(res.raw.get("bucket"), "aws_s3_bucket")
            parent = buckets.get(target)
            if parent is not None:
                parent.attrs["logging_enabled"] = Attr(True, res.rng())
        elif t == "aws_s3_bucket_acl":
            target = _ref_target(res.raw.get("bucket"), "aws_s3_bucket")
            parent = buckets.get(target)
            if parent is not None and "acl" in res.attrs:
                parent.attrs["acl"] = Attr(res.value("acl"),
                                           res.rng("acl"))
        elif t == "aws_security_group_rule":
            rtype = res.value("type")
            target = _ref_target(res.raw.get("security_group_id"),
                                 "aws_security_group")
            parent = groups.get(target)
            if parent is None:
                parent = CloudResource("aws_security_group", res.name,
                                       rng=res.rng(), path=res.path)
                parent.attrs["description"] = Attr("rule-only group")
                parent.attrs["ingress"] = Attr([])
                parent.attrs["egress"] = Attr([])
                groups[res.name] = parent
                out.append(parent)
            cidrs = []
            for key in ("cidr_blocks", "ipv6_cidr_blocks"):
                v = res.value(key)
                if isinstance(v, list):
                    cidrs.extend(x for x in v
                                 if not isinstance(x, Unknown))
            desc = res.value("description") or ""
            rule = {"cidrs": cidrs,
                    "description": desc
                    if not isinstance(desc, Unknown) else "",
                    "rng": res.rng()}
            side = "egress" if rtype == "egress" else "ingress"
            parent.attrs[side].value.append(rule)

    return out


def _tf_providers():
    """Provider registry: (adapter, check list) pairs.  Each adapter
    yields CloudResources only for its own resource-type prefixes, so a
    provider's checks run (and count successes) only when the module
    actually uses that provider — absent state passes trivially, the
    way the reference's rego sees empty input documents."""
    from .azure import AZURE_CHECKS, adapt_azurerm
    from .gcp import GCP_CHECKS, adapt_google
    from .providers_extra import EXTRA_CHECKS, adapt_extra
    return [(adapt_terraform, AWS_CHECKS),
            (adapt_azurerm, AZURE_CHECKS),
            (adapt_google, GCP_CHECKS),
            (adapt_extra, EXTRA_CHECKS)]


def scan_terraform_module(files: dict[str, str]
                          ) -> dict[str, tuple[list, int]]:
    """files: path → text (one module).  → per-file (failures,
    successes); module-wide passes are attributed to the first file."""
    module = TfModule(files)
    provider_work = []
    for adapt, checks in _tf_providers():
        resources = adapt(module)
        if resources:
            provider_work.append((resources, checks))
    if not provider_work:
        return {}
    ignores = {path: ignored_ids_by_line(text)
               for path, text in files.items()}
    lines = {path: text.splitlines() for path, text in files.items()}
    by_file: dict[str, list] = {}
    successes = 0
    for resources, checks in provider_work:
        for check in checks:
            found = []
            for r in resources:
                for msg, rng in check.fn([r]):
                    if is_ignored(ignores.get(r.path, {}), check,
                                  rng[0]):
                        continue
                    found.append((r.path, msg, rng))
            if not found:
                successes += 1
                continue
            for path, msg, rng in found:
                by_file.setdefault(path, []).append(build_misconf(
                    check, "terraform", msg, rng, lines.get(path, [])))
    out = {}
    tf_paths = sorted(p for p in files if p.endswith((".tf",
                                                      ".tf.json")))
    first = tf_paths[0] if tf_paths else sorted(files)[0]
    for path in sorted(set(list(by_file) + [first])):
        out[path] = (by_file.get(path, []),
                     successes if path == first else 0)
    return out


def scan_terraform_files(all_files: dict[str, bytes]
                         ) -> list[T.Misconfiguration]:
    """Group .tf/.tfvars files by directory (module), scan each module,
    → per-file Misconfiguration records."""
    modules: dict[str, dict[str, str]] = {}
    for path, content in all_files.items():
        if not path.endswith((".tf", ".tfvars")):
            continue
        d = path.rsplit("/", 1)[0] if "/" in path else "."
        modules.setdefault(d, {})[path] = content.decode(
            "utf-8", errors="replace")
    records = []
    for d in sorted(modules):
        per_file = scan_terraform_module(modules[d])
        for path in sorted(per_file):
            failures, succ = per_file[path]
            if not failures and not succ:
                continue
            records.append(T.Misconfiguration(
                file_type="terraform", file_path=path,
                successes=succ,
                failures=sorted(failures,
                                key=lambda f: (f.id, f.message))))
    return records
