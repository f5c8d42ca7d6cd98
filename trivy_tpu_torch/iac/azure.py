"""Azure ARM template scanner (reference pkg/iac/scanners/azure/arm).

Parses ARM deployment templates (JSON with positions via the YAML
loader, like the cloudformation scanner), evaluates the ARM expression
language (`[concat(parameters('x'), '-suffix')]` — reference
pkg/iac/scanners/azure/{expressions,functions,resolver}), walks the
resource tree including nested child resources
(deployment.go GetResourcesByType), adapts resources into the shared
cloud-state model (pkg/iac/adapters/arm/*), and evaluates an AVD-AZU
check set over it.

Unresolvable expressions (reference(), runtime params) become UNKNOWN
and pass checks, matching the tri-state semantics used by the terraform
and cloudformation scanners.
"""

from __future__ import annotations

import hashlib
import json
import re

from .. import types as T
from .cloud import Attr, CloudResource, UNKNOWN, Unknown
from .core import Check, build_misconf, ignored_ids_by_line, is_ignored
from .yamlpos import load_documents, value_range


# ---- ARM expression language -----------------------------------------

class _ExprError(Exception):
    pass


_EXPR_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<str>'(?:''|[^'])*')
  | (?P<num>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[().,\[\]])
""", re.VERBOSE)


def _lex_expr(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _EXPR_TOKEN.match(src, pos)
        if not m:
            raise _ExprError(f"bad expression at {src[pos:]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "str":
            toks.append(("str", text[1:-1].replace("''", "'")))
        elif kind == "num":
            toks.append(("num", float(text) if "." in text
                         else int(text)))
        elif kind == "ident":
            toks.append(("ident", text))
        else:
            toks.append(("punct", text))
    toks.append(("eof", None))
    return toks


class _ExprParser:
    """expr := call | literal; postfix: .prop | [index]"""

    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def parse(self):
        node = self.parse_expr()
        if self.peek()[0] != "eof":
            raise _ExprError("trailing tokens")
        return node

    def parse_expr(self):
        k, v = self.next()
        if k == "str" or k == "num":
            node = ("lit", v)
        elif k == "ident":
            if self.peek() == ("punct", "("):
                self.next()
                args = []
                if self.peek() != ("punct", ")"):
                    while True:
                        args.append(self.parse_expr())
                        if self.peek() == ("punct", ","):
                            self.next()
                            continue
                        break
                if self.next() != ("punct", ")"):
                    raise _ExprError("expected )")
                node = ("call", v.lower(), args)
            else:
                node = ("lit", v)   # bare identifiers: true/false/null
        else:
            raise _ExprError(f"unexpected {v!r}")
        while True:
            if self.peek() == ("punct", "."):
                self.next()
                k2, name = self.next()
                if k2 != "ident":
                    raise _ExprError("expected property name")
                node = ("prop", node, name)
            elif self.peek() == ("punct", "["):
                self.next()
                idx = self.parse_expr()
                if self.next() != ("punct", "]"):
                    raise _ExprError("expected ]")
                node = ("index", node, idx)
            else:
                return node


class ArmEvaluator:
    """Evaluates ARM template expressions against a deployment's
    parameters/variables (reference resolver.go + functions/*.go)."""

    def __init__(self, parameters: dict, variables: dict):
        self.parameters = parameters or {}
        self.variables = variables or {}
        self._var_cache: dict = {}
        self._var_stack: set = set()

    # entry: resolve any JSON value recursively
    def resolve(self, value):
        if isinstance(value, str):
            return self.resolve_string(value)
        if isinstance(value, dict):
            return {k: self.resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self.resolve(v) for v in value]
        return value

    def resolve_string(self, s: str):
        if len(s) >= 2 and s.startswith("[") and s.endswith("]") and \
                not s.startswith("[["):
            try:
                node = _ExprParser(_lex_expr(s[1:-1])).parse()
                return self.eval(node)
            except _ExprError:
                return UNKNOWN
        if s.startswith("[["):
            return s[1:]
        return s

    def eval(self, node):
        kind = node[0]
        if kind == "lit":
            v = node[1]
            if v == "true":
                return True
            if v == "false":
                return False
            if v == "null":
                return None
            return v
        if kind == "prop":
            base = self.eval(node[1])
            if isinstance(base, Unknown):
                return UNKNOWN
            if isinstance(base, dict):
                # case-insensitive property lookup (ARM is)
                for k, v in base.items():
                    if k.lower() == node[2].lower():
                        return self.resolve(v)
            return UNKNOWN
        if kind == "index":
            base = self.eval(node[1])
            idx = self.eval(node[2])
            if isinstance(base, Unknown) or isinstance(idx, Unknown):
                return UNKNOWN
            try:
                return self.resolve(base[idx])
            except (KeyError, IndexError, TypeError):
                return UNKNOWN
        if kind == "call":
            return self.call(node[1], [self.eval(a) for a in node[2]])
        return UNKNOWN

    def call(self, name, args):
        if any(isinstance(a, Unknown) for a in args) and name not in (
                "coalesce", "if"):
            return UNKNOWN
        fn = getattr(self, f"_fn_{name}", None)
        if fn is None:
            return UNKNOWN
        try:
            return fn(*args)
        except Exception:
            return UNKNOWN

    # -- function library (subset of pkg/iac/scanners/azure/functions)
    def _fn_parameters(self, name):
        p = self.parameters.get(name)
        if isinstance(p, dict) and "defaultValue" in p:
            return self.resolve(p["defaultValue"])
        return UNKNOWN

    def _fn_variables(self, name):
        if name in self._var_cache:
            return self._var_cache[name]
        if name in self._var_stack or name not in self.variables:
            return UNKNOWN
        self._var_stack.add(name)
        try:
            v = self.resolve(self.variables[name])
        finally:
            self._var_stack.discard(name)
        self._var_cache[name] = v
        return v

    def _fn_concat(self, *args):
        if all(isinstance(a, list) for a in args):
            return [x for a in args for x in a]
        return "".join(_arm_str(a) for a in args)

    def _fn_format(self, fmt, *args):
        def sub(m):
            return _arm_str(args[int(m.group(1))])
        return re.sub(r"\{(\d+)\}", sub, fmt)

    def _fn_tolower(self, s):
        return _arm_str(s).lower()

    def _fn_toupper(self, s):
        return _arm_str(s).upper()

    def _fn_trim(self, s):
        return _arm_str(s).strip()

    def _fn_substring(self, s, start, length=None):
        s = _arm_str(s)
        start = int(start)
        return s[start:] if length is None else s[start:start + int(length)]

    def _fn_replace(self, s, old, new):
        return _arm_str(s).replace(old, new)

    def _fn_split(self, s, delim):
        if isinstance(delim, list):
            pat = "|".join(re.escape(d) for d in delim)
            return re.split(pat, _arm_str(s))
        return _arm_str(s).split(delim)

    def _fn_string(self, v):
        return _arm_str(v)

    def _fn_int(self, v):
        return int(float(v))

    def _fn_bool(self, v):
        if isinstance(v, str):
            return v.lower() == "true"
        return bool(v)

    def _fn_length(self, v):
        return len(v)

    def _fn_empty(self, v):
        return not v

    def _fn_contains(self, coll, item):
        if isinstance(coll, str):
            return _arm_str(item).lower() in coll.lower()
        if isinstance(coll, dict):
            return any(k.lower() == _arm_str(item).lower()
                       for k in coll)
        return item in coll

    def _fn_startswith(self, s, pre):
        return _arm_str(s).lower().startswith(_arm_str(pre).lower())

    def _fn_endswith(self, s, suf):
        return _arm_str(s).lower().endswith(_arm_str(suf).lower())

    def _fn_indexof(self, s, sub):
        return _arm_str(s).lower().find(_arm_str(sub).lower())

    def _fn_equals(self, a, b):
        if isinstance(a, str) and isinstance(b, str):
            return a.lower() == b.lower()
        return a == b

    def _fn_not(self, v):
        return not v

    def _fn_and(self, *args):
        return all(args)

    def _fn_or(self, *args):
        return any(args)

    def _fn_if(self, cond, then, els):
        if isinstance(cond, Unknown):
            return UNKNOWN
        return then if cond else els

    def _fn_coalesce(self, *args):
        for a in args:
            if a is not None and not isinstance(a, Unknown):
                return a
        return None

    def _fn_union(self, *args):
        if all(isinstance(a, dict) for a in args):
            out = {}
            for a in args:
                out.update(a)
            return out
        out = []
        for a in args:
            for x in a:
                if x not in out:
                    out.append(x)
        return out

    def _fn_intersection(self, *args):
        first = args[0]
        if all(isinstance(a, dict) for a in args):
            return {k: v for k, v in first.items()
                    if all(k in a for a in args[1:])}
        return [x for x in first if all(x in a for a in args[1:])]

    def _fn_first(self, v):
        return v[0] if v else ""

    def _fn_last(self, v):
        return v[-1] if v else ""

    def _fn_min(self, *a):
        vals = a[0] if len(a) == 1 and isinstance(a[0], list) else a
        return min(vals)

    def _fn_max(self, *a):
        vals = a[0] if len(a) == 1 and isinstance(a[0], list) else a
        return max(vals)

    def _fn_add(self, a, b):
        return a + b

    def _fn_sub(self, a, b):
        return a - b

    def _fn_mul(self, a, b):
        return a * b

    def _fn_div(self, a, b):
        return a // b

    def _fn_mod(self, a, b):
        return a % b

    def _fn_createarray(self, *args):
        return list(args)

    def _fn_createobject(self, *args):
        return {args[i]: args[i + 1] for i in range(0, len(args), 2)}

    def _fn_json(self, s):
        return json.loads(s)

    def _fn_range(self, start, count):
        return list(range(int(start), int(start) + int(count)))

    def _fn_uniquestring(self, *args):
        h = hashlib.sha256("|".join(_arm_str(a)
                                    for a in args).encode())
        return h.hexdigest()[:13]

    def _fn_guid(self, *args):
        h = hashlib.sha256("|".join(_arm_str(a)
                                    for a in args).encode()).hexdigest()
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"

    def _fn_resourceid(self, *args):
        return "/".join(_arm_str(a) for a in args)

    def _fn_resourcegroup(self):
        return {"id": "resourcegroup-id", "name": "resource-group",
                "location": "eastus"}

    def _fn_subscription(self):
        return {"id": "subscription-id",
                "subscriptionId": "subscription-id",
                "tenantId": "tenant-id"}

    def _fn_deployment(self):
        return {"name": "deployment"}

    # runtime-only: unknown
    def _fn_reference(self, *a):
        return UNKNOWN

    def _fn_list(self, *a):
        return UNKNOWN

    def _fn_listkeys(self, *a):
        return UNKNOWN

    def _fn_utcnow(self, *a):
        return UNKNOWN

    def _fn_newguid(self, *a):
        return UNKNOWN

    def _fn_copyindex(self, *a):
        return UNKNOWN


def _arm_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return ""
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


# ---- deployment model -------------------------------------------------

class ArmResource:
    def __init__(self, rtype: str, name, properties: dict, raw: dict,
                 rng: tuple, prop_ranges):
        self.type = rtype
        self.name = name
        self.properties = properties or {}
        self.raw = raw
        self.rng = rng
        self._prop_ranges = prop_ranges  # callable(key) -> rng

    def prop(self, *path, default=None):
        cur = self.properties
        for p in path:
            if isinstance(cur, Unknown):
                return UNKNOWN
            if not isinstance(cur, dict):
                return default
            hit = None
            for k, v in cur.items():
                if k.lower() == p.lower():
                    hit = v
                    break
            if hit is None:
                return default
            cur = hit
        return cur

    def prop_rng(self, key):
        return self._prop_ranges(key)


def parse_deployment(content: bytes):
    """→ (resources: [ArmResource], src_text) or (None, "") when the
    document is not an ARM template."""
    text = content.decode("utf-8", errors="replace")
    try:
        docs = load_documents(text)
    except Exception:
        return None, ""
    if not docs:
        return None, ""
    doc = docs[0]
    if not isinstance(doc, dict) or "$schema" not in doc or \
            "deploymentTemplate.json" not in str(doc.get("$schema", "")):
        if not (isinstance(doc, dict) and "resources" in doc and
                "contentVersion" in doc):
            return None, ""
    ev = ArmEvaluator(doc.get("parameters") or {},
                      doc.get("variables") or {})
    resources: list[ArmResource] = []

    def add(node, parent_type=""):
        if not isinstance(node, dict):
            return
        rtype = node.get("type", "")
        if parent_type and "/" not in rtype.split("/", 1)[-1] and \
                not rtype.startswith("Microsoft."):
            rtype = parent_type + "/" + rtype
        rng = _node_rng(node)
        props_raw = node.get("properties") or {}

        def prop_ranges(key):
            r = value_range(props_raw, key, (0, 0))
            if r == (0, 0) and hasattr(props_raw, "key_lines"):
                for k, kr in props_raw.key_lines.items():
                    if k.lower() == key.lower():
                        return kr
            return r if r != (0, 0) else rng

        resources.append(ArmResource(
            rtype=rtype,
            name=ev.resolve(node.get("name", "")),
            properties=ev.resolve(props_raw),
            raw=node, rng=rng, prop_ranges=prop_ranges))
        for child in node.get("resources") or []:
            add(child, parent_type=rtype)

    for rnode in doc.get("resources") or []:
        add(rnode)
    return resources, text


def _node_rng(node):
    start = getattr(node, "start", 0)
    end = getattr(node, "end", 0)
    return (start, end) if start else (0, 0)


def resources_by_type(resources, rtype: str):
    rl = rtype.lower()
    for r in resources:
        t = r.type.lower()
        if t == rl or t.endswith("/" + rl):
            yield r


# ---- adapter: ARM resources → shared cloud state ---------------------

def adapt_arm(resources: list[ArmResource]) -> list[CloudResource]:
    out: list[CloudResource] = []
    for res in resources_by_type(resources,
                                 "Microsoft.Storage/storageAccounts"):
        r = CloudResource("azurerm_storage_account",
                          _arm_str(res.name), rng=res.rng)
        r.attrs["enable_https_traffic_only"] = Attr(
            res.prop("supportsHttpsTrafficOnly", default=False),
            res.prop_rng("supportsHttpsTrafficOnly"))
        r.attrs["min_tls_version"] = Attr(
            res.prop("minimumTlsVersion", default="TLS1_0"),
            res.prop_rng("minimumTlsVersion"))
        r.attrs["allow_blob_public_access"] = Attr(
            res.prop("allowBlobPublicAccess", default=True),
            res.prop_rng("allowBlobPublicAccess"))
        out.append(r)
    for res in resources_by_type(resources,
                                 "blobServices/containers"):
        r = CloudResource("azurerm_storage_container",
                          _arm_str(res.name), rng=res.rng)
        r.attrs["container_access_type"] = Attr(
            res.prop("publicAccess", default="None"),
            res.prop_rng("publicAccess"))
        out.append(r)

    # NSG rules: inline securityRules and child resources
    for res in resources_by_type(
            resources, "Microsoft.Network/networkSecurityGroups"):
        for rule in (res.prop("securityRules", default=[]) or []):
            if isinstance(rule, Unknown):
                continue
            props = rule.get("properties", rule) if \
                isinstance(rule, dict) else {}
            out.append(_nsg_rule(props, res.rng))
    for res in resources_by_type(
            resources,
            "Microsoft.Network/networkSecurityGroups/securityRules"):
        out.append(_nsg_rule(res.properties, res.rng))

    for res in resources_by_type(resources,
                                 "Microsoft.KeyVault/vaults"):
        r = CloudResource("azurerm_key_vault", _arm_str(res.name),
                          rng=res.rng)
        r.attrs["purge_protection_enabled"] = Attr(
            res.prop("enablePurgeProtection", default=False),
            res.prop_rng("enablePurgeProtection"))
        r.attrs["soft_delete_retention_days"] = Attr(
            res.prop("softDeleteRetentionInDays", default=0),
            res.prop_rng("softDeleteRetentionInDays"))
        acls = res.prop("networkAcls")
        r.attrs["network_acls_default_action"] = Attr(
            (acls or {}).get("defaultAction") if isinstance(acls, dict)
            else (UNKNOWN if isinstance(acls, Unknown) else None),
            res.prop_rng("networkAcls"))
        out.append(r)
    for res in resources_by_type(resources, "vaults/secrets"):
        r = CloudResource("azurerm_key_vault_secret",
                          _arm_str(res.name), rng=res.rng)
        attrs = res.prop("attributes", default={})
        r.attrs["expiration_date"] = Attr(
            attrs.get("exp") if isinstance(attrs, dict) else UNKNOWN,
            res.prop_rng("attributes"))
        r.attrs["content_type"] = Attr(
            res.prop("contentType", default=""),
            res.prop_rng("contentType"))
        out.append(r)

    for res in resources_by_type(resources, "Microsoft.Sql/servers"):
        r = CloudResource("azurerm_mssql_server", _arm_str(res.name),
                          rng=res.rng)
        r.attrs["minimum_tls_version"] = Attr(
            res.prop("minimalTlsVersion", default=""),
            res.prop_rng("minimalTlsVersion"))
        r.attrs["public_network_access_enabled"] = Attr(
            _arm_str(res.prop("publicNetworkAccess",
                              default="Enabled")).lower() == "enabled",
            res.prop_rng("publicNetworkAccess"))
        out.append(r)
    for res in resources_by_type(resources, "servers/firewallRules"):
        r = CloudResource("azurerm_sql_firewall_rule",
                          _arm_str(res.name), rng=res.rng)
        r.attrs["start_ip_address"] = Attr(
            res.prop("startIpAddress"), res.prop_rng("startIpAddress"))
        r.attrs["end_ip_address"] = Attr(
            res.prop("endIpAddress"), res.prop_rng("endIpAddress"))
        out.append(r)

    for res in resources_by_type(
            resources, "Microsoft.DBforPostgreSQL/servers"):
        r = CloudResource("azurerm_postgresql_server",
                          _arm_str(res.name), rng=res.rng)
        r.attrs["ssl_enforcement_enabled"] = Attr(
            _arm_str(res.prop("sslEnforcement",
                              default="Disabled")).lower() == "enabled",
            res.prop_rng("sslEnforcement"))
        out.append(r)

    for res in resources_by_type(resources, "Microsoft.Web/sites"):
        r = CloudResource("azurerm_app_service", _arm_str(res.name),
                          rng=res.rng)
        r.attrs["https_only"] = Attr(
            res.prop("httpsOnly", default=False),
            res.prop_rng("httpsOnly"))
        site_cfg = res.prop("siteConfig", default={})
        r.attrs["min_tls_version"] = Attr(
            site_cfg.get("minTlsVersion", "1.2")
            if isinstance(site_cfg, dict) else UNKNOWN,
            res.prop_rng("siteConfig"))
        out.append(r)

    for res in resources_by_type(
            resources, "Microsoft.Compute/virtualMachines"):
        r = CloudResource("azurerm_linux_virtual_machine",
                          _arm_str(res.name), rng=res.rng)
        lincfg = res.prop("osProfile", "linuxConfiguration")
        if isinstance(lincfg, dict):
            r.attrs["disable_password_authentication"] = Attr(
                lincfg.get("disablePasswordAuthentication", False),
                res.prop_rng("osProfile"))
            out.append(r)
        elif isinstance(lincfg, Unknown):
            r.attrs["disable_password_authentication"] = Attr(
                UNKNOWN, res.prop_rng("osProfile"))
            out.append(r)

    for res in resources_by_type(
            resources, "Microsoft.ContainerService/managedClusters"):
        r = CloudResource("azurerm_kubernetes_cluster",
                          _arm_str(res.name), rng=res.rng)
        r.attrs["role_based_access_control_enabled"] = Attr(
            res.prop("enableRBAC", default=False),
            res.prop_rng("enableRBAC"))
        r.attrs["private_cluster_enabled"] = Attr(
            res.prop("apiServerAccessProfile", "enablePrivateCluster",
                     default=False),
            res.prop_rng("apiServerAccessProfile"))
        out.append(r)
    return out


def _nsg_rule(props: dict, rng: tuple) -> CloudResource:
    if not isinstance(props, dict):
        props = {}

    def get(key, default=None):
        for k, v in props.items():
            if k.lower() == key.lower():
                return v
        return default

    r = CloudResource("azurerm_network_security_rule", "", rng=rng)
    srcs = list(get("sourceAddressPrefixes") or [])
    one = get("sourceAddressPrefix")
    if one:
        srcs.append(one)
    dsts = list(get("destinationAddressPrefixes") or [])
    one = get("destinationAddressPrefix")
    if one:
        dsts.append(one)
    ports = list(get("destinationPortRanges") or [])
    one = get("destinationPortRange")
    if one is not None:
        ports.append(one)
    r.attrs["access"] = Attr(get("access", ""), rng)
    r.attrs["direction"] = Attr(get("direction", ""), rng)
    r.attrs["source_address_prefixes"] = Attr(srcs, rng)
    r.attrs["destination_address_prefixes"] = Attr(dsts, rng)
    r.attrs["destination_port_ranges"] = Attr(
        [_arm_str(p) for p in ports if not isinstance(p, Unknown)], rng)
    return r


# ---- AVD-AZU checks ---------------------------------------------------

AZURE_CHECKS: list[Check] = []


def _azu(id_, title, severity, service, description="", resolution=""):
    def deco(fn):
        AZURE_CHECKS.append(Check(
            id=id_, avd_id=id_, title=title, severity=severity,
            description=description, resolution=resolution,
            provider="Azure", service=service,
            namespace=f"builtin.azure.{service}.{id_}", fn=fn))
        return fn
    return deco


def _of(resources, kind):
    return [r for r in resources if r.kind == kind]


@_azu("AVD-AZU-0008", "Storage accounts should enforce HTTPS", "HIGH",
      "storage",
      description="Requiring secure transfer ensures data in transit "
                  "is encrypted.",
      resolution="Set supportsHttpsTrafficOnly to true.")
def _storage_https(resources):
    for r in _of(resources, "azurerm_storage_account"):
        v = r.val("enable_https_traffic_only")
        if v is False:
            yield ("Account does not enforce HTTPS.",
                   r.attr_rng("enable_https_traffic_only"))


@_azu("AVD-AZU-0011", "Storage accounts should use a secure TLS policy",
      "CRITICAL", "storage",
      description="TLS 1.0/1.1 are vulnerable; storage accounts should "
                  "require TLS1_2.",
      resolution="Set minimumTlsVersion to TLS1_2.")
def _storage_tls(resources):
    for r in _of(resources, "azurerm_storage_account"):
        v = r.val("min_tls_version")
        if isinstance(v, str) and v in ("TLS1_0", "TLS1_1"):
            yield (f"Account uses insecure TLS version ({v}).",
                   r.attr_rng("min_tls_version"))


@_azu("AVD-AZU-0007", "Storage containers should deny public access",
      "HIGH", "storage",
      description="Anonymous public read access to containers exposes "
                  "blob data.",
      resolution="Set publicAccess to None.")
def _container_public(resources):
    for r in _of(resources, "azurerm_storage_container"):
        v = r.val("container_access_type")
        if isinstance(v, str) and v.lower() in ("blob", "container"):
            yield ("Container allows public access.",
                   r.attr_rng("container_access_type"))


def _is_public_prefix(p) -> bool:
    if not isinstance(p, str):
        return False
    return p in ("*", "0.0.0.0", "0.0.0.0/0", "internet", "Internet",
                 "any", "Any") or p.endswith("/0")


@_azu("AVD-AZU-0047",
      "Security group rules should not allow ingress from any IP",
      "CRITICAL", "network",
      description="Opening inbound traffic to every address exposes "
                  "the resource to the internet.",
      resolution="Restrict sourceAddressPrefix.")
def _nsg_public_ingress(resources):
    for r in _of(resources, "azurerm_network_security_rule"):
        if _arm_str(r.val("access", "")).lower() != "allow":
            continue
        if _arm_str(r.val("direction", "")).lower() != "inbound":
            continue
        for p in r.val("source_address_prefixes", []) or []:
            if _is_public_prefix(p):
                yield ("Security group rule allows ingress from "
                       "public internet.", r.rng)
                break


@_azu("AVD-AZU-0051",
      "Security group rules should not allow egress to any IP",
      "CRITICAL", "network",
      description="Unrestricted egress eases data exfiltration.",
      resolution="Restrict destinationAddressPrefix.")
def _nsg_public_egress(resources):
    for r in _of(resources, "azurerm_network_security_rule"):
        if _arm_str(r.val("access", "")).lower() != "allow":
            continue
        if _arm_str(r.val("direction", "")).lower() != "outbound":
            continue
        for p in r.val("destination_address_prefixes", []) or []:
            if _is_public_prefix(p):
                yield ("Security group rule allows egress to public "
                       "internet.", r.rng)
                break


def _rule_covers_port(r, port: int) -> bool:
    for pr in r.val("destination_port_ranges", []) or []:
        pr = str(pr)
        if pr == "*":
            return True
        if "-" in pr:
            try:
                lo, hi = pr.split("-", 1)
                if int(lo) <= port <= int(hi):
                    return True
            except ValueError:
                continue
        else:
            try:
                if int(pr) == port:
                    return True
            except ValueError:
                continue
    return False


@_azu("AVD-AZU-0050", "SSH should be blocked from the internet",
      "CRITICAL", "network",
      description="SSH port 22 open to the internet invites "
                  "brute-force attacks.",
      resolution="Block port 22 from public sources.")
def _nsg_ssh(resources):
    for r in _of(resources, "azurerm_network_security_rule"):
        if _arm_str(r.val("access", "")).lower() != "allow" or \
                _arm_str(r.val("direction", "")).lower() != "inbound":
            continue
        if any(_is_public_prefix(p)
               for p in r.val("source_address_prefixes", []) or []) \
                and _rule_covers_port(r, 22):
            yield ("SSH port 22 is exposed to the internet.", r.rng)


@_azu("AVD-AZU-0048", "RDP should be blocked from the internet",
      "CRITICAL", "network",
      description="RDP port 3389 open to the internet invites "
                  "brute-force attacks.",
      resolution="Block port 3389 from public sources.")
def _nsg_rdp(resources):
    for r in _of(resources, "azurerm_network_security_rule"):
        if _arm_str(r.val("access", "")).lower() != "allow" or \
                _arm_str(r.val("direction", "")).lower() != "inbound":
            continue
        if any(_is_public_prefix(p)
               for p in r.val("source_address_prefixes", []) or []) \
                and _rule_covers_port(r, 3389):
            yield ("RDP port 3389 is exposed to the internet.", r.rng)


@_azu("AVD-AZU-0016", "Key vaults should have purge protection",
      "MEDIUM", "keyvault",
      description="Purge protection prevents immediate permanent "
                  "deletion of vault contents.",
      resolution="Set enablePurgeProtection to true.")
def _kv_purge(resources):
    for r in _of(resources, "azurerm_key_vault"):
        if r.val("purge_protection_enabled") is False:
            yield ("Vault does not enable purge protection.",
                   r.attr_rng("purge_protection_enabled"))


@_azu("AVD-AZU-0013", "Key vaults should restrict network access",
      "CRITICAL", "keyvault",
      description="Without a network ACL default-deny, the vault is "
                  "reachable from any network.",
      resolution="Set networkAcls.defaultAction to Deny.")
def _kv_acl(resources):
    for r in _of(resources, "azurerm_key_vault"):
        v = r.val("network_acls_default_action")
        if v is None or (isinstance(v, str) and v.lower() == "allow"):
            yield ("Vault network ACL does not default to Deny.",
                   r.attr_rng("network_acls_default_action"))


@_azu("AVD-AZU-0017", "Key vault secrets should have an expiry",
      "MEDIUM", "keyvault",
      description="Secrets without expiration dates linger forever if "
                  "leaked.",
      resolution="Set attributes.exp on the secret.")
def _kv_secret_exp(resources):
    for r in _of(resources, "azurerm_key_vault_secret"):
        if not r.unknown("expiration_date") and \
                not r.val("expiration_date"):
            yield ("Secret has no expiration date.", r.rng)


@_azu("AVD-AZU-0018",
      "PostgreSQL servers should enforce SSL connections", "HIGH",
      "database",
      description="Unencrypted database connections expose credentials "
                  "and data.",
      resolution="Set sslEnforcement to Enabled.")
def _pg_ssl(resources):
    for r in _of(resources, "azurerm_postgresql_server"):
        if r.val("ssl_enforcement_enabled") is False:
            yield ("SSL enforcement is disabled.",
                   r.attr_rng("ssl_enforcement_enabled"))


@_azu("AVD-AZU-0026",
      "SQL servers should use a secure TLS version", "MEDIUM",
      "database",
      description="Old TLS versions are vulnerable to downgrade "
                  "attacks.",
      resolution="Set minimalTlsVersion to 1.2.")
def _sql_tls(resources):
    for r in _of(resources, "azurerm_mssql_server"):
        v = r.val("minimum_tls_version")
        if isinstance(v, str) and v in ("1.0", "1.1"):
            yield (f"Server allows TLS {v}.",
                   r.attr_rng("minimum_tls_version"))


@_azu("AVD-AZU-0027",
      "SQL firewall rules should not allow public access", "HIGH",
      "database",
      description="A 0.0.0.0 firewall range opens the server to every "
                  "Azure/Internet address.",
      resolution="Restrict firewall start/end addresses.")
def _sql_fw(resources):
    for r in _of(resources, "azurerm_sql_firewall_rule"):
        start = _arm_str(r.val("start_ip_address", ""))
        end = _arm_str(r.val("end_ip_address", ""))
        if start == "0.0.0.0" and end in ("0.0.0.0", "255.255.255.255"):
            yield ("Firewall rule allows public access.", r.rng)


@_azu("AVD-AZU-0002", "App services should enforce HTTPS", "HIGH",
      "appservice",
      description="HTTP traffic to the app is unencrypted.",
      resolution="Set httpsOnly to true.")
def _app_https(resources):
    for r in _of(resources, "azurerm_app_service"):
        if r.val("https_only") is False:
            yield ("App service does not enforce HTTPS.",
                   r.attr_rng("https_only"))


@_azu("AVD-AZU-0039",
      "Linux VMs should disable password authentication", "HIGH",
      "compute",
      description="SSH keys resist brute-force attacks; passwords "
                  "do not.",
      resolution="Set disablePasswordAuthentication to true.")
def _vm_password(resources):
    for r in _of(resources, "azurerm_linux_virtual_machine"):
        if r.val("disable_password_authentication") is False:
            yield ("VM allows password authentication.",
                   r.attr_rng("disable_password_authentication"))


@_azu("AVD-AZU-0042", "AKS clusters should enable RBAC", "HIGH",
      "container",
      description="RBAC limits who can read/modify cluster state.",
      resolution="Set enableRBAC to true.")
def _aks_rbac(resources):
    for r in _of(resources, "azurerm_kubernetes_cluster"):
        if r.val("role_based_access_control_enabled") is False:
            yield ("Cluster does not enable RBAC.",
                   r.attr_rng("role_based_access_control_enabled"))


# ---- scanning entry ---------------------------------------------------

def scan_arm(path: str, content: bytes, lines=None, docs=None):
    """→ (failures, successes) in the shared misconf shape."""
    resources, text = parse_deployment(content)
    if resources is None:
        return [], 0
    adapted = adapt_arm(resources)
    src_lines = text.splitlines()
    ignores = ignored_ids_by_line(text)
    failures = []
    successes = 0
    for check in AZURE_CHECKS:
        found = [x for x in check.fn(adapted)
                 if not is_ignored(ignores, check, x[1][0])]
        if not found:
            successes += 1
            continue
        for msg, rng in found:
            failures.append(build_misconf(
                check, "azure-arm", msg, rng, src_lines))
    return failures, successes


def is_arm_template(doc) -> bool:
    return isinstance(doc, dict) and (
        "deploymentTemplate.json" in str(doc.get("$schema", "")) or
        ("resources" in doc and "contentVersion" in doc))


# ---- terraform azurerm adapter --------------------------------------

_TF_AZURE_KINDS = {
    "azurerm_storage_account", "azurerm_storage_container",
    "azurerm_network_security_rule", "azurerm_key_vault",
    "azurerm_key_vault_secret", "azurerm_postgresql_server",
    "azurerm_mssql_server", "azurerm_sql_firewall_rule",
    "azurerm_app_service", "azurerm_linux_virtual_machine",
    "azurerm_kubernetes_cluster",
}


def adapt_azurerm(module) -> list:
    """Terraform azurerm_* resources → the same CloudResource shapes
    the ARM-template adapter produces (the AZURE_CHECKS read terraform
    argument names — the ARM adapter normalizes TO them, reference
    pkg/iac/adapters/{arm,terraform}/azure share one provider
    model)."""
    from .cloud import Attr, CloudResource, block_attr

    out = []
    for res in module.resources:
        t = res.type
        if t not in _TF_AZURE_KINDS:
            continue
        cr = CloudResource(t, res.name, rng=res.rng(), path=res.path)
        for key, (value, rng) in res.attrs.items():
            cr.attrs[key] = Attr(value, rng)
        if t == "azurerm_network_security_rule":
            # singular argument variants normalize to the plural lists
            for single, plural in (
                    ("source_address_prefix",
                     "source_address_prefixes"),
                    ("destination_address_prefix",
                     "destination_address_prefixes"),
                    ("destination_port_range",
                     "destination_port_ranges")):
                if plural not in cr.attrs and single in cr.attrs:
                    a = cr.attrs[single]
                    cr.attrs[plural] = Attr([a.value], a.rng)
            # the NSG checks iterate these lists (the ARM adapter
            # pre-sanitizes); Unknown values/elements must neither
            # crash nor fire
            from .cloud import Unknown as _Unk
            for key in ("source_address_prefixes",
                        "destination_address_prefixes",
                        "destination_port_ranges"):
                a = cr.attrs.get(key)
                if a is None:
                    continue
                if isinstance(a.value, _Unk):
                    cr.attrs[key] = Attr([], a.rng)
                elif isinstance(a.value, list):
                    cr.attrs[key] = Attr(
                        [x for x in a.value
                         if isinstance(x, (str, int))], a.rng)
        elif t == "azurerm_key_vault":
            for b in res.blocks("network_acls"):
                v, rng = block_attr(module, b, "default_action", "")
                cr.attrs["network_acls_default_action"] = Attr(v, rng)
            # terraform default: purge protection off
            if "purge_protection_enabled" not in cr.attrs:
                cr.attrs["purge_protection_enabled"] = Attr(False)
        elif t == "azurerm_app_service":
            # terraform default: https_only off
            if "https_only" not in cr.attrs:
                cr.attrs["https_only"] = Attr(False)
        elif t == "azurerm_linux_virtual_machine":
            # terraform default: password auth DISABLED unless set
            if "disable_password_authentication" not in cr.attrs:
                cr.attrs["disable_password_authentication"] = \
                    Attr(True)
        elif t == "azurerm_kubernetes_cluster":
            # legacy nested block form: role_based_access_control {}
            for b in res.blocks("role_based_access_control"):
                v, rng = block_attr(module, b, "enabled", True)
                cr.attrs["role_based_access_control_enabled"] = \
                    Attr(v, rng)
        out.append(cr)
    return out
