"""Google Cloud IaC support: terraform adapter + check set.

Reference counterparts: pkg/iac/providers/google/** (typed state:
sql/storage/gke/compute/dns/kms/bigquery/iam) and
pkg/iac/adapters/terraform/google/** (resource-type mapping, e.g.
sql/adapt.go google_sql_database_instance flags/backup/ip-config,
compute/instances.go shielded-VM + metadata-key semantics,
gke/adapt.go cluster defaults).  The check bodies live in the external
trivy-checks bundle; they are re-authored here from the typed state the
adapters produce, with IDs/severities following the published AVD-GCP
series (avd.aquasec.com; AVD-GCP-0007's metadata is pinned by the
reference's pkg/report/sarif_test.go:556-560).

Adapter defaults mirror the reference exactly where they matter for
check semantics: shielded-VM flags default false without a
shielded_instance_config block and integrity-monitoring/vTPM default
true inside one (instances.go:18-59); GKE clusters default
enable_shielded_nodes=true, legacy_endpoints=true, logging/monitoring
to the kubernetes services (gke/adapt.go:50-100); SQL Server
contained-db-auth and cross-db-ownership-chaining default true
(sql/adapt.go:36-44)."""

from __future__ import annotations

import re

from .cloud import (Attr, CloudResource, Unknown, block_attr,
                    sub_blocks)
from .core import Check

GCP_CHECKS: list[Check] = []


def _gcp(id_, title, severity, service, description="", resolution=""):
    def deco(fn):
        GCP_CHECKS.append(Check(
            id=id_, avd_id=id_, title=title, severity=severity,
            description=description, resolution=resolution,
            provider="Google", service=service,
            namespace=f"builtin.google.{service}.{id_}", fn=fn))
        return fn
    return deco


def _of(resources, kind):
    return [r for r in resources if r.kind == kind]


def _known_false(v):
    return not isinstance(v, Unknown) and \
        (v is False or v == "false" or v == "False" or v == 0 or v is None)


def _known_true(v):
    return not isinstance(v, Unknown) and \
        (v is True or v == "true" or v == "True" or v == 1)


# ---------------------------------------------------------------------
# Adapter: TfModule -> CloudResource list (google_* resource types)
# ---------------------------------------------------------------------

_sub_blocks = sub_blocks
_block_attr = block_attr


def _adapt_sql(module, res, cr):
    cr.attrs["database_version"] = Attr(res.value("database_version", ""))
    cr.attrs["is_replica"] = Attr("master_instance_name" in res.attrs)
    backups, ipv4, require_ssl = False, True, False
    backups_rng = ssl_rng = ipv4_rng = None
    networks = []
    flags = {}
    flag_rngs = {}
    for settings in res.blocks("settings"):
        for fb in _sub_blocks(settings, "database_flags"):
            name, _ = _block_attr(module, fb, "name")
            value, vrng = _block_attr(module, fb, "value")
            if isinstance(name, str):
                flags[name] = value
                flag_rngs[name] = vrng
        for bb in _sub_blocks(settings, "backup_configuration"):
            backups, backups_rng = _block_attr(module, bb, "enabled", False)
        for ib in _sub_blocks(settings, "ip_configuration"):
            ipv4, ipv4_rng = _block_attr(module, ib, "ipv4_enabled", True)
            require_ssl, ssl_rng = _block_attr(module, ib, "require_ssl",
                                               False)
            for nb in _sub_blocks(ib, "authorized_networks"):
                cidr, crng = _block_attr(module, nb, "value")
                networks.append({"cidr": cidr, "rng": crng})
    cr.attrs["backups_enabled"] = Attr(backups, backups_rng or cr.rng)
    cr.attrs["ipv4_enabled"] = Attr(ipv4, ipv4_rng or cr.rng)
    cr.attrs["require_ssl"] = Attr(require_ssl, ssl_rng or cr.rng)
    cr.attrs["authorized_networks"] = Attr(networks)
    cr.attrs["flags"] = Attr(flags)
    cr.attrs["flag_rngs"] = Attr(flag_rngs)


def _adapt_gke_node_config(module, block, cr):
    """node_config block → image_type / service_account / workload
    metadata / legacy endpoints attrs on cr."""
    it, it_rng = _block_attr(module, block, "image_type", "")
    cr.attrs["node_image_type"] = Attr(it, it_rng)
    sa, _ = _block_attr(module, block, "service_account", "")
    cr.attrs["node_service_account"] = Attr(sa)
    md, _ = _block_attr(module, block, "metadata", None)
    if isinstance(md, dict) and "disable-legacy-endpoints" in md:
        v = md["disable-legacy-endpoints"]
        cr.attrs["legacy_endpoints"] = Attr(
            not (_known_true(v)), cr.attr_rng("node_image_type"))
    for wb in _sub_blocks(block, "workload_metadata_config"):
        for key in ("node_metadata", "mode"):
            v, vrng = _block_attr(module, wb, key)
            if isinstance(v, str):
                cr.attrs["node_metadata"] = Attr(v, vrng)


def _adapt_gke(module, res, cr):
    cr.attrs["shielded_nodes"] = Attr(
        res.value("enable_shielded_nodes", True),
        res.rng("enable_shielded_nodes"))
    cr.attrs["legacy_abac"] = Attr(res.value("enable_legacy_abac", False),
                                   res.rng("enable_legacy_abac"))
    cr.attrs["datapath_provider"] = Attr(
        res.value("datapath_provider", "DATAPATH_PROVIDER_UNSPECIFIED"))
    cr.attrs["logging_service"] = Attr(
        res.value("logging_service", "logging.googleapis.com/kubernetes"),
        res.rng("logging_service"))
    cr.attrs["monitoring_service"] = Attr(
        res.value("monitoring_service",
                  "monitoring.googleapis.com/kubernetes"),
        res.rng("monitoring_service"))
    labels = res.value("resource_labels")
    cr.attrs["resource_labels"] = Attr(
        labels if isinstance(labels, (dict, Unknown)) else {},
        res.rng("resource_labels"))
    cr.attrs["autopilot"] = Attr(res.value("enable_autopilot", False))
    cr.attrs["ip_aliasing"] = Attr(False)
    cr.attrs["master_networks"] = Attr(False)
    cr.attrs["network_policy"] = Attr(False)
    cr.attrs["private_nodes"] = Attr(False)
    cr.attrs["issue_client_cert"] = Attr(False)
    cr.attrs["master_username"] = Attr("")
    cr.attrs["legacy_endpoints"] = Attr(True)
    cr.attrs["node_service_account"] = Attr("")
    for b in res.blocks("ip_allocation_policy"):
        cr.attrs["ip_aliasing"] = Attr(True, (b.start, b.end))
    for b in res.blocks("master_authorized_networks_config"):
        cr.attrs["master_networks"] = Attr(True, (b.start, b.end))
    for b in res.blocks("network_policy"):
        v, rng = _block_attr(module, b, "enabled", False)
        cr.attrs["network_policy"] = Attr(v, rng)
    for b in res.blocks("private_cluster_config"):
        v, rng = _block_attr(module, b, "enable_private_nodes", False)
        cr.attrs["private_nodes"] = Attr(v, rng)
    for b in res.blocks("master_auth"):
        u, urng = _block_attr(module, b, "username", "")
        cr.attrs["master_username"] = Attr(u, urng)
        for cb in _sub_blocks(b, "client_certificate_config"):
            v, vrng = _block_attr(module, cb, "issue_client_certificate",
                                  False)
            cr.attrs["issue_client_cert"] = Attr(v, vrng)
    for b in res.blocks("node_config"):
        _adapt_gke_node_config(module, b, cr)


def _adapt_instance(module, res, cr):
    ifaces = []
    for b in res.blocks("network_interface"):
        has_public = bool(_sub_blocks(b, "access_config"))
        ifaces.append({"public_ip": has_public, "rng": (b.start, b.end)})
    cr.attrs["interfaces"] = Attr(ifaces)
    cr.attrs["can_ip_forward"] = Attr(res.value("can_ip_forward", False),
                                      res.rng("can_ip_forward"))
    # shielded VM: absent block -> all false; inside a block IM/vTPM
    # default true, secure boot false (reference instances.go:18-59)
    secure_boot = integrity = vtpm = False
    sh_rng = cr.rng
    for b in res.blocks("shielded_instance_config"):
        sh_rng = (b.start, b.end)
        integrity, _ = _block_attr(module, b, "enable_integrity_monitoring",
                                   True)
        vtpm, _ = _block_attr(module, b, "enable_vtpm", True)
        secure_boot, _ = _block_attr(module, b, "enable_secure_boot", False)
    cr.attrs["secure_boot"] = Attr(secure_boot, sh_rng)
    cr.attrs["integrity_monitoring"] = Attr(integrity, sh_rng)
    cr.attrs["vtpm"] = Attr(vtpm, sh_rng)
    md = res.value("metadata")
    md = md if isinstance(md, dict) else {}

    def _md_bool(key, absent):
        v = md.get(key)
        if isinstance(v, Unknown):
            return v          # unresolvable: checks must not fire
        return _known_true(v) if key in md else absent

    cr.attrs["oslogin"] = Attr(_md_bool("enable-oslogin", True),
                               res.rng("metadata"))
    cr.attrs["block_project_ssh_keys"] = Attr(
        _md_bool("block-project-ssh-keys", False), res.rng("metadata"))
    cr.attrs["serial_port"] = Attr(
        _md_bool("serial-port-enable", False), res.rng("metadata"))
    # service account: empty email or *-compute@developer... is default
    sa_default, sa_email, sa_rng = None, "", cr.rng
    for b in res.blocks("service_account"):
        sa_rng = (b.start, b.end)
        sa_email, _ = _block_attr(module, b, "email", "")
        if not isinstance(sa_email, str):
            sa_default = False      # reference-style block ref: not default
        else:
            sa_default = (sa_email == "" or sa_email.endswith(
                "-compute@developer.gserviceaccount.com"))
    cr.attrs["sa_is_default"] = Attr(sa_default, sa_rng)
    disks = []
    for btype in ("boot_disk", "attached_disk"):
        for b in res.blocks(btype):
            raw, _ = _block_attr(module, b, "disk_encryption_key_raw")
            kms, _ = _block_attr(module, b, "kms_key_self_link", "")
            disks.append({
                "raw_key": bool(raw) and not isinstance(raw, Unknown),
                "kms_key": kms,   # may be Unknown: CMK check skips it
                "rng": (b.start, b.end)})
    cr.attrs["disks"] = Attr(disks)


def _adapt_firewall(module, res, cr):
    # ranges apply to the firewall as a whole; allow blocks only decide
    # whether any traffic is admitted at all
    ingress, egress = [], []
    if res.blocks("allow"):
        src = res.value("source_ranges")
        dst = res.value("destination_ranges")
        direction = res.value("direction", "INGRESS")
        if isinstance(direction, str) and direction.upper() == "EGRESS":
            for c in (dst if isinstance(dst, list) else []):
                if isinstance(c, str):
                    egress.append({"cidr": c,
                                   "rng": res.rng("destination_ranges")})
        else:
            for c in (src if isinstance(src, list) else []):
                if isinstance(c, str):
                    ingress.append({"cidr": c,
                                    "rng": res.rng("source_ranges")})
    cr.attrs["ingress"] = Attr(ingress)
    cr.attrs["egress"] = Attr(egress)


def _adapt_dns(module, res, cr):
    state, s_rng = "off", cr.rng
    algos = []
    for b in res.blocks("dnssec_config"):
        state, s_rng = _block_attr(module, b, "state", "off")
        for kb in _sub_blocks(b, "default_key_specs"):
            alg, arng = _block_attr(module, kb, "algorithm", "")
            algos.append({"algorithm": alg, "rng": arng})
    cr.attrs["dnssec_state"] = Attr(state, s_rng)
    cr.attrs["key_algorithms"] = Attr(algos)


_IMPERSONATION_ROLES = ("roles/iam.serviceAccountUser",
                        "roles/iam.serviceAccountTokenCreator")


def _adapt_iam(res, cr, level):
    cr.attrs["level"] = Attr(level)
    cr.attrs["role"] = Attr(res.value("role", ""), res.rng("role"))
    members = []
    m = res.value("member")
    if isinstance(m, str):
        members.append(m)
    ms = res.value("members")
    if isinstance(ms, list):
        members.extend(x for x in ms if isinstance(x, str))
    cr.attrs["members"] = Attr(
        members, res.rng("member") if "member" in res.attrs
        else res.rng("members"))


def adapt_google(module) -> list[CloudResource]:
    """Adapt one TfModule's google_* resources into CloudResources."""
    out: list[CloudResource] = []
    for res in module.resources:
        t = res.type
        if not t.startswith("google_"):
            continue
        cr = CloudResource(t, res.name, rng=res.rng(), path=res.path)
        if t == "google_sql_database_instance":
            _adapt_sql(module, res, cr)
        elif t == "google_storage_bucket":
            cr.attrs["uniform_access"] = Attr(
                res.value("uniform_bucket_level_access", False),
                res.rng("uniform_bucket_level_access"))
            kms = ""
            for b in res.blocks("encryption"):
                kms, _ = _block_attr(module, b, "default_kms_key_name", "")
            cr.attrs["kms_key"] = Attr(kms)
        elif t in ("google_storage_bucket_iam_member",
                   "google_storage_bucket_iam_binding"):
            cr.kind = "google_storage_bucket_iam"
            _adapt_iam(res, cr, "bucket")
        elif t == "google_container_cluster":
            _adapt_gke(module, res, cr)
        elif t == "google_container_node_pool":
            ar = au = False
            m_rng = cr.rng
            for b in res.blocks("management"):
                m_rng = (b.start, b.end)
                ar, _ = _block_attr(module, b, "auto_repair", False)
                au, _ = _block_attr(module, b, "auto_upgrade", False)
            cr.attrs["auto_repair"] = Attr(ar, m_rng)
            cr.attrs["auto_upgrade"] = Attr(au, m_rng)
            for b in res.blocks("node_config"):
                _adapt_gke_node_config(module, b, cr)
        elif t == "google_compute_instance":
            _adapt_instance(module, res, cr)
        elif t == "google_compute_disk":
            raw, kms = False, ""
            rng = cr.rng
            for b in res.blocks("disk_encryption_key"):
                rng = (b.start, b.end)
                rk, _ = _block_attr(module, b, "raw_key")
                raw = bool(rk) and not isinstance(rk, Unknown)
                kms, _ = _block_attr(module, b, "kms_key_self_link", "")
            cr.attrs["raw_key"] = Attr(raw, rng)
            cr.attrs["kms_key"] = Attr(kms, rng)
        elif t == "google_compute_firewall":
            _adapt_firewall(module, res, cr)
        elif t == "google_compute_subnetwork":
            cr.attrs["flow_logs"] = Attr(bool(res.blocks("log_config")))
            cr.attrs["purpose"] = Attr(res.value("purpose", ""))
        elif t == "google_compute_ssl_policy":
            cr.attrs["min_tls_version"] = Attr(
                res.value("min_tls_version", "TLS_1_0"),
                res.rng("min_tls_version"))
            cr.attrs["profile"] = Attr(res.value("profile", ""))
        elif t == "google_compute_project_metadata":
            md = res.value("metadata")
            md = md if isinstance(md, dict) else {}
            cr.attrs["oslogin"] = Attr(
                _known_true(md.get("enable-oslogin")), res.rng("metadata"))
        elif t == "google_dns_managed_zone":
            _adapt_dns(module, res, cr)
        elif t == "google_kms_crypto_key":
            period = res.value("rotation_period")
            seconds = None
            if isinstance(period, Unknown):
                seconds = period           # unknown passes the check
            elif isinstance(period, str) and period.endswith("s"):
                try:
                    seconds = int(float(period[:-1]))
                except ValueError:
                    seconds = None
            cr.attrs["rotation_seconds"] = Attr(
                seconds, res.rng("rotation_period"))
        elif t == "google_bigquery_dataset":
            groups = []
            for b in res.blocks("access"):
                g, grng = _block_attr(module, b, "special_group", "")
                if isinstance(g, str) and g:
                    groups.append({"group": g, "rng": grng})
            cr.attrs["special_groups"] = Attr(groups)
        elif t in ("google_project_iam_member", "google_project_iam_binding"):
            cr.kind = "google_iam_grant"
            _adapt_iam(res, cr, "project")
        elif t in ("google_folder_iam_member", "google_folder_iam_binding"):
            cr.kind = "google_iam_grant"
            _adapt_iam(res, cr, "folder")
        elif t in ("google_organization_iam_member",
                   "google_organization_iam_binding"):
            cr.kind = "google_iam_grant"
            _adapt_iam(res, cr, "organization")
        elif t == "google_project":
            cr.attrs["auto_create_network"] = Attr(
                res.value("auto_create_network", True),
                res.rng("auto_create_network"))
        else:
            continue
        out.append(cr)
    return out


# ---------------------------------------------------------------------
# Checks — Cloud SQL
# ---------------------------------------------------------------------

def _family(r):
    v = r.get("database_version", "")
    return v.split("_")[0] if isinstance(v, str) else ""


@_gcp("AVD-GCP-0003", "Cloud SQL instances should have automated backups "
      "enabled", "MEDIUM", "sql",
      "Without automated backups a database cannot be restored after "
      "data loss or corruption.", "Enable backup_configuration.")
def _sql_backups(resources):
    for r in _of(resources, "google_sql_database_instance"):
        if _known_true(r.get("is_replica")):
            continue
        if _known_false(r.val("backups_enabled")):
            yield (f"Database instance '{r.name}' does not have backups "
                   f"enabled.", r.attr_rng("backups_enabled"))


@_gcp("AVD-GCP-0017", "Cloud SQL instances should not be publicly "
      "accessible", "HIGH", "sql",
      "Publicly reachable database instances expose the attack surface "
      "to the entire internet.",
      "Disable public IPv4 or restrict authorized networks.")
def _sql_public(resources):
    for r in _of(resources, "google_sql_database_instance"):
        for n in r.get("authorized_networks", []):
            if n.get("cidr") in ("0.0.0.0/0", "::/0"):
                yield (f"Database instance '{r.name}' authorizes access "
                       f"from anywhere.", n["rng"])


@_gcp("AVD-GCP-0015", "Cloud SQL instances should require TLS for all "
      "connections", "HIGH", "sql",
      "Unencrypted connections expose data in transit.",
      "Set settings.ip_configuration.require_ssl = true.")
def _sql_tls(resources):
    for r in _of(resources, "google_sql_database_instance"):
        if _known_false(r.val("require_ssl")):
            yield (f"Database instance '{r.name}' does not require TLS for "
                   f"all connections.", r.attr_rng("require_ssl"))


def _pg_flag_check(id_, flag, title):
    @_gcp(id_, title, "MEDIUM", "sql",
          f"The {flag} flag aids audit and incident analysis on "
          f"PostgreSQL instances.", f"Set the {flag} database flag to on.")
    def check(resources):
        for r in _of(resources, "google_sql_database_instance"):
            if _family(r) != "POSTGRES":
                continue
            flags = r.get("flags", {})
            if isinstance(flags.get(flag), Unknown):
                continue
            if flags.get(flag) != "on":
                rng = r.get("flag_rngs", {}).get(flag, r.rng)
                yield (f"Database instance '{r.name}' is not configured "
                       f"to log {flag.replace('log_', '').replace('_', ' ')}"
                       f".", rng)
    return check


_pg_flag_check("AVD-GCP-0016", "log_checkpoints",
               "PostgreSQL instances should log checkpoints")
_pg_flag_check("AVD-GCP-0014", "log_connections",
               "PostgreSQL instances should log connections")
_pg_flag_check("AVD-GCP-0022", "log_disconnections",
               "PostgreSQL instances should log disconnections")
_pg_flag_check("AVD-GCP-0020", "log_lock_waits",
               "PostgreSQL instances should log lock waits")


@_gcp("AVD-GCP-0026", "MySQL instances should not allow local data "
      "loading", "HIGH", "sql",
      "local_infile allows reading files from the server host during "
      "LOAD DATA operations.", "Set the local_infile flag to off.")
def _sql_local_infile(resources):
    for r in _of(resources, "google_sql_database_instance"):
        if _family(r) != "MYSQL":
            continue
        v = r.get("flags", {}).get("local_infile")
        if not isinstance(v, Unknown) and v == "on":
            yield (f"Database instance '{r.name}' has local file reads "
                   f"enabled.",
                   r.get("flag_rngs", {}).get("local_infile", r.rng))


def _sqlserver_flag_check(id_, flag, title):
    @_gcp(id_, title, "MEDIUM", "sql",
          f"The '{flag}' flag should be disabled on SQL Server "
          f"instances.", f"Set the '{flag}' database flag to off.")
    def check(resources):
        for r in _of(resources, "google_sql_database_instance"):
            if _family(r) != "SQLSERVER":
                continue
            if isinstance(r.get("flags", {}).get(flag), Unknown):
                continue
            # reference default: enabled unless explicitly set off
            if r.get("flags", {}).get(flag) != "off":
                rng = r.get("flag_rngs", {}).get(flag, r.rng)
                yield (f"Database instance '{r.name}' does not disable "
                       f"'{flag}'.", rng)
    return check


_sqlserver_flag_check(
    "AVD-GCP-0023", "contained database authentication",
    "SQL Server instances should disable contained database "
    "authentication")
_sqlserver_flag_check(
    "AVD-GCP-0019", "cross db ownership chaining",
    "SQL Server instances should disable cross-database ownership "
    "chaining")


# ---------------------------------------------------------------------
# Checks — Cloud Storage
# ---------------------------------------------------------------------

_PUBLIC_MEMBERS = ("allUsers", "allAuthenticatedUsers")


@_gcp("AVD-GCP-0001", "Storage buckets should not be publicly accessible",
      "HIGH", "storage",
      "Granting allUsers or allAuthenticatedUsers exposes the bucket "
      "contents to everyone.", "Restrict IAM members to identities.")
def _storage_public(resources):
    for r in _of(resources, "google_storage_bucket_iam"):
        for m in r.get("members", []):
            if m in _PUBLIC_MEMBERS:
                yield (f"Bucket IAM grant '{r.name}' allows public access "
                       f"({m}).", r.attr_rng("members"))


@_gcp("AVD-GCP-0002", "Storage buckets should enable uniform bucket-level "
      "access", "MEDIUM", "storage",
      "Uniform bucket-level access disables per-object ACLs, leaving "
      "IAM as the single access-control plane.",
      "Set uniform_bucket_level_access = true.")
def _storage_ubla(resources):
    for r in _of(resources, "google_storage_bucket"):
        if _known_false(r.val("uniform_access")):
            yield (f"Bucket '{r.name}' does not enable uniform "
                   f"bucket-level access.", r.attr_rng("uniform_access"))


@_gcp("AVD-GCP-0066", "Storage buckets should be encrypted with "
      "customer-managed keys", "LOW", "storage",
      "Customer-managed KMS keys give control over key rotation and "
      "revocation.", "Set encryption.default_kms_key_name.")
def _storage_cmk(resources):
    for r in _of(resources, "google_storage_bucket"):
        if r.unknown("kms_key"):
            continue
        if not r.get("kms_key"):
            yield (f"Bucket '{r.name}' is not encrypted with a "
                   f"customer-managed key.", r.rng)


# ---------------------------------------------------------------------
# Checks — GKE
# ---------------------------------------------------------------------

@_gcp("AVD-GCP-0060", "GKE clusters should not use legacy ABAC",
      "HIGH", "gke",
      "Legacy ABAC grants broad, coarse permissions and predates RBAC.",
      "Set enable_legacy_abac = false.")
def _gke_abac(resources):
    for r in _of(resources, "google_container_cluster"):
        if _known_true(r.val("legacy_abac")):
            yield (f"Cluster '{r.name}' has legacy ABAC enabled.",
                   r.attr_rng("legacy_abac"))


@_gcp("AVD-GCP-0056", "GKE clusters should have a network policy enabled",
      "MEDIUM", "gke",
      "Without network policies any pod may talk to any other pod.",
      "Enable network_policy (or the ADVANCED_DATAPATH dataplane).")
def _gke_netpol(resources):
    for r in _of(resources, "google_container_cluster"):
        if r.get("datapath_provider") == "ADVANCED_DATAPATH":
            continue
        if _known_false(r.val("network_policy")):
            yield (f"Cluster '{r.name}' does not have a network policy "
                   f"enabled.", r.attr_rng("network_policy"))


@_gcp("AVD-GCP-0053", "GKE clusters should use private nodes",
      "MEDIUM", "gke",
      "Nodes with public IPs are directly reachable from the internet.",
      "Set private_cluster_config.enable_private_nodes = true.")
def _gke_private(resources):
    for r in _of(resources, "google_container_cluster"):
        if _known_false(r.val("private_nodes")):
            yield (f"Cluster '{r.name}' does not use private nodes.",
                   r.attr_rng("private_nodes"))


@_gcp("AVD-GCP-0051", "GKE clusters should enable master authorized "
      "networks", "MEDIUM", "gke",
      "Master authorized networks restrict control-plane access to "
      "known CIDR ranges.",
      "Add a master_authorized_networks_config block.")
def _gke_master_networks(resources):
    for r in _of(resources, "google_container_cluster"):
        if _known_false(r.val("master_networks")):
            yield (f"Cluster '{r.name}' does not enable master authorized "
                   f"networks.", r.attr_rng("master_networks"))


@_gcp("AVD-GCP-0054", "GKE clusters should have shielded nodes enabled",
      "HIGH", "gke",
      "Shielded nodes provide verifiable node identity and integrity.",
      "Keep enable_shielded_nodes = true.")
def _gke_shielded(resources):
    for r in _of(resources, "google_container_cluster"):
        if _known_false(r.val("shielded_nodes")):
            yield (f"Cluster '{r.name}' has shielded nodes disabled.",
                   r.attr_rng("shielded_nodes"))


@_gcp("AVD-GCP-0055", "GKE clusters should not use basic authentication",
      "HIGH", "gke",
      "Basic auth places a static username/password on the API server.",
      "Remove master_auth username/password.")
def _gke_basic_auth(resources):
    for r in _of(resources, "google_container_cluster"):
        u = r.get("master_username", "")
        if isinstance(u, str) and u:
            yield (f"Cluster '{r.name}' uses basic authentication.",
                   r.attr_rng("master_username"))


@_gcp("AVD-GCP-0052", "GKE clusters should not issue client certificates",
      "MEDIUM", "gke",
      "Client certificates cannot be revoked without rotating the "
      "cluster CA.",
      "Set client_certificate_config.issue_client_certificate = false.")
def _gke_client_cert(resources):
    for r in _of(resources, "google_container_cluster"):
        if _known_true(r.val("issue_client_cert")):
            yield (f"Cluster '{r.name}' issues a client certificate.",
                   r.attr_rng("issue_client_cert"))


@_gcp("AVD-GCP-0057", "GKE clusters should have IP aliasing enabled",
      "LOW", "gke",
      "IP aliasing (VPC-native networking) enables network policy "
      "enforcement and private access paths.",
      "Add an ip_allocation_policy block.")
def _gke_ip_alias(resources):
    for r in _of(resources, "google_container_cluster"):
        if _known_false(r.val("ip_aliasing")):
            yield (f"Cluster '{r.name}' does not have IP aliasing "
                   f"enabled.", r.attr_rng("ip_aliasing"))


@_gcp("AVD-GCP-0038", "GKE clusters should have logging enabled",
      "MEDIUM", "gke",
      "Disabling cluster logging removes the audit trail.",
      "Leave logging_service at its kubernetes default.")
def _gke_logging(resources):
    for r in _of(resources, "google_container_cluster"):
        if r.get("logging_service") == "none":
            yield (f"Cluster '{r.name}' has logging disabled.",
                   r.attr_rng("logging_service"))


@_gcp("AVD-GCP-0040", "GKE clusters should have monitoring enabled",
      "MEDIUM", "gke",
      "Disabling monitoring removes visibility into cluster health.",
      "Leave monitoring_service at its kubernetes default.")
def _gke_monitoring(resources):
    for r in _of(resources, "google_container_cluster"):
        if r.get("monitoring_service") == "none":
            yield (f"Cluster '{r.name}' has monitoring disabled.",
                   r.attr_rng("monitoring_service"))


@_gcp("AVD-GCP-0062", "GKE clusters should have resource labels",
      "LOW", "gke",
      "Resource labels support cost attribution and policy targeting.",
      "Set resource_labels.")
def _gke_labels(resources):
    for r in _of(resources, "google_container_cluster"):
        if r.unknown("resource_labels"):
            continue
        if not r.get("resource_labels"):
            yield (f"Cluster '{r.name}' does not set resource labels.",
                   r.attr_rng("resource_labels"))


@_gcp("AVD-GCP-0049", "GKE nodes should disable legacy metadata endpoints",
      "HIGH", "gke",
      "The v0.1/v1beta1 metadata endpoints expose instance metadata "
      "without requiring custom headers.",
      "Set node metadata disable-legacy-endpoints = true.")
def _gke_legacy_endpoints(resources):
    for r in resources:
        if r.kind not in ("google_container_cluster",
                          "google_container_node_pool"):
            continue
        if r.kind == "google_container_cluster" and \
                _known_true(r.val("autopilot")):
            continue
        v = r.val("legacy_endpoints")
        if v is None and r.kind == "google_container_node_pool":
            continue
        if not _known_false(v):
            yield (f"'{r.name}' does not disable legacy metadata "
                   f"endpoints.", r.attr_rng("legacy_endpoints"))


@_gcp("AVD-GCP-0050", "GKE nodes should conceal workload metadata",
      "HIGH", "gke",
      "Exposed node metadata lets workloads read node credentials.",
      "Set workload_metadata_config mode to GKE_METADATA (or SECURE).")
def _gke_node_metadata(resources):
    for r in resources:
        if r.kind not in ("google_container_cluster",
                          "google_container_node_pool"):
            continue
        v = r.get("node_metadata")
        if isinstance(v, str) and v.upper() in ("EXPOSE", "EXPOSED",
                                                "UNSPECIFIED"):
            yield (f"'{r.name}' exposes node metadata to workloads.",
                   r.attr_rng("node_metadata"))


@_gcp("AVD-GCP-0048", "GKE node pools should have auto-repair enabled",
      "LOW", "gke",
      "Auto-repair replaces unhealthy nodes automatically.",
      "Set management.auto_repair = true.")
def _gke_auto_repair(resources):
    for r in _of(resources, "google_container_node_pool"):
        if _known_false(r.val("auto_repair")):
            yield (f"Node pool '{r.name}' does not have auto-repair "
                   f"enabled.", r.attr_rng("auto_repair"))


@_gcp("AVD-GCP-0058", "GKE node pools should have auto-upgrade enabled",
      "LOW", "gke",
      "Auto-upgrade keeps node kubelets patched.",
      "Set management.auto_upgrade = true.")
def _gke_auto_upgrade(resources):
    for r in _of(resources, "google_container_node_pool"):
        if _known_false(r.val("auto_upgrade")):
            yield (f"Node pool '{r.name}' does not have auto-upgrade "
                   f"enabled.", r.attr_rng("auto_upgrade"))


@_gcp("AVD-GCP-0059", "GKE nodes should use the COS image type",
      "LOW", "gke",
      "Container-Optimized OS has a minimal, verified attack surface.",
      "Set node_config.image_type to a COS variant.")
def _gke_cos(resources):
    for r in resources:
        if r.kind not in ("google_container_cluster",
                          "google_container_node_pool"):
            continue
        it = r.get("node_image_type", "")
        if isinstance(it, str) and it and \
                not it.upper().startswith("COS"):
            yield (f"'{r.name}' does not use a Container-Optimized OS "
                   f"node image.", r.attr_rng("node_image_type"))


# ---------------------------------------------------------------------
# Checks — Compute
# ---------------------------------------------------------------------

@_gcp("AVD-GCP-0031", "Compute instances should not have public IP "
      "addresses", "HIGH", "compute",
      "Instances with external IPs are directly reachable from the "
      "internet.", "Remove the access_config block.")
def _inst_public_ip(resources):
    for r in _of(resources, "google_compute_instance"):
        for iface in r.get("interfaces", []):
            if iface["public_ip"]:
                yield (f"Instance '{r.name}' has a public IP allocated.",
                       iface["rng"])


@_gcp("AVD-GCP-0043", "Compute instances should not have IP forwarding "
      "enabled", "HIGH", "compute",
      "IP forwarding lets an instance spoof or route foreign traffic.",
      "Set can_ip_forward = false.")
def _inst_ip_forward(resources):
    for r in _of(resources, "google_compute_instance"):
        if _known_true(r.val("can_ip_forward")):
            yield (f"Instance '{r.name}' has IP forwarding allowed.",
                   r.attr_rng("can_ip_forward"))


@_gcp("AVD-GCP-0044", "Compute instances should not use the default "
      "service account", "HIGH", "compute",
      "The default service account carries project-editor privileges.",
      "Attach a minimally-scoped service account.")
def _inst_default_sa(resources):
    for r in _of(resources, "google_compute_instance"):
        if _known_true(r.val("sa_is_default")):
            yield (f"Instance '{r.name}' uses the default service "
                   f"account.", r.attr_rng("sa_is_default"))


@_gcp("AVD-GCP-0030", "Compute instances should block project-wide SSH "
      "keys", "MEDIUM", "compute",
      "Project-wide SSH keys grant every key holder access to every "
      "instance.", "Set metadata block-project-ssh-keys = true.")
def _inst_ssh_keys(resources):
    for r in _of(resources, "google_compute_instance"):
        if _known_false(r.val("block_project_ssh_keys")):
            yield (f"Instance '{r.name}' does not block project-wide SSH "
                   f"keys.", r.attr_rng("block_project_ssh_keys"))


@_gcp("AVD-GCP-0032", "Compute instances should disable serial port "
      "access", "MEDIUM", "compute",
      "The interactive serial console bypasses firewall rules.",
      "Remove metadata serial-port-enable.")
def _inst_serial(resources):
    for r in _of(resources, "google_compute_instance"):
        if _known_true(r.val("serial_port")):
            yield (f"Instance '{r.name}' enables serial port access.",
                   r.attr_rng("serial_port"))


@_gcp("AVD-GCP-0036", "Compute instances should not override OS Login",
      "MEDIUM", "compute",
      "Disabling OS Login re-enables static metadata SSH keys.",
      "Remove metadata enable-oslogin = false.")
def _inst_oslogin(resources):
    for r in _of(resources, "google_compute_instance"):
        if _known_false(r.val("oslogin")):
            yield (f"Instance '{r.name}' disables OS Login.",
                   r.attr_rng("oslogin"))


def _shield_check(id_, attr, what):
    @_gcp(id_, f"Compute instances should have Shielded VM {what} "
          f"enabled", "MEDIUM", "compute",
          f"Shielded VM {what} protects the boot chain and runtime "
          f"integrity of the instance.",
          f"Enable {attr} in shielded_instance_config.")
    def check(resources):
        for r in _of(resources, "google_compute_instance"):
            if _known_false(r.val(attr)):
                yield (f"Instance '{r.name}' does not have Shielded VM "
                       f"{what} enabled.", r.attr_rng(attr))
    return check


_shield_check("AVD-GCP-0067", "secure_boot", "secure boot")
_shield_check("AVD-GCP-0045", "integrity_monitoring",
              "integrity monitoring")
_shield_check("AVD-GCP-0068", "vtpm", "vTPM")


@_gcp("AVD-GCP-0037", "Compute disks should not embed plaintext "
      "encryption keys", "CRITICAL", "compute",
      "A raw key in the configuration leaks the disk key to anyone who "
      "can read state or source.", "Use a KMS key instead of a raw key.")
def _disk_raw_key(resources):
    for r in _of(resources, "google_compute_disk"):
        if _known_true(r.val("raw_key")):
            yield (f"Disk '{r.name}' specifies a plaintext encryption "
                   f"key.", r.attr_rng("raw_key"))
    for r in _of(resources, "google_compute_instance"):
        for d in r.get("disks", []):
            if d["raw_key"]:
                yield (f"Instance '{r.name}' attaches a disk with a "
                       f"plaintext encryption key.", d["rng"])


@_gcp("AVD-GCP-0034", "Compute disks should be encrypted with "
      "customer-managed keys", "LOW", "compute",
      "Customer-managed keys allow rotation and revocation control.",
      "Set disk_encryption_key.kms_key_self_link.")
def _disk_cmk(resources):
    for r in _of(resources, "google_compute_disk"):
        if r.unknown("kms_key"):
            continue
        if not r.get("kms_key") and not _known_true(r.val("raw_key")):
            yield (f"Disk '{r.name}' is not encrypted with a "
                   f"customer-managed key.", r.rng)


@_gcp("AVD-GCP-0033", "Instance disks should be encrypted with "
      "customer-managed keys", "LOW", "compute",
      "Customer-managed keys allow rotation and revocation control.",
      "Set kms_key_self_link on boot/attached disks.")
def _inst_disk_cmk(resources):
    for r in _of(resources, "google_compute_instance"):
        for d in r.get("disks", []):
            if isinstance(d["kms_key"], Unknown):
                continue
            if not d["kms_key"] and not d["raw_key"]:
                yield (f"Instance '{r.name}' has a disk without a "
                       f"customer-managed encryption key.", d["rng"])


@_gcp("AVD-GCP-0027", "Firewall rules should not permit public ingress",
      "HIGH", "compute",
      "An allow rule from 0.0.0.0/0 opens the port to the internet.",
      "Restrict source_ranges.")
def _fw_ingress(resources):
    for r in _of(resources, "google_compute_firewall"):
        for rule in r.get("ingress", []):
            if rule["cidr"] in ("0.0.0.0/0", "::/0", "0.0.0.0"):
                yield (f"Firewall '{r.name}' allows ingress from anywhere.",
                       rule["rng"])


@_gcp("AVD-GCP-0035", "Firewall rules should not permit public egress",
      "HIGH", "compute",
      "Unrestricted egress allows exfiltration to any destination.",
      "Restrict destination_ranges.")
def _fw_egress(resources):
    for r in _of(resources, "google_compute_firewall"):
        for rule in r.get("egress", []):
            if rule["cidr"] in ("0.0.0.0/0", "::/0", "0.0.0.0"):
                yield (f"Firewall '{r.name}' allows egress to anywhere.",
                       rule["rng"])


@_gcp("AVD-GCP-0029", "VPC subnetworks should have flow logs enabled",
      "LOW", "compute",
      "Flow logs record network traffic for audit and forensics.",
      "Add a log_config block.")
def _subnet_flow_logs(resources):
    for r in _of(resources, "google_compute_subnetwork"):
        purpose = r.get("purpose", "")
        if purpose in ("REGIONAL_MANAGED_PROXY",
                       "INTERNAL_HTTPS_LOAD_BALANCER"):
            continue
        if _known_false(r.val("flow_logs")):
            yield (f"Subnetwork '{r.name}' does not have flow logs "
                   f"enabled.", r.rng)


@_gcp("AVD-GCP-0039", "SSL policies should use a secure TLS version",
      "MEDIUM", "compute",
      "TLS versions below 1.2 have known weaknesses.",
      "Set min_tls_version = TLS_1_2.")
def _ssl_policy(resources):
    for r in _of(resources, "google_compute_ssl_policy"):
        v = r.get("min_tls_version", "TLS_1_0")
        if isinstance(v, str) and v != "TLS_1_2":
            yield (f"SSL policy '{r.name}' allows TLS versions below "
                   f"1.2.", r.attr_rng("min_tls_version"))


@_gcp("AVD-GCP-0042", "Projects should have OS Login enabled", "MEDIUM",
      "compute",
      "OS Login centralizes SSH access through IAM.",
      "Set project metadata enable-oslogin = true.")
def _project_oslogin(resources):
    for r in _of(resources, "google_compute_project_metadata"):
        if _known_false(r.val("oslogin")):
            yield ("Project metadata does not enable OS Login.",
                   r.attr_rng("oslogin"))


# ---------------------------------------------------------------------
# Checks — DNS / KMS / BigQuery / IAM
# ---------------------------------------------------------------------

@_gcp("AVD-GCP-0012", "Managed DNS zones should have DNSSEC enabled",
      "MEDIUM", "dns",
      "DNSSEC protects zone records from spoofing.",
      "Set dnssec_config.state = on.")
def _dns_dnssec(resources):
    for r in _of(resources, "google_dns_managed_zone"):
        state = r.get("dnssec_state", "off")
        if isinstance(state, str) and state != "on":
            yield (f"Managed zone '{r.name}' does not have DNSSEC "
                   f"enabled.", r.attr_rng("dnssec_state"))


@_gcp("AVD-GCP-0011", "Zone-signing keys should not use RSASHA1",
      "MEDIUM", "dns",
      "RSASHA1 is cryptographically weak for DNSSEC signing.",
      "Use RSASHA256 or an elliptic-curve algorithm.")
def _dns_rsasha1(resources):
    for r in _of(resources, "google_dns_managed_zone"):
        for spec in r.get("key_algorithms", []):
            if spec["algorithm"] == "rsasha1":
                yield (f"Managed zone '{r.name}' signs with RSASHA1.",
                       spec["rng"])


@_gcp("AVD-GCP-0065", "KMS keys should be rotated at least every 90 days",
      "HIGH", "kms",
      "Stale keys grow the blast radius of a key compromise.",
      "Set rotation_period to 7776000s or less.")
def _kms_rotation(resources):
    for r in _of(resources, "google_kms_crypto_key"):
        if r.unknown("rotation_seconds"):
            continue
        secs = r.get("rotation_seconds")
        if secs is None or secs > 7776000:
            yield (f"KMS key '{r.name}' is not rotated at least every "
                   f"90 days.", r.attr_rng("rotation_seconds"))


@_gcp("AVD-GCP-0046", "BigQuery datasets should not be publicly "
      "accessible", "CRITICAL", "bigquery",
      "allAuthenticatedUsers means every Google account holder.",
      "Restrict dataset access to specific identities.")
def _bq_public(resources):
    for r in _of(resources, "google_bigquery_dataset"):
        for g in r.get("special_groups", []):
            if g["group"] == "allAuthenticatedUsers":
                yield (f"Dataset '{r.name}' is accessible to all "
                       f"authenticated users.", g["rng"])


_PRIVILEGED_RE = re.compile(
    r"^roles/(owner|editor)$|(Admin|admin)$")


@_gcp("AVD-GCP-0007", "Service accounts should not have roles assigned "
      "with excessive privileges", "HIGH", "iam",
      "Service accounts should have a minimal set of permissions "
      "assigned in order to do their job. They should never have "
      "excessive access as if compromised, an attacker can escalate "
      "privileges and take over the entire account.",
      "Limit service account roles to minimal required access.")
def _iam_privileged_sa(resources):
    for r in _of(resources, "google_iam_grant"):
        role = r.get("role", "")
        if not (isinstance(role, str) and _PRIVILEGED_RE.search(role)):
            continue
        for m in r.get("members", []):
            if m.startswith("serviceAccount:"):
                yield ("Service account is granted a privileged role.",
                       r.attr_rng("members"))


def _impersonation_check(id_, level):
    @_gcp(id_, f"Service-account impersonation should not be granted at "
          f"the {level} level", "HIGH", "iam",
          "serviceAccountUser / serviceAccountTokenCreator at a "
          "hierarchy level allows impersonating every service account "
          "below it.", "Grant impersonation on specific accounts only.")
    def check(resources):
        for r in _of(resources, "google_iam_grant"):
            if r.get("level") != level:
                continue
            if r.get("role", "") in _IMPERSONATION_ROLES:
                yield (f"Impersonation role granted at {level} level.",
                       r.attr_rng("role"))
    return check


_impersonation_check("AVD-GCP-0005", "project")
_impersonation_check("AVD-GCP-0006", "folder")
_impersonation_check("AVD-GCP-0004", "organization")


@_gcp("AVD-GCP-0010", "Projects should not have the default network",
      "HIGH", "iam",
      "The auto-created default network ships permissive firewall "
      "rules.", "Set auto_create_network = false.")
def _project_default_network(resources):
    for r in _of(resources, "google_project"):
        if _known_true(r.val("auto_create_network")):
            yield (f"Project '{r.name}' creates the default network.",
                   r.attr_rng("auto_create_network"))
