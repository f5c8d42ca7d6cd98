"""Minor-cloud IaC support: DigitalOcean, Nifcloud, OpenStack, GitHub,
Oracle and CloudStack terraform adapters + check sets.

Reference counterparts: pkg/iac/providers/{digitalocean,nifcloud,
openstack,github,oracle,cloudstack}/** (typed state) and
pkg/iac/adapters/terraform/<provider>/** for the resource-type and
attribute mapping (e.g. nifcloud_db_instance publicly_accessible
defaults true and network_id defaults net-COMMON_PRIVATE per
rdb/db_instance.go; digitalocean_spaces_bucket acl defaults
public-read per spaces/adapt.go).  Check bodies are re-authored from
that typed state with IDs following the published AVD series."""

from __future__ import annotations

import re

from .cloud import (Attr, CloudResource, Unknown, block_attr,
                    sub_blocks)
from .core import Check

EXTRA_CHECKS: list[Check] = []


def _reg(provider, service):
    def make(id_, title, severity, description="", resolution=""):
        def deco(fn):
            EXTRA_CHECKS.append(Check(
                id=id_, avd_id=id_, title=title, severity=severity,
                description=description, resolution=resolution,
                provider=provider, service=service,
                namespace=f"builtin.{provider.lower()}.{service}.{id_}",
                fn=fn))
            return fn
        return deco
    return make


def _of(resources, kind):
    return [r for r in resources if r.kind == kind]


def _known(v):
    return not isinstance(v, Unknown)


def _public_cidr(c):
    return c in ("0.0.0.0/0", "::/0", "0.0.0.0")


# ---------------------------------------------------------------------
# Adapter
# ---------------------------------------------------------------------

_PREFIXES = ("digitalocean_", "nifcloud_", "openstack_", "github_",
             "opc_", "cloudstack_")


_sub_blocks = sub_blocks
_block_attr = block_attr


def _rule_cidrs(module, res, btype, key):
    out = []
    for b in res.blocks(btype):
        v, rng = _block_attr(module, b, key)
        if isinstance(v, list):
            out.extend({"cidr": c, "rng": rng} for c in v
                       if isinstance(c, str))
        elif isinstance(v, str):
            out.append({"cidr": v, "rng": rng})
    return out


def adapt_extra(module) -> list[CloudResource]:
    """Adapt minor-provider terraform resources into CloudResources."""
    out: list[CloudResource] = []
    for res in module.resources:
        t = res.type
        if not t.startswith(_PREFIXES):
            continue
        cr = CloudResource(t, res.name, rng=res.rng(), path=res.path)

        if t == "digitalocean_firewall":
            cr.attrs["inbound"] = Attr(
                _rule_cidrs(module, res, "inbound_rule",
                            "source_addresses"))
            cr.attrs["outbound"] = Attr(
                _rule_cidrs(module, res, "outbound_rule",
                            "destination_addresses"))
        elif t == "digitalocean_droplet":
            keys = res.value("ssh_keys")
            if not isinstance(keys, (list, Unknown)):
                keys = []
            cr.attrs["ssh_keys"] = Attr(keys, res.rng("ssh_keys"))
        elif t == "digitalocean_loadbalancer":
            rules = []
            for b in res.blocks("forwarding_rule"):
                proto, rng = _block_attr(module, b, "entry_protocol", "")
                rules.append({"entry_protocol":
                              proto.lower() if isinstance(proto, str)
                              else "", "rng": rng})
            cr.attrs["forwarding_rules"] = Attr(rules)
            cr.attrs["redirect_http_to_https"] = Attr(
                res.value("redirect_http_to_https", False))
        elif t == "digitalocean_kubernetes_cluster":
            cr.attrs["auto_upgrade"] = Attr(
                res.value("auto_upgrade", False), res.rng("auto_upgrade"))
            cr.attrs["surge_upgrade"] = Attr(
                res.value("surge_upgrade", False),
                res.rng("surge_upgrade"))
        elif t == "digitalocean_spaces_bucket":
            cr.attrs["acl"] = Attr(res.value("acl", "public-read"),
                                   res.rng("acl"))
            cr.attrs["force_destroy"] = Attr(
                res.value("force_destroy", False),
                res.rng("force_destroy"))
            versioning = False
            v_rng = cr.rng
            for b in res.blocks("versioning"):
                versioning, v_rng = _block_attr(module, b, "enabled",
                                                False)
            cr.attrs["versioning"] = Attr(versioning, v_rng)
        elif t == "digitalocean_spaces_bucket_object":
            cr.attrs["acl"] = Attr(res.value("acl", "private"),
                                   res.rng("acl"))

        elif t == "nifcloud_security_group":
            cr.attrs["description"] = Attr(
                res.value("description", ""), res.rng("description"))
        elif t == "nifcloud_security_group_rule":
            cr.attrs["cidr"] = Attr(res.value("cidr_ip", ""),
                                    res.rng("cidr_ip"))
            cr.attrs["type"] = Attr(res.value("type", "IN"))
        elif t == "nifcloud_instance":
            cr.attrs["security_group"] = Attr(
                res.value("security_group", ""),
                res.rng("security_group"))
            nets = []
            for b in res.blocks("network_interface"):
                nid, rng = _block_attr(module, b, "network_id", "")
                nets.append({"network_id": nid, "rng": rng})
            cr.attrs["interfaces"] = Attr(nets)
        elif t == "nifcloud_router":
            cr.attrs["security_group"] = Attr(
                res.value("security_group", ""),
                res.rng("security_group"))
        elif t == "nifcloud_vpn_gateway":
            cr.attrs["security_group"] = Attr(
                res.value("security_group", ""),
                res.rng("security_group"))
        elif t == "nifcloud_load_balancer":
            cr.attrs["port"] = Attr(res.value("load_balancer_port"),
                                    res.rng("load_balancer_port"))
            cr.attrs["ssl_policy"] = Attr(
                res.value("ssl_policy_id")
                or res.value("ssl_policy_name") or "")
        elif t == "nifcloud_elb":
            cr.attrs["protocol"] = Attr(res.value("protocol", ""),
                                        res.rng("protocol"))
            nets = []
            for b in res.blocks("network_interface"):
                nid, rng = _block_attr(module, b, "network_id", "")
                nets.append({"network_id": nid, "rng": rng})
            cr.attrs["interfaces"] = Attr(nets)
        elif t == "nifcloud_db_instance":
            cr.attrs["backup_retention"] = Attr(
                res.value("backup_retention_period", 0),
                res.rng("backup_retention_period"))
            # reference default: publicly accessible unless disabled
            cr.attrs["public"] = Attr(
                res.value("publicly_accessible", True),
                res.rng("publicly_accessible"))
            cr.attrs["network_id"] = Attr(
                res.value("network_id", "net-COMMON_PRIVATE"),
                res.rng("network_id"))
        elif t in ("nifcloud_db_security_group",
                   "nifcloud_nas_security_group"):
            cr.attrs["cidrs"] = Attr(
                _rule_cidrs(module, res, "rule", "cidr_ip"))
        elif t == "nifcloud_nas_instance":
            cr.attrs["network_id"] = Attr(
                res.value("network_id", "net-COMMON_PRIVATE"),
                res.rng("network_id"))
        elif t == "nifcloud_dns_record":
            cr.attrs["type"] = Attr(res.value("type", ""))
            cr.attrs["record"] = Attr(res.value("record", ""),
                                      res.rng("record"))

        elif t == "openstack_compute_instance_v2":
            cr.attrs["admin_pass"] = Attr(res.value("admin_pass", ""),
                                          res.rng("admin_pass"))
        elif t == "openstack_fw_rule_v1":
            cr.attrs["action"] = Attr(res.value("action", ""))
            cr.attrs["enabled"] = Attr(res.value("enabled", True))
            cr.attrs["source"] = Attr(
                res.value("source_ip_address", ""))
            cr.attrs["destination"] = Attr(
                res.value("destination_ip_address", ""))
        elif t == "openstack_networking_secgroup_v2":
            cr.attrs["description"] = Attr(
                res.value("description", ""), res.rng("description"))
        elif t == "openstack_networking_secgroup_rule_v2":
            cr.attrs["direction"] = Attr(res.value("direction", ""))
            cr.attrs["cidr"] = Attr(res.value("remote_ip_prefix", ""),
                                    res.rng("remote_ip_prefix"))

        elif t == "github_repository":
            private = res.value("private")
            visibility = res.value("visibility")
            if isinstance(visibility, Unknown) or \
                    isinstance(private, Unknown):
                public = visibility if isinstance(visibility, Unknown) \
                    else private
            elif isinstance(visibility, str) and visibility:
                public = visibility == "public"
            elif private is not None:
                public = not private
            else:
                public = True
            cr.attrs["public"] = Attr(
                public, res.rng("visibility")
                if "visibility" in res.attrs else res.rng("private"))
            cr.attrs["vulnerability_alerts"] = Attr(
                res.value("vulnerability_alerts", False),
                res.rng("vulnerability_alerts"))
            cr.attrs["archived"] = Attr(res.value("archived", False))
        elif t == "github_branch_protection":
            cr.attrs["require_signed_commits"] = Attr(
                res.value("require_signed_commits", False),
                res.rng("require_signed_commits"))
        elif t == "github_actions_environment_secret":
            cr.attrs["plaintext_value"] = Attr(
                res.value("plaintext_value", ""),
                res.rng("plaintext_value"))

        elif t == "opc_compute_ip_address_reservation":
            cr.attrs["pool"] = Attr(res.value("ip_address_pool", ""),
                                    res.rng("ip_address_pool"))
        elif t == "cloudstack_instance":
            cr.attrs["user_data"] = Attr(res.value("user_data", ""),
                                         res.rng("user_data"))
        else:
            continue
        out.append(cr)
    return out


# ---------------------------------------------------------------------
# DigitalOcean checks
# ---------------------------------------------------------------------

_dig_compute = _reg("DigitalOcean", "compute")
_dig_spaces = _reg("DigitalOcean", "spaces")


@_dig_compute("AVD-DIG-0001", "Firewalls should not permit public "
              "inbound traffic", "HIGH",
              "An inbound rule from 0.0.0.0/0 opens the port to the "
              "internet.", "Restrict source_addresses.")
def _dig_fw_in(resources):
    for r in _of(resources, "digitalocean_firewall"):
        for rule in r.get("inbound", []):
            if _public_cidr(rule["cidr"]):
                yield (f"Firewall '{r.name}' allows inbound access from "
                       f"anywhere.", rule["rng"])


@_dig_compute("AVD-DIG-0003", "Firewalls should not permit unrestricted "
              "outbound traffic", "HIGH",
              "Unrestricted egress allows exfiltration to any "
              "destination.", "Restrict destination_addresses.")
def _dig_fw_out(resources):
    for r in _of(resources, "digitalocean_firewall"):
        for rule in r.get("outbound", []):
            if _public_cidr(rule["cidr"]):
                yield (f"Firewall '{r.name}' allows outbound access to "
                       f"anywhere.", rule["rng"])


@_dig_compute("AVD-DIG-0002", "Load balancers should not forward plain "
              "HTTP", "HIGH",
              "HTTP forwarding rules carry traffic unencrypted.",
              "Use https/http2 entry protocols or redirect to HTTPS.")
def _dig_lb_http(resources):
    for r in _of(resources, "digitalocean_loadbalancer"):
        if r.get("redirect_http_to_https") is True:
            continue
        for rule in r.get("forwarding_rules", []):
            if rule["entry_protocol"] == "http":
                yield (f"Load balancer '{r.name}' accepts plain HTTP.",
                       rule["rng"])


@_dig_compute("AVD-DIG-0004", "Droplets should use SSH keys instead of "
              "passwords", "MEDIUM",
              "Password authentication is brute-forceable.",
              "Provision droplets with ssh_keys.")
def _dig_ssh(resources):
    for r in _of(resources, "digitalocean_droplet"):
        if r.unknown("ssh_keys"):
            continue
        if not r.get("ssh_keys"):
            yield (f"Droplet '{r.name}' does not specify SSH keys.",
                   r.rng)


@_dig_compute("AVD-DIG-0005", "Kubernetes clusters should enable surge "
              "upgrades", "MEDIUM",
              "Surge upgrades replace nodes before draining them, "
              "avoiding capacity loss during upgrades.",
              "Set surge_upgrade = true.")
def _dig_surge(resources):
    for r in _of(resources, "digitalocean_kubernetes_cluster"):
        if r.unknown("surge_upgrade"):
            continue
        if r.get("surge_upgrade") is not True:
            yield (f"Cluster '{r.name}' does not enable surge upgrades.",
                   r.attr_rng("surge_upgrade"))


@_dig_compute("AVD-DIG-0008", "Kubernetes clusters should enable "
              "auto-upgrade", "MEDIUM",
              "Auto-upgrade keeps the control plane patched.",
              "Set auto_upgrade = true.")
def _dig_auto_upgrade(resources):
    for r in _of(resources, "digitalocean_kubernetes_cluster"):
        if r.unknown("auto_upgrade"):
            continue
        if r.get("auto_upgrade") is not True:
            yield (f"Cluster '{r.name}' does not enable auto-upgrade.",
                   r.attr_rng("auto_upgrade"))


@_dig_spaces("AVD-DIG-0006", "Spaces buckets should not be publicly "
             "readable", "HIGH",
             "A public-read ACL exposes all objects.",
             "Set acl = private.")
def _dig_acl(resources):
    for r in _of(resources, "digitalocean_spaces_bucket"):
        if r.unknown("acl"):
            continue
        if r.get("acl", "public-read") == "public-read":
            yield (f"Spaces bucket '{r.name}' has a public-read ACL.",
                   r.attr_rng("acl"))
    for r in _of(resources, "digitalocean_spaces_bucket_object"):
        if r.unknown("acl"):
            continue
        if r.get("acl", "private") == "public-read":
            yield (f"Spaces bucket object '{r.name}' has a public-read "
                   f"ACL.", r.attr_rng("acl"))


@_dig_spaces("AVD-DIG-0007", "Spaces buckets should have versioning "
             "enabled", "MEDIUM",
             "Versioning protects objects from overwrite and deletion.",
             "Add a versioning block with enabled = true.")
def _dig_versioning(resources):
    for r in _of(resources, "digitalocean_spaces_bucket"):
        if r.unknown("versioning"):
            continue
        if r.get("versioning") is not True:
            yield (f"Spaces bucket '{r.name}' does not have versioning "
                   f"enabled.", r.attr_rng("versioning"))


@_dig_spaces("AVD-DIG-0009", "Spaces buckets should not enable "
             "force-destroy", "MEDIUM",
             "force_destroy deletes all objects on bucket removal.",
             "Leave force_destroy = false.")
def _dig_force_destroy(resources):
    for r in _of(resources, "digitalocean_spaces_bucket"):
        if r.get("force_destroy") is True:
            yield (f"Spaces bucket '{r.name}' enables force-destroy.",
                   r.attr_rng("force_destroy"))


# ---------------------------------------------------------------------
# Nifcloud checks
# ---------------------------------------------------------------------

_nif_computing = _reg("Nifcloud", "computing")
_nif_network = _reg("Nifcloud", "network")
_nif_rdb = _reg("Nifcloud", "rdb")
_nif_nas = _reg("Nifcloud", "nas")
_nif_dns = _reg("Nifcloud", "dns")

_COMMON_NETS = ("net-COMMON_GLOBAL", "net-COMMON_PRIVATE")


@_nif_computing("AVD-NIF-0001", "Security groups should not permit "
                "public ingress", "HIGH",
                "An IN rule from 0.0.0.0/0 opens the port to the "
                "internet.", "Restrict cidr_ip.")
def _nif_sg_public(resources):
    for r in _of(resources, "nifcloud_security_group_rule"):
        if r.get("type", "IN") == "IN" and _public_cidr(r.get("cidr", "")):
            yield (f"Security group rule '{r.name}' allows ingress from "
                   f"anywhere.", r.attr_rng("cidr"))


@_nif_computing("AVD-NIF-0002", "Security groups should have a "
                "description", "LOW",
                "Descriptions document rule intent for audits.",
                "Add a description.")
def _nif_sg_desc(resources):
    for r in _of(resources, "nifcloud_security_group"):
        if r.unknown("description"):
            continue
        if not r.get("description"):
            yield (f"Security group '{r.name}' has no description.",
                   r.rng)


@_nif_computing("AVD-NIF-0003", "Instances should have a security group",
                "MEDIUM",
                "An instance without a security group is unfiltered.",
                "Set security_group.")
def _nif_inst_sg(resources):
    for r in _of(resources, "nifcloud_instance"):
        if r.unknown("security_group"):
            continue
        if not r.get("security_group"):
            yield (f"Instance '{r.name}' does not set a security group.",
                   r.rng)


@_nif_computing("AVD-NIF-0004", "Instances should not sit on common "
                "networks", "LOW",
                "The shared COMMON networks are reachable by other "
                "tenants.", "Use a private LAN network_id.")
def _nif_inst_net(resources):
    for r in _of(resources, "nifcloud_instance"):
        for iface in r.get("interfaces", []):
            if iface["network_id"] in _COMMON_NETS:
                yield (f"Instance '{r.name}' uses the shared "
                       f"{iface['network_id']} network.", iface["rng"])


@_nif_network("AVD-NIF-0005", "Load balancers should use TLS", "MEDIUM",
              "Plain listeners carry traffic unencrypted.",
              "Terminate TLS (port 443 + ssl policy) on the listener.")
def _nif_lb_tls(resources):
    for r in _of(resources, "nifcloud_load_balancer"):
        if r.unknown("ssl_policy"):
            continue
        port = r.get("port")
        if port == 443 and not r.get("ssl_policy"):
            yield (f"Load balancer '{r.name}' serves 443 without a TLS "
                   f"policy.", r.attr_rng("port"))
        elif isinstance(port, int) and port not in (443,):
            yield (f"Load balancer '{r.name}' listens on plain port "
                   f"{port}.", r.attr_rng("port"))
    for r in _of(resources, "nifcloud_elb"):
        proto = r.get("protocol", "")
        if isinstance(proto, str) and proto.upper() in ("HTTP", "TCP"):
            yield (f"ELB '{r.name}' uses unencrypted protocol "
                   f"{proto}.", r.attr_rng("protocol"))


@_nif_network("AVD-NIF-0006", "Routers should have a security group",
              "MEDIUM",
              "An unfiltered router forwards any traffic.",
              "Set security_group.")
def _nif_router_sg(resources):
    for r in _of(resources, "nifcloud_router"):
        if r.unknown("security_group"):
            continue
        if not r.get("security_group"):
            yield (f"Router '{r.name}' does not set a security group.",
                   r.rng)


@_nif_network("AVD-NIF-0007", "VPN gateways should have a security group",
              "MEDIUM",
              "An unfiltered VPN gateway accepts any peer.",
              "Set security_group.")
def _nif_vpngw_sg(resources):
    for r in _of(resources, "nifcloud_vpn_gateway"):
        if r.unknown("security_group"):
            continue
        if not r.get("security_group"):
            yield (f"VPN gateway '{r.name}' does not set a security "
                   f"group.", r.rng)


@_nif_network("AVD-NIF-0008", "ELBs should not sit on common networks",
              "LOW",
              "The shared COMMON networks are reachable by other "
              "tenants.", "Use a private LAN network_id.")
def _nif_elb_net(resources):
    for r in _of(resources, "nifcloud_elb"):
        for iface in r.get("interfaces", []):
            if iface["network_id"] in _COMMON_NETS:
                yield (f"ELB '{r.name}' uses the shared "
                       f"{iface['network_id']} network.", iface["rng"])


@_nif_rdb("AVD-NIF-0009", "DB security groups should not permit public "
          "ingress", "HIGH",
          "A rule from 0.0.0.0/0 opens the database to the internet.",
          "Restrict cidr_ip.")
def _nif_dbsg_public(resources):
    for r in _of(resources, "nifcloud_db_security_group"):
        for rule in r.get("cidrs", []):
            if _public_cidr(rule["cidr"]):
                yield (f"DB security group '{r.name}' allows access from "
                       f"anywhere.", rule["rng"])


@_nif_rdb("AVD-NIF-0010", "DB instances should have backups enabled",
          "MEDIUM",
          "Without backup retention a database cannot be restored.",
          "Set backup_retention_period > 0.")
def _nif_db_backup(resources):
    for r in _of(resources, "nifcloud_db_instance"):
        if r.unknown("backup_retention"):
            continue
        ret = r.get("backup_retention", 0)
        if isinstance(ret, int) and ret <= 0:
            yield (f"DB instance '{r.name}' disables backups.",
                   r.attr_rng("backup_retention"))


@_nif_rdb("AVD-NIF-0011", "DB instances should not be publicly "
          "accessible", "HIGH",
          "Publicly reachable databases expose the attack surface to "
          "the internet.", "Set publicly_accessible = false.")
def _nif_db_public(resources):
    for r in _of(resources, "nifcloud_db_instance"):
        if r.unknown("public"):
            continue
        if r.get("public", True) is not False:
            yield (f"DB instance '{r.name}' is publicly accessible.",
                   r.attr_rng("public"))


@_nif_rdb("AVD-NIF-0012", "DB instances should not sit on common "
          "networks", "LOW",
          "The shared COMMON networks are reachable by other tenants.",
          "Use a private LAN network_id.")
def _nif_db_net(resources):
    for r in _of(resources, "nifcloud_db_instance"):
        if r.get("network_id") in _COMMON_NETS:
            yield (f"DB instance '{r.name}' uses a shared COMMON "
                   f"network.", r.attr_rng("network_id"))


@_nif_nas("AVD-NIF-0013", "NAS security groups should not permit public "
          "ingress", "HIGH",
          "A rule from 0.0.0.0/0 opens the share to the internet.",
          "Restrict cidr_ip.")
def _nif_nassg_public(resources):
    for r in _of(resources, "nifcloud_nas_security_group"):
        for rule in r.get("cidrs", []):
            if _public_cidr(rule["cidr"]):
                yield (f"NAS security group '{r.name}' allows access "
                       f"from anywhere.", rule["rng"])


@_nif_nas("AVD-NIF-0014", "NAS instances should not sit on common "
          "networks", "LOW",
          "The shared COMMON networks are reachable by other tenants.",
          "Use a private LAN network_id.")
def _nif_nas_net(resources):
    for r in _of(resources, "nifcloud_nas_instance"):
        if r.get("network_id") in _COMMON_NETS:
            yield (f"NAS instance '{r.name}' uses a shared COMMON "
                   f"network.", r.attr_rng("network_id"))


@_nif_dns("AVD-NIF-0015", "Zone-registration verify records should be "
          "removed", "MEDIUM",
          "The nifty-dns-verify TXT record is only needed during zone "
          "registration; leaving it allows re-verification hijack.",
          "Delete the verify record after registration.")
def _nif_dns_verify(resources):
    for r in _of(resources, "nifcloud_dns_record"):
        record = r.get("record", "")
        if r.get("type") == "TXT" and isinstance(record, str) and \
                record.startswith("nifty-dns-verify="):
            yield (f"DNS record '{r.name}' keeps the zone-registration "
                   f"verify token.", r.attr_rng("record"))


# ---------------------------------------------------------------------
# OpenStack checks
# ---------------------------------------------------------------------

_os_compute = _reg("OpenStack", "compute")
_os_network = _reg("OpenStack", "networking")


@_os_compute("AVD-OPNSTK-0001", "Instances should not have a plaintext "
             "admin password", "MEDIUM",
             "admin_pass stores the root password in state and source.",
             "Use key pairs instead of admin_pass.")
def _os_admin_pass(resources):
    for r in _of(resources, "openstack_compute_instance_v2"):
        if r.get("admin_pass"):
            yield (f"Instance '{r.name}' sets a plaintext admin "
                   f"password.", r.attr_rng("admin_pass"))


@_os_compute("AVD-OPNSTK-0002", "Firewall rules should not allow "
             "unrestricted traffic", "HIGH",
             "An allow rule without source and destination restrictions "
             "matches everything.", "Scope source/destination addresses.")
def _os_fw_rule(resources):
    for r in _of(resources, "openstack_fw_rule_v1"):
        if r.unknown("source") or r.unknown("destination"):
            continue
        if r.get("action") == "allow" and r.get("enabled", True) and \
                not r.get("source") and not r.get("destination"):
            yield (f"Firewall rule '{r.name}' allows unrestricted "
                   f"traffic.", r.rng)


@_os_network("AVD-OPNSTK-0003", "Security group rules should not permit "
             "public ingress", "HIGH",
             "An ingress rule from 0.0.0.0/0 opens the port to the "
             "internet.", "Restrict remote_ip_prefix.")
def _os_sg_ingress(resources):
    for r in _of(resources, "openstack_networking_secgroup_rule_v2"):
        if r.get("direction") == "ingress" and \
                _public_cidr(r.get("cidr", "")):
            yield (f"Security group rule '{r.name}' allows ingress from "
                   f"anywhere.", r.attr_rng("cidr"))


@_os_network("AVD-OPNSTK-0004", "Security group rules should not permit "
             "public egress", "HIGH",
             "An egress rule to 0.0.0.0/0 allows exfiltration "
             "anywhere.", "Restrict remote_ip_prefix.")
def _os_sg_egress(resources):
    for r in _of(resources, "openstack_networking_secgroup_rule_v2"):
        if r.get("direction") == "egress" and \
                _public_cidr(r.get("cidr", "")):
            yield (f"Security group rule '{r.name}' allows egress to "
                   f"anywhere.", r.attr_rng("cidr"))


@_os_network("AVD-OPNSTK-0005", "Security groups should have a "
             "description", "LOW",
             "Descriptions document rule intent for audits.",
             "Add a description.")
def _os_sg_desc(resources):
    for r in _of(resources, "openstack_networking_secgroup_v2"):
        if r.unknown("description"):
            continue
        if not r.get("description"):
            yield (f"Security group '{r.name}' has no description.",
                   r.rng)


# ---------------------------------------------------------------------
# GitHub checks
# ---------------------------------------------------------------------

_git_repos = _reg("GitHub", "repositories")
_git_branch = _reg("GitHub", "branch_protections")
_git_secrets = _reg("GitHub", "actions")


@_git_repos("AVD-GIT-0001", "Repositories should be private", "HIGH",
            "Public repositories expose source and history to everyone.",
            "Set visibility = private.")
def _git_private(resources):
    for r in _of(resources, "github_repository"):
        if r.get("public") is True:
            yield (f"Repository '{r.name}' is public.",
                   r.attr_rng("public"))


@_git_repos("AVD-GIT-0003", "Repositories should enable vulnerability "
            "alerts", "MEDIUM",
            "Vulnerability alerts surface known-vulnerable "
            "dependencies.", "Set vulnerability_alerts = true.")
def _git_vuln_alerts(resources):
    for r in _of(resources, "github_repository"):
        if r.get("archived") is True or r.unknown("vulnerability_alerts"):
            continue
        if r.get("vulnerability_alerts") is not True:
            yield (f"Repository '{r.name}' does not enable vulnerability "
                   f"alerts.", r.attr_rng("vulnerability_alerts"))


@_git_branch("AVD-GIT-0002", "Branch protections should require signed "
             "commits", "HIGH",
             "Signed commits authenticate the author of each change.",
             "Set require_signed_commits = true.")
def _git_signed(resources):
    for r in _of(resources, "github_branch_protection"):
        if r.unknown("require_signed_commits"):
            continue
        if r.get("require_signed_commits") is not True:
            yield (f"Branch protection '{r.name}' does not require "
                   f"signed commits.",
                   r.attr_rng("require_signed_commits"))


@_git_secrets("AVD-GIT-0004", "Actions secrets should not have plaintext "
              "values", "HIGH",
              "plaintext_value stores the secret unencrypted in state "
              "and source.", "Use encrypted_value.")
def _git_plaintext(resources):
    for r in _of(resources, "github_actions_environment_secret"):
        if r.get("plaintext_value"):
            yield (f"Actions secret '{r.name}' is set from a plaintext "
                   f"value.", r.attr_rng("plaintext_value"))


# ---------------------------------------------------------------------
# Oracle / CloudStack checks
# ---------------------------------------------------------------------

_oci_compute = _reg("Oracle", "compute")
_cs_compute = _reg("CloudStack", "compute")


@_oci_compute("AVD-OCI-0001", "Compute IP reservations should not use "
              "the public pool", "HIGH",
              "Addresses from the public-ippool are internet-reachable.",
              "Reserve from a private pool.")
def _oci_public_pool(resources):
    for r in _of(resources, "opc_compute_ip_address_reservation"):
        if r.get("pool") == "public-ippool":
            yield (f"IP reservation '{r.name}' draws from the public "
                   f"pool.", r.attr_rng("pool"))


_SENSITIVE_RE = re.compile(
    r"(?i)(password|passwd|secret|aws_access_key_id|aws_secret_access_key"
    r"|api[_-]?key|private[_-]?key|token)\s*[=:]")


@_cs_compute("AVD-CLDSTK-0001", "Instance user data should not contain "
             "sensitive information", "HIGH",
             "user_data is readable by anyone who can describe the "
             "instance.", "Deliver credentials via a secrets manager.")
def _cs_user_data(resources):
    import base64
    for r in _of(resources, "cloudstack_instance"):
        data = r.get("user_data", "")
        if not isinstance(data, str) or not data:
            continue
        decoded = data
        try:
            raw = base64.b64decode(data, validate=True)
            decoded = raw.decode("utf-8", errors="replace")
        except Exception:
            pass
        if _SENSITIVE_RE.search(decoded):
            yield (f"Instance '{r.name}' embeds sensitive data in "
                   f"user_data.", r.attr_rng("user_data"))
