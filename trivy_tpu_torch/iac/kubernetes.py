"""Kubernetes manifest checks (reference pkg/iac/scanners/kubernetes +
trivy-checks kubernetes KSV-series policies).

Parses multi-document YAML/JSON manifests with source positions, walks
pod specs out of every workload kind, and evaluates native
reimplementations of the published KSV checks — IDs, severities, and
message shapes follow avd.aquasec.com so output lines up with the
reference's rego results."""

from __future__ import annotations

import json

from .. import types as T
from .core import Check, run_checks
from .yamlpos import PosDict, PosList, load_documents, value_range

_WORKLOAD_KINDS = {
    "Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet",
    "ReplicationController", "Job", "CronJob",
}


def _dig(d, *keys):
    """Safe nested lookup: any non-dict along the path → None."""
    for k in keys:
        if not isinstance(d, dict):
            return None
        d = d.get(k)
    return d


def _pod_spec(doc):
    kind = doc.get("kind")
    if kind == "Pod":
        return doc.get("spec")
    if kind == "CronJob":
        return _dig(doc, "spec", "jobTemplate", "spec", "template",
                    "spec")
    if kind in _WORKLOAD_KINDS:
        return _dig(doc, "spec", "template", "spec")
    return None


def _containers(spec):
    """→ [(container_dict, range)] over containers + initContainers."""
    out = []
    for key in ("containers", "initContainers"):
        lst = spec.get(key)
        if isinstance(lst, PosList):
            for i, c in enumerate(lst):
                if isinstance(c, dict):
                    out.append((c, value_range(lst, i)))
        elif isinstance(lst, list):
            out.extend((c, (0, 0)) for c in lst if isinstance(c, dict))
    return out


def _rng(container, key, fallback):
    r = value_range(container, key)
    return r if r != (0, 0) else fallback


def _sec_ctx(c):
    sc = c.get("securityContext")
    return sc if isinstance(sc, dict) else {}


def _name(doc):
    md = doc.get("metadata")
    if isinstance(md, dict):
        return md.get("name", "")
    return ""


def _cname(c):
    return c.get("name", "")


class _Ctx:
    def __init__(self, doc):
        self.doc = doc
        self.kind = doc.get("kind", "")
        self.name = _name(doc)
        self.spec = _pod_spec(doc) if isinstance(doc, dict) else None
        self.containers = _containers(self.spec) \
            if isinstance(self.spec, dict) else []


CHECKS: list[Check] = []


def _k(id_, title, severity, description="", resolution=""):
    def deco(fn):
        CHECKS.append(Check(
            id=id_, avd_id=f"AVD-{id_[:3]}-{int(id_[3:]):04d}",
            title=title, severity=severity, description=description,
            resolution=resolution, provider="Kubernetes",
            service="general",
            namespace=f"builtin.kubernetes.{id_}", fn=fn))
        return fn
    return deco


@_k("KSV001", "Process can elevate its own privileges", "MEDIUM",
    "A program inside the container can elevate its own privileges and "
    "run as root.",
    "Set 'set containers[].securityContext.allowPrivilegeEscalation' "
    "to 'false'.")
def _priv_escalation(ctx):
    for c, crng in ctx.containers:
        sc = _sec_ctx(c)
        if sc.get("allowPrivilegeEscalation") is not False:
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'securityContext.allowPrivilegeEscalation'"
                   f" to false", _rng(c, "securityContext", crng))


@_k("KSV003", "Default capabilities not dropped", "LOW",
    "The container should drop all default capabilities and add only "
    "those that are needed for its execution.",
    "Add 'ALL' to containers[].securityContext.capabilities.drop.")
def _drop_caps(ctx):
    for c, crng in ctx.containers:
        caps = _sec_ctx(c).get("capabilities")
        drop = caps.get("drop") if isinstance(caps, dict) else None
        names = {str(x).upper() for x in drop} if isinstance(drop, list) \
            else set()
        if not ({"ALL", "NET_RAW"} & names):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should add 'ALL' to 'securityContext.capabilities."
                   f"drop'", crng)


@_k("KSV008", "Access to host IPC namespace", "HIGH",
    "Sharing the host's IPC namespace allows container processes to "
    "communicate with processes on the host.",
    "Do not set 'spec.template.spec.hostIPC' to true.")
def _host_ipc(ctx):
    if ctx.spec.get("hostIPC") is True:
        yield (f"{ctx.kind} '{ctx.name}' should not set "
               f"'spec.template.spec.hostIPC' to true",
               value_range(ctx.spec, "hostIPC"))


@_k("KSV009", "Access to host network", "HIGH",
    "Sharing the host's network namespace permits processes in the pod "
    "to communicate with processes bound to the host's loopback adapter.",
    "Do not set 'spec.template.spec.hostNetwork' to true.")
def _host_network(ctx):
    if ctx.spec.get("hostNetwork") is True:
        yield (f"{ctx.kind} '{ctx.name}' should not set "
               f"'spec.template.spec.hostNetwork' to true",
               value_range(ctx.spec, "hostNetwork"))


@_k("KSV010", "Access to host PID", "HIGH",
    "Sharing the host's PID namespace allows visibility on host "
    "processes, potentially leaking information such as environment "
    "variables and configuration.",
    "Do not set 'spec.template.spec.hostPID' to true.")
def _host_pid(ctx):
    if ctx.spec.get("hostPID") is True:
        yield (f"{ctx.kind} '{ctx.name}' should not set "
               f"'spec.template.spec.hostPID' to true",
               value_range(ctx.spec, "hostPID"))


@_k("KSV011", "CPU not limited", "LOW",
    "Enforcing CPU limits prevents DoS via resource exhaustion.",
    "Add a cpu limitation to 'spec.resources.limits.cpu'.")
def _cpu_limit(ctx):
    for c, crng in ctx.containers:
        limits = (c.get("resources") or {}).get("limits") \
            if isinstance(c.get("resources"), dict) else None
        if not (isinstance(limits, dict) and limits.get("cpu")):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'resources.limits.cpu'",
                   _rng(c, "resources", crng))


@_k("KSV012", "Runs as root user", "MEDIUM",
    "Force the running image to run as a non-root user to ensure least "
    "privileges.",
    "Set 'containers[].securityContext.runAsNonRoot' to true.")
def _run_as_non_root(ctx):
    pod_sc = ctx.spec.get("securityContext")
    pod_val = pod_sc.get("runAsNonRoot") \
        if isinstance(pod_sc, dict) else None
    for c, crng in ctx.containers:
        c_val = _sec_ctx(c).get("runAsNonRoot")
        # container-level setting overrides the pod-level one
        effective = c_val if c_val is not None else pod_val
        if effective is not True:
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'securityContext.runAsNonRoot' to true",
                   _rng(c, "securityContext", crng))


@_k("KSV013", "Image tag ':latest' used", "MEDIUM",
    "It is best to avoid using the ':latest' image tag when deploying "
    "containers in production, as it is harder to track which version "
    "of the image is running.",
    "Use a specific container image tag that is not 'latest'.")
def _latest_tag(ctx):
    for c, crng in ctx.containers:
        image = str(c.get("image", ""))
        if not image:
            continue
        last = image.split("/")[-1]
        if "@" in last:
            continue
        tag = last.rsplit(":", 1)[1] if ":" in last else ""
        if tag in ("", "latest"):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should specify an image tag", _rng(c, "image", crng))


@_k("KSV014", "Root file system is not read-only", "HIGH",
    "An immutable root file system prevents applications from writing "
    "to their local disk.",
    "Change 'containers[].securityContext.readOnlyRootFilesystem' to "
    "true.")
def _readonly_rootfs(ctx):
    for c, crng in ctx.containers:
        if _sec_ctx(c).get("readOnlyRootFilesystem") is not True:
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'securityContext.readOnlyRootFilesystem'"
                   f" to true", _rng(c, "securityContext", crng))


@_k("KSV015", "CPU requests not specified", "LOW",
    "When containers have resource requests specified, the scheduler "
    "can make better decisions about which nodes to place pods on.",
    "Set 'containers[].resources.requests.cpu'.")
def _cpu_request(ctx):
    for c, crng in ctx.containers:
        req = (c.get("resources") or {}).get("requests") \
            if isinstance(c.get("resources"), dict) else None
        if not (isinstance(req, dict) and req.get("cpu")):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'resources.requests.cpu'",
                   _rng(c, "resources", crng))


@_k("KSV016", "Memory requests not specified", "LOW",
    "When containers have memory requests specified, the scheduler can "
    "make better decisions about which nodes to place pods on.",
    "Set 'containers[].resources.requests.memory'.")
def _mem_request(ctx):
    for c, crng in ctx.containers:
        req = (c.get("resources") or {}).get("requests") \
            if isinstance(c.get("resources"), dict) else None
        if not (isinstance(req, dict) and req.get("memory")):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'resources.requests.memory'",
                   _rng(c, "resources", crng))


@_k("KSV017", "Privileged container", "HIGH",
    "Privileged containers share namespaces with the host system and "
    "do not offer any security isolation.",
    "Change 'containers[].securityContext.privileged' to false.")
def _privileged(ctx):
    for c, crng in ctx.containers:
        if _sec_ctx(c).get("privileged") is True:
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'securityContext.privileged' to false",
                   _rng(c, "securityContext", crng))


@_k("KSV018", "Memory not limited", "LOW",
    "Enforcing memory limits prevents DoS via resource exhaustion.",
    "Set a limit value under 'containers[].resources.limits.memory'.")
def _mem_limit(ctx):
    for c, crng in ctx.containers:
        limits = (c.get("resources") or {}).get("limits") \
            if isinstance(c.get("resources"), dict) else None
        if not (isinstance(limits, dict) and limits.get("memory")):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'resources.limits.memory'",
                   _rng(c, "resources", crng))


@_k("KSV020", "Runs with UID <= 10000", "LOW",
    "Force the container to run with user ID > 10000 to avoid "
    "conflicts with the host's user table.",
    "Set 'containers[].securityContext.runAsUser' to an integer > "
    "10000.")
def _low_uid(ctx):
    pod_sc = ctx.spec.get("securityContext")
    pod_uid = pod_sc.get("runAsUser") if isinstance(pod_sc, dict) else None
    for c, crng in ctx.containers:
        uid = _sec_ctx(c).get("runAsUser", pod_uid)
        if uid is None or (isinstance(uid, int) and uid <= 10000):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'securityContext.runAsUser' > 10000",
                   _rng(c, "securityContext", crng))


@_k("KSV021", "Runs with GID <= 10000", "LOW",
    "Force the container to run with group ID > 10000 to avoid "
    "conflicts with the host's user table.",
    "Set 'containers[].securityContext.runAsGroup' to an integer > "
    "10000.")
def _low_gid(ctx):
    pod_sc = ctx.spec.get("securityContext")
    pod_gid = pod_sc.get("runAsGroup") if isinstance(pod_sc, dict) else None
    for c, crng in ctx.containers:
        gid = _sec_ctx(c).get("runAsGroup", pod_gid)
        if gid is None or (isinstance(gid, int) and gid <= 10000):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'securityContext.runAsGroup' > 10000",
                   _rng(c, "securityContext", crng))


@_k("KSV022", "Non-default capabilities added", "MEDIUM",
    "Adding capabilities beyond the default set increases the risk of "
    "container breakout.",
    "Do not set 'spec.containers[].securityContext.capabilities.add'.")
def _added_caps(ctx):
    for c, crng in ctx.containers:
        caps = _sec_ctx(c).get("capabilities")
        add = caps.get("add") if isinstance(caps, dict) else None
        if isinstance(add, list) and add:
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should not set 'securityContext.capabilities.add'",
                   _rng(c, "securityContext", crng))


@_k("KSV023", "hostPath volumes mounted", "MEDIUM",
    "HostPath volumes must be forbidden.",
    "Do not set 'spec.volumes[*].hostPath'.")
def _hostpath(ctx):
    vols = ctx.spec.get("volumes")
    if not isinstance(vols, list):
        return
    for i, v in enumerate(vols):
        if isinstance(v, dict) and "hostPath" in v:
            yield (f"{ctx.kind} '{ctx.name}' should not set "
                   f"'spec.template.volumes.hostPath'",
                   value_range(vols, i) if isinstance(vols, PosList)
                   else (0, 0))


@_k("KSV025", "SELinux custom options set", "MEDIUM",
    "Setting a custom SELinux user or role option should be forbidden.",
    "Do not set 'spec.securityContext.seLinuxOptions', "
    "'spec.containers[*].securityContext.seLinuxOptions'.")
def _selinux(ctx):
    pod_sc = ctx.spec.get("securityContext")
    if isinstance(pod_sc, dict) and "seLinuxOptions" in pod_sc:
        opts = pod_sc["seLinuxOptions"]
        if isinstance(opts, dict) and (opts.get("user") or
                                       opts.get("role")):
            yield (f"{ctx.kind} '{ctx.name}' should not set a custom "
                   f"SELinux user or role",
                   value_range(pod_sc, "seLinuxOptions"))
    for c, crng in ctx.containers:
        opts = _sec_ctx(c).get("seLinuxOptions")
        if isinstance(opts, dict) and (opts.get("user") or
                                       opts.get("role")):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should not set a custom SELinux user or role",
                   _rng(c, "securityContext", crng))


@_k("KSV030", "Runtime/default seccomp profile not set", "LOW",
    "The runtime default seccomp profile must be required, or allow "
    "specific additional profiles.",
    "Set 'spec.securityContext.seccompProfile.type' to 'RuntimeDefault'"
    " or 'Localhost'.")
def _seccomp(ctx):
    pod_sc = ctx.spec.get("securityContext")
    pod_type = ""
    if isinstance(pod_sc, dict):
        prof = pod_sc.get("seccompProfile")
        if isinstance(prof, dict):
            pod_type = str(prof.get("type", ""))
    for c, crng in ctx.containers:
        prof = _sec_ctx(c).get("seccompProfile")
        ctype = str(prof.get("type", "")) if isinstance(prof, dict) else ""
        eff = ctype or pod_type
        if eff not in ("RuntimeDefault", "Localhost"):
            yield (f"Container '{_cname(c)}' of {ctx.kind} '{ctx.name}' "
                   f"should set 'securityContext.seccompProfile.type' to"
                   f" 'RuntimeDefault'", _rng(c, "securityContext", crng))


@_k("KSV104", "Seccomp policies disabled", "MEDIUM",
    "A program inside the container can bypass the Seccomp profile "
    "protection policies.",
    "Specify a seccomp profile (and never 'Unconfined') for every "
    "container.")
def _seccomp_disabled(ctx):
    """Fires when a container's EFFECTIVE seccomp profile (container
    securityContext, falling back to the pod's) is absent or
    Unconfined — the reference golden fires this on charts with no
    seccomp configuration at all (helm_testchart.json.golden)."""
    pod_sc = ctx.spec.get("securityContext")
    pod_type = ""
    if isinstance(pod_sc, dict):
        prof = pod_sc.get("seccompProfile")
        if isinstance(prof, dict):
            pod_type = str(prof.get("type", ""))
    for c, crng in ctx.containers:
        prof = _sec_ctx(c).get("seccompProfile")
        ctype = str(prof.get("type", "")) if isinstance(prof, dict) \
            else ""
        eff = ctype or pod_type
        if not eff or eff == "Unconfined":
            yield (f"Container '{_cname(c)}' of {ctx.kind} "
                   f"'{ctx.name}' should specify a seccomp profile",
                   _rng(c, "securityContext", crng))


@_k("KSV105", "Containers must not set runAsUser to 0", "LOW",
    "Containers should be forbidden from running with a root UID.",
    "Set 'securityContext.runAsUser' to a non-zero integer.")
def _run_as_root_uid(ctx):
    pod_sc = ctx.spec.get("securityContext")
    pod_uid = pod_sc.get("runAsUser") if isinstance(pod_sc, dict) \
        else None
    for c, crng in ctx.containers:
        uid = _sec_ctx(c).get("runAsUser", pod_uid)
        if uid == 0:
            yield ("securityContext.runAsUser should be set to a "
                   "value greater than 0",
                   _rng(c, "securityContext", crng))


@_k("KSV106", "Container capabilities must only include "
    "NET_BIND_SERVICE", "LOW",
    "Containers must drop ALL capabilities, and are only permitted to "
    "add back the NET_BIND_SERVICE capability.",
    "Set 'securityContext.capabilities.drop' to ['ALL'] and only add "
    "'NET_BIND_SERVICE' back if needed.")
def _caps_net_bind_only(ctx):
    for c, crng in ctx.containers:
        caps = _sec_ctx(c).get("capabilities")
        caps = caps if isinstance(caps, dict) else {}
        drop = caps.get("drop") or []
        add = caps.get("add") or []
        if not (isinstance(drop, list) and
                any(str(d).upper() == "ALL" for d in drop)):
            yield ("container should drop all",
                   _rng(c, "securityContext", crng))
        if isinstance(add, list) and any(
                str(a).upper() != "NET_BIND_SERVICE" for a in add):
            yield (f"Container '{_cname(c)}' of {ctx.kind} "
                   f"'{ctx.name}' should only add the "
                   f"'NET_BIND_SERVICE' capability",
                   _rng(c, "securityContext", crng))


@_k("KSV117", "Prevent binding to privileged ports", "HIGH",
    "Privileged ports (below 1024) require escalated privileges to "
    "bind, and binding them in containers suggests running with more "
    "privilege than needed.",
    "Use container ports of 1024 or above.")
def _privileged_ports(ctx):
    for c, crng in ctx.containers:
        ports = c.get("ports")
        if not isinstance(ports, list):
            continue
        for p in ports:
            port = p.get("containerPort") if isinstance(p, dict) \
                else None
            if isinstance(port, int) and 0 < port < 1024:
                yield (f"{ctx.kind.lower()} {ctx.name} should not set "
                       f"spec.template.spec.containers.ports."
                       f"containerPort to {port}",
                       _rng(c, "ports", crng))


@_k("KSV002", "Default AppArmor profile not set", "MEDIUM",
    "A program inside the container can bypass AppArmor protection "
    "policies.",
    "Remove 'container.apparmor.security.beta.kubernetes.io' "
    "annotation or set it to 'runtime/default'.")
def _apparmor(ctx):
    # AppArmor annotations live on the Pod metadata — for controllers
    # that is the pod-template metadata, not the workload's own
    sources = [ctx.doc.get("metadata")]
    if ctx.kind == "CronJob":
        sources.append(_dig(ctx.doc, "spec", "jobTemplate", "spec",
                            "template", "metadata"))
    elif ctx.kind != "Pod":
        sources.append(_dig(ctx.doc, "spec", "template", "metadata"))
    for md in sources:
        annotations = md.get("annotations") \
            if isinstance(md, dict) else None
        if not isinstance(annotations, dict):
            continue
        for key, val in annotations.items():
            if str(key).startswith(
                    "container.apparmor.security.beta.kubernetes.io/") \
                    and str(val) == "unconfined":
                yield (f"{ctx.kind} '{ctx.name}' should specify an "
                       f"AppArmor profile",
                       value_range(annotations, key))


@_k("KSV028", "Non-ephemeral volume types used", "LOW",
    "According to pod security standard 'Volume types', non-ephemeral "
    "volume types must not be used.",
    "Do not Set 'spec.volumes[*]' to any of the disallowed volume "
    "types.")
def _volume_types(ctx):
    allowed = {"configMap", "csi", "downwardAPI", "emptyDir",
               "ephemeral", "persistentVolumeClaim", "projected",
               "secret", "name"}
    vols = ctx.spec.get("volumes")
    if not isinstance(vols, list):
        return
    for i, v in enumerate(vols):
        if not isinstance(v, dict):
            continue
        bad = [k for k in v if k not in allowed]
        if bad:
            yield (f"{ctx.kind} '{ctx.name}' should not use volume type "
                   f"'{bad[0]}'",
                   value_range(vols, i) if isinstance(vols, PosList)
                   else (0, 0))


def _has_root_gid(sc) -> bool:
    """Shared by KSV029 and its PSS twin KSV116 (the upstream bundle
    carries both)."""
    return isinstance(sc, dict) and (
        sc.get("runAsGroup") == 0 or sc.get("fsGroup") == 0 or
        (isinstance(sc.get("supplementalGroups"), list) and
         0 in sc["supplementalGroups"]))


@_k("KSV029", "A root primary or supplementary GID set", "LOW",
    "Containers should be forbidden from running with a root primary "
    "or supplementary GID.",
    "Set 'containers[].securityContext.runAsGroup' to a non-zero "
    "integer or leave it unset.")
def _root_gid(ctx):
    scopes = [(ctx.spec.get("securityContext"), ctx.spec,
               "securityContext")]
    scopes += [(_sec_ctx(c), c, "securityContext")
               for c, _ in ctx.containers]
    for sc, holder, key in scopes:
        if _has_root_gid(sc):
            yield (f"{ctx.kind} '{ctx.name}' should not set a root "
                   f"group ID", value_range(holder, key))


@_k("KSV036", "Protecting Pod service account tokens", "MEDIUM",
    "Ensure that Pod specifications disable the secret token being "
    "mounted by setting automountServiceAccountToken: false.",
    "Set 'spec.automountServiceAccountToken' to false.")
def _sa_token(ctx):
    # fires only on an EXPLICIT true: the reference's rego leaves the
    # unset default alone (helm_testchart.json.golden evaluates this
    # check as a success on a chart that never sets it)
    if ctx.spec.get("automountServiceAccountToken") is True:
        yield (f"{ctx.kind} '{ctx.name}' should set "
               f"'spec.automountServiceAccountToken' to false",
               value_range(ctx.spec, "automountServiceAccountToken",
                           (ctx.spec.start, ctx.spec.start)
                           if isinstance(ctx.spec, PosDict) else (0, 0)))


@_k("KSV005", "SYS_ADMIN capability added", "HIGH",
    "SYS_ADMIN gives the container full administration operations on "
    "the host.",
    "Remove 'SYS_ADMIN' from 'securityContext.capabilities.add'.")
def _sys_admin(ctx):
    for c, crng in ctx.containers:
        caps = _sec_ctx(c).get("capabilities")
        add = caps.get("add") if isinstance(caps, dict) else None
        if isinstance(add, list) and any(
                str(a).upper() == "SYS_ADMIN" for a in add):
            yield (f"Container '{_cname(c)}' of {ctx.kind} "
                   f"'{ctx.name}' should not include 'SYS_ADMIN' in "
                   f"'securityContext.capabilities.add'",
                   _rng(c, "securityContext", crng))


@_k("KSV006", "hostPath volume mounted with docker.sock", "HIGH",
    "Mounting docker.sock gives the container full control of the "
    "host's container runtime.",
    "Do not mount '/var/run/docker.sock'.")
def _docker_sock(ctx):
    vols = ctx.spec.get("volumes")
    if not isinstance(vols, list):
        return
    for v in vols:
        hp = v.get("hostPath") if isinstance(v, dict) else None
        path = hp.get("path") if isinstance(hp, dict) else ""
        if path == "/var/run/docker.sock":
            yield (f"{ctx.kind} '{ctx.name}' should not mount "
                   f"'/var/run/docker.sock'",
                   value_range(ctx.spec, "volumes"))


@_k("KSV007", "hostAliases is set", "LOW",
    "Managing /etc/hosts via hostAliases can redirect traffic to "
    "malicious hosts.",
    "Do not set 'spec.hostAliases'.")
def _host_aliases(ctx):
    if ctx.spec.get("hostAliases") is not None:
        yield (f"{ctx.kind} '{ctx.name}' should not set "
               f"'spec.hostAliases'",
               value_range(ctx.spec, "hostAliases"))


@_k("KSV024", "Access to host ports", "HIGH",
    "hostPort binds the container to the node's network identity.",
    "Do not set 'containers[].ports[].hostPort'.")
def _host_ports(ctx):
    for c, crng in ctx.containers:
        ports = c.get("ports")
        if not isinstance(ports, list):
            continue
        for p in ports:
            if isinstance(p, dict) and p.get("hostPort") is not None:
                yield (f"Container '{_cname(c)}' of {ctx.kind} "
                       f"'{ctx.name}' should not set 'hostPort'",
                       _rng(c, "ports", crng))


_SAFE_SYSCTLS = {
    "kernel.shm_rmid_forced", "net.ipv4.ip_local_port_range",
    "net.ipv4.ip_unprivileged_port_start", "net.ipv4.tcp_syncookies",
    "net.ipv4.ping_group_range",
}


@_k("KSV026", "Unsafe sysctl options set", "MEDIUM",
    "Only a small allowlist of sysctls is considered safe to set from "
    "a pod.",
    "Remove unsafe entries from 'securityContext.sysctls'.")
def _unsafe_sysctls(ctx):
    sc = ctx.spec.get("securityContext")
    sysctls = sc.get("sysctls") if isinstance(sc, dict) else None
    if not isinstance(sysctls, list):
        return
    for s in sysctls:
        name = s.get("name") if isinstance(s, dict) else None
        if name and name not in _SAFE_SYSCTLS:
            yield (f"{ctx.kind} '{ctx.name}' should not set unsafe "
                   f"sysctl '{name}'",
                   value_range(ctx.spec, "securityContext"))


@_k("KSV027", "Non-default /proc mask set", "MEDIUM",
    "Changing procMount from the default exposes host information to "
    "the container.",
    "Do not set 'securityContext.procMount'.")
def _proc_mount(ctx):
    for c, crng in ctx.containers:
        pm = _sec_ctx(c).get("procMount")
        if pm is not None and str(pm) != "Default":
            yield (f"Container '{_cname(c)}' of {ctx.kind} "
                   f"'{ctx.name}' should not set "
                   f"'securityContext.procMount'",
                   _rng(c, "securityContext", crng))


@_k("KSV037", "Workload deployed in default or kube-system namespace",
    "MEDIUM",
    "Deploying user workloads into kube-system blurs the boundary "
    "with cluster-control components.",
    "Deploy workloads into a dedicated namespace.")
def _system_namespace(ctx):
    if ctx.kind not in _WORKLOAD_KINDS:
        return  # RBAC objects in kube-system are normal
    md = ctx.doc.get("metadata")
    ns = md.get("namespace") if isinstance(md, dict) else ""
    if ns == "kube-system":
        yield (f"{ctx.kind} '{ctx.name}' should not be deployed in "
               f"the 'kube-system' namespace",
               value_range(md, "namespace") if isinstance(md, PosDict)
               else (0, 0))


@_k("KSV110", "Workloads in the default namespace", "LOW",
    "Checks whether a workload runs in the default namespace, which "
    "offers no isolation boundary.",
    "Create and use a dedicated namespace.")
def _default_namespace(ctx):
    if ctx.kind not in _WORKLOAD_KINDS:
        return
    md = ctx.doc.get("metadata")
    ns = md.get("namespace") if isinstance(md, dict) else None
    # only an EXPLICIT default namespace fires — rendered manifests
    # with no namespace field pass (the helm goldens confirm the
    # reference bundle behaves this way)
    if ns == "default":
        yield (f"{ctx.kind} '{ctx.name}' should not be set with "
               f"'default' namespace",
               value_range(md, "namespace")
               if isinstance(md, PosDict) else (0, 0))


@_k("KSV116", "Runs with a root primary or supplementary GID", "LOW",
    "Containers should be forbidden from running with a root primary "
    "or supplementary GID.",
    "Set securityContext gid fields to non-zero values.")
def _root_gid_pss(ctx):
    if _has_root_gid(ctx.spec.get("securityContext")):
        yield (f"{ctx.kind} '{ctx.name}' should not run with a root "
               f"primary or supplementary GID",
               value_range(ctx.spec, "securityContext"))
    for c, crng in ctx.containers:
        if _sec_ctx(c).get("runAsGroup") == 0:
            yield (f"Container '{_cname(c)}' of {ctx.kind} "
                   f"'{ctx.name}' should not run with a root GID",
                   _rng(c, "securityContext", crng))


# --- RBAC checks (Role / ClusterRole documents) ----------------------

def _rbac_rules(ctx):
    if ctx.kind not in ("Role", "ClusterRole"):
        return []
    rules = ctx.doc.get("rules")
    return [r for r in rules if isinstance(r, dict)] \
        if isinstance(rules, list) else []


def _rule_rng(ctx):
    return value_range(ctx.doc, "rules") \
        if isinstance(ctx.doc, PosDict) else (0, 0)


@_k("KSV041", "Manage secrets", "CRITICAL",
    "Roles able to read secrets can exfiltrate every credential in "
    "their scope.",
    "Remove 'secrets' from the role's resources, or narrow the "
    "verbs.")
def _rbac_secrets(ctx):
    for rule in _rbac_rules(ctx):
        resources = rule.get("resources") or []
        verbs = rule.get("verbs") or []
        if "secrets" in resources and any(
                v in ("get", "list", "watch", "*") for v in verbs):
            yield (f"{ctx.kind} '{ctx.name}' should not have access "
                   f"to resource 'secrets'", _rule_rng(ctx))


@_k("KSV044", "No wildcard verb roles", "CRITICAL",
    "A '*' verb grants every action on the rule's resources.",
    "List the needed verbs explicitly.")
def _rbac_wildcard_verbs(ctx):
    for rule in _rbac_rules(ctx):
        if "*" in (rule.get("verbs") or []):
            yield (f"{ctx.kind} '{ctx.name}' should not use wildcard "
                   f"verbs", _rule_rng(ctx))


@_k("KSV045", "No wildcard resource roles", "CRITICAL",
    "A '*' resource grants the rule's verbs on every resource kind.",
    "List the needed resources explicitly.")
def _rbac_wildcard_resources(ctx):
    for rule in _rbac_rules(ctx):
        if "*" in (rule.get("resources") or []):
            yield (f"{ctx.kind} '{ctx.name}' should not use wildcard "
                   f"resources", _rule_rng(ctx))


_MODIFY_VERBS = {"create", "update", "patch", "delete",
                 "deletecollection", "*"}


@_k("KSV042", "Delete pod logs", "MEDIUM",
    "The ability to delete pod logs lets an attacker cover their "
    "tracks.",
    "Remove delete verbs on the pods/log resource.")
def _rbac_pod_logs(ctx):
    for rule in _rbac_rules(ctx):
        if "pods/log" in (rule.get("resources") or []) and \
                {"delete", "deletecollection", "*"} & \
                set(rule.get("verbs") or []):
            yield (f"{ctx.kind} '{ctx.name}' should not allow deleting "
                   f"pod logs", _rule_rng(ctx))


@_k("KSV043", "Impersonate privileged groups", "CRITICAL",
    "Impersonating privileged groups grants their full privileges.",
    "Remove the impersonate verb on groups.")
def _rbac_impersonate_groups(ctx):
    for rule in _rbac_rules(ctx):
        if "groups" in (rule.get("resources") or []) and \
                "impersonate" in (rule.get("verbs") or []):
            yield (f"{ctx.kind} '{ctx.name}' should not allow "
                   f"impersonating groups", _rule_rng(ctx))


@_k("KSV049", "Manage configmaps", "MEDIUM",
    "Some workloads store sensitive data in configmaps; write access "
    "allows tampering with application behavior.",
    "Narrow configmap verbs to read-only.")
def _rbac_configmaps(ctx):
    for rule in _rbac_rules(ctx):
        if "configmaps" in (rule.get("resources") or []) and \
                _MODIFY_VERBS & set(rule.get("verbs") or []):
            yield (f"{ctx.kind} '{ctx.name}' should not allow managing "
                   f"configmaps", _rule_rng(ctx))


@_k("KSV053", "Getting shell on pods", "HIGH",
    "The pods/exec resource with create lets a role open a shell in "
    "any pod in scope.",
    "Remove create on pods/exec.")
def _rbac_pod_exec(ctx):
    for rule in _rbac_rules(ctx):
        if "pods/exec" in (rule.get("resources") or []) and \
                {"create", "*"} & set(rule.get("verbs") or []):
            yield (f"{ctx.kind} '{ctx.name}' should not allow getting "
                   f"a shell on pods", _rule_rng(ctx))


@_k("KSV056", "Manage Kubernetes networking resources", "HIGH",
    "Write access to services/ingresses/network policies lets a role "
    "redirect cluster traffic.",
    "Narrow networking resource verbs to read-only.")
def _rbac_networking(ctx):
    netres = {"services", "endpoints", "endpointslices", "ingresses",
              "networkpolicies"}
    for rule in _rbac_rules(ctx):
        if netres & set(rule.get("resources") or []) and \
                _MODIFY_VERBS & set(rule.get("verbs") or []):
            yield (f"{ctx.kind} '{ctx.name}' should not allow managing "
                   f"networking resources", _rule_rng(ctx))


@_k("KSV047", "Privilege escalation verbs", "HIGH",
    "The escalate, bind and impersonate verbs allow privilege "
    "escalation through the RBAC system itself.",
    "Remove 'escalate', 'bind' and 'impersonate' verbs.")
def _rbac_escalation(ctx):
    for rule in _rbac_rules(ctx):
        bad = {"escalate", "bind", "impersonate"} & \
            set(rule.get("verbs") or [])
        if bad:
            yield (f"{ctx.kind} '{ctx.name}' should not grant "
                   f"privilege-escalation verbs "
                   f"({', '.join(sorted(bad))})", _rule_rng(ctx))


@_k("KSV103", "HostProcess container defined", "HIGH",
    "Windows pods offer the ability to run HostProcess containers "
    "which enables privileged access to the Windows node.",
    "Do not enable 'hostProcess' on any securityContext.")
def _host_process(ctx):
    scopes = [(ctx.spec.get("securityContext"), ctx.spec,
               "securityContext")]
    scopes += [(_sec_ctx(c), c, "securityContext")
               for c, _ in ctx.containers]
    for sc, holder, key in scopes:
        if not isinstance(sc, dict):
            continue
        wo = sc.get("windowsOptions")
        if isinstance(wo, dict) and wo.get("hostProcess") is True:
            yield (f"{ctx.kind} '{ctx.name}' should not set "
                   f"'windowsOptions.hostProcess' to true",
                   value_range(holder, key))


def scan_kubernetes(path: str, content: bytes, lines=None,
                    docs=None) -> tuple[list, int]:
    """→ (failures, successes) over all workload documents in the file.
    `docs` carries pre-parsed documents from detection.sniff."""
    text = content.decode("utf-8", errors="replace")
    if docs is None:
        if path.endswith(".json"):
            try:
                raw = json.loads(text)
            except Exception:
                return [], 0
            docs = raw if isinstance(raw, list) else [raw]
        else:
            docs = load_documents(text)
    contexts = []
    for doc in docs:
        if not isinstance(doc, dict) or doc.get("kind") is None:
            continue
        items = doc.get("items")
        subdocs = items if doc.get("kind") == "List" and \
            isinstance(items, list) else [doc]
        for d in subdocs:
            if not isinstance(d, dict):
                continue
            kind = d.get("kind")
            if kind in _WORKLOAD_KINDS:
                ctx = _Ctx(d)
                if isinstance(ctx.spec, dict):
                    contexts.append(ctx)
            elif kind in ("Role", "ClusterRole"):
                # RBAC documents: pod-spec checks no-op on the empty
                # spec; the KSV041/044/045/047 family gates on kind
                ctx = _Ctx(d)
                ctx.spec = {}
                contexts.append(ctx)
    if not contexts:
        return [], 0

    def call(check):
        for ctx in contexts:
            yield from check.fn(ctx)

    return run_checks(CHECKS, "kubernetes", text, call)
