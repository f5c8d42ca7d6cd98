"""Dockerfile misconfiguration checks.

Native reimplementation of the trivy-checks dockerfile policies the
reference evaluates through rego (pkg/iac/scanners/dockerfile); check IDs
and severities follow the published AVD DS-series so findings line up."""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from .. import types as T


@dataclass
class Instruction:
    cmd: str
    args: str
    start_line: int
    end_line: int


def parse_dockerfile(content: str) -> list[Instruction]:
    out = []
    cont = None
    for i, raw in enumerate(content.splitlines(), 1):
        line = raw.strip()
        if cont is not None:
            cont.args += " " + line.rstrip("\\").strip()
            cont.end_line = i
            if not line.endswith("\\"):
                out.append(cont)
                cont = None
            continue
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        cmd = parts[0].upper()
        args = parts[1] if len(parts) > 1 else ""
        inst = Instruction(cmd=cmd, args=args.rstrip("\\").strip(),
                           start_line=i, end_line=i)
        if args.endswith("\\"):
            cont = inst
        else:
            out.append(inst)
    if cont is not None:
        out.append(cont)
    return out


@dataclass
class Check:
    id: str
    avd_id: str
    title: str
    severity: str
    description: str
    resolution: str
    fn: object = None


def _mk(id_, title, severity, description, resolution):
    def deco(fn):
        CHECKS.append(Check(id=id_,
                            avd_id=f"AVD-DS-{int(id_[2:]):04d}",
                            title=title,
                            severity=severity, description=description,
                            resolution=resolution, fn=fn))
        return fn
    return deco


CHECKS: list[Check] = []


@_mk("DS001", "':latest' tag used", "MEDIUM",
     "When using a 'FROM' statement you should use a specific tag.",
     "Add a tag to the image in the 'FROM' statement")
def _latest_tag(insts):
    for inst in insts:
        if inst.cmd != "FROM":
            continue
        image = inst.args.split()[0]
        if image.lower() == "scratch" or "$" in image:
            continue
        if "@" in image:
            continue  # digest-pinned
        tag = image.rsplit(":", 1)[1] if ":" in image.split("/")[-1] else ""
        if tag == "latest" or (not tag and ":" not in image.split("/")[-1]):
            if not tag:
                continue  # bare name without tag → DS001 flags only :latest
            yield inst, f"Specify a tag in the 'FROM' statement for image " \
                        f"'{image.rsplit(':', 1)[0]}'"


@_mk("DS002", "Image user should not be 'root'", "HIGH",
     "Running containers with 'root' user can lead to a container escape "
     "situation.",
     "Add 'USER <non root user name>' line to the Dockerfile")
def _root_user(insts):
    users = [i for i in insts if i.cmd == "USER"]
    if not users:
        last_from = next((i for i in reversed(insts) if i.cmd == "FROM"),
                         None)
        if last_from is not None:
            yield last_from, "Specify at least 1 USER command in " \
                             "Dockerfile with non-root user as argument"
        return
    last = users[-1]
    if last.args.strip().split(":")[0] in ("root", "0"):
        yield last, "Last USER command in Dockerfile should not be 'root'"


@_mk("DS004", "Port 22 exposed", "MEDIUM",
     "Exposing port 22 might allow users to SSH into the container.",
     "Remove 'EXPOSE 22' statement from the Dockerfile")
def _ssh_port(insts):
    for inst in insts:
        if inst.cmd == "EXPOSE":
            for port in inst.args.split():
                if port.split("/")[0] == "22":
                    yield inst, "Port 22 should not be exposed in Dockerfile"


@_mk("DS005", "ADD instead of COPY", "LOW",
     "You should use COPY instead of ADD unless you want to extract a "
     "tar file.",
     "Use COPY instead of ADD")
def _add_instead_of_copy(insts):
    for inst in insts:
        if inst.cmd != "ADD":
            continue
        src = inst.args.split()[0] if inst.args.split() else ""
        if re.search(r"\.(tar|tar\.gz|tgz|tar\.bz2|tar\.xz)$", src) or \
                src.startswith(("http://", "https://")):
            continue
        yield inst, f"Consider using 'COPY {inst.args}' command instead"


@_mk("DS013", "'RUN cd ...' to change directory", "MEDIUM",
     "Use WORKDIR instead of proliferating instructions like "
     "'RUN cd … && do-something'.",
     "Use WORKDIR to change directory")
def _run_cd(insts):
    for inst in insts:
        if inst.cmd == "RUN" and re.match(r"^cd\s+\S+\s*$", inst.args):
            yield inst, f"RUN should not be used to change directory: " \
                        f"'{inst.args}'. Use 'WORKDIR' statement instead."


@_mk("DS017", "'RUN <package-manager> update' instruction alone", "HIGH",
     "The instruction 'RUN <package-manager> update' should always be "
     "followed by '<package-manager> install' in the same RUN statement.",
     "Combine '<package-manager> update' and '<package-manager> install' "
     "instructions")
def _update_alone(insts):
    for inst in insts:
        if inst.cmd != "RUN":
            continue
        args = inst.args
        if re.search(r"\b(apt-get|apt|yum|apk)\s+update\b", args) and \
                not re.search(r"\b(install|add|upgrade)\b", args):
            yield inst, "The instruction 'RUN <package-manager> update' " \
                        "should always be followed by " \
                        "'<package-manager> install' in the same RUN " \
                        "statement."


@_mk("DS025", "'apk add' without '--no-cache'", "HIGH",
     "You should use 'apk add' with '--no-cache' to clean package cached "
     "data and reduce image size.",
     "Add '--no-cache' to 'apk add' in Dockerfile")
def _apk_cache(insts):
    for inst in insts:
        if inst.cmd == "RUN" and re.search(r"\bapk\s+(\S+\s+)*add\b",
                                           inst.args) and \
                "--no-cache" not in inst.args:
            yield inst, f"'--no-cache' is missed: 'apk add' in " \
                        f"'{inst.args}'"


@_mk("DS026", "No HEALTHCHECK defined", "LOW",
     "You should add HEALTHCHECK instruction in your docker container "
     "images to perform the health check on running containers.",
     "Add HEALTHCHECK instruction in Dockerfile")
def _healthcheck(insts):
    if not any(i.cmd == "HEALTHCHECK" for i in insts):
        first = insts[0] if insts else None
        if first is not None:
            yield None, "Add HEALTHCHECK instruction in your Dockerfile"


def _stages(insts):
    """Split instructions into build stages at each FROM."""
    stages, cur = [], []
    for inst in insts:
        if inst.cmd == "FROM" and cur:
            stages.append(cur)
            cur = []
        cur.append(inst)
    if cur:
        stages.append(cur)
    return stages


def _from_alias(inst) -> str:
    # skip flag tokens: FROM --platform=linux/amd64 img AS name
    parts = [p for p in inst.args.split() if not p.startswith("--")]
    if len(parts) >= 3 and parts[1].upper() == "AS":
        return parts[2].lower()
    return ""


@_mk("DS006", "COPY '--from' references current FROM alias", "CRITICAL",
     "COPY '--from' should point to a previous build stage, not the "
     "stage it is defined in.",
     "Point the COPY '--from' to a previous stage or external image")
def _copy_from_self(insts):
    for stage in _stages(insts):
        alias = (_from_alias(stage[0])
                 if stage and stage[0].cmd == "FROM" else "")
        if not alias:
            continue
        for inst in stage:
            if inst.cmd != "COPY":
                continue
            m = re.search(r"--from=(\S+)", inst.args)
            if m and m.group(1).lower() == alias:
                yield inst, (f"'COPY --from' should not mention its "
                             f"own FROM alias '{alias}'")


@_mk("DS007", "Multiple ENTRYPOINT instructions listed", "CRITICAL",
     "There can only be one ENTRYPOINT instruction in a Dockerfile; "
     "only the last one takes effect.",
     "Remove the extra ENTRYPOINT instructions")
def _multi_entrypoint(insts):
    for stage in _stages(insts):
        eps = [i for i in stage if i.cmd == "ENTRYPOINT"]
        for inst in eps[1:]:
            yield inst, ("There are 2 or more ENTRYPOINT instructions "
                         "in this stage; only the last one takes "
                         "effect")


@_mk("DS008", "Exposed port out of range", "CRITICAL",
     "Exposed ports must be in the 0-65535 range.",
     "Use a port number inside 0-65535")
def _port_range(insts):
    for inst in insts:
        if inst.cmd != "EXPOSE":
            continue
        for port in inst.args.split():
            num = port.split("/")[0]
            if num.isdigit() and not 0 <= int(num) <= 65535:
                yield inst, (f"'EXPOSE' instruction should use port "
                             f"numbers in 0-65535 range ({num})")


@_mk("DS009", "WORKDIR path not absolute", "HIGH",
     "For clarity and reliability, always use absolute paths in "
     "WORKDIR.",
     "Use an absolute path in the WORKDIR instruction")
def _workdir_relative(insts):
    for inst in insts:
        if inst.cmd != "WORKDIR":
            continue
        p = inst.args.strip().strip("'\"")
        if p and not p.startswith(("/", "$", "C:", "c:")):
            yield inst, (f"WORKDIR path '{p}' should be absolute")


@_mk("DS010", "RUN using 'sudo'", "CRITICAL",
     "Avoid using 'sudo' in RUN instructions: it has unpredictable "
     "TTY and signal-forwarding behavior.",
     "Do not use 'sudo' in RUN instructions")
def _run_sudo(insts):
    for inst in insts:
        if inst.cmd == "RUN" and re.search(r"\bsudo\b", inst.args):
            yield inst, "Using 'sudo' in Dockerfile should be avoided"


@_mk("DS011", "COPY with multiple sources needs a directory "
     "destination", "CRITICAL",
     "When copying multiple sources, the destination must be a "
     "directory (end with '/').",
     "End the COPY destination with '/'")
def _copy_dest_dir(insts):
    for inst in insts:
        if inst.cmd != "COPY":
            continue
        raw = inst.args.strip()
        if raw.startswith("["):
            # JSON (exec) form: parse the array for the real tokens
            try:
                parsed = json.loads(raw)
            except ValueError:
                continue
            args = [str(a) for a in parsed] \
                if isinstance(parsed, list) else []
        else:
            args = [a for a in raw.split() if not a.startswith("--")]
        if len(args) > 2 and not args[-1].endswith(("/", "\\")):
            yield inst, (f"COPY with more than two arguments requires "
                         f"the last argument to end with '/'")


@_mk("DS012", "Duplicate FROM alias", "CRITICAL",
     "Build-stage aliases must be unique.",
     "Rename the duplicated stage alias")
def _dup_alias(insts):
    seen = {}
    for inst in insts:
        if inst.cmd != "FROM":
            continue
        alias = _from_alias(inst)
        if not alias:
            continue
        if alias in seen:
            yield inst, (f"Duplicate aliases '{alias}' are defined in "
                         f"multiple FROM instructions")
        seen[alias] = inst


@_mk("DS014", "RUN using 'wget' and 'curl' together", "LOW",
     "Using both tools doubles the image dependencies; pick one.",
     "Use either 'wget' or 'curl', not both")
def _wget_and_curl(insts):
    # stages build independent images: only flag a stage using both
    for stage in _stages(insts):
        has = {"wget": False, "curl": False}
        for inst in stage:
            if inst.cmd != "RUN":
                continue
            for tool in has:
                if re.search(rf"(^|[\s;&|]){tool}\b", inst.args):
                    has[tool] = True
        if has["wget"] and has["curl"]:
            for inst in stage:
                if inst.cmd == "RUN" and \
                        re.search(r"(^|[\s;&|])curl\b", inst.args):
                    yield inst, ("Shouldn't use both curl and wget")
                    break


def _clean_missing_check(id_, install_re, clean_phrase):
    """yum/dnf/zypper share one body: install without a cache clean in
    the same RUN statement."""
    @_mk(id_, f"'{clean_phrase}' missing", "HIGH",
         "Cached package data should be cleaned after installation to "
         "reduce image size.",
         f"Add '{clean_phrase}' to the same RUN statement")
    def check(insts):
        for inst in insts:
            if inst.cmd == "RUN" and \
                    re.search(install_re, inst.args) and \
                    clean_phrase not in inst.args:
                yield inst, (f"'{clean_phrase}' is missed: "
                             f"'{inst.args}'")
    return check


_clean_missing_check("DS015", r"\byum\s+(-\S+\s+)*install\b",
                     "yum clean all")


@_mk("DS016", "Multiple CMD instructions listed", "HIGH",
     "There can only be one CMD instruction in a Dockerfile; only the "
     "last one takes effect.",
     "Remove the extra CMD instructions")
def _multi_cmd(insts):
    for stage in _stages(insts):
        cmds = [i for i in stage if i.cmd == "CMD"]
        for inst in cmds[1:]:
            yield inst, ("There are 2 or more CMD instructions in this "
                         "stage; only the last one takes effect")


_clean_missing_check("DS019", r"\bdnf\s+(-\S+\s+)*install\b",
                     "dnf clean all")
_clean_missing_check("DS020", r"\bzypper\s+(-\S+\s+)*(install|in)\b",
                     "zypper clean")


@_mk("DS021", "'apt-get install' without '-y'", "HIGH",
     "Without '-y' the build may hang on a confirmation prompt.",
     "Add '-y' (or '--yes') to 'apt-get install'")
def _apt_yes(insts):
    for inst in insts:
        if inst.cmd != "RUN":
            continue
        for m in re.finditer(r"apt-get\s+(?:-\S+\s+)*install\b[^&|;]*",
                             inst.args):
            seg = m.group(0)
            if not re.search(r"(^|\s)(-y|--yes|--assume-yes|-qq)\b",
                             seg):
                yield inst, (f"'-y' flag is missed: '{seg.strip()}'")


@_mk("DS022", "MAINTAINER is deprecated", "LOW",
     "MAINTAINER has been deprecated since Docker 1.13.0.",
     "Use LABEL maintainer=... instead")
def _maintainer(insts):
    for inst in insts:
        if inst.cmd == "MAINTAINER":
            yield inst, (f"MAINTAINER should not be used: 'MAINTAINER "
                         f"{inst.args}'")


@_mk("DS023", "Multiple HEALTHCHECK instructions listed", "CRITICAL",
     "Only one HEALTHCHECK instruction may be present; only the last "
     "one takes effect.",
     "Remove the extra HEALTHCHECK instructions")
def _multi_healthcheck(insts):
    for stage in _stages(insts):
        hcs = [i for i in stage if i.cmd == "HEALTHCHECK"]
        for inst in hcs[1:]:
            yield inst, ("There are 2 or more HEALTHCHECK "
                         "instructions in this stage; only the last "
                         "one takes effect")


@_mk("DS024", "'apt-get dist-upgrade' used", "HIGH",
     "Full distribution upgrades inside a container defeat image "
     "reproducibility.",
     "Remove 'apt-get dist-upgrade'")
def _dist_upgrade(insts):
    for inst in insts:
        if inst.cmd == "RUN" and \
                re.search(r"\bapt-get\s+(-\S+\s+)*dist-upgrade\b",
                          inst.args):
            yield inst, ("'apt-get dist-upgrade' should not be used in "
                         "Dockerfile")


@_mk("DS029", "'apt-get install' without '--no-install-recommends'",
     "HIGH",
     "Skipping recommended packages keeps images small.",
     "Add '--no-install-recommends' to 'apt-get install'")
def _apt_no_recommends(insts):
    for inst in insts:
        if inst.cmd != "RUN":
            continue
        for m in re.finditer(r"apt-get\s+(?:-\S+\s+)*install\b[^&|;]*",
                             inst.args):
            seg = m.group(0)
            if "--no-install-recommends" not in seg:
                yield inst, (f"'--no-install-recommends' is missed: "
                             f"'{seg.strip()}'")


def scan_dockerfile(path: str, content: bytes,
                    lines: list[str] | None = None
                    ) -> tuple[list[T.DetectedMisconfiguration], int]:
    """→ (failures, successes_count)."""
    text = content.decode(errors="replace")
    insts = parse_dockerfile(text)
    if not insts:
        return [], 0
    src_lines = text.splitlines()
    failures = []
    successes = 0
    for check in CHECKS:
        found = list(check.fn(insts))
        if not found:
            successes += 1
            continue
        for inst, message in found:
            m = T.DetectedMisconfiguration(
                type="dockerfile",
                id=check.id,
                avd_id=check.avd_id,
                title=check.title,
                description=check.description,
                message=message,
                namespace=f"builtin.dockerfile.{check.id}",
                resolution=check.resolution,
                severity=check.severity,
                primary_url=f"https://avd.aquasec.com/misconfig/"
                            f"{check.id.lower()}",
                status="FAIL",
            )
            if inst is not None:
                m.cause_metadata = T.CauseMetadata(
                    provider="Dockerfile", service="general",
                    start_line=inst.start_line, end_line=inst.end_line,
                    code=T.Code(lines=[
                        T.CodeLine(number=n + 1, content=src_lines[n],
                                   is_cause=True, first_cause=(
                                       n + 1 == inst.start_line),
                                   last_cause=(n + 1 == inst.end_line),
                                   highlighted=src_lines[n])
                        for n in range(inst.start_line - 1,
                                       min(inst.end_line, len(src_lines)))
                    ]))
            failures.append(m)
    return failures, successes
