"""Misconfiguration scanning (reference pkg/misconf + pkg/iac), the
port's copy of the JAX package's misconf/.

Bridges the config analyzer to the IaC engine: file-type detection
(iac.detection), the per-type scanners (the dockerfile checks here; the
kubernetes, CloudFormation, Terraform plan and Azure ARM ones in
trivy_tpu_torch.iac; Terraform modules through the `terraform`
post-analyzer), user rego checks with their exceptions, and
DetectedMisconfiguration results with cause locations."""

from dataclasses import dataclass

from .dockerfile import scan_dockerfile as _scan_dockerfile


def scan_dockerfile(path, content, lines=None, docs=None):
    return _scan_dockerfile(path, content, lines)


def _scan_kubernetes(path, content, lines=None, docs=None):
    from ..iac.kubernetes import scan_kubernetes
    return scan_kubernetes(path, content, lines, docs=docs)


def _scan_cloudformation(path, content, lines=None, docs=None):
    from ..iac.cloudformation import scan_cloudformation
    return scan_cloudformation(path, content, lines, docs=docs)


def _scan_tfplan(path, content, lines=None, docs=None):
    from ..iac.tfplan import scan_plan_file
    records = scan_plan_file(path, content)
    failures = [f for r in records for f in r.failures]
    successes = sum(r.successes for r in records)
    return failures, successes


def _scan_arm(path, content, lines=None, docs=None):
    from ..iac.azure import scan_arm
    return scan_arm(path, content, lines, docs)


FILE_TYPES = {
    "dockerfile": scan_dockerfile,
    "kubernetes": _scan_kubernetes,
    "cloudformation": _scan_cloudformation,
    "terraformplan": _scan_tfplan,
    "azure-arm": _scan_arm,
}

# ---- custom rego checks (reference pkg/misconf ScannerOption
# PolicyPaths/DataPaths/Namespaces → pkg/iac/rego) -------------------

# the process default user checks, set via set_custom_checks; a scan
# carries its own in MisconfSettings
_custom_scanner = None


def _load_checks(check_paths, data_paths, namespaces, trace):
    from ..iac.rego import RegoChecksScanner
    scanner = RegoChecksScanner.from_paths(
        check_paths, data_paths=data_paths, namespaces=namespaces,
        trace=trace)
    scanner.fingerprint = _fingerprint_paths(
        check_paths, data_paths, namespaces)
    return scanner


def set_custom_checks(check_paths, data_paths=None, namespaces=None):
    """Configure user .rego checks as the process default, which an
    AnalyzerGroup built without its own settings takes. Pass empty/None
    paths to clear."""
    global _custom_scanner
    if not check_paths:
        _custom_scanner = None
        return None
    from ..iac.rego import PROCESS_DEFAULT
    _custom_scanner = _load_checks(check_paths, data_paths, namespaces,
                                   PROCESS_DEFAULT)
    return _custom_scanner


@dataclass(frozen=True)
class MisconfSettings:
    """One scan's misconfiguration settings (reference misconf
    ScannerOption): the user rego checks (a RegoChecksScanner carrying
    its fingerprint, or None), the helm value overrides (the --helm-set
    strings and the parsed --helm-values documents) and the rego trace
    sink. The CLI builds them from its flags and gives them to the
    scan's AnalyzerGroup and ScanOptions, so concurrent scans in one
    process do not share them."""
    checks: object = None
    helm_sets: tuple = ()
    helm_values: tuple = ()
    trace: object = None    # None: no trace

    @classmethod
    def from_flags(cls, check_paths=(), data_paths=(), namespaces=(),
                   helm_sets=(), helm_values_files=(), trace=None):
        """Raises iac.helm.HelmRenderError for a values file that does
        not load."""
        from ..iac.helm import load_values_files
        helm_values = tuple(load_values_files(helm_values_files))
        return cls(
            checks=_load_checks(check_paths, data_paths, namespaces,
                                trace) if check_paths else None,
            helm_sets=tuple(helm_sets or ()), helm_values=helm_values,
            trace=trace)

    @property
    def helm_overrides(self) -> tuple:
        return self.helm_sets, self.helm_values

    def fingerprint(self) -> str:
        """The user checks' hash for the cache key; '' without them."""
        return getattr(self.checks, "fingerprint", "") \
            if self.checks is not None else ""


def current_settings() -> MisconfSettings:
    """The process default, as the set_* functions left it."""
    from ..iac.helm import helm_overrides
    from ..iac.rego import rego_trace
    sets, values = helm_overrides()
    return MisconfSettings(checks=_custom_scanner, helm_sets=sets,
                           helm_values=values, trace=rego_trace())


def _fingerprint_paths(check_paths, data_paths, namespaces) -> str:
    """Stable hash of check/data file contents + namespaces, mixed into
    the layer cache key so cached blobs are invalidated when the policy
    set changes (reference pkg/fanal/cache/key.go hashes policy
    contents the same way)."""
    import hashlib
    import os
    h = hashlib.sha256()
    for group in (check_paths or []), (data_paths or []):
        for p in group:
            files = []
            if os.path.isdir(p):
                for root, _, names in os.walk(p):
                    files.extend(os.path.join(root, n)
                                 for n in sorted(names))
            elif os.path.exists(p):
                files = [p]
            for fp in files:
                h.update(fp.encode())
                try:
                    with open(fp, "rb") as f:
                        h.update(f.read())
                except OSError:
                    pass
        h.update(b"|")
    h.update(",".join(sorted(namespaces or [])).encode())
    return h.hexdigest()


def custom_checks_fingerprint() -> str:
    """'' when no custom checks are configured."""
    if _custom_scanner is None:
        return ""
    return getattr(_custom_scanner, "fingerprint", "")


def custom_checks_scanner():
    return _custom_scanner


def dockerfile_rego_input(content: bytes) -> dict:
    """Build the mixed-case rego input document for dockerfiles
    (reference pkg/iac/providers/dockerfile/dockerfile.go ToRego)."""
    from .dockerfile import parse_dockerfile
    text = content.decode(errors="replace")
    stages = []
    cur = {"Name": "", "Commands": []}
    stage_idx = -1
    for inst in parse_dockerfile(text):
        if inst.cmd == "FROM":
            if cur["Commands"]:
                stages.append(cur)
            stage_idx += 1
            cur = {"Name": inst.args, "Commands": []}
        value = inst.args
        cur["Commands"].append({
            "Cmd": inst.cmd.lower(),
            "SubCmd": "",
            "Flags": [],
            "Value": [value],
            "Original": f"{inst.cmd} {inst.args}",
            "JSON": False,
            "Stage": max(stage_idx, 0),
            "StartLine": inst.start_line,
            "EndLine": inst.end_line,
        })
    stages.append(cur)
    return {"Stages": [s for s in stages if s["Commands"]]}


def run_custom_checks(ftype: str, path: str, content: bytes, docs,
                      scanner):
    """→ (failures, successes, exceptions) from the user rego checks of
    `scanner`."""
    text = content.decode(errors="replace")
    if ftype == "dockerfile":
        inputs = [dockerfile_rego_input(content)]
    elif docs is not None:
        inputs = [d for d in docs if d is not None]
    else:
        inputs = _parse_plain_docs(path, text)
    if not inputs:
        return [], 0, 0
    builtin = _builtin_namespaces(ftype) or []
    custom = sorted(".".join(m.package)
                    for m in scanner.check_modules())
    return scanner.scan_docs(
        ftype, path, inputs, text,
        extra_namespaces=sorted(set(builtin) | set(custom)))


def _parse_plain_docs(path: str, text: str):
    base = path.lower()
    try:
        if base.endswith((".yaml", ".yml")):
            import yaml
            return [d for d in yaml.safe_load_all(text) if d is not None]
        if base.endswith(".json"):
            import json
            data = json.loads(text)
            return data if isinstance(data, list) else [data]
        if base.endswith(".toml"):
            import tomllib
            return [tomllib.loads(text)]
    except Exception:
        return []
    return []


def detect_file_type(path: str, custom: bool | None = None) -> str:
    """Path-only pre-gate; content sniffing happens in the analyzer
    (detection.sniff). custom: whether user checks are set (they take
    TOML files too); None asks the process default."""
    if custom is None:
        custom = _custom_scanner is not None
    base = path.rsplit("/", 1)[-1].lower()
    if base == "dockerfile" or base.startswith("dockerfile.") or \
            base.endswith(".dockerfile"):
        return "dockerfile"
    if base.endswith((".yaml", ".yml", ".json", ".tf", ".tf.json")):
        return "candidate"
    if base.endswith(".toml") and custom:
        return "candidate"
    return ""


def _builtin_namespaces(ftype: str):
    """Every check namespace a file type's builtin scanner evaluates,
    or None when the scanner doesn't have per-check accounting."""
    if ftype == "dockerfile":
        from .dockerfile import CHECKS
        return [f"builtin.dockerfile.{c.id}" for c in CHECKS]
    if ftype == "kubernetes":
        from ..iac.kubernetes import CHECKS
        return [c.namespace for c in CHECKS]
    return None


def apply_exceptions(ftype: str, path: str, content: bytes, docs,
                     failures, successes, scanner):
    """Rego exceptions over BUILTIN results (reference
    pkg/iac/rego/exceptions.go: `namespace.exceptions.exception[_] ==
    ns` and `endswith(rule, data.<ns>.exception[_][_])`, both
    input-aware). Native checks correspond to the reference's `deny`
    rules, so the rule-name tested is "deny". → (failures, successes,
    exceptions). scanner: the user checks."""
    if not scanner.has_exceptions():
        return failures, successes, 0
    if not failures and not successes:
        # the builtin scanner evaluated nothing for this file (e.g. a
        # kubernetes file with no workload/RBAC documents): there is
        # nothing to except
        return failures, successes, 0
    if ftype == "dockerfile":
        input_docs = [dockerfile_rego_input(content)]
    else:
        input_docs = [d for d in (docs or []) if d is not None]
    names = _builtin_namespaces(ftype)
    custom_ns = sorted(".".join(m.package)
                       for m in scanner.check_modules())
    if names is None:
        # no per-check registry: except whole failing checks only
        universe = sorted({f.namespace for f in failures}
                          | set(custom_ns))
        excepted = {
            ns for ns in {f.namespace for f in failures}
            if any(scanner.is_ignored(ns, "deny", doc, universe)
                   for doc in input_docs)}
        kept = [f for f in failures if f.namespace not in excepted]
        return kept, successes, len(excepted)
    # one namespace universe for builtin AND custom passes, like the
    # reference's single data.namespaces document
    universe = sorted(set(names) | set(custom_ns))
    excepted = set()
    for ns in names:
        if any(scanner.is_ignored(ns, "deny", doc, universe)
               for doc in input_docs):
            excepted.add(ns)
    if not excepted:
        return failures, successes, 0
    kept = [f for f in failures if f.namespace not in excepted]
    kept_failed_ns = {f.namespace for f in kept}
    exceptions = len(excepted)
    successes = max(len(names) - exceptions - len(kept_failed_ns), 0)
    return kept, successes, exceptions
