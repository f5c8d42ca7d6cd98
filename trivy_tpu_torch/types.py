"""Core scan/report types — the subset the ported scan paths use.

Mirrors the reference report schema so JSON output is comparable
byte-for-byte after normalization:
- pkg/types/report.go (Report/Result), pkg/types/vulnerability.go
  (DetectedVulnerability), pkg/fanal/types/artifact.go (Package, BlobInfo,
  ArtifactDetail, OS, Layer), pkg/fanal/types/secret.go (SecretFinding).

Go's `json:",omitempty"` semantics are reproduced by `_strip_empty`:
zero values (empty string, 0, False, empty list/dict, None) are omitted.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


# --- enums (string constants, reference pkg/fanal/types/const.go) ---

class OSFamily:
    NONE = "none"  # packages without a detected OS (scan.go:70)
    ALPINE = "alpine"
    DEBIAN = "debian"
    UBUNTU = "ubuntu"
    REDHAT = "redhat"
    CENTOS = "centos"
    ROCKY = "rocky"
    ALMA = "alma"
    AMAZON = "amazon"
    ORACLE = "oracle"
    FEDORA = "fedora"
    SUSE = "suse"  # family umbrella; concrete: opensuse/sles
    OPENSUSE = "opensuse"
    OPENSUSE_LEAP = "opensuse.leap"
    OPENSUSE_TUMBLEWEED = "opensuse.tumbleweed"
    SLES = "suse linux enterprise server"
    PHOTON = "photon"
    WOLFI = "wolfi"
    CHAINGUARD = "chainguard"
    MARINER = "cbl-mariner"


class ResultClass:
    OS_PKGS = "os-pkgs"
    LANG_PKGS = "lang-pkgs"
    CONFIG = "config"
    SECRET = "secret"
    LICENSE = "license"
    LICENSE_FILE = "license-file"
    CUSTOM = "custom"
    INGEST = "ingest"  # fanald degradation annotations (partial scans)


class ArtifactType:
    CONTAINER_IMAGE = "container_image"
    FILESYSTEM = "filesystem"
    REPOSITORY = "repository"
    CYCLONEDX = "cyclonedx"
    SPDX = "spdx"
    VM = "vm"


class Scanner:
    VULN = "vuln"
    SECRET = "secret"
    MISCONF = "misconfig"
    LICENSE = "license"
    NONE = "none"


SEVERITIES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]


class Status:
    """Advisory status (trivy-db pkg/types/status.go ordering)."""
    UNKNOWN = "unknown"
    NOT_AFFECTED = "not_affected"
    AFFECTED = "affected"
    FIXED = "fixed"
    UNDER_INVESTIGATION = "under_investigation"
    WILL_NOT_FIX = "will_not_fix"
    FIX_DEFERRED = "fix_deferred"
    END_OF_LIFE = "end_of_life"


# --- helpers ---

def _strip_empty(v: Any) -> Any:
    """Drop Go-zero values recursively (json omitempty emulation)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return v.to_json()
    if isinstance(v, dict):
        out = {}
        for k, val in v.items():
            sv = _strip_empty(val)
            if sv not in ("", None, [], {}, 0, False) or sv is True:
                out[k] = sv
        return out
    if isinstance(v, (list, tuple)):
        return [_strip_empty(x) for x in v]
    if isinstance(v, float) and v.is_integer():
        return int(v)  # Go marshals float64(5) as "5", not "5.0"
    return v


class JsonMixin:
    _json_names: dict = {}
    _keep_zero: tuple = ()  # fields serialized even when zero (no omitempty)
    _json_skip: tuple = ()  # fields never serialized (Go `json:"-"`)
    _json_raw: tuple = ()   # fields emitted verbatim (no zero-stripping)

    def to_json(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            if f.name in self._json_skip:
                continue
            v = getattr(self, f.name)
            name = self._json_names.get(f.name, _pascal(f.name))
            sv = v if f.name in self._json_raw else _strip_empty(v)
            if f.name in self._keep_zero:
                out[name] = sv
                continue
            if sv in ("", None, [], {}, 0, False):
                continue
            out[name] = sv
        return out


def _pascal(name: str) -> str:
    return "".join(p.capitalize() if not p[0].isupper() else p
                   for p in name.split("_")) if "_" in name else (name[0].upper() + name[1:])


# --- fanal types ---

@dataclass
class Layer(JsonMixin):
    digest: str = ""
    diff_id: str = ""
    created_by: str = ""
    _json_names = {"diff_id": "DiffID"}

    def __bool__(self):
        return bool(self.digest or self.diff_id or self.created_by)


@dataclass
class OS(JsonMixin):
    family: str = ""
    name: str = ""
    eosl: bool = False
    extended: bool = False
    _json_names = {"eosl": "EOSL", "extended": "extended"}

    @property
    def detected(self) -> bool:
        return self.family != ""

    def merge(self, other: "OS") -> None:
        """Reference OS.Merge (pkg/fanal/types/artifact.go:30-55):
        a previously detected family is KEPT unless it is redhat or
        debian — Oracle ships /etc/redhat-release (detected as RHEL by
        mistake) and Ubuntu ships debian files, so only those two get
        overwritten by a later, more specific detection."""
        if not other.detected:
            return
        if self.family in (OSFamily.REDHAT, OSFamily.DEBIAN):
            self.family = other.family
            self.name = other.name
            self.extended = other.extended
            return
        if not self.family:
            self.family = other.family
        if not self.name:
            self.name = other.name
        self.extended = self.extended or other.extended


@dataclass
class Repository(JsonMixin):
    family: str = ""
    release: str = ""


@dataclass
class Location(JsonMixin):
    start_line: int = 0
    end_line: int = 0


@dataclass
class PkgIdentifier(JsonMixin):
    purl: str = ""
    bom_ref: str = ""
    uid: str = ""
    _json_names = {"purl": "PURL", "bom_ref": "BOMRef", "uid": "UID"}


@dataclass
class Package(JsonMixin):
    """Installed package row (reference pkg/fanal/types/artifact.go:68)."""
    id: str = ""
    name: str = ""
    identifier: PkgIdentifier = field(default_factory=PkgIdentifier)
    version: str = ""
    release: str = ""
    epoch: int = 0
    arch: str = ""
    dev: bool = False
    src_name: str = ""
    src_version: str = ""
    src_release: str = ""
    src_epoch: int = 0
    licenses: list = field(default_factory=list)
    maintainer: str = ""
    modularitylabel: str = ""
    indirect: bool = False
    depends_on: list = field(default_factory=list)
    layer: Layer = field(default_factory=Layer)
    file_path: str = ""
    digest: str = ""
    locations: list = field(default_factory=list)
    installed_files: list = field(default_factory=list)
    # attached by the applier from the origin layer's Red Hat build
    # metadata (docker.go lookupBuildInfo); never serialized to reports
    # (reference Package has BuildInfo `json:"-"`)
    build_info: Optional["BuildInfo"] = None
    _json_skip = ("build_info",)
    _json_names = {"id": "ID", "src_name": "SrcName", "src_version": "SrcVersion",
                   "src_release": "SrcRelease", "src_epoch": "SrcEpoch"}
    # non-pointer structs: always marshaled by Go (see DetectedVulnerability)
    _keep_zero = ("identifier", "layer")

    def format_version(self) -> str:
        """epoch:version-release (reference pkg/scanner/utils/util.go FormatVersion)."""
        return _format_ver(self.epoch, self.version, self.release)

    def format_src_version(self) -> str:
        return _format_ver(self.src_epoch, self.src_version, self.src_release)


def _format_ver(epoch: int, version: str, release: str) -> str:
    if version == "":
        return ""
    v = version
    if release != "":
        v = f"{v}-{release}"
    if epoch:
        v = f"{epoch}:{v}"
    return v


@dataclass
class PackageInfo(JsonMixin):
    file_path: str = ""
    packages: list = field(default_factory=list)  # [Package]


@dataclass
class Application(JsonMixin):
    """A language-ecosystem application (reference
    pkg/fanal/types/artifact.go Application)."""
    type: str = ""          # ecosystem, e.g. "python-pkg"
    file_path: str = ""
    packages: list = field(default_factory=list)  # [Package]


@dataclass
class Code(JsonMixin):
    lines: list = field(default_factory=list)


@dataclass
class CodeLine(JsonMixin):
    number: int = 0
    content: str = ""
    is_cause: bool = False
    annotation: str = ""
    truncated: bool = False
    highlighted: str = ""
    first_cause: bool = False
    last_cause: bool = False
    _json_names = {"is_cause": "IsCause", "first_cause": "FirstCause",
                   "last_cause": "LastCause"}
    _keep_zero = ("number", "content", "is_cause", "annotation",
                  "truncated", "first_cause", "last_cause")


@dataclass
class SecretFinding(JsonMixin):
    rule_id: str = ""
    category: str = ""
    severity: str = ""
    title: str = ""
    start_line: int = 0
    end_line: int = 0
    code: Code = field(default_factory=Code)
    match: str = ""
    layer: Layer = field(default_factory=Layer)
    _json_names = {"rule_id": "RuleID"}
    _keep_zero = ("rule_id", "category", "severity", "title",
                  "start_line", "end_line", "code", "match", "layer")


@dataclass
class Secret(JsonMixin):
    file_path: str = ""
    findings: list = field(default_factory=list)  # [SecretFinding]


@dataclass
class Misconfiguration(JsonMixin):
    """Per-file misconfiguration record inside a blob
    (reference pkg/fanal/types/misconf.go)."""
    file_type: str = ""
    file_path: str = ""
    successes: int = 0
    exceptions: int = 0
    failures: list = field(default_factory=list)  # [DetectedMisconfiguration]
    layer: "Layer" = field(default_factory=lambda: Layer())


@dataclass
class BuildInfo(JsonMixin):
    """Red Hat build metadata (reference pkg/fanal/types/artifact.go
    BuildInfo): content sets scope which advisories apply."""
    content_sets: list = field(default_factory=list)
    nvr: str = ""
    arch: str = ""
    _json_names = {"nvr": "Nvr"}


@dataclass
class BlobInfo(JsonMixin):
    """Per-layer analysis result (reference pkg/fanal/types/artifact.go:311)."""
    schema_version: int = 2
    digest: str = ""
    diff_id: str = ""
    created_by: str = ""
    opaque_dirs: list = field(default_factory=list)
    whiteout_files: list = field(default_factory=list)
    os: OS = field(default_factory=OS)
    repository: Optional[Repository] = None
    package_infos: list = field(default_factory=list)   # [PackageInfo]
    applications: list = field(default_factory=list)    # [Application]
    misconfigurations: list = field(default_factory=list)  # [Misconfiguration]
    secrets: list = field(default_factory=list)         # [Secret]
    licenses: list = field(default_factory=list)        # [DetectedLicense]
    # extension modules' output: [{"Type", "FilePath", "Data"}]
    custom_resources: list = field(default_factory=list)
    build_info: Optional[BuildInfo] = None
    # per-stage degradation annotations (fanal/ingest.py); a non-empty
    # list marks this blob a PARTIAL analysis, cached only under a
    # salted partial id and surfaced in the report
    ingest_errors: list = field(default_factory=list)
    _json_names = {"diff_id": "DiffID", "os": "OS",
                   "ingest_errors": "IngestErrors"}
    _json_raw = ("ingest_errors",)


@dataclass
class ArtifactInfo(JsonMixin):
    schema_version: int = 2
    architecture: str = ""
    created: str = ""
    docker_version: str = ""
    os: str = ""
    _json_names = {"os": "OS"}


@dataclass
class ArtifactDetail(JsonMixin):
    """Squashed view of all layers (reference pkg/fanal/types/artifact.go:341)."""
    os: OS = field(default_factory=OS)
    repository: Optional[Repository] = None
    packages: list = field(default_factory=list)      # [Package]
    applications: list = field(default_factory=list)  # [Application]
    misconfigurations: list = field(default_factory=list)  # [Misconfiguration]
    secrets: list = field(default_factory=list)       # [Secret]
    licenses: list = field(default_factory=list)      # [DetectedLicense]
    custom_resources: list = field(default_factory=list)
    # the blobs' annotations squashed in layer order (applier.py); the
    # scanner surfaces them as one ResultClass.INGEST result
    ingest_errors: list = field(default_factory=list)
    _json_names = {"os": "OS", "ingest_errors": "IngestErrors"}
    _json_raw = ("ingest_errors",)


# --- db / vulnerability types (trivy-db pkg/types) ---

@dataclass
class DataSource(JsonMixin):
    id: str = ""
    name: str = ""
    url: str = ""
    _json_names = {"id": "ID", "name": "Name", "url": "URL"}
    _keep_zero = ("id", "name", "url")


@dataclass
class CVSS(JsonMixin):
    v2_vector: str = ""
    v3_vector: str = ""
    v40_vector: str = ""
    v2_score: float = 0.0
    v3_score: float = 0.0
    v40_score: float = 0.0
    _json_names = {"v2_vector": "V2Vector", "v3_vector": "V3Vector",
                   "v40_vector": "V40Vector", "v2_score": "V2Score",
                   "v3_score": "V3Score", "v40_score": "V40Score"}


@dataclass
class Vulnerability(JsonMixin):
    """Vulnerability details (trivy-db pkg/types/types.go Vulnerability)."""
    title: str = ""
    description: str = ""
    severity: str = ""
    cwe_ids: list = field(default_factory=list)
    vendor_severity: dict = field(default_factory=dict)
    cvss: dict = field(default_factory=dict)  # source -> CVSS
    references: list = field(default_factory=list)
    published_date: str = ""
    last_modified_date: str = ""
    _json_names = {"cwe_ids": "CweIDs", "vendor_severity": "VendorSeverity",
                   "cvss": "CVSS"}


@dataclass
class DetectedVulnerability(JsonMixin):
    vulnerability_id: str = ""
    vendor_ids: list = field(default_factory=list)
    pkg_id: str = ""
    pkg_name: str = ""
    pkg_path: str = ""
    pkg_identifier: PkgIdentifier = field(default_factory=PkgIdentifier)
    installed_version: str = ""
    fixed_version: str = ""
    status: str = ""
    layer: Layer = field(default_factory=Layer)
    severity_source: str = ""
    primary_url: str = ""
    data_source: Optional[DataSource] = None
    # embedded details (filled by FillInfo)
    vulnerability: Vulnerability = field(default_factory=Vulnerability)
    _json_names = {"vulnerability_id": "VulnerabilityID", "vendor_ids": "VendorIDs",
                   "pkg_id": "PkgID", "pkg_name": "PkgName", "pkg_path": "PkgPath",
                   "primary_url": "PrimaryURL", "severity_source": "SeveritySource"}
    # PkgIdentifier/Layer are non-pointer structs in the reference: Go
    # omitempty never elides them (npm.json.golden shows "Layer": {})
    _keep_zero = ("pkg_identifier", "layer")

    def to_json(self) -> dict:
        out = super().to_json()
        # Go embeds types.Vulnerability fields inline at the top level.
        emb = out.pop("Vulnerability", None) or {}
        out.update(emb)
        return out

    @property
    def severity(self) -> str:
        return self.vulnerability.severity or "UNKNOWN"


@dataclass
class DetectedLicense(JsonMixin):
    """Reference pkg/types/license.go."""
    severity: str = ""
    category: str = ""
    pkg_name: str = ""
    file_path: str = ""
    name: str = ""
    text: str = ""
    confidence: float = 1.0
    link: str = ""
    _json_names = {"pkg_name": "PkgName", "file_path": "FilePath"}
    _keep_zero = ("severity", "category", "pkg_name", "file_path", "name",
                  "confidence", "link")


@dataclass
class CauseMetadata(JsonMixin):
    provider: str = ""
    service: str = ""
    start_line: int = 0
    end_line: int = 0
    code: "Code" = field(default_factory=lambda: Code())


@dataclass
class DetectedMisconfiguration(JsonMixin):
    """Reference pkg/types/misconfiguration.go: one failed check, from
    the dockerfile, kubernetes, helm or user rego checks, or read back
    from a saved report by `convert`."""
    type: str = ""
    id: str = ""
    avd_id: str = ""
    title: str = ""
    description: str = ""
    message: str = ""
    namespace: str = ""
    query: str = ""
    resolution: str = ""
    severity: str = ""
    primary_url: str = ""
    references: list = field(default_factory=list)
    status: str = ""
    layer: Layer = field(default_factory=Layer)
    cause_metadata: CauseMetadata = field(default_factory=CauseMetadata)
    _json_names = {"id": "ID", "avd_id": "AVDID", "primary_url": "PrimaryURL"}
    _keep_zero = ("type", "id", "title", "description", "message",
                  "namespace", "query", "resolution", "severity", "status")


# --- result / report ---

@dataclass
class MisconfSummary(JsonMixin):
    successes: int = 0
    failures: int = 0
    exceptions: int = 0
    _keep_zero = ("successes", "failures", "exceptions")


@dataclass
class Result(JsonMixin):
    target: str = ""
    clazz: str = ""
    type: str = ""
    packages: list = field(default_factory=list)
    vulnerabilities: list = field(default_factory=list)
    misconf_summary: Optional[MisconfSummary] = None
    misconfigurations: list = field(default_factory=list)
    secrets: list = field(default_factory=list)
    licenses: list = field(default_factory=list)
    custom_resources: list = field(default_factory=list)
    # degradation annotations (ResultClass.INGEST results)
    ingest_errors: list = field(default_factory=list)
    _json_names = {"clazz": "Class", "ingest_errors": "IngestErrors"}
    _json_raw = ("ingest_errors",)
    _keep_zero = ("target",)

    def is_empty(self) -> bool:
        # a config result whose checks all passed or were excepted still
        # carries its summary (reference local/scan.go:214-258)
        has_summary = self.misconf_summary is not None and (
            self.misconf_summary.successes
            or self.misconf_summary.exceptions)
        return not (self.packages or self.vulnerabilities
                    or self.misconfigurations or self.secrets
                    or self.licenses or self.custom_resources
                    or self.ingest_errors or has_summary)


@dataclass
class Metadata(JsonMixin):
    size: int = 0
    os: Optional[OS] = None
    image_id: str = ""
    diff_ids: list = field(default_factory=list)
    repo_tags: list = field(default_factory=list)
    repo_digests: list = field(default_factory=list)
    image_config: dict = field(default_factory=dict)
    _json_names = {"os": "OS", "image_id": "ImageID", "diff_ids": "DiffIDs"}
    # ImageConfig is a non-pointer struct in the reference
    # (types.Metadata → v1.ConfigFile): Go's omitempty never drops it,
    # so every report carries at least the zero config. Raw passthrough:
    # the stored dict is the image's own config JSON.
    _keep_zero = ("image_config",)
    _json_raw = ("image_config",)


# Marshal of the go-containerregistry v1.ConfigFile zero value — what
# the reference emits as Metadata.ImageConfig for non-image artifacts
# (fs/repo/sbom reports; see integration/testdata/npm.json.golden).
ZERO_IMAGE_CONFIG = {
    "architecture": "",
    "created": "0001-01-01T00:00:00Z",
    "os": "",
    "rootfs": {"type": "", "diff_ids": None},
    "config": {},
}


@dataclass
class Report(JsonMixin):
    schema_version: int = 2
    created_at: str = ""
    artifact_name: str = ""
    artifact_type: str = ""
    metadata: Metadata = field(default_factory=Metadata)
    results: list = field(default_factory=list)  # [Result]


# --- scan options / target ---

@dataclass
class ScanOptions:
    pkg_types: tuple = ("os", "library")
    scanners: tuple = (Scanner.VULN,)
    list_all_packages: bool = False
    include_dev_deps: bool = False
