"""OS-package vulnerability detection — per-family drivers over the
batched join engine.

Mirrors the reference driver table (pkg/detector/ospkg/detect.go:32-48) and
each family's stream naming / version-formatting / severity rules:
- alpine (alpine/alpine.go): stream = Minor(osVer), repo release preferred,
  join on SrcName with FormatSrcVersion;
- debian (debian/debian.go): stream = Major(osVer), advisory severity →
  SeveritySource "debian", unfixed advisories reported with Status;
- ubuntu (ubuntu/ubuntu.go): stream = osVer (xx.yy), or its ESM stream
  once the release is past its end of life;
- wolfi/chainguard: flat stream;
- the rpm families (amazon, oracle, rocky, alma, photon, cbl-mariner,
  opensuse.leap, SLES), and Red Hat/CentOS with content-set scoped
  advisories (redhat/redhat.go).

EOL tables reproduce each driver's eolDates; EOSL flags the report like
osver.Supported (version/version.go:31).
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass
from typing import Callable, Optional

from .. import types as T
from .engine import BatchDetector, Hit, PkgQuery

_FAR_FUTURE = dt.datetime(9999, 1, 1, tzinfo=dt.timezone.utc)


def _d(y, m, d):
    return dt.datetime(y, m, d, 23, 59, 59, tzinfo=dt.timezone.utc)


ALPINE_EOL = {
    "2.0": _d(2012, 4, 1), "2.1": _d(2012, 11, 1), "2.2": _d(2013, 5, 1),
    "2.3": _d(2013, 11, 1), "2.4": _d(2014, 5, 1), "2.5": _d(2014, 11, 1),
    "2.6": _d(2015, 5, 1), "2.7": _d(2015, 11, 1), "3.0": _d(2016, 5, 1),
    "3.1": _d(2016, 11, 1), "3.2": _d(2017, 5, 1), "3.3": _d(2017, 11, 1),
    "3.4": _d(2018, 5, 1), "3.5": _d(2018, 11, 1), "3.6": _d(2019, 5, 1),
    "3.7": _d(2019, 11, 1), "3.8": _d(2020, 5, 1), "3.9": _d(2020, 11, 1),
    "3.10": _d(2021, 5, 1), "3.11": _d(2021, 11, 1), "3.12": _d(2022, 5, 1),
    "3.13": _d(2022, 11, 1), "3.14": _d(2023, 5, 1), "3.15": _d(2023, 11, 1),
    "3.16": _d(2024, 5, 23), "3.17": _d(2024, 11, 22), "3.18": _d(2025, 5, 9),
    "3.19": _d(2025, 11, 1), "edge": _FAR_FUTURE,
}

DEBIAN_EOL = {
    "7": _d(2018, 5, 31), "8": _d(2020, 6, 30), "9": _d(2022, 6, 30),
    "10": _d(2024, 6, 30), "11": _d(2026, 6, 30), "12": _d(2028, 6, 30),
}

UBUNTU_EOL = {
    "12.04": _d(2019, 4, 26), "12.04-ESM": _d(2019, 4, 28),
    "14.04": _d(2022, 4, 25), "14.04-ESM": _d(2024, 4, 25),
    "16.04": _d(2021, 4, 21), "16.04-ESM": _d(2026, 4, 29),
    "18.04": _d(2023, 5, 31), "18.04-ESM": _d(2028, 3, 31),
    "20.04": _d(2025, 4, 23),
    "21.04": _d(2022, 1, 20), "21.10": _d(2022, 7, 14),
    "22.04": _d(2027, 4, 23), "22.10": _d(2023, 7, 20),
    "23.04": _d(2024, 1, 20), "23.10": _d(2024, 7, 11),
    "24.04": _d(2029, 4, 25),
}


def _ubuntu_stream(os_ver: str,
                   now: Optional[dt.datetime] = None) -> str:
    """Once the base release is EOL, fall over to the '<ver>-ESM'
    advisory stream when one exists (ubuntu.go versionFromEolDates)."""
    now = now or dt.datetime.now(dt.timezone.utc)
    eol = UBUNTU_EOL.get(os_ver)
    if eol is not None and now <= eol:
        return os_ver
    esm = os_ver + "-ESM"
    if esm in UBUNTU_EOL:
        return esm
    return os_ver


def minor(os_ver: str) -> str:
    parts = os_ver.split(".")
    return ".".join(parts[:2])


def major(os_ver: str) -> str:
    return os_ver.split(".", 1)[0]


@dataclass
class FamilyDriver:
    family: str
    ecosystem: str
    stream: Callable[[str, Optional[T.Repository]], str]     # → version key
    bucket: Callable[[str], str]                             # stream → bucket
    severity_source: str = ""   # SeveritySource when advisory has severity
    eol: Optional[dict] = None
    eol_key: Callable[[str], str] = staticmethod(lambda v: v)
    use_src: bool = True        # join on SrcName (False: binary pkg name)
    arch_aware: bool = False    # advisories scoped per-arch (Rocky/Alma)
    # drivers that round-trip the advisory's FixedVersion through
    # go-rpm-version String() — which omits an explicit epoch 0 —
    # before reporting (alma.go:71, rocky.go:71, mariner.go:68,
    # redhat.go:163; oracle/photon/suse/amazon report it raw)
    strip_zero_epoch: bool = False


def _strip_zero_epoch(ver: str) -> str:
    """go-rpm-version String() omits an explicit epoch 0 — '0:1.2-3'
    prints as '1.2-3'."""
    return ver[2:] if ver.startswith("0:") else ver


def _alpine_stream(os_ver: str, repo: Optional[T.Repository]) -> str:
    v = minor(os_ver)
    if repo and repo.release:
        rel = repo.release
        if rel.count(".") > 1:
            rel = rel[:rel.rindex(".")]
        if rel and v != rel:
            v = rel  # repository release preferred (alpine.go:76-83)
    return v


def _amazon_stream(v: str) -> str:
    v = major(v.split()[0]) if v.strip() else v
    return v if v in ("2", "2022", "2023") else "1"


AMAZON_EOL = {
    "1": _d(2023, 12, 31), "2": _d(2025, 6, 30),
    "2022": _d(2024, 6, 30), "2023": _d(2028, 3, 15),
}
ORACLE_EOL = {
    "5": _d(2017, 12, 31), "6": _d(2021, 3, 21), "7": _d(2024, 12, 31),
    "8": _d(2029, 7, 31), "9": _d(2032, 6, 30),
}
ROCKY_EOL = {"8": _d(2029, 5, 31), "9": _d(2032, 5, 31)}
ALMA_EOL = {"8": _d(2029, 3, 1), "9": _d(2032, 5, 31)}
SUSE_SLES_EOL = {
    "12": _d(2016, 6, 30), "12.1": _d(2017, 5, 31),
    "12.2": _d(2018, 3, 31), "12.3": _d(2019, 1, 30),
    "12.4": _d(2020, 6, 30), "12.5": _d(2024, 10, 31),
    "15": _d(2019, 12, 31), "15.1": _d(2021, 1, 31),
    "15.2": _d(2021, 12, 31), "15.3": _d(2022, 12, 31),
    "15.4": _d(2023, 12, 31), "15.5": _d(2028, 12, 31),
}
SUSE_OPENSUSE_EOL = {
    "15.0": _d(2019, 12, 3), "15.1": _d(2020, 11, 30),
    "15.2": _d(2021, 11, 30), "15.3": _d(2022, 11, 30),
    "15.4": _d(2023, 11, 30), "15.5": _d(2024, 12, 31),
}
PHOTON_EOL = {
    "1.0": _d(2022, 2, 28), "2.0": _d(2022, 12, 31),
    "3.0": _d(2024, 3, 1), "4.0": _d(2026, 3, 1), "5.0": _d(2028, 3, 1),
}


DRIVERS: dict[str, FamilyDriver] = {
    "alpine": FamilyDriver(
        family="alpine", ecosystem="alpine",
        stream=_alpine_stream,
        bucket=lambda s: f"alpine {s}",
        eol=ALPINE_EOL, eol_key=minor),
    "wolfi": FamilyDriver(
        family="wolfi", ecosystem="alpine",
        stream=lambda v, r: "",
        bucket=lambda s: "wolfi"),
    "chainguard": FamilyDriver(
        family="chainguard", ecosystem="alpine",
        stream=lambda v, r: "",
        bucket=lambda s: "chainguard"),
    "debian": FamilyDriver(
        family="debian", ecosystem="debian",
        stream=lambda v, r: major(v),
        bucket=lambda s: f"debian {s}",
        severity_source="debian",
        eol=DEBIAN_EOL, eol_key=major),
    "ubuntu": FamilyDriver(
        family="ubuntu", ecosystem="ubuntu",
        stream=lambda v, r: _ubuntu_stream(v),
        bucket=lambda s: f"ubuntu {s}",
        eol=UBUNTU_EOL),
    # rpm families (pkg/detector/ospkg/{amazon,oracle,rocky,alma,photon,
    # mariner,suse}); join-name and stream rules follow each driver
    "amazon": FamilyDriver(
        family="amazon", ecosystem="amazon",
        stream=lambda v, r: _amazon_stream(v),
        bucket=lambda s: f"amazon linux {s}",
        eol=AMAZON_EOL, eol_key=_amazon_stream, use_src=False),
    "oracle": FamilyDriver(
        family="oracle", ecosystem="oracle",
        stream=lambda v, r: major(v),
        bucket=lambda s: f"Oracle Linux {s}",
        eol=ORACLE_EOL, eol_key=major, use_src=False),
    "rocky": FamilyDriver(
        family="rocky", ecosystem="rocky",
        stream=lambda v, r: major(v),
        bucket=lambda s: f"rocky {s}",
        eol=ROCKY_EOL, eol_key=major, use_src=False, arch_aware=True,
        strip_zero_epoch=True),
    "alma": FamilyDriver(
        family="alma", ecosystem="alma",
        stream=lambda v, r: major(v),
        bucket=lambda s: f"alma {s}",
        eol=ALMA_EOL, eol_key=major, use_src=False, arch_aware=True,
        strip_zero_epoch=True),
    "photon": FamilyDriver(
        family="photon", ecosystem="photon",
        stream=lambda v, r: v,
        bucket=lambda s: f"Photon OS {s}",
        eol=PHOTON_EOL),
    "cbl-mariner": FamilyDriver(
        family="cbl-mariner", ecosystem="cbl-mariner",
        stream=lambda v, r: minor(v),
        bucket=lambda s: f"CBL-Mariner {s}",
        eol_key=minor, strip_zero_epoch=True),
    # suse.go joins on the BINARY package name (suse.go:99)
    "opensuse.leap": FamilyDriver(
        family="opensuse.leap", ecosystem="opensuse.leap",
        stream=lambda v, r: v,
        bucket=lambda s: f"openSUSE Leap {s}", use_src=False,
        eol=SUSE_OPENSUSE_EOL),
    # suse.go NewScanner(SUSEEnterpriseLinux): susecvrf bucket
    # "SUSE Linux Enterprise <ver>"
    "suse linux enterprise server": FamilyDriver(
        family="suse linux enterprise server",
        ecosystem="suse linux enterprise server",
        stream=lambda v, r: v,
        bucket=lambda s: f"SUSE Linux Enterprise {s}", use_src=False,
        eol=SUSE_SLES_EOL),
}

# ----- Red Hat / CentOS (content-set scoped OVAL v2) -----

REDHAT_DEFAULT_CONTENT_SETS = {
    "6": ["rhel-6-server-rpms", "rhel-6-server-extras-rpms"],
    "7": ["rhel-7-server-rpms", "rhel-7-server-extras-rpms"],
    "8": ["rhel-8-for-x86_64-baseos-rpms",
          "rhel-8-for-x86_64-appstream-rpms"],
    "9": ["rhel-9-for-x86_64-baseos-rpms",
          "rhel-9-for-x86_64-appstream-rpms"],
}
REDHAT_EOL = {
    "4": _d(2017, 5, 31), "5": _d(2020, 11, 30), "6": _d(2024, 6, 30),
    "7": _FAR_FUTURE, "8": _FAR_FUTURE, "9": _FAR_FUTURE,
}
CENTOS_EOL = {
    "3": _d(2010, 10, 31), "4": _d(2012, 2, 29), "5": _d(2017, 3, 31),
    "6": _d(2020, 11, 30), "7": _d(2024, 6, 30), "8": _d(2021, 12, 31),
}


def add_modular_namespace(name: str, label: str) -> str:
    """'nodejs:12:8030020201124152102:229f0a1c' + 'npm' →
    'nodejs:12::npm' (redhat.go addModularNamespace)."""
    parts = label.split(":")
    if len(parts) >= 2:
        return f"{parts[0]}:{parts[1]}::{name}"
    return name



class OspkgScanner:
    """Batched equivalent of ospkgDetector.Detect (detect.go:63-82)."""

    def __init__(self, detector: BatchDetector):
        self.detector = detector

    def prepare(self, os_info: T.OS, repo: Optional[T.Repository],
                packages: list[T.Package],
                now: Optional[dt.datetime] = None):
        """→ (queries, finish) with finish(hits) → (vulns, eosl); finish
        is None for a family without a driver (the caller emits no
        result, like ospkg/scan.go ErrUnsupportedOS). gpg-pubkey pseudo
        packages are skipped like detect.go:73. Splitting query
        construction from hit assembly lets a scan fold its OS and
        application batches into one detect_many call."""
        if os_info.family in ("redhat", "centos"):
            return self._prepare_redhat(os_info, packages, now)
        driver = DRIVERS.get(os_info.family)
        if driver is None:
            # unsupported family: the caller emits NO result
            # (ospkg/scan.go ErrUnsupportedOS → empty Result)
            return [], None
        now = now or dt.datetime.now(dt.timezone.utc)
        if driver.family == "ubuntu":
            # stream selection shares the scan clock so the ESM
            # fallover and the EOSL flag agree
            stream = _ubuntu_stream(os_info.name, now)
        else:
            stream = driver.stream(os_info.name, repo)
        bucket = driver.bucket(stream)

        queries = []
        for pkg in packages:
            if pkg.name == "gpg-pubkey":
                continue
            if driver.use_src:
                name = pkg.src_name or pkg.name
                ver = pkg.format_src_version() or pkg.format_version()
            else:
                name = pkg.name
                ver = pkg.format_version()
            if not ver:
                continue
            queries.append(PkgQuery(
                source=bucket, ecosystem=driver.ecosystem,
                name=name, version=ver,
                arch=pkg.arch if driver.arch_aware else "", ref=pkg))

        def finish(hits):
            vulns = [self._to_vuln(h, driver) for h in hits]
            eosl = False
            if driver.eol is not None:
                at = now or dt.datetime.now(dt.timezone.utc)
                eol = driver.eol.get(driver.eol_key(os_info.name))
                eosl = eol is not None and at > eol
            return vulns, eosl

        return queries, finish

    def _prepare_redhat(self, os_info: T.OS, packages: list[T.Package],
                        now: Optional[dt.datetime] = None):
        """RHEL/CentOS: advisories are scoped by CPE indices resolved
        from each package's content sets / NVR (redhat.go detect)."""
        maj = major(os_info.name)
        cpe_maps = self.table_aux().get("Red Hat CPE") or {}
        repo_map = cpe_maps.get("repository") or {}
        nvr_map = cpe_maps.get("nvr") or {}

        queries = []
        for pkg in packages:
            if pkg.name == "gpg-pubkey":
                continue
            if pkg.release.endswith(".remi"):
                continue  # unsupported vendor (redhat.go:64-66)
            name = pkg.name
            if pkg.modularitylabel:
                name = add_modular_namespace(name, pkg.modularitylabel)
            bi = pkg.build_info
            if bi is None:
                content_sets = REDHAT_DEFAULT_CONTENT_SETS.get(maj, [])
                nvrs = []
            else:
                content_sets = bi.content_sets
                nvrs = [f"{bi.nvr}-{bi.arch}"] if bi.nvr else []
            allowed: set = set()
            for cs in content_sets:
                allowed.update(repo_map.get(cs) or ())
            for nvr in nvrs:
                allowed.update(nvr_map.get(nvr) or ())
            ver = pkg.format_version()
            if not ver:
                continue
            queries.append(PkgQuery(
                source="Red Hat", ecosystem="redhat",
                name=name, version=ver,
                arch="" if pkg.arch == "noarch" else pkg.arch,
                cpe_indices=frozenset(allowed), ref=pkg))

        def finish(hits):
            return self._finish_redhat(hits, os_info, now)

        return queries, finish

    def _finish_redhat(self, hits, os_info: T.OS,
                       now: Optional[dt.datetime]):
        from .. import version as V
        maj = major(os_info.name)
        # per (pkg, vuln): unfixed never overwrite; fixed take the max
        # fixed version and merged vendor ids (redhat.go:148-179)
        merged: dict[tuple, Hit] = {}
        for h in hits:
            k = (id(h.query.ref), h.vuln_id)
            prev = merged.get(k)
            if h.fixed_version == "":
                if prev is None:
                    merged[k] = h
                continue
            if prev is None or prev.fixed_version == "":
                merged[k] = h
                continue
            # Hit is an immutable NamedTuple — merge via _replace
            vids = tuple(dict.fromkeys(
                prev.vendor_ids + h.vendor_ids))
            fixed = prev.fixed_version
            try:
                if V.compare("redhat", fixed, h.fixed_version) < 0:
                    fixed = h.fixed_version
            except (ValueError, KeyError):
                pass
            merged[k] = prev._replace(vendor_ids=vids,
                                      fixed_version=fixed)

        vulns = []
        for h in merged.values():
            pkg: T.Package = h.query.ref
            v = T.DetectedVulnerability(
                vulnerability_id=h.vuln_id,
                vendor_ids=list(h.vendor_ids),
                pkg_id=pkg.id, pkg_name=pkg.name,
                pkg_identifier=pkg.identifier,
                installed_version=pkg.format_version(),
                fixed_version=_strip_zero_epoch(h.fixed_version),
                status=h.status, layer=pkg.layer,
                data_source=T.DataSource(**h.data_source)
                if h.data_source else None,
            )
            v.severity_source = "redhat"
            v.vulnerability.severity = h.severity or "UNKNOWN"
            vulns.append(v)
        vulns.sort(key=lambda v: (v.pkg_name, v.vulnerability_id))

        eol_table = CENTOS_EOL if os_info.family == "centos" \
            else REDHAT_EOL
        now = now or dt.datetime.now(dt.timezone.utc)
        eol = eol_table.get(maj)
        eosl = eol is not None and now > eol
        return vulns, eosl

    def table_aux(self) -> dict:
        return getattr(self.detector.table, "aux", {}) or {}

    @staticmethod
    def _to_vuln(h: Hit, driver: FamilyDriver) -> T.DetectedVulnerability:
        pkg: T.Package = h.query.ref
        v = T.DetectedVulnerability(
            vulnerability_id=h.vuln_id,
            vendor_ids=list(h.vendor_ids),
            pkg_id=pkg.id,
            pkg_name=pkg.name,
            pkg_identifier=pkg.identifier,
            installed_version=pkg.format_version(),
            fixed_version=_strip_zero_epoch(h.fixed_version)
            if driver.strip_zero_epoch else h.fixed_version,
            status=h.status,
            layer=pkg.layer,
            data_source=T.DataSource(**h.data_source) if h.data_source else None,
        )
        if h.severity and h.severity != "UNKNOWN":
            v.severity_source = driver.severity_source or driver.family
            v.vulnerability.severity = h.severity
        return v
