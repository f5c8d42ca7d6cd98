"""The port's OS- and language-package detection against the JAX
package's, on the fixture DB: for every family driver, and for Red Hat
and CentOS, `OspkgScanner.prepare` builds the same queries, and the
finished vulnerabilities (the port's plain CPU join against the JAX
join) and the EOSL flag are equal at a fixed clock. Exact equality: the
queries and findings are strings and integers."""

import datetime as dt
import glob
import os

import pytest

from trivy_tpu import types as RT
from trivy_tpu.db import build_table as ref_build_table
from trivy_tpu.db.fixtures import load_fixture_files as ref_load
from trivy_tpu.detect import langpkg as ref_langpkg
from trivy_tpu.detect import ospkg as ref_ospkg
from trivy_tpu.detect.engine import BatchDetector as RefDetector
from trivy_tpu_torch import types as PT
from trivy_tpu_torch.db import build_table as port_build_table
from trivy_tpu_torch.db.fixtures import load_fixture_files as port_load
from trivy_tpu_torch.db.table import AdvisoryTable
from trivy_tpu_torch.detect import langpkg as port_langpkg
from trivy_tpu_torch.detect import ospkg as port_ospkg
from trivy_tpu_torch.detect.engine import BatchDetector as PortDetector

FIXTURES = sorted(glob.glob(
    os.path.join(os.path.dirname(__file__), "fixtures", "db", "*.yaml")))


def _table(load, build):
    advisories, details, sources = load(FIXTURES)
    return build(advisories, details,
                 aux={"Red Hat CPE": sources["Red Hat CPE"]})


@pytest.fixture(scope="module")
def detectors():
    port = PortDetector(_table(port_load, port_build_table), device="cpu")
    ref = RefDetector(_table(ref_load, ref_build_table))
    return port, ref


def _rpm(name, version, release, epoch=0, arch="x86_64", **kw):
    return dict(name=name, version=version, release=release, epoch=epoch,
                arch=arch, id=f"{name}@{version}-{release}", **kw)


def _deb(name, version, release, src="", epoch=0, **kw):
    return dict(name=name, version=version, release=release, epoch=epoch,
                src_name=src or name, src_version=version,
                src_release=release, src_epoch=epoch, arch="amd64",
                id=f"{name}@{version}-{release}", **kw)


RHEL_BUILD = {"content_sets": ["rhel-7-server-rpms",
                               "rhel-8-for-x86_64-appstream-rpms"]}

# name → (family, os name, repository, [package kwargs])
CASES = {
    "alpine": ("alpine", "3.17.3", None, [
        dict(name="musl", version="1.2.3-r4", src_name="musl",
             src_version="1.2.3-r4", id="musl@1.2.3-r4"),
        dict(name="libcrypto3", version="3.0.7-r0", src_name="openssl",
             src_version="3.0.7-r0", id="libcrypto3@3.0.7-r0"),
        dict(name="gpg-pubkey", version="1")]),
    "alpine_repo_release": ("alpine", "3.17.3", ("alpine", "3.18.2"), [
        dict(name="libssl3", version="3.1.0-r0", src_name="openssl",
             src_version="3.1.0-r0")]),
    "wolfi": ("wolfi", "20230201", None, [
        dict(name="busybox", version="1.36.0-r0")]),
    "chainguard": ("chainguard", "20230214", None, [
        dict(name="busybox", version="1.36.0-r0")]),
    "debian12": ("debian", "12.1", None, [
        _deb("libssl3", "3.0.8", "1", src="openssl"),
        _deb("libc6", "2.36", "9+deb12u1", src="glibc")]),
    "debian11": ("debian", "11.6", None, [
        _deb("bash", "5.1", "2+deb11u1"),
        _deb("libssl1.1", "1.1.1n", "0+deb11u3", src="openssl"),
        _deb("libc6", "2.31", "13+deb11u5", src="glibc")]),
    "ubuntu2204": ("ubuntu", "22.04", None, [
        _deb("libssl3", "3.0.2", "0ubuntu1.7", src="openssl")]),
    "ubuntu1804_esm": ("ubuntu", "18.04", None, [
        _deb("libssl1.1", "1.1.1", "1ubuntu2.1~18.04.20", src="openssl")]),
    "amazon2": ("amazon", "2 (Karoo)", None, [
        _rpm("curl", "7.79.1", "1.amzn2.0.1")]),
    "oracle9": ("oracle", "9.2", None, [
        _rpm("glibc", "2.34", "60.0.1.el9_2")]),
    "rocky9": ("rocky", "9.1", None, [
        _rpm("openssl-libs", "3.0.1", "43.el9_0", epoch=1),
        _rpm("openssl-libs", "3.0.1", "43.el9_0", epoch=1, arch="aarch64")]),
    "alma9": ("alma", "9.1", None, [
        _rpm("openssl-libs", "3.0.1", "43.el9_0", epoch=1)]),
    "photon4": ("photon", "4.0", None, [
        _rpm("openssl", "3.0.8", "1.ph4")]),
    "mariner2": ("cbl-mariner", "2.0.20220226", None, [
        _rpm("openssl", "1.1.1k", "17.cm2")]),
    "opensuse_leap": ("opensuse.leap", "15.4", None, [
        _rpm("libopenssl1_1", "1.1.1l", "150400.7.13.1")]),
    "sles": ("suse linux enterprise server", "15.4", None, [
        _rpm("libopenssl1_1", "1.1.1l", "150400.7.13.1")]),
    "redhat7_default_sets": ("redhat", "7.9", None, [
        _rpm("openssl-libs", "1.0.2k", "16.el7", epoch=1),
        _rpm("openssl-libs", "1.0.2k", "1.el7.remi", epoch=1)]),
    "redhat8_build_info": ("redhat", "8.4", None, [
        _rpm("openssl-libs", "1.0.2k", "16.el7", epoch=1,
             build_info=RHEL_BUILD),
        _rpm("npm", "6.14.10", "1.module+el8.3.0", epoch=1,
             modularitylabel="nodejs:12:8030020201124152102:229f0a1c",
             build_info=RHEL_BUILD),
        _rpm("openssl-libs", "1.0.2k", "16.el7", epoch=1, arch="noarch",
             build_info={"nvr": "ubi7-container-7.7-140",
                         "arch": "x86_64"})]),
    "centos7": ("centos", "7.9.2009", None, [
        _rpm("openssl-libs", "1.0.2k", "16.el7", epoch=1)]),
    "unsupported": ("fedora", "38", None, [_rpm("bash", "5.2", "1")]),
}

NOWS = {"2023": dt.datetime(2023, 1, 1, tzinfo=dt.timezone.utc),
        "2030": dt.datetime(2030, 1, 1, tzinfo=dt.timezone.utc)}


def _packages(types, specs):
    out = []
    for kw in specs:
        kw = dict(kw)
        bi = kw.pop("build_info", None)
        pkg = types.Package(**kw)
        if bi is not None:
            pkg.build_info = types.BuildInfo(**bi)
        out.append(pkg)
    return out


def _queries(qs):
    return [(q.source, q.ecosystem, q.name, q.version, q.arch,
             sorted(q.cpe_indices), q.ref.name, q.ref.arch) for q in qs]


def test_every_family_driver_is_covered():
    families = {c[0] for c in CASES.values()}
    assert set(port_ospkg.DRIVERS) == set(ref_ospkg.DRIVERS)
    assert set(port_ospkg.DRIVERS) | {"redhat", "centos"} <= families


@pytest.mark.parametrize("now", sorted(NOWS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_ospkg_matches_reference(name, now, detectors):
    family, os_name, repo, specs = CASES[name]
    port_det, ref_det = detectors
    out = []
    for types, mod, det in ((PT, port_ospkg, port_det),
                            (RT, ref_ospkg, ref_det)):
        scanner = mod.OspkgScanner(det)
        qs, finish = scanner.prepare(
            types.OS(family=family, name=os_name),
            types.Repository(*repo) if repo else None,
            _packages(types, specs), now=NOWS[now])
        if finish is None:
            out.append((_queries(qs), None))
            continue
        vulns, eosl = finish(det.detect_many([qs])[0])
        out.append((_queries(qs), (
            sorted((v.to_json() for v in vulns),
                   key=lambda j: (j["PkgName"], j["VulnerabilityID"],
                                  j["PkgIdentifier"].get("PURL", ""),
                                  j.get("FixedVersion", ""))),
            eosl)))
    assert out[0] == out[1]
    if family != "fedora":
        assert out[0][0], "no queries built"


def test_families_with_advisories_find_them(detectors):
    """The fixture DB has advisories for these cases: the comparison
    above is not vacuous for them."""
    port_det, _ = detectors
    for name in ("alpine", "debian11", "debian12", "ubuntu2204", "amazon2",
                 "oracle9", "rocky9", "photon4", "sles",
                 "redhat7_default_sets", "redhat8_build_info", "centos7"):
        family, os_name, repo, specs = CASES[name]
        qs, finish = port_ospkg.OspkgScanner(port_det).prepare(
            PT.OS(family=family, name=os_name), None,
            _packages(PT, specs), now=NOWS["2023"])
        vulns, _eosl = finish(port_det.detect_many([qs])[0])
        assert vulns, name


def test_ubuntu_esm_stream_and_modular_namespace():
    now = dt.datetime(2030, 1, 1, tzinfo=dt.timezone.utc)
    assert port_ospkg._ubuntu_stream("18.04", now) == "18.04-ESM"
    assert port_ospkg._ubuntu_stream("22.04", NOWS["2023"]) == "22.04"
    assert port_ospkg.add_modular_namespace(
        "npm", "nodejs:12:8030020201124152102:229f0a1c") == "nodejs:12::npm"
    assert port_ospkg.add_modular_namespace("npm", "bad") == "npm"


APPS = {
    "python": ("python-pkg", [("Flask", "2.2.2"), ("requests", "2.28.1"),
                              ("Some_Pkg.Name", "1.0"), ("noversion", "")]),
    "python_fixed": ("python-pkg", [("Flask", "2.3.2")]),
    "unknown_type": ("conda-pkg", [("numpy", "1.0")]),
    "npm": ("node-pkg", [("lodash", "4.17.20")]),
}


@pytest.mark.parametrize("name", sorted(APPS))
def test_langpkg_matches_reference(name, detectors):
    app_type, pkgs = APPS[name]
    port_det, ref_det = detectors
    out = []
    for types, mod, det in ((PT, port_langpkg, port_det),
                            (RT, ref_langpkg, ref_det)):
        app = types.Application(type=app_type, packages=[
            types.Package(id=f"{n}@{v}", name=n, version=v,
                          file_path=f"lib/{n}/METADATA")
            for n, v in pkgs])
        qs, finish = mod.LangpkgScanner(det).prepare_app(app)
        vulns = finish(det.detect_many([qs])[0] if qs else [])
        out.append((_queries(qs), sorted(
            (v.to_json() for v in vulns),
            key=lambda j: (j["PkgName"], j["VulnerabilityID"]))))
    assert out[0] == out[1]


def test_sources_for_prefix_and_save_round_trip(detectors, tmp_path):
    port_det, ref_det = detectors
    for prefix in ("pip::", "npm::", "alpine", "nope::"):
        assert port_det.table.sources_for_prefix(prefix) == \
            ref_det.table.sources_for_prefix(prefix)
    path = str(tmp_path / "table.npz")
    port_det.table.save(path)
    again = AdvisoryTable.load(path)
    from trivy_tpu.db.table import AdvisoryTable as RefTable
    ref = RefTable.load(path)
    assert again.sources == port_det.table.sources == ref.sources
    assert again.aux == port_det.table.aux
    det = PortDetector(again, device="cpu")
    qs, finish = port_ospkg.OspkgScanner(det).prepare(
        PT.OS(family="redhat", name="7.9"), None,
        _packages(PT, CASES["redhat7_default_sets"][3]), now=NOWS["2023"])
    assert finish(det.detect_many([qs])[0])[0]
