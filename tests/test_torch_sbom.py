"""The port's SBOM decoding and LibraryIndex held against the JAX
package's, on the CPU, with the same inputs:

- decode parity for each of the 7 SBOM documents of tests/golden/inputs
  (CycloneDX, in-toto, SPDX JSON and tag-value, a KBOM, licenses): the
  cached blob, its id and the applied ArtifactDetail equal field by
  field;
- the CycloneDX and SPDX round trips: an image's packages out through
  the encoder and back through the decoder detect the same
  vulnerabilities (the encoders' output equals the JAX encoders' in
  tests/test_torch_sbom_golden.py, through both CLIs);
- the decoder cases of tests/test_sbom.py (content addressing, the
  per-package-class version schema, lying data, the round trips and the
  hostile documents: malformed, not UTF-8, unknown format, byte, depth
  and component budgets), each a case of one parametrised test that
  runs it through both packages and compares what comes out;
- hostile containment: the same annotations and the same salted
  `partial_blob_id` as the JAX package's `SBOMArtifact(...).inspect()`,
  and a report with the same "Ingest Degradations" result;
- `LibraryIndex` against the port's NumPy oracle and against the JAX
  LibraryIndex, hit for hit.

Not mirrored here: the cases of tests/test_sbom.py for the parse
breaker and watchdog, the failpoints, the memo and redetectd, the server
route and the storm lane. The breaker, watchdog and failpoints are not
ported by design (ROADMAP, "Not ported"), the SBOMArtifact of the port
has no metrics, the memo and redetectd are still queued (ROADMAP A9),
the storm lane with A12, and tests/test_torch_server.py holds the
server's ScanSBOM route both ways."""

import json
import os
import types as pytypes

import pytest

from helpers import ALPINE_OS_RELEASE, APK_INSTALLED, make_image
import trivy_tpu.detect.libscan as ref_libscan
import trivy_tpu.fanal.applier as ref_applier
import trivy_tpu.fanal.cache as ref_cache
import trivy_tpu.report.writer as ref_writer
import trivy_tpu.sbom.artifact as ref_sbom_artifact
import trivy_tpu.sbom.cyclonedx as ref_cdx
import trivy_tpu.sbom.spdx as ref_spdx
import trivy_tpu.types as ref_types
import trivy_tpu_torch.detect.libscan as port_libscan
import trivy_tpu_torch.fanal.applier as port_applier
import trivy_tpu_torch.fanal.artifact as port_artifact
import trivy_tpu_torch.fanal.cache as port_cache
import trivy_tpu_torch.report.writer as port_writer
import trivy_tpu_torch.sbom.artifact as port_sbom_artifact
import trivy_tpu_torch.sbom.cyclonedx as port_cdx
import trivy_tpu_torch.sbom.spdx as port_spdx
import trivy_tpu_torch.types as port_types
from trivy_tpu_torch.db.table import RawAdvisory, build_table
from trivy_tpu_torch.detect.engine import BatchDetector
from trivy_tpu_torch.fanal.ingest import partial_blob_id
from trivy_tpu_torch.scanner import LocalScanner

HERE = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(HERE, "golden", "inputs")
PROP = "aquasecurity:trivy:"
FAKE_UUID = "3ff14136-e09f-4df9-80ea-%012d"
FAKE_NOW = "2021-08-25T12:20:30Z"

PORT = pytypes.SimpleNamespace(
    T=port_types, cache=port_cache, art=port_sbom_artifact, cdx=port_cdx,
    spdx=port_spdx, applier=port_applier, writer=port_writer)
REF = pytypes.SimpleNamespace(
    T=ref_types, cache=ref_cache, art=ref_sbom_artifact, cdx=ref_cdx,
    spdx=ref_spdx, applier=ref_applier, writer=ref_writer)

SBOM_INPUTS = ["centos-7-cyclonedx.json", "centos-7-cyclonedx.intoto.jsonl",
               "centos-7-spdx.json", "centos-7-spdx.txt",
               "fluentd-multiple-lockfiles-cyclonedx.json",
               "minikube-kbom.json", "license-cyclonedx.json"]


def _inspect(ns, raw, opts=None, name=""):
    """→ (artifact reference, cached blob) of one document."""
    cache = ns.cache.MemoryCache()
    o = None if opts is None else ns.art.SBOMOptions(**opts)
    ref = ns.art.SBOMArtifact(raw, cache, name=name, opts=o).inspect()
    return ref, cache.get_blob(ref.id)


@pytest.mark.parametrize("name", SBOM_INPUTS)
def test_decode_parity_on_golden_inputs(name):
    with open(os.path.join(INPUTS, name), "rb") as f:
        raw = f.read()
    got, want = (_inspect(ns, raw, name=name) for ns in (PORT, REF))
    assert (got[0].id, got[0].type, got[0].blob_ids, got[0].name) == \
        (want[0].id, want[0].type, want[0].blob_ids, want[0].name)
    assert got[1].to_json() == want[1].to_json()
    assert not got[1].ingest_errors
    d_got = PORT.applier.apply_layers([got[1]]).to_json()
    d_want = REF.applier.apply_layers([want[1]]).to_json()
    assert d_got == d_want and (d_got.get("Packages")
                                or d_got.get("Applications"))


# ---- the decoder cases of tests/test_sbom.py, through both packages ------

def comp(name, version, ptype="alpine", distro="3.17.3", **extra):
    purl = f"pkg:apk/alpine/{name}@{version}?distro={distro}"
    c = {"type": "library", "bom-ref": extra.pop("bom_ref", purl),
         "name": name, "version": version, "purl": purl,
         "properties": [
             {"name": PROP + "PkgType", "value": ptype},
             {"name": PROP + "SrcName",
              "value": extra.pop("src_name", name)},
             {"name": PROP + "SrcVersion",
              "value": extra.pop("src_version", version)}]}
    c.update(extra)
    return c


def cdx_doc(components, os_name="alpine", os_version="3.17.3"):
    return {
        "bomFormat": "CycloneDX", "specVersion": "1.5",
        "serialNumber": "urn:uuid:test-sbom", "version": 1,
        "metadata": {"component": {
            "type": "operating-system", "name": os_name,
            "version": os_version,
            "properties": [{"name": PROP + "Type", "value": os_name}]}},
        "components": components,
    }


def doc_bytes(doc):
    return json.dumps(doc, sort_keys=True).encode()


def _pkgs(detail):
    return [(p.name, p.version, p.release, p.epoch, p.src_name,
             p.src_version, p.src_release, p.src_epoch, p.arch,
             p.identifier.purl, p.id, tuple(p.licenses))
            for p in detail.packages]


def _annotated(ns, raw, opts=None):
    ref, blob = _inspect(ns, raw, opts)
    canonical = ns.cache.cache_key(ns.art.doc_digest(raw),
                                   ns.art.DECODER_VERSIONS, {})
    return {"id": ref.id, "canonical": ref.id == canonical,
            "errors": blob.ingest_errors,
            "names": [p.name for pi in blob.package_infos
                      for p in pi.packages]}


def case_digest_stable(ns):
    raw = doc_bytes(cdx_doc([comp("musl", "1.2.3-r4")]))
    return [ns.art.doc_digest(raw), ns.art.doc_digest(raw + b" ")]


def case_from_doc_key_order(ns):
    a = {"bomFormat": "CycloneDX", "specVersion": "1.5", "components": []}
    b = {"components": [], "specVersion": "1.5", "bomFormat": "CycloneDX"}
    return [ns.art.SBOMArtifact.from_doc(d, ns.cache.MemoryCache()).digest
            for d in (a, b)]


def case_duplicate_documents(ns):
    cache = ns.cache.MemoryCache()
    raw = doc_bytes(cdx_doc([comp("musl", "1.2.3-r4")]))
    r1 = ns.art.SBOMArtifact(raw, cache).inspect()
    r2 = ns.art.SBOMArtifact(raw, cache).inspect()
    blob = cache.get_blob(r1.id)
    return [r1.id, r2.id, len(cache.blobs), blob.diff_id,
            blob.ingest_errors]


def case_json_depth(ns):
    deep = {"a": 1}
    for _ in range(5000):
        deep = {"d": deep}
    return [ns.art.json_depth(deep, 50),
            ns.art.json_depth({"a": [1, {"b": 2}]}, 50)]


def case_apk_class(ns):
    d = ns.cdx.decode_cyclonedx(cdx_doc([comp("musl", "1.2.3-r4")]))
    return [_pkgs(d), d.os.family, d.os.name]


def case_rpm_class(ns):
    c = {"type": "library", "bom-ref": "r1", "name": "bash",
         "version": "1:5.1.8-6.el9",
         "purl": "pkg:rpm/centos/bash@5.1.8-6.el9?epoch=1",
         "properties": [{"name": PROP + "PkgType", "value": "centos"},
                        {"name": PROP + "SrcName", "value": "bash"},
                        {"name": PROP + "SrcVersion",
                         "value": "1:5.1.8-6.el9"}]}
    return _pkgs(ns.cdx.decode_cyclonedx(
        cdx_doc([c], os_name="centos", os_version="8")))


def case_deb_class(ns):
    c = {"type": "library", "bom-ref": "d1", "name": "libc6",
         "version": "2.31-13+deb11u5",
         "purl": "pkg:deb/debian/libc6@2.31-13%2Bdeb11u5",
         "properties": [{"name": PROP + "PkgType", "value": "debian"},
                        {"name": PROP + "PkgRelease",
                         "value": "13+deb11u5"}]}
    return _pkgs(ns.cdx.decode_cyclonedx(
        cdx_doc([c], os_name="debian", os_version="11")))


def case_duplicate_bom_refs(ns):
    return _pkgs(ns.cdx.decode_cyclonedx(cdx_doc([
        comp("musl", "1.2.3-r4", bom_ref="dup"),
        comp("musl", "9.9.9-r0", bom_ref="dup")])))


def case_lying_epoch(ns):
    c = comp("musl", "1.2.3-r4")
    c["properties"].append({"name": PROP + "SrcEpoch",
                            "value": "not-a-number"})
    return _pkgs(ns.cdx.decode_cyclonedx(cdx_doc([c])))


def case_purl_canonical(ns):
    c = comp("musl", "1.2.3-r4")
    c["purl"] = "pkg:apk/alpine/musl@1.2.3-r4?distro=3.17.3&arch=x86_64"
    return _pkgs(ns.cdx.decode_cyclonedx(cdx_doc([c])))


def _report(ns, results, os_info=None, kind="container_image"):
    return ns.writer.build_report("img", kind, results, os_info,
                                  created_at=FAKE_NOW)


def case_cdx_round_trip_properties(ns):
    T = ns.T
    pkg = T.Package(name="musl", version="1.2.3-r4", src_name="musl-src",
                    src_version="1.2.3-r4", id="musl@1.2.3-r4",
                    licenses=["MIT"])
    rep = _report(ns, [T.Result(target="img (alpine 3.17.3)",
                                clazz=T.ResultClass.OS_PKGS,
                                type="alpine", packages=[pkg])],
                  T.OS(family="alpine", name="3.17.3"))
    doc = ns.cdx.encode_cyclonedx(rep)
    return [doc, _pkgs(ns.cdx.decode_cyclonedx(doc))]


def case_spdx_round_trip_lang(ns):
    T = ns.T
    pkg = T.Package(name="flask", version="2.2.2", id="flask@2.2.2")
    rep = _report(ns, [T.Result(target="requirements.txt",
                                clazz=T.ResultClass.LANG_PKGS, type="pip",
                                packages=[pkg])], kind="filesystem")
    doc = ns.spdx.encode_spdx(rep)
    d = ns.spdx.decode_spdx(doc)
    return [doc, [(p.name, p.version) for a in d.applications
                  for p in a.packages]]


def case_malformed(ns):
    return [_annotated(ns, raw) for raw in (
        b"not json at all {", b"\xff\xfe garbage bytes", b"[1, 2, 3]",
        b'{"bomFormat": "CycloneDX"')]


def case_partial_deterministic(ns):
    return [_annotated(ns, b"not json at all {")["id"] for _ in range(2)]


def case_unknown_format(ns):
    return [_annotated(ns, b'{"hello": "world"}'),
            _annotated(ns, json.dumps({"payloadType": "x/y",
                                       "payload": ""}).encode())]


def case_byte_budget(ns):
    raw = doc_bytes(cdx_doc([comp("musl", "1.2.3-r4")]))
    return _annotated(ns, raw, {"max_doc_bytes": 64})


def case_depth_bomb(ns):
    inner: dict = {"x": 1}
    for _ in range(64):
        inner = {"n": inner}
    doc = cdx_doc([])
    doc["metadata"]["deep"] = inner
    return _annotated(ns, doc_bytes(doc), {"max_depth": 16})


def case_component_bomb(ns):
    comps = [comp(f"p{i}", "1.0.0-r0", bom_ref=f"#{i}") for i in range(40)]
    return _annotated(ns, doc_bytes(cdx_doc(comps)),
                      {"max_components": 8})


def case_lying_component_shapes(ns):
    return _annotated(ns, doc_bytes(cdx_doc([42, "nope",
                                             comp("musl", "1.2.3-r4")])))


DECODER_CASES = {
    "digest_stable": (case_digest_stable,
                      lambda r: r[0] != r[1] and r[0].startswith("sha256:")),
    "from_doc_key_order": (case_from_doc_key_order,
                           lambda r: r[0] == r[1]),
    "duplicate_documents_share_one_blob": (
        case_duplicate_documents,
        lambda r: r[0] == r[1] and r[2] == 1 and not r[4]),
    "json_depth_iterative": (case_json_depth,
                             lambda r: r[0] > 50 and r[1] == 4),
    "apk_class_keeps_joined_version": (
        case_apk_class,
        lambda r: r[0][0][1:4] == ("1.2.3-r4", "", 0)
        and r[1:] == ["alpine", "3.17.3"]),
    "rpm_class_splits_epoch_version_release": (
        case_rpm_class,
        lambda r: r[0][1:4] == ("5.1.8", "6.el9", 1)
        and r[0][5:8] == ("5.1.8", "6.el9", 1)),
    "deb_class_respects_pkg_release": (
        case_deb_class, lambda r: r[0][1:3] == ("2.31", "13+deb11u5")),
    "duplicate_bom_refs_decode_once": (
        case_duplicate_bom_refs,
        lambda r: len(r) == 1 and r[0][1] == "1.2.3-r4"),
    "lying_epoch_degrades_to_zero": (case_lying_epoch,
                                     lambda r: r[0][7] == 0),
    "purl_qualifiers_canonicalized": (
        case_purl_canonical,
        lambda r: r[0][9].endswith("?arch=x86_64&distro=3.17.3")
        and r[0][8] == "x86_64"),
    "cyclonedx_round_trip_properties": (
        case_cdx_round_trip_properties,
        lambda r: r[1][0][4] == "musl-src" and r[1][0][10:] ==
        ("musl@1.2.3-r4", ("MIT",))),
    "spdx_round_trip_lang_packages": (
        case_spdx_round_trip_lang, lambda r: r[1] == [("flask", "2.2.2")]),
    "malformed_is_annotated_partial": (
        case_malformed,
        lambda r: [a["errors"][0]["Kind"] for a in r] ==
        ["malformed", "encoding", "malformed", "malformed"]
        and not any(a["canonical"] for a in r)),
    "partial_id_deterministic": (case_partial_deterministic,
                                 lambda r: r[0] == r[1]),
    "unknown_format_annotated": (
        case_unknown_format,
        lambda r: all(a["errors"][0]["Kind"] == "format" for a in r)),
    "byte_budget_trips": (
        case_byte_budget,
        lambda r: r["errors"][0]["Kind"] == "budget.doc_bytes"),
    "depth_bomb_trips_budget": (
        case_depth_bomb, lambda r: r["errors"][0]["Kind"] == "budget.depth"),
    "component_bomb_clamps_to_prefix": (
        case_component_bomb,
        lambda r: r["errors"][0]["Kind"] == "budget.components"
        and r["names"] == [f"p{i}" for i in range(8)]),
    "lying_component_shapes_contained": (
        case_lying_component_shapes, lambda r: r["id"].startswith("sha256:")),
}


@pytest.mark.parametrize("name", list(DECODER_CASES))
def test_decoder_case_parity(name, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_UUID", FAKE_UUID)
    case, holds = DECODER_CASES[name]
    got, want = case(PORT), case(REF)
    assert got == want
    assert holds(got)


# ---- hostile containment through the CLI report -------------------------

@pytest.mark.parametrize("raw,kind", [
    (b"not json {", "malformed"), (b"\xff\xfe", "encoding"),
    (b'{"bomFormat": "CycloneDX", "components": "x"}', "decode_error"),
    (b'{"spdxVersion": "SPDX-2.3", "packages": [{"SPDXID": '
     b'"SPDXRef-Package-1", "externalRefs": [{"referenceType": "purl", '
     b'"referenceLocator": "pkg:"}]}]}', None)],
    ids=["malformed", "encoding", "lying-components", "lying-purl"])
def test_hostile_document_report_equals_reference(raw, kind, tmp_path,
                                                  monkeypatch):
    """The "Ingest Degradations" result and the salted id: the JSON
    reports of both CLIs are equal byte for byte."""
    from test_torch_license import run_both
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", FAKE_NOW)
    doc = tmp_path / "doc.json"
    doc.write_bytes(raw)
    db = os.path.join(HERE, "fixtures", "db", "*.yaml")
    port, ref = run_both(["sbom", str(doc), "--db", db], tmp_path)
    assert port == ref
    got = json.loads(port)
    ing = [r for r in got.get("Results", []) if r.get("Class") == "ingest"]
    got_ref, _ = _inspect(PORT, raw)
    want_ref, _ = _inspect(REF, raw)
    assert got_ref.id == want_ref.id
    assert [e["Kind"] for r in ing for e in r["IngestErrors"]] == \
        ([kind] if kind else [])
    if ing:
        assert ing[0]["Target"] == "Ingest Degradations"
        errors = ing[0]["IngestErrors"]
        assert got_ref.id == partial_blob_id(
            PORT.cache.cache_key(PORT.art.doc_digest(raw),
                                 PORT.art.DECODER_VERSIONS, {}), errors)


# ---- round trips through the scanner --------------------------------------

@pytest.fixture(scope="module")
def apk_table():
    """Advisories on the APK_INSTALLED fixture packages, so the archive
    path and the SBOM path detect the same planted CVEs."""
    raw, details = [], {}
    for name, fixed in (("musl", "1.2.4-r0"), ("zlib", "1.2.14-r0"),
                        ("libcrypto3", "3.0.8-r0")):
        vid = f"CVE-2026-{name.upper()}"
        raw.append(RawAdvisory(source="alpine 3.17", ecosystem="alpine",
                               pkg_name=name, vuln_id=vid,
                               fixed_version=fixed))
        details[vid] = {"Title": f"planted {vid}", "Severity": "HIGH"}
    return build_table(raw, details)


def _vuln_keys(results):
    return {(v.vulnerability_id, v.pkg_name, v.installed_version,
             v.fixed_version)
            for r in results for v in r.vulnerabilities}


def test_archive_and_sbom_paths_detect_identically(tmp_path, apk_table,
                                                   monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_FAKE_UUID", FAKE_UUID)
    img = str(tmp_path / "img.tar")
    make_image(img, [{"etc/os-release": ALPINE_OS_RELEASE,
                      "lib/apk/db/installed": APK_INSTALLED}])
    T = port_types
    cache = port_cache.MemoryCache()
    ref = port_artifact.ImageArchiveArtifact(img, cache).inspect()
    scanner = LocalScanner(cache, apk_table, device="cpu")
    opts = T.ScanOptions(scanners=("vuln",), list_all_packages=True)
    want, os_want = scanner.scan(ref.name, ref.id, ref.blob_ids, opts)
    assert _vuln_keys(want)
    report = port_writer.build_report(ref.name, "container_image", want,
                                      os_want, created_at=FAKE_NOW)
    doc = port_cdx.encode_cyclonedx(report)
    assert doc["components"] and doc["vulnerabilities"]
    sb = port_sbom_artifact.SBOMArtifact(doc_bytes(doc), cache).inspect()
    got, os_got = scanner.scan(sb.name, sb.id, sb.blob_ids,
                               T.ScanOptions(scanners=("vuln",)))
    assert (os_got.family, os_got.name) == (os_want.family, os_want.name)
    assert _vuln_keys(got) == _vuln_keys(want)
    # SPDX keeps the packages (its encoder writes no OS package, in
    # both packages, so the OS is lost on that route)
    detail = port_spdx.decode_spdx(port_spdx.encode_spdx(report))
    assert sorted((p.name, p.version) for p in detail.packages) == \
        sorted((p.name, p.version) for r in want for p in r.packages)


# ---- LibraryIndex ---------------------------------------------------------

def lib_corpus(mod, n_libs=40, n_vers=4):
    return [mod.LibraryFingerprint(
        corpus="test-corpus", library=f"lib{li:03d}",
        version=f"{vi}.{li % 7}.{(li * vi) % 5}", token=f"tok-{li:03d}-{vi}")
        for li in range(n_libs) for vi in range(n_vers)]


def _observations(mod, fps):
    obs = []
    for k, f in enumerate(fps[:120]):
        ver = (f.version, "9.9.9", f"{f.version}.junk")[k % 3]
        obs.append(mod.LibraryObservation(f.corpus, f.token, ver, ref=k))
    obs.append(mod.LibraryObservation("test-corpus", "tok-000-0", "",
                                      ref=-1))
    return obs


def test_library_index_build_and_digest_equal_reference():
    fps = lib_corpus(port_libscan)
    a = port_libscan.LibraryIndex.build(fps)
    b = port_libscan.LibraryIndex.build(list(reversed(fps)) + fps[:5])
    want = ref_libscan.LibraryIndex.build(lib_corpus(ref_libscan))
    assert a.content_digest() == b.content_digest() == \
        want.content_digest()
    assert a.content_digest() != a.table.content_digest()
    assert a.corpora() == want.corpora() == ["test-corpus"]
    qs = a.queries(_observations(port_libscan, fps))
    assert len(qs) == 120 and all(q.version for q in qs)


def test_library_index_detect_matches_oracle_and_reference():
    fps = lib_corpus(port_libscan)
    idx = port_libscan.LibraryIndex.build(fps)
    obs = _observations(port_libscan, fps)
    got = idx.detect(BatchDetector(idx.table, device="cpu"), obs)
    want = idx.oracle(obs)
    assert got == want
    honest = [o for o in obs if o.ref >= 0 and o.ref % 3 == 0]
    assert honest and all(o in want for o in honest)
    assert all(o not in want for o in obs if o.ref % 3)

    from trivy_tpu.detect.engine import BatchDetector as RefDetector
    r_idx = ref_libscan.LibraryIndex.build(lib_corpus(ref_libscan))
    r_obs = _observations(ref_libscan, lib_corpus(ref_libscan))
    det = RefDetector(r_idx.table)
    try:
        r_got = r_idx.detect(det, r_obs)
    finally:
        det.close()
    assert {o.ref: v for o, v in got.items()} == \
        {o.ref: v for o, v in r_got.items()}


def test_third_party_document_keeps_last_application_like_reference(
        monkeypatch):
    """A syft-style document (purls and licenses, no trivy properties,
    no file paths): every ecosystem decodes to an application at path
    "", and the applier keeps one application per path, the last. The
    port copies this from the JAX package (ROADMAP C); chip_smoke's sbom
    phase orders npm last for it."""
    import numpy as np

    import chip_smoke
    monkeypatch.setattr(chip_smoke, "SBOM_COMPONENTS", tuple(
        (p, e, max(n // 250, 2)) for p, e, n in chip_smoke.SBOM_COMPONENTS))
    deb = [f"src{i:05d}" for i in range(50)]
    names = {eco: chip_smoke.app_names(eco, 50)
             for eco, _n, _label in chip_smoke.APP_ECOSYSTEMS}
    raw = json.dumps(chip_smoke.third_party_sbom(
        np.random.default_rng(7), deb, names)).encode()
    got, want = (_inspect(ns, raw) for ns in (PORT, REF))
    assert got[0].id == want[0].id
    assert got[1].to_json() == want[1].to_json()
    assert len(got[1].applications) == 8
    detail = PORT.applier.apply_layers([got[1]])
    assert detail.to_json() == REF.applier.apply_layers([want[1]]).to_json()
    assert [a.type for a in detail.applications] == ["node-pkg"]
    assert len(detail.packages) == 8 and detail.os.family == "debian"
