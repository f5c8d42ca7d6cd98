"""The port's Twirp binary codec (trivy_tpu_torch/server/protowire.py):
the mirror of tests/test_protowire.py's codec cases, each message
encoding to the very bytes the JAX package's encoder writes, and each
side decoding the other's bytes; and the results converter
(server/convert.py) giving the JAX one's ScanResponse on the same
results."""

import pytest

from trivy_tpu.server import convert as ref_convert
from trivy_tpu.server import protowire as ref_pw
from trivy_tpu_torch.server import convert
from trivy_tpu_torch.server.protowire import decode_msg, encode_msg

MESSAGES = [
    ("OS", {"family": "alpine", "name": "3.17.3", "eosl": True}),
    ("ScanRequest", {
        "target": "img:latest", "artifact_id": "sha256:a",
        "blob_ids": ["sha256:b1", "sha256:b2"],
        "options": {"scanners": ["vuln", "secret"],
                    "list_all_packages": True}}),
    ("Vulnerability", {
        "vulnerability_id": "CVE-2023-0286", "severity": 4,
        "cvss": {"nvd": {"v3_vector": "AV:N", "v3_score": 9.8}},
        "vendor_severity": {"nvd": 3}}),
    ("CustomResource", {"type": "custom", "file_path": "f",
                        "data": {"k": [1, "two", True, None]}}),
    ("BlobInfo", {
        "schema_version": 2, "os": {"family": "alpine", "name": "3.17.3"},
        "diff_id": "sha256:x",
        "package_infos": [{
            "file_path": "lib/apk/db/installed",
            "packages": [{"name": "musl", "version": "1.2.3-r4",
                          "src_name": "musl"}]}],
        "opaque_dirs": ["a/", "b/"]}),
    ("PutBlobRequest", {"diff_id": "sha256:y", "blob_info": {
        "schema_version": 2, "diff_id": "sha256:y",
        "applications": [{"type": "npm", "file_path": "package-lock.json",
                          "libraries": [{"name": "lodash",
                                        "version": "4.17.20"}]}]}}),
    ("MissingBlobsRequest", {"artifact_id": "sha256:a",
                             "blob_ids": ["sha256:b"]}),
    ("MissingBlobsResponse", {"missing_artifact": True,
                              "missing_blob_ids": ["sha256:b"]}),
    ("ScanSBOMRequest", {"target": "bom.json", "artifact_id": "sha256:c",
                         "kind": "cyclonedx", "document": b"{}"}),
]


class TestCodec:
    def test_scalar_roundtrip(self):
        msg = {"family": "alpine", "name": "3.17.3", "eosl": True}
        assert decode_msg(encode_msg(msg, "OS"), "OS") == msg

    def test_nested_and_repeated(self):
        desc, msg = MESSAGES[1]
        assert decode_msg(encode_msg(msg, desc), desc) == msg

    def test_map_and_enum(self):
        out = decode_msg(encode_msg(MESSAGES[2][1], "Vulnerability"),
                         "Vulnerability")
        assert out["severity"] == 4
        assert out["cvss"]["nvd"]["v3_score"] == 9.8
        assert out["vendor_severity"] == {"nvd": 3}

    def test_timestamp_and_value(self):
        out = decode_msg(encode_msg(MESSAGES[3][1], "CustomResource"),
                         "CustomResource")
        assert out["data"] == {"k": [1.0, "two", True, None]}

    def test_unknown_fields_skipped(self):
        data = encode_msg({"name": "musl", "version": "1.2"}, "Package")
        assert decode_msg(data, "OS").get("family", "") in ("", "musl")

    def test_blob_info_roundtrip(self):
        desc, msg = MESSAGES[4]
        assert decode_msg(encode_msg(msg, desc), desc) == msg


@pytest.mark.parametrize("desc,msg", MESSAGES,
                         ids=[d for d, _ in MESSAGES])
def test_same_bytes_as_reference(desc, msg):
    data = encode_msg(msg, desc)
    assert data == ref_pw.encode_msg(msg, desc)
    assert decode_msg(data, desc) == ref_pw.decode_msg(data, desc)


def test_descriptor_tables_equal_reference():
    """Every message's field table (numbers, kinds, nesting) is the JAX
    package's."""
    from trivy_tpu_torch.server import protowire as pw
    assert set(pw.REGISTRY) == set(ref_pw.REGISTRY)
    for name, fields in pw.REGISTRY.items():
        assert repr(fields) == repr(ref_pw.REGISTRY[name]), name


def test_results_to_proto_equal_reference():
    """A scan's results (an alpine image's vulnerability)
    convert to the JAX converter's ScanResponse bytes, and a proto
    BlobInfo converts back to its Go-JSON shape alike."""
    from trivy_tpu import types as RT
    from trivy_tpu_torch import types as T

    def results(mod):
        v = mod.DetectedVulnerability(
            vulnerability_id="CVE-2023-0286", pkg_name="libssl3",
            installed_version="3.0.7-r0", fixed_version="3.0.8-r0")
        v.vulnerability.severity = "HIGH"
        v.vulnerability.title = "X.400 address type confusion"
        return [mod.Result(target="img (alpine 3.17.3)", clazz="os-pkgs",
                           type="alpine", vulnerabilities=[v])]
    got = encode_msg(convert.results_to_proto(
        results(T), T.OS(family="alpine", name="3.17.3")), "ScanResponse")
    want = ref_pw.encode_msg(ref_convert.results_to_proto(
        results(RT), RT.OS(family="alpine", name="3.17.3")),
        "ScanResponse")
    assert got == want
    blob = MESSAGES[4][1]
    assert convert.proto_blob_to_json(blob) == \
        ref_convert.proto_blob_to_json(blob)
