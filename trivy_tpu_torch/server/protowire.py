"""Handwritten protobuf (proto3) wire codec for the Twirp services.

The reference serves Twirp in both JSON and application/protobuf; the
binary encoding is what the Go client sends by default
(rpc/scanner/service.twirp.go). protoc isn't available at runtime here,
so messages are described by hand-maintained field tables mirroring
rpc/common/service.proto, rpc/scanner/service.proto and
rpc/cache/service.proto (field numbers in comments there).

Supported kinds: string, bytes, bool, int32, int64, double, float,
enum, msg (nested), map (string keys), value (google.protobuf.Value),
timestamp (google.protobuf.Timestamp ↔ RFC3339 string). Repeated
fields decode from both packed and unpacked encodings.

Python-side representation: plain dicts keyed by proto field name.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass(frozen=True)
class F:
    name: str
    kind: str
    sub: object = None       # message descriptor name / map value spec
    repeated: bool = False


# ---- varint helpers ---------------------------------------------------

def _enc_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ---- encode -----------------------------------------------------------

def _tag(num: int, wt: int) -> bytes:
    return _enc_varint((num << 3) | wt)


def _enc_field(num: int, f: F, value, registry) -> bytes:
    if value is None:
        return b""
    if f.kind == "map":
        out = bytearray()
        vspec: F = f.sub
        for k, v in (value or {}).items():
            entry = _enc_field(1, F("key", "string"), str(k), registry) \
                + _enc_field(2, vspec, v, registry)
            out += _tag(num, 2) + _enc_varint(len(entry)) + entry
        return bytes(out)
    if f.repeated:
        out = bytearray()
        item = F(f.name, f.kind, f.sub)
        for v in (value or []):
            out += _enc_field(num, item, v, registry)
        return bytes(out)
    if f.kind == "string":
        if value == "":
            return b""
        b = str(value).encode()
        return _tag(num, 2) + _enc_varint(len(b)) + b
    if f.kind == "bytes":
        if not value:
            return b""
        return _tag(num, 2) + _enc_varint(len(value)) + value
    if f.kind == "bool":
        if not value:
            return b""
        return _tag(num, 0) + _enc_varint(1)
    if f.kind in ("int32", "int64", "enum"):
        v = int(value)
        if v == 0:
            return b""
        return _tag(num, 0) + _enc_varint(v)
    if f.kind == "double":
        if value == 0:
            return b""
        return _tag(num, 1) + struct.pack("<d", float(value))
    if f.kind == "float":
        if value == 0:
            return b""
        return _tag(num, 5) + struct.pack("<f", float(value))
    if f.kind == "msg":
        body = encode(value or {}, f.sub, registry)
        return _tag(num, 2) + _enc_varint(len(body)) + body
    if f.kind == "timestamp":
        body = _enc_timestamp(value)
        if not body:
            return b""
        return _tag(num, 2) + _enc_varint(len(body)) + body
    if f.kind == "value":
        body = _enc_value(value)
        return _tag(num, 2) + _enc_varint(len(body)) + body
    raise ValueError(f"unknown kind {f.kind}")


def encode(msg: dict, desc_name: str, registry) -> bytes:
    desc = registry[desc_name]
    out = bytearray()
    for num in sorted(desc):
        f = desc[num]
        if f.name in msg:
            out += _enc_field(num, f, msg[f.name], registry)
    return bytes(out)


def _enc_timestamp(value) -> bytes:
    """RFC3339 string (or epoch seconds) → Timestamp body."""
    if not value:
        return b""
    import datetime as dt
    if isinstance(value, (int, float)):
        secs, nanos = int(value), int((value % 1) * 1e9)
    else:
        try:
            d = dt.datetime.fromisoformat(
                str(value).replace("Z", "+00:00"))
        except ValueError:
            return b""
        secs = int(d.timestamp())
        nanos = d.microsecond * 1000
    out = b""
    if secs:
        out += _tag(1, 0) + _enc_varint(secs)
    if nanos:
        out += _tag(2, 0) + _enc_varint(nanos)
    return out


def _enc_value(v) -> bytes:
    # google.protobuf.Value oneof
    if v is None:
        return _tag(1, 0) + _enc_varint(0)
    if isinstance(v, bool):
        return _tag(4, 0) + _enc_varint(1 if v else 0)
    if isinstance(v, (int, float)):
        return _tag(2, 1) + struct.pack("<d", float(v))
    if isinstance(v, str):
        b = v.encode()
        return _tag(3, 2) + _enc_varint(len(b)) + b
    if isinstance(v, dict):
        fields = bytearray()
        for k, sub in v.items():
            kb = str(k).encode()
            subb = _enc_value(sub)
            entry = _tag(1, 2) + _enc_varint(len(kb)) + kb + \
                _tag(2, 2) + _enc_varint(len(subb)) + subb
            fields += _tag(1, 2) + _enc_varint(len(entry)) + entry
        body = bytes(fields)
        return _tag(5, 2) + _enc_varint(len(body)) + body
    if isinstance(v, list):
        items = bytearray()
        for sub in v:
            subb = _enc_value(sub)
            items += _tag(1, 2) + _enc_varint(len(subb)) + subb
        body = bytes(items)
        return _tag(6, 2) + _enc_varint(len(body)) + body
    return _enc_value(str(v))


# ---- decode -----------------------------------------------------------

def decode(data: bytes, desc_name: str, registry) -> dict:
    desc = registry[desc_name]
    out: dict = {}
    i = 0
    n = len(data)
    while i < n:
        key, i = _dec_varint(data, i)
        num, wt = key >> 3, key & 7
        f = desc.get(num)
        raw, i = _dec_wire(data, i, wt)
        if f is None:
            continue
        _merge_field(out, f, raw, wt, registry)
    return out


def _dec_wire(data, i, wt):
    if wt == 0:
        return _dec_varint(data, i)
    if wt == 1:
        return data[i:i + 8], i + 8
    if wt == 2:
        ln, i = _dec_varint(data, i)
        return data[i:i + ln], i + ln
    if wt == 5:
        return data[i:i + 4], i + 4
    raise ValueError(f"unsupported wire type {wt}")


def _scalar(f: F, raw, wt, registry):
    if f.kind == "string":
        return raw.decode("utf-8", "replace") if isinstance(raw, bytes) \
            else str(raw)
    if f.kind == "bytes":
        return raw
    if f.kind == "bool":
        return bool(raw)
    if f.kind in ("int32", "int64"):
        return _to_signed64(raw) if isinstance(raw, int) else 0
    if f.kind == "enum":
        return int(raw)
    if f.kind == "double":
        return struct.unpack("<d", raw)[0]
    if f.kind == "float":
        return struct.unpack("<f", raw)[0]
    if f.kind == "msg":
        return decode(raw, f.sub, registry)
    if f.kind == "timestamp":
        return _dec_timestamp(raw)
    if f.kind == "value":
        return _dec_value(raw)
    raise ValueError(f"unknown kind {f.kind}")


def _merge_field(out, f: F, raw, wt, registry):
    if f.kind == "map":
        vspec: F = f.sub
        entry = raw
        k = ""
        v = None
        i = 0
        while i < len(entry):
            key, i = _dec_varint(entry, i)
            num, ewt = key >> 3, key & 7
            rawv, i = _dec_wire(entry, i, ewt)
            if num == 1:
                k = rawv.decode("utf-8", "replace")
            elif num == 2:
                v = _scalar(vspec, rawv, ewt, registry)
        out.setdefault(f.name, {})[k] = v
        return
    if f.repeated:
        lst = out.setdefault(f.name, [])
        if wt == 2 and f.kind in ("int32", "int64", "bool", "enum",
                                  "double", "float"):
            # packed
            i = 0
            while i < len(raw):
                if f.kind in ("double",):
                    lst.append(struct.unpack("<d", raw[i:i + 8])[0])
                    i += 8
                elif f.kind == "float":
                    lst.append(struct.unpack("<f", raw[i:i + 4])[0])
                    i += 4
                else:
                    v, i = _dec_varint(raw, i)
                    lst.append(_scalar(f, v, 0, registry))
            return
        lst.append(_scalar(f, raw, wt, registry))
        return
    out[f.name] = _scalar(f, raw, wt, registry)


def _dec_timestamp(raw: bytes):
    import datetime as dt
    secs = 0
    nanos = 0
    i = 0
    while i < len(raw):
        key, i = _dec_varint(raw, i)
        num, wt = key >> 3, key & 7
        v, i = _dec_wire(raw, i, wt)
        if num == 1:
            secs = _to_signed64(v)
        elif num == 2:
            nanos = v
    if not secs and not nanos:
        return ""
    d = dt.datetime.fromtimestamp(secs, dt.timezone.utc).replace(
        microsecond=nanos // 1000)
    return d.isoformat().replace("+00:00", "Z")


def _dec_value(raw: bytes):
    i = 0
    result = None
    while i < len(raw):
        key, i = _dec_varint(raw, i)
        num, wt = key >> 3, key & 7
        v, i = _dec_wire(raw, i, wt)
        if num == 1:        # null_value
            result = None
        elif num == 2:
            result = struct.unpack("<d", v)[0]
        elif num == 3:
            result = v.decode("utf-8", "replace")
        elif num == 4:
            result = bool(v)
        elif num == 5:      # struct
            result = _dec_struct(v)
        elif num == 6:      # list
            result = _dec_listvalue(v)
    return result


def _dec_struct(raw: bytes) -> dict:
    out = {}
    i = 0
    while i < len(raw):
        key, i = _dec_varint(raw, i)
        num, wt = key >> 3, key & 7
        v, i = _dec_wire(raw, i, wt)
        if num != 1:
            continue
        # v is a map entry
        k = ""
        val = None
        j = 0
        while j < len(v):
            ekey, j = _dec_varint(v, j)
            enum_, ewt = ekey >> 3, ekey & 7
            ev, j = _dec_wire(v, j, ewt)
            if enum_ == 1:
                k = ev.decode("utf-8", "replace")
            elif enum_ == 2:
                val = _dec_value(ev)
        out[k] = val
    return out


def _dec_listvalue(raw: bytes) -> list:
    out = []
    i = 0
    while i < len(raw):
        key, i = _dec_varint(raw, i)
        num, wt = key >> 3, key & 7
        v, i = _dec_wire(raw, i, wt)
        if num == 1:
            out.append(_dec_value(v))
    return out


# ---- descriptors (rpc/common + rpc/scanner + rpc/cache) ---------------

def _m(name, sub=None, repeated=False):
    return F(name, "msg", sub, repeated)


REGISTRY: dict[str, dict[int, F]] = {
    # rpc/common/service.proto
    "OS": {1: F("family", "string"), 2: F("name", "string"),
           3: F("eosl", "bool"), 4: F("extended", "bool")},
    "Repository": {1: F("family", "string"), 2: F("release", "string")},
    "PackageInfo": {1: F("file_path", "string"),
                    2: _m("packages", "Package", True)},
    "Application": {1: F("type", "string"), 2: F("file_path", "string"),
                    3: _m("libraries", "Package", True)},
    "Package": {
        13: F("id", "string"), 1: F("name", "string"),
        2: F("version", "string"), 3: F("release", "string"),
        4: F("epoch", "int32"), 19: _m("identifier", "PkgIdentifier"),
        5: F("arch", "string"), 6: F("src_name", "string"),
        7: F("src_version", "string"), 8: F("src_release", "string"),
        9: F("src_epoch", "int32"),
        15: F("licenses", "string", repeated=True),
        20: _m("locations", "Location", True),
        11: _m("layer", "Layer"), 12: F("file_path", "string"),
        14: F("depends_on", "string", repeated=True),
        16: F("digest", "string"), 17: F("dev", "bool"),
        18: F("indirect", "bool"),
    },
    "PkgIdentifier": {1: F("purl", "string"), 2: F("bom_ref", "string")},
    "Location": {1: F("start_line", "int32"), 2: F("end_line", "int32")},
    "Misconfiguration": {
        1: F("file_type", "string"), 2: F("file_path", "string"),
        3: _m("successes", "MisconfResult", True),
        4: _m("warnings", "MisconfResult", True),
        5: _m("failures", "MisconfResult", True),
        6: _m("exceptions", "MisconfResult", True),
    },
    "MisconfResult": {
        1: F("namespace", "string"), 2: F("message", "string"),
        7: _m("policy_metadata", "PolicyMetadata"),
        8: _m("cause_metadata", "CauseMetadata"),
    },
    "PolicyMetadata": {
        1: F("id", "string"), 2: F("adv_id", "string"),
        3: F("type", "string"), 4: F("title", "string"),
        5: F("description", "string"), 6: F("severity", "string"),
        7: F("recommended_actions", "string"),
        8: F("references", "string", repeated=True),
    },
    "DetectedMisconfiguration": {
        1: F("type", "string"), 2: F("id", "string"),
        3: F("title", "string"), 4: F("description", "string"),
        5: F("message", "string"), 6: F("namespace", "string"),
        7: F("resolution", "string"), 8: F("severity", "enum"),
        9: F("primary_url", "string"),
        10: F("references", "string", repeated=True),
        11: F("status", "string"), 12: _m("layer", "Layer"),
        13: _m("cause_metadata", "CauseMetadata"),
        14: F("avd_id", "string"), 15: F("query", "string"),
    },
    "Vulnerability": {
        1: F("vulnerability_id", "string"), 2: F("pkg_name", "string"),
        3: F("installed_version", "string"),
        4: F("fixed_version", "string"), 5: F("title", "string"),
        6: F("description", "string"), 7: F("severity", "enum"),
        8: F("references", "string", repeated=True),
        25: _m("pkg_identifier", "PkgIdentifier"),
        10: _m("layer", "Layer"), 11: F("severity_source", "string"),
        12: F("cvss", "map", F("v", "msg", "CVSS")),
        13: F("cwe_ids", "string", repeated=True),
        14: F("primary_url", "string"),
        15: F("published_date", "timestamp"),
        16: F("last_modified_date", "timestamp"),
        17: F("custom_advisory_data", "value"),
        18: F("custom_vuln_data", "value"),
        19: F("vendor_ids", "string", repeated=True),
        20: _m("data_source", "DataSource"),
        21: F("vendor_severity", "map", F("v", "enum")),
        22: F("pkg_path", "string"), 23: F("pkg_id", "string"),
        24: F("status", "int32"),
    },
    "DataSource": {1: F("id", "string"), 2: F("name", "string"),
                   3: F("url", "string")},
    "Layer": {1: F("digest", "string"), 2: F("diff_id", "string"),
              3: F("created_by", "string")},
    "CauseMetadata": {
        1: F("resource", "string"), 2: F("provider", "string"),
        3: F("service", "string"), 4: F("start_line", "int32"),
        5: F("end_line", "int32"), 6: _m("code", "Code"),
    },
    "CVSS": {1: F("v2_vector", "string"), 2: F("v3_vector", "string"),
             3: F("v2_score", "double"), 4: F("v3_score", "double")},
    "CustomResource": {1: F("type", "string"),
                       2: F("file_path", "string"),
                       3: _m("layer", "Layer"), 4: F("data", "value")},
    "Line": {
        1: F("number", "int32"), 2: F("content", "string"),
        3: F("is_cause", "bool"), 4: F("annotation", "string"),
        5: F("truncated", "bool"), 6: F("highlighted", "string"),
        7: F("first_cause", "bool"), 8: F("last_cause", "bool"),
    },
    "Code": {1: _m("lines", "Line", True)},
    "SecretFinding": {
        1: F("rule_id", "string"), 2: F("category", "string"),
        3: F("severity", "string"), 4: F("title", "string"),
        5: F("start_line", "int32"), 6: F("end_line", "int32"),
        7: _m("code", "Code"), 8: F("match", "string"),
        10: _m("layer", "Layer"),
    },
    "Secret": {1: F("filepath", "string"),
               2: _m("findings", "SecretFinding", True)},
    "DetectedLicense": {
        1: F("severity", "enum"), 2: F("category", "enum"),
        3: F("pkg_name", "string"), 4: F("file_path", "string"),
        5: F("name", "string"), 6: F("confidence", "float"),
        7: F("link", "string"),
    },
    "LicenseFile": {
        1: F("license_type", "enum"), 2: F("file_path", "string"),
        3: F("pkg_name", "string"),
        4: _m("fingings", "LicenseFinding", True),
        5: _m("layer", "Layer"),
    },
    "LicenseFinding": {
        1: F("category", "enum"), 2: F("name", "string"),
        3: F("confidence", "float"), 4: F("link", "string"),
    },

    # rpc/scanner/service.proto
    "ScanRequest": {
        1: F("target", "string"), 2: F("artifact_id", "string"),
        3: F("blob_ids", "string", repeated=True),
        4: _m("options", "ScanOptions"),
    },
    "Licenses": {1: F("names", "string", repeated=True)},
    "ScanOptions": {
        1: F("vuln_type", "string", repeated=True),
        2: F("scanners", "string", repeated=True),
        3: F("list_all_packages", "bool"),
        4: F("license_categories", "map", F("v", "msg", "Licenses")),
        5: F("include_dev_deps", "bool"),
    },
    # graftbom SBOM ingress (repo extension — no reference .proto):
    # the raw document bytes travel in-band; artifact_id carries the
    # client-stamped document digest so the fleet router's affinity
    # lands duplicate documents on the same replica's memo, and kind
    # carries the client's format sniff ("cyclonedx"/"spdx"/"")
    "ScanSBOMRequest": {
        1: F("target", "string"), 2: F("artifact_id", "string"),
        3: F("kind", "string"), 4: F("document", "bytes"),
        5: _m("options", "ScanOptions"),
    },
    "ScanResponse": {1: _m("os", "OS"),
                     3: _m("results", "ScanResult", True)},
    "ScanResult": {
        1: F("target", "string"),
        2: _m("vulnerabilities", "Vulnerability", True),
        4: _m("misconfigurations", "DetectedMisconfiguration", True),
        6: F("class", "string"), 3: F("type", "string"),
        5: _m("packages", "Package", True),
        7: _m("custom_resources", "CustomResource", True),
        8: _m("secrets", "SecretFinding", True),
        9: _m("licenses", "DetectedLicense", True),
    },

    # rpc/cache/service.proto
    "ArtifactInfo": {
        1: F("schema_version", "int32"), 2: F("architecture", "string"),
        3: F("created", "timestamp"), 4: F("docker_version", "string"),
        5: F("os", "string"),
        6: _m("history_packages", "Package", True),
    },
    "PutArtifactRequest": {1: F("artifact_id", "string"),
                           2: _m("artifact_info", "ArtifactInfo")},
    "BlobInfo": {
        1: F("schema_version", "int32"), 2: _m("os", "OS"),
        11: _m("repository", "Repository"),
        3: _m("package_infos", "PackageInfo", True),
        4: _m("applications", "Application", True),
        9: _m("misconfigurations", "Misconfiguration", True),
        5: F("opaque_dirs", "string", repeated=True),
        6: F("whiteout_files", "string", repeated=True),
        7: F("digest", "string"), 8: F("diff_id", "string"),
        10: _m("custom_resources", "CustomResource", True),
        12: _m("secrets", "Secret", True),
        13: _m("licenses", "LicenseFile", True),
    },
    "PutBlobRequest": {1: F("diff_id", "string"),
                       3: _m("blob_info", "BlobInfo")},
    "MissingBlobsRequest": {1: F("artifact_id", "string"),
                            2: F("blob_ids", "string", repeated=True)},
    "MissingBlobsResponse": {
        1: F("missing_artifact", "bool"),
        2: F("missing_blob_ids", "string", repeated=True),
    },
    "DeleteBlobsRequest": {1: F("blob_ids", "string", repeated=True)},
    "Empty": {},
}

SEVERITY_NAMES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]


def encode_msg(msg: dict, name: str) -> bytes:
    return encode(msg, name, REGISTRY)


def decode_msg(data: bytes, name: str) -> dict:
    return decode(data, name, REGISTRY)
