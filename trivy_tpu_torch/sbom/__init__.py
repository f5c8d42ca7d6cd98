"""SBOM encode/decode (reference pkg/sbom): CycloneDX JSON, SPDX JSON and
tag-value, and in-toto attestations that wrap them.

Decoding an SBOM is the fastest ingest path: it skips analysis and feeds
the packages straight into the batched detector
(pkg/fanal/artifact/sbom/sbom.go)."""

from .cyclonedx import decode_cyclonedx, encode_cyclonedx  # noqa: F401
from .io import decode_sbom_file, detect_format, write_sbom  # noqa: F401
from .spdx import encode_spdx  # noqa: F401
