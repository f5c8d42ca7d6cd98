"""Client/server mode (reference rpc/ + pkg/rpc): a Twirp-shaped HTTP
boundary between analysis on the client and batched detection on the
server, wire-compatible with the JAX package's server and client.

The header names live here, not in listen.py, so the client imports
them without the server stack."""

TOKEN_HEADER = "Trivy-Token"
# per-request deadline: milliseconds the client is willing to wait,
# queue time included; the admission queue never parks a handler past it
DEADLINE_HEADER = "X-Trivy-Deadline-Ms"
# the serving table's content digest, stamped on every Scan response and
# in /healthz
DB_VERSION_HEADER = "X-Trivy-DB-Version"
# who the scan is for; detectd's fair queue and the admission quotas key
# on its clamped label (obs/cost.py)
TENANT_HEADER = "X-Trivy-Tenant"

# request-message descriptor per Twirp route (binary encoding)
ROUTE_DESCRIPTORS = {
    "/twirp/trivy.scanner.v1.Scanner/Scan": "ScanRequest",
    # the SBOM document rides the request body; the server decodes it
    # and runs the Scan path behind it
    "/twirp/trivy.scanner.v1.Scanner/ScanSBOM": "ScanSBOMRequest",
    "/twirp/trivy.cache.v1.Cache/PutArtifact": "PutArtifactRequest",
    "/twirp/trivy.cache.v1.Cache/PutBlob": "PutBlobRequest",
    "/twirp/trivy.cache.v1.Cache/MissingBlobs": "MissingBlobsRequest",
    "/twirp/trivy.cache.v1.Cache/DeleteBlobs": "DeleteBlobsRequest",
}
