"""Client/server mode (reference rpc/ + pkg/rpc): a Twirp-shaped HTTP
boundary between analysis on the client and batched detection on the
server, wire-compatible with the JAX package's server and client.

The header names live here, not in listen.py, so the client imports
them without the server stack."""

TOKEN_HEADER = "Trivy-Token"
# per-RPC trace id: honored when the client sends one, minted otherwise;
# echoed on every response and stamped on every span and log line the
# request produces
TRACE_HEADER = "X-Trivy-Trace-Id"
# cross-process parentage: the forwarding span's id (the client's
# client.scan), so the server's root span links under it and
# obs.collect stitches one tree across processes with no shared clock
PARENT_SPAN_HEADER = "X-Trivy-Parent-Span"
# per-request deadline: milliseconds the client is willing to wait,
# queue time included; the admission queue never parks a handler past it
DEADLINE_HEADER = "X-Trivy-Deadline-Ms"
# the serving table's content digest, stamped on every Scan response and
# in /healthz
DB_VERSION_HEADER = "X-Trivy-DB-Version"
# who the scan is for; detectd's fair queue and the admission quotas key
# on its clamped label (obs/cost.py)
TENANT_HEADER = "X-Trivy-Tenant"
# the per-request cost split (obs/cost.py CostLedger.header_doc):
# compact JSON stamped on every response made inside a request ledger
COST_HEADER = "X-Trivy-Cost"

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
