"""graftwatch — tracing, flight recorder, SLOs, device status, the
dispatch ledger and the tenant cost ledgers.

  trace     the span core: context-local spans, trace-id propagation
            (X-Trivy-Trace-Id, X-Trivy-Parent-Span), Chrome
            trace-event export (`--trace FILE`) and phase totals.
  recorder  the always-on flight recorder: every finished span and log
            record lands in a bounded lock-free ring; slow, error and
            incident traces are pinned past churn; /debug/traces and
            /debug/incidents read it.
  slo       declared objectives (scan latency p99, error rate,
            device-serving ratio) over sliding windows with
            multi-window burn-rate gauges.
  collect   cross-process trace assembly from /debug/traces fragments.
  check     offline validator for incident files, trace dumps, profile
            manifests and cost reports
            (`python -m trivy_tpu_torch.obs.check`).
  device    the cached device view /healthz serves.
  perf      the dispatch ledger (LEDGER), device memory gauges and the
            torch.profiler capture (PROF) behind /debug/profile and
            --profile-dir.
  perfcheck the bench-tail regression gate.
  cost      per-request cost ledgers, tenant aggregation and the
            conservation report behind /debug/costs.
  exposition the strict Prometheus text-format parser.

Metrics live in `trivy_tpu_torch.metrics`. Each module is the port's
copy of the JAX package's module of the same name; every singleton has
its own `reset_for_tests()`.
"""

from .device import device_status, note_dispatch
from .perf import LEDGER, PROF
from .recorder import RECORDER
from .slo import SLO
from .trace import (COLLECTOR, add_attr, chrome_trace, current_span_id,
                    current_trace_id, ensure_trace, new_trace,
                    phase_totals, recording, span, write_chrome_trace)

__all__ = [
    "COLLECTOR", "LEDGER", "PROF", "RECORDER", "SLO", "add_attr",
    "chrome_trace", "current_span_id", "current_trace_id",
    "device_status", "ensure_trace", "new_trace", "note_dispatch",
    "phase_totals", "recording", "span", "write_chrome_trace",
]
