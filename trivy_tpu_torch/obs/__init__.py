"""The observability subset the port has: the tenant label clamp
(cost.py). Spans, the cost ledgers, the metrics and the debug pages
are not ported (ROADMAP A17)."""
