"""Report writers (reference pkg/report/writer.go format switch)."""

from .writer import build_report, to_json, to_table, write_report  # noqa: F401
