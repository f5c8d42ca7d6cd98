"""Result post-processing (reference pkg/result): severity, status and
ignore-file filtering after detection, before the report."""

from .filter import FilterOptions, filter_results  # noqa: F401
from .ignore import IgnoreFile, parse_ignore_file  # noqa: F401
