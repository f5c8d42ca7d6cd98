"""Shared ASCII table rendering for summary-style reports (compliance
summary, k8s namespace summary)."""

from __future__ import annotations


def render_table(title: str, head: list[str],
                 rows: list[list[str]]) -> str:
    widths = [max(len(r[i]) for r in rows + [head])
              for i in range(len(head))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [title, sep,
             "|" + "|".join(f" {head[i]:<{widths[i]}} "
                            for i in range(len(head))) + "|", sep]
    for r in rows:
        lines.append("|" + "|".join(
            f" {r[i]:<{widths[i]}} " for i in range(len(head))) + "|")
    lines.append(sep)
    return "\n".join(lines) + "\n"
