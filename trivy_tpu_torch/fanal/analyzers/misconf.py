"""Config-file analyzers routing IaC files to the misconfiguration
scanners (reference pkg/fanal/analyzer/config + pkg/misconf bridge), the
port's copy of the JAX package's analyzers/misconf.py under the JAX
names and versions: the per-file `misconf` analyzer (dockerfile,
kubernetes, CloudFormation, Terraform plans, Azure ARM, and user rego
checks on any YAML, JSON or TOML file), the chart-scoped `helm`
post-analyzer and the module-scoped `terraform` one. Each reads the
user checks and helm overrides from its group's MisconfSettings
(`self.misconf`)."""

from __future__ import annotations

from typing import Optional

from ... import types as T
from ...iac.detection import sniff
from ...misconf import FILE_TYPES, detect_file_type
from . import AnalysisResult, Analyzer, PostAnalyzer, register, \
    register_post


@register
class MisconfAnalyzer(Analyzer):
    name = "misconf"
    version = 2

    def required(self, path: str, size: int = -1) -> bool:
        return detect_file_type(
            path, custom=self.misconf.checks is not None) != ""

    def analyze(self, path: str, content: bytes) -> Optional[AnalysisResult]:
        from ...misconf import apply_exceptions, run_custom_checks
        ftype, docs = sniff(path, content)
        failures: list = []
        successes = 0
        exceptions = 0
        scanner = FILE_TYPES.get(ftype)
        if scanner is not None:
            failures, successes = scanner(path, content, docs=docs)
        checks = self.misconf.checks
        if checks is not None:
            if ftype:
                # rego exceptions apply to the builtin results
                failures, successes, exceptions = apply_exceptions(
                    ftype, path, content, docs, failures, successes,
                    scanner=checks)
            eff_type = ftype
            if not eff_type:
                base = path.lower()
                if base.endswith((".yaml", ".yml")):
                    eff_type = "yaml"
                elif base.endswith(".json"):
                    eff_type = "json"
                elif base.endswith(".toml"):
                    eff_type = "toml"
            if eff_type:
                cf, cs, ce = run_custom_checks(eff_type, path, content,
                                               docs, scanner=checks)
                failures = failures + cf
                successes += cs
                exceptions += ce
                ftype = ftype or eff_type
        if not failures and not successes and not exceptions:
            return None
        result = AnalysisResult()
        result.misconfigurations = [T.Misconfiguration(
            file_type=ftype, file_path=path,
            successes=successes, exceptions=exceptions,
            failures=failures)]
        return result


@register_post
class HelmPostAnalyzer(PostAnalyzer):
    """Chart-scoped helm scanning: whole chart trees rendered with the
    template engine then run through the kubernetes checks (reference
    pkg/iac/scanners/helm renders via helm's engine)."""
    name = "helm"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        base = path.rsplit("/", 1)[-1]
        if base in ("Chart.yaml", "values.yaml", ".helmignore") or \
                path.endswith((".tpl", ".tgz")):
            return True
        return "/templates/" in path or path.startswith("templates/")

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        from ...iac.helm import (find_charts, load_chart_tgz,
                                 scan_chart_files, scan_rendered_chart)
        overrides = self.misconf.helm_overrides
        records = []
        # packaged charts (.tgz archives)
        for path, content in files.items():
            if not path.endswith(".tgz"):
                continue
            try:
                chart = load_chart_tgz(content)
            except Exception:
                continue
            if chart.templates:
                records.extend(
                    scan_rendered_chart(chart, prefix=path + ":",
                                        overrides=overrides))
        # chart directories
        for root, paths in find_charts(list(files)).items():
            rel = {p[len(root) + 1 if root else 0:]: files[p]
                   for p in paths}
            if "Chart.yaml" not in rel:
                continue
            records.extend(scan_chart_files(rel, overrides=overrides))
        if not records:
            return None
        result = AnalysisResult()
        result.misconfigurations = records
        return result


@register_post
class TerraformPostAnalyzer(PostAnalyzer):
    """Module-scoped terraform scanning: all .tf/.tfvars of a directory
    evaluated together (reference terraform scanner operates on the
    whole module, not per file)."""
    name = "terraform"
    version = 1

    def required(self, path: str, size: int = -1) -> bool:
        return path.endswith((".tf", ".tfvars"))

    def post_analyze(self, files: dict) -> Optional[AnalysisResult]:
        from ...iac.terraform import scan_terraform_files
        records = scan_terraform_files(files)
        if not records:
            return None
        result = AnalysisResult()
        result.misconfigurations = records
        return result
