"""IaC misconfiguration engine (reference pkg/iac), the port's copy of
the JAX package's iac/ for the file types ported so far.

Per-format parsers that keep source positions, and Python check
functions keyed by the published AVD IDs so findings line up with the
reference's output:
  kubernetes  — manifest checks (KSV series)
  helm        — charts rendered through the Go template engine, then the
                kubernetes checks
  rego        — the interpreter for user checks, exceptions and the
                ignore policy
  dockerfile  — lives in trivy_tpu_torch.misconf.dockerfile (DS series)
File-type detection mirrors pkg/iac/detection/detect.go. CloudFormation,
Terraform, Terraform plans and Azure ARM are detected but not ported
(ROADMAP A4): misconf.refuse_unported stops a misconfig scan that meets
one of them.
"""
