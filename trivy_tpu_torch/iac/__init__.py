"""IaC misconfiguration engine (reference pkg/iac), the port's copy of
the JAX package's iac/.

Per-format parsers that keep source positions, adapters into a
position-carrying cloud-state model, and Python check functions keyed by
the published AVD IDs so findings line up with the reference's output:
  kubernetes     — manifest checks (KSV series)
  helm           — charts rendered through the Go template engine, then
                   the kubernetes checks
  cloudformation — YAML/JSON templates with intrinsics (AVD-AWS series,
                   the checks of cloud.py)
  terraform      — HCL2 parse + eval (hcl.py) of a module, with the AWS,
                   Google (gcp.py), Azure (azure.py) and other provider
                   (providers_extra.py) checks; tfplan.py renders plan
                   JSON into HCL for it
  azure          — also the ARM template scanner
  rego           — the interpreter for user checks, exceptions and the
                   ignore policy
  dockerfile     — lives in trivy_tpu_torch.misconf.dockerfile (DS series)
File-type detection mirrors pkg/iac/detection/detect.go.
"""

from . import detection  # noqa: F401
from .detection import detect_config_type  # noqa: F401
