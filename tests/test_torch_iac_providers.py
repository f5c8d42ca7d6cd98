"""The port's Terraform provider checks (iac/gcp.py, iac/azure.py's
azurerm half, iac/providers_extra.py and iac/cloud.py's AWS checks
through iac/terraform.py), held against the JAX package: every case of
tests/test_iac_providers.py runs through test_torch_mirror, its
assertions on the port and each value it reads equal to the reference's."""

import pytest

from test_torch_mirror import mirror_cases, run_case


@pytest.mark.parametrize("cls,fn", mirror_cases("test_iac_providers.py"))
def test_iac_providers_case_like_reference(cls, fn, request):
    run_case(cls, fn, request)
