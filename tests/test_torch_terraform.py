"""The port's HCL lexer, parser and evaluator (iac/hcl.py), TfModule,
the adapter and the module scanner (iac/terraform.py), and the terraform
post-analyzer, held against the JAX package: every case of
tests/test_terraform.py runs through test_torch_mirror, its assertions
on the port and each value it reads equal to the reference's."""

import pytest

from test_torch_mirror import mirror_cases, run_case


@pytest.mark.parametrize("cls,fn", mirror_cases("test_terraform.py"))
def test_terraform_case_like_reference(cls, fn, request):
    run_case(cls, fn, request)
