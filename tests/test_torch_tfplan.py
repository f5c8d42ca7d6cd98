"""The port's Terraform plan scanner (iac/tfplan.py), its detection and
the analyzer's records, held against the JAX package: every case of
tests/test_tfplan.py runs through test_torch_mirror, its assertions on
the port and each value it reads equal to the reference's."""

import pytest

from test_torch_mirror import mirror_cases, run_case


@pytest.mark.parametrize("cls,fn", mirror_cases("test_tfplan.py"))
def test_tfplan_case_like_reference(cls, fn, request):
    run_case(cls, fn, request)
