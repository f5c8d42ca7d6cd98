"""The port's CloudFormation scanner (trivy_tpu_torch/iac/cloudformation.py
over iac/cloud.py's AWS checks) and file-type detection, held against the
JAX package: every CloudFormation case of tests/test_iac.py
(TestCloudFormation, TestUnknownSemantics, the CloudFormation case of
TestMalformedManifests, TestDetection and TestIgnores) runs through
test_torch_mirror, its assertions on the port and each value it reads
equal to the reference's."""

import pytest

from test_torch_mirror import mirror_cases, run_case

CFN_CLASSES = ("TestCloudFormation::", "TestUnknownSemantics::",
               "TestMalformedManifests::test_unknown_pab_passes",
               "TestDetection::", "TestIgnores::")


@pytest.mark.parametrize("cls,fn", mirror_cases(
    "test_iac.py", keep=lambda case: case.startswith(CFN_CLASSES)))
def test_iac_case_like_reference(cls, fn, request):
    run_case(cls, fn, request)
