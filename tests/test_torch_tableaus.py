"""PyTorch port: the Butcher tableaus equal the JAX package's exactly."""

import dataclasses

import pytest

from tfdiffeq_tpu.ops import tableaus as JT
from tfdiffeq_tpu_torch.ops import tableaus as PT

NAMES = ["DOPRI5", "BOSH3", "ADAPTIVE_HEUN", "TSIT5", "DOPRI8", "EULER",
         "MIDPOINT", "RK4", "RK4_38"]


@pytest.mark.parametrize("name", NAMES)
def test_tableau_equals_reference(name):
    got, ref = getattr(PT, name), getattr(JT, name)
    # Field by field, so a failure names the field; floats compare exactly.
    for field in dataclasses.fields(ref):
        assert getattr(got, field.name) == getattr(ref, field.name), \
            field.name
    assert got.stages == ref.stages
    assert got.evals_per_step == ref.evals_per_step


def test_adaptive_registry_matches_reference():
    assert sorted(PT.TABLEAUS_BY_NAME) == sorted(JT.TABLEAUS_BY_NAME)
    for name, tab in PT.TABLEAUS_BY_NAME.items():
        assert dataclasses.astuple(tab) == \
            dataclasses.astuple(JT.TABLEAUS_BY_NAME[name])


def test_dense_output_midpoints_equal_reference():
    # tsit5 and dopri8 derive their midpoint weights by least squares at
    # import; both packages must land on the same floats.
    for name in ("TSIT5", "DOPRI8"):
        assert getattr(PT, name).c_mid == getattr(JT, name).c_mid
    assert PT.derive_c_mid(PT.DOPRI5.c, PT.DOPRI5.a) == \
        JT.derive_c_mid(JT.DOPRI5.c, JT.DOPRI5.a)
