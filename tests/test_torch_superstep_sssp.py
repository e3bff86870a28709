"""One superstep of the PyTorch port against the JAX reference from the
same state, across join x group-by x connector x sender_combine x
partition, for SSSP: every field exactly (a min program).
Helpers live in test_torch_superstep.py."""
import _torch_threads  # noqa: F401  (first: see the module)
import pytest

from test_torch_superstep import PLANS, _check_plan


@pytest.mark.parametrize("join,groupby,connector,sender_combine,partition",
                         PLANS)
def test_superstep_matches_reference(join, groupby, connector,
                                     sender_combine, partition):
    _check_plan("sssp", join, groupby, connector, sender_combine,
                partition)
