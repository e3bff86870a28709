"""Reachability of the port against the JAX reference on the CPU, end to
end through ``run_host`` under every plan of join x group-by x connector
x sender combine (a max fold: every field equal). Split from
test_torch_algorithms.py so the two run on separate workers."""
import _torch_threads  # noqa: F401  (first: see the module)
import numpy as np
import pytest

import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from test_torch_algorithms import EDGES, N, PLAN_IDS, PLANS, run_both


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_reachability_equals_jax(plan):
    rt = run_both(JG.Reachability(3), TG.Reachability(3), plan, EDGES, 1)
    bfs = run_both(JG.BFS(3), TG.BFS(3), plan, EDGES, 1) \
        if plan == PLANS[0] else None
    got = T.gather_values(rt.vertex, N)[:, 0]
    assert set(np.unique(got)) <= {0.0, 1.0} and got[3] == 1.0
    if bfs is not None:
        lv = T.gather_values(bfs.vertex, N)[:, 0]
        assert np.array_equal(got > 0, lv < np.float32(3.4e38))
