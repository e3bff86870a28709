"""The port's MoE layer against the JAX package's on the reduced
qwen2-moe config (d 128, 8 experts padded to 16, top-2, a shared expert,
float32), with the weights carried across by ``params_from_numpy``:
the router's gates and expert choice, the aux loss, and both dispatch
plans. atol 1e-5: the same float32 products summed in another order."""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import moe as J
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import moe as T
from repro_torch.models import params_from_numpy
from repro_torch.models.param import layer_views

ARCH = "qwen2-moe-a2.7b"


def _cfgs(dispatch):
    j = j_get_config(ARCH).reduced()
    t = t_get_config(ARCH).reduced()
    j = dataclasses.replace(j, moe=dataclasses.replace(j.moe,
                                                       dispatch=dispatch))
    t = dataclasses.replace(t, moe=dataclasses.replace(t.moe,
                                                       dispatch=dispatch))
    return j, t


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs("sort")
    jp = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_numpy(tcfg, jp, device="cpu")
    j_moe = jax.tree.map(lambda a: jnp.asarray(a[1]),
                         jp["stages"][0]["sub0"]["moe"])
    t_moe = layer_views(tp.stages[0])[1]["sub0"]["moe"]
    return j_moe, t_moe


def _x(S=24, B=2, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, 128)) \
        .astype(np.float32)


def test_route(weights):
    j_moe, t_moe = weights
    x = _x()
    jg, ji, ja = J._route(j_moe, jnp.asarray(x), 2)
    tg, ti, ta = T._route(t_moe, torch.from_numpy(x), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("S", [1, 24])
def test_dispatch_matches_jax(weights, dispatch, S):
    j_moe, t_moe = weights
    jcfg, tcfg = _cfgs(dispatch)
    x = _x(S=S, seed=S)
    jo, ja = J.apply_moe(j_moe, jnp.asarray(x), jcfg)
    to, ta = T.apply_moe(t_moe, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_sort_and_scatter_agree_without_overflow(weights):
    """With capacity above every group's size the two plans are one
    function."""
    _, t_moe = weights
    _, tcfg = _cfgs("sort")
    scfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, dispatch="einsum", capacity_factor=8.0))
    x = torch.from_numpy(_x(seed=5))
    a, _ = T.apply_moe(t_moe, x, tcfg)
    b, _ = T.apply_moe(t_moe, x, scfg)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
