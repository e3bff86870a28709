"""The port's training forward, loss and gradients against the JAX
package's on the CPU for the state-space models at ``reduced()`` size:
zamba2-1.2b (4 Mamba2 layers, the shared attention block after every
second) and falcon-mamba-7b (4 Mamba1 layers; the scan keeps each state
under autograd). Tolerances as ``_torch_train_common`` states them."""
import _torch_threads  # noqa: F401  (first: see the module)

import pytest

import _torch_train_common as common

NAMES = ("zamba2", "falcon-mamba")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_forward_train_matches_jax(name, remat):
    common.check_forward(name, remat)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_match_jax(name):
    common.check_grads(name)
