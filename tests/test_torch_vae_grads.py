"""The port's VAE families against the JAX package's: the gradient of the
loss on bridged weights, every parameter within 1e-4 of that tensor's
largest entry, each family and input type. The port's MMAF takes the
Leibniz route (backend "torch"), as JAX's "xla" differentiates; JAX's
noise is handed to the port through a patched ``reparameterize``.
"""

import numpy as np
import pytest
import torch

from torch_vae_cases import (GRAD_GAP, INPUTS, _batch, _family_pair, _jax_loss, _np_tree,
                             _port_loss, patch_jax_eps)
from umnn_tpu_torch.bridge import vae_params_to_numpy
from umnn_tpu_torch.models.vae.vae import VAE_FAMILIES


@pytest.fixture
def jax_eps(monkeypatch):
    return patch_jax_eps(monkeypatch)


@pytest.mark.parametrize("input_type", list(INPUTS))
@pytest.mark.parametrize("family", sorted(VAE_FAMILIES))
def test_family_gradients_match_jax(family, input_type, jax_eps):
    import jax

    # the port's Leibniz route, as JAX's "xla" differentiates
    jmodel, params, tmodel = _family_pair(family, input_type, backend="torch")
    x = _batch(input_type)
    grads_j = jax.grad(lambda p: _jax_loss(jmodel, p, x, jax_eps, input_type)[1][0])(params)
    grads_j = jax.tree_util.tree_leaves(_np_tree(grads_j))
    _, loss_t = _port_loss(tmodel, x, input_type)
    loss_t[0].backward()
    with torch.no_grad():
        for p in tmodel.parameters():
            p.copy_(p.grad)
    grads_t = jax.tree_util.tree_leaves(vae_params_to_numpy(tmodel))
    assert len(grads_t) == len(grads_j)
    for gt, gj in zip(grads_t, grads_j):
        assert gt.shape == gj.shape
        gap = np.abs(gt - gj).max() / (np.abs(gj).max() + 1e-30)
        assert gap <= GRAD_GAP or np.abs(gj).max() == 0.0, gap


