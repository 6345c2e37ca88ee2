"""The port's MADE against the JAX package's, on the same weights."""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.nn.made import MADE, build_made_masks

CONFIGS = [
    dict(nin=5, hidden_sizes=(16, 16), nout=5),
    dict(nin=4, hidden_sizes=(8,), nout=12),
    dict(nin=6, hidden_sizes=(13, 7, 9), nout=18),
    dict(nin=3, hidden_sizes=(10, 10), nout=6, random_degrees=True, seed=3),
    dict(nin=5, hidden_sizes=(12,), nout=10, natural_ordering=False, random_degrees=True, seed=1),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_masks_equal_jax(cfg):
    from umnn_tpu.nn.made import build_made_masks as jax_masks

    cfg = dict(cfg)
    args = (cfg.pop("nin"), cfg.pop("hidden_sizes"), cfg.pop("nout"))
    m_t, order_t = build_made_masks(*args, **cfg)
    m_j, order_j = jax_masks(*args, **cfg)
    assert len(m_t) == len(m_j)
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(order_t, order_j)


def test_masks_reject_bad_nout():
    with pytest.raises(ValueError):
        build_made_masks(4, (8,), 6)


def _jax_made(nin, hidden, nout, seed):
    import jax
    from umnn_tpu.nn.made import MADE as JaxMADE

    made = JaxMADE(nin, tuple(hidden), nout)
    params = jax.tree_util.tree_map(np.asarray, made.init(jax.random.PRNGKey(seed)))
    return made, params


def _port_made(nin, hidden, nout, params):
    made = MADE(nin, hidden, nout, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for layer, p in zip(made.layers, params["layers"]):
            layer.weight.copy_(torch.tensor(p["w"].T))
            layer.bias.copy_(torch.tensor(p["b"]))
    return made


@pytest.mark.parametrize("nin,hidden,k", [(6, (32, 32), 3), (8, (16,), 1), (5, (20, 20, 20), 2)])
def test_outputs_equal_jax(nin, hidden, k):
    made_j, params = _jax_made(nin, hidden, k * nin, seed=nin)
    made_t = _port_made(nin, hidden, k * nin, params)
    x = np.random.RandomState(0).randn(7, nin).astype(np.float32)
    out_j = np.asarray(made_j.apply(params, x))
    with torch.no_grad():
        out_t = made_t(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


def test_outputs_equal_jax_through_the_flow_bridge():
    """The bridge carries a JAX flow's MADE into the port's unchanged."""
    import jax
    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    from umnn_tpu_torch.bridge import load_jax_flow_params
    from umnn_tpu_torch.models.flow import UMNNMAFFlow

    kw = dict(nb_flow=2, nb_in=5, hidden_derivative=(8,), hidden_embedding=(16, 16), embedding_s=3)
    flow_j = JaxFlow(**kw)
    params = jax.tree_util.tree_map(np.asarray, flow_j.init(jax.random.PRNGKey(4)))
    flow_t = load_jax_flow_params(UMNNMAFFlow(**kw, device="cpu"), params)
    x = np.random.RandomState(1).randn(9, 5).astype(np.float32)
    for block_t, p in zip(flow_t.blocks, params):
        out_j = np.asarray(flow_j.block.net.made.apply(p["net"]["made"], x))
        with torch.no_grad():
            out_t = block_t.net.made(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_jacobian_upper_triangle_is_zero(k):
    """Output block j*nin + d depends on x[:d] only."""
    nin = 6
    made = MADE(nin, (24, 24), k * nin, torch.Generator().manual_seed(k), device="cpu")
    x = torch.randn(nin, generator=torch.Generator().manual_seed(7))
    jac = torch.autograd.functional.jacobian(made, x)  # [k*nin, nin]
    for j in range(k):
        block = jac[j * nin : (j + 1) * nin]
        assert torch.all(torch.triu(block) == 0)
        assert torch.any(torch.tril(block, -1) != 0)
