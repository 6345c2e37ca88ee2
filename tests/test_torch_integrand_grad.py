"""Gradients of the port's fused integrand integral against the JAX
package's Pallas kernel (interpret mode, unpacked) on the same inputs.

On CPU tensors the port's wrapper runs its plain version and autograd
differentiates it; the CUDA backward kernel is held against
``fused_cc_integral_bwd_plain`` on the card by ``chip_smoke.py``. Both
sides give the exact derivative of the K-node sum. Tolerance: rtol 1e-4,
atol 1e-6, as `tests/test_pallas_kernel.py` holds JAX's kernel gradients
to its oracle: a gradient sums K x rows float32 products in another order
in each package, so a few ulp of each term add up over the 21 nodes.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.nn.core import elu_plus
from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors, padded_cc_quadrature

E = 6
WIDTHS = [1 + E, 72, 16, 1]
SHAPE = (5, 8)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    import jax
    from umnn_tpu.nn.core import mlp_init

    layers = mlp_init(jax.random.PRNGKey(2), WIDTHS)
    layers = [{k: np.array(v) for k, v in l.items()} for l in layers]
    h = np.random.RandomState(3).randn(*SHAPE, E).astype(np.float32)
    return layers, h


def _x(case):
    x = np.random.RandomState(4).uniform(0.3, 1.5, SHAPE).astype(np.float32)
    if case == "neg":
        return -x
    if case == "zero":
        return np.zeros(SHAPE, np.float32)
    if case == "mixed":
        x[::2] *= -1
        x[:, ::3] = 0
    return x


def _nodes(padded):
    if padded:
        return padded_cc_quadrature(20, 30, "cpu")
    return cc_tensors(20, "cpu")


def _port_inputs(layers, x, h):
    ws = [torch.tensor(l["w"].T) for l in layers]
    bs = [torch.tensor(l["b"]) for l in layers]
    return ws, bs, torch.tensor(x), torch.tensor(h)


def _port_grads(layers, x, h, neg_slope, padded):
    ws, bs, xt, ht = _port_inputs(layers, x, h)
    leaves = [t.requires_grad_() for t in (*ws, *bs, xt, ht)]
    nodes, ccw = _nodes(padded)
    z = ik.fused_cc_integral(ws, bs, xt, ht, nodes, ccw, neg_slope=neg_slope)
    grads = torch.autograd.grad(torch.sin(z).sum(), leaves)
    n = len(ws)
    return [g.numpy() for g in grads[:n]], [g.numpy() for g in grads[n : 2 * n]], grads[-2].numpy(), grads[-1].numpy()


def _jax_grads(layers, x, h, neg_slope, padded):
    import jax
    import jax.numpy as jnp
    from umnn_tpu.ops.integrand_kernel import fused_cc_integral
    from umnn_tpu.ops.quadrature import cc_quadrature
    from umnn_tpu.ops.quadrature import padded_cc_quadrature as jax_padded

    if padded:
        nodes, ccw = jax_padded(20, 30)
    else:
        n, w = cc_quadrature(20)
        nodes, ccw = jnp.asarray(n, jnp.float32), jnp.asarray(w, jnp.float32)

    def loss(ws, bs, xx, hh):
        z = fused_cc_integral(
            ws, bs, xx, hh, nodes, ccw, tile_r=8, interpret=True, neg_slope=neg_slope,
            pack2=False, pack4=False,
        )
        return jnp.sum(jnp.sin(z))

    ws = [jnp.asarray(l["w"]) for l in layers]
    bs = [jnp.asarray(l["b"]) for l in layers]
    g = jax.grad(loss, argnums=(0, 1, 2, 3))(ws, bs, jnp.asarray(x), jnp.asarray(h))
    return [np.asarray(a).T for a in g[0]], [np.asarray(a) for a in g[1]], np.asarray(g[2]), np.asarray(g[3])


CASES = [
    ("pos", 0.01, False), ("zero", 0.01, False), ("neg", 0.01, False),
    ("mixed", 0.01, False), ("pos", 0.0, False), ("mixed", 0.01, True),
]


@pytest.mark.parametrize("case,neg_slope,padded", CASES, ids=[
    "pos", "zero", "neg", "mixed", "relu", "mixed_padded_nodes"])
def test_gradients_match_jax_interpret_kernel(setup, case, neg_slope, padded):
    layers, h = setup
    x = _x(case)
    dws, dbs, dx, dh = _port_grads(layers, x, h, neg_slope, padded)
    jws, jbs, jx, jh = _jax_grads(layers, x, h, neg_slope, padded)
    for a, b in zip(dws + dbs, jws + jbs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    np.testing.assert_allclose(dx, jx, **GRAD_TOL)
    np.testing.assert_allclose(dh, jh, **GRAD_TOL)


def _node_values(layers, x, h, nodes, neg_slope):
    """f at every (row, node) pair through a plain MLP on [x s_n, h]."""
    xs = torch.tensor(x)[..., None] * ((nodes + 1) * 0.5)  # [..., K]
    hh = torch.tensor(h)[..., None, :].expand(*xs.shape, E)
    a = torch.cat([xs[..., None], hh], -1)
    for l in layers[:-1]:
        a = torch.nn.functional.leaky_relu(a @ torch.tensor(l["w"]) + torch.tensor(l["b"]), neg_slope)
    return elu_plus(a @ torch.tensor(layers[-1]["w"]) + torch.tensor(layers[-1]["b"]))[..., 0]


@pytest.mark.parametrize("case,neg_slope,padded", CASES[:4] + CASES[5:], ids=[
    "pos", "zero", "neg", "mixed", "mixed_padded_nodes"])
def test_bwd_plain_gives_the_same_gradients_and_S(setup, case, neg_slope, padded):
    """``fused_cc_integral_bwd_plain`` with cotangent ``cos(z)`` is the
    gradient of ``sum(sin(z))``; its S is ``sum_n w_n f_n``."""
    layers, h = setup
    x = _x(case)
    ws, bs, xt, ht = _port_inputs(layers, x, h)
    nodes, ccw = _nodes(padded)
    z = ik.fused_cc_integral_plain(ws, bs, xt, ht, nodes, ccw, neg_slope)
    dws, dbs, dx, dh, S = ik.fused_cc_integral_bwd_plain(
        ws, bs, xt, ht, nodes, ccw, torch.cos(z), neg_slope
    )
    jws, jbs, jx, jh = _jax_grads(layers, x, h, neg_slope, padded)
    for a, b in zip(dws + dbs, jws + jbs):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)
    np.testing.assert_allclose(dx.numpy(), jx, **GRAD_TOL)
    np.testing.assert_allclose(dh.numpy(), jh, **GRAD_TOL)
    f = _node_values(layers, x, h, nodes, neg_slope)
    np.testing.assert_allclose(S.numpy(), (f * ccw).sum(-1).numpy(), rtol=1e-5, atol=1e-6)
    assert S.shape == xt.shape and dx.shape == xt.shape and dh.shape == ht.shape


def test_dx_at_zero_is_the_integrand(setup):
    """At x = 0, dz/dx = f(0, h): the node path vanishes and S/2 = f."""
    layers, h = setup
    x = np.zeros(SHAPE, np.float32)
    _, _, dx, _ = _port_grads(layers, x, h, 0.01, False)
    f0 = _node_values(layers, x, h, torch.tensor([1.0]), 0.01)[..., 0]
    # d sum(sin z)/dx = cos(0) f(0, h)
    np.testing.assert_allclose(dx, f0.numpy(), rtol=1e-5, atol=1e-6)
    assert dx.min() > 0.1


def test_cpu_backward_launches_nothing(setup):
    layers, h = setup
    before = dict(ik.LAUNCHES)
    _port_grads(layers, _x("pos"), h, 0.01, False)
    assert ik.LAUNCHES == before
