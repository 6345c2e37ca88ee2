"""The port's Leibniz-rule ``neural_integral`` and padded nodes against the
JAX package's (`umnn_tpu/ops/quadrature.py:102-127,251-331`).

Both sides integrate the same MLP integrand, weights made in JAX and
carried across, on the same numpy inputs, and differentiate with the
Leibniz rule: endpoints ``+-g f(x)``, the rest one VJP through the node
megabatch. Tolerance on gradients: rtol 1e-4, atol 1e-6, as
`tests/test_pallas_kernel.py` holds gradients (each sums 21 node terms
over the batch in another order in each package); on values rtol 1e-5,
atol 1e-6, as `tests/test_torch_quadrature.py`.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.nn.core import MLP
from umnn_tpu_torch.ops import quadrature as tq

B, D, E = 4, 3, 5
SIZES = [1 + E, 16, 16, 1]
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("nb_steps,max_steps", [(20, 30), (10, 100), (50, 50)])
def test_padded_nodes_equal_jax(nb_steps, max_steps):
    from umnn_tpu.ops.quadrature import padded_cc_quadrature as jax_padded

    n_j, w_j = jax_padded(nb_steps, max_steps)
    n_t, w_t = tq.padded_cc_quadrature(nb_steps, max_steps, "cpu")
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert (n_t[nb_steps + 1 :] == -1).all() and (w_t[nb_steps + 1 :] == 0).all()


def test_padded_nodes_reject_fewer_slots_than_steps():
    with pytest.raises(ValueError):
        tq.padded_cc_quadrature(20, 10, "cpu")


class PortIntegrand(torch.nn.Module):
    """f(x, h) per dimension: ELU+1 of an MLP on ``[x_d, h]``."""

    def __init__(self, layers):
        super().__init__()
        self.mlp = MLP(SIZES, torch.Generator(), "LeakyReLU", "ELUPlus", device="cpu")
        with torch.no_grad():
            for lin, l in zip(self.mlp.layers, layers):
                lin.weight.copy_(torch.tensor(l["w"].T))
                lin.bias.copy_(torch.tensor(l["b"]))

    def forward(self, x, h):
        hh = h[..., None, :].expand(*x.shape, h.shape[-1])
        return self.mlp(torch.cat([x[..., None], hh], -1))[..., 0]


def _jax_integrand(p, x, h):
    import jax.numpy as jnp
    from umnn_tpu.nn.core import ACTIVATIONS, mlp_apply

    hh = jnp.broadcast_to(h[..., None, :], (*x.shape, h.shape[-1]))
    rows = jnp.concatenate([x[..., None], hh], -1)
    return mlp_apply(p, rows, ACTIVATIONS["LeakyReLU"], ACTIVATIONS["ELUPlus"])[..., 0]


@pytest.fixture(scope="module")
def setup():
    import jax
    from umnn_tpu.nn.core import mlp_init

    layers = [{k: np.array(v) for k, v in l.items()} for l in mlp_init(jax.random.PRNGKey(7), SIZES)]
    rng = np.random.RandomState(8)
    x0 = rng.uniform(-1.0, 0.0, (B, D)).astype(np.float32)
    xT = rng.uniform(-1.0, 2.0, (B, D)).astype(np.float32)
    xT[0, 0] = 0.0
    h = rng.randn(B, E).astype(np.float32)
    return layers, x0, xT, h


@pytest.mark.parametrize("inv_f", [False, True])
@pytest.mark.parametrize("padded", [False, True], ids=["nodes_21", "padded_21_of_31"])
def test_value_and_every_gradient_match_jax(setup, inv_f, padded):
    import jax
    import jax.numpy as jnp
    from umnn_tpu.ops.quadrature import neural_integral as jax_ni
    from umnn_tpu.ops.quadrature import padded_cc_quadrature as jax_padded

    layers, x0, xT, h = setup
    if padded:
        nodes_j, w_j = jax_padded(20, 30)
        nodes_t, w_t = tq.padded_cc_quadrature(20, 30, "cpu")
    else:
        nodes_j = w_j = None
        nodes_t, w_t = tq.cc_tensors(20, "cpu")

    def loss_j(p, a, b, hh):
        z = jax_ni(_jax_integrand, p, a, b, hh, 20, nodes=nodes_j, weights=w_j, inv_f=inv_f)
        return jnp.sum(jnp.sin(z)), z

    params = jax.tree_util.tree_map(jnp.asarray, layers)
    (_, z_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True)(
        params, *map(jnp.asarray, (x0, xT, h))
    )

    f = PortIntegrand(layers)
    a, b, hh = (torch.tensor(v, requires_grad=True) for v in (x0, xT, h))
    z_t = tq.neural_integral(f, a, b, hh, nodes=nodes_t, weights=w_t, inv_f=inv_f)
    params_t = list(f.parameters())
    grads = torch.autograd.grad(torch.sin(z_t).sum(), [a, b, hh, *params_t])

    np.testing.assert_allclose(z_t.detach().numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-6)
    for got, want in zip(grads[:3], g_j[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    for i, l in enumerate(g_j[0]):
        np.testing.assert_allclose(grads[3 + 2 * i].numpy(), np.asarray(l["w"]).T, **GRAD_TOL)
        np.testing.assert_allclose(grads[4 + 2 * i].numpy(), np.asarray(l["b"]), **GRAD_TOL)


def test_leibniz_endpoints_are_the_integrand(setup):
    """dz/dxT = f(xT, h) and dz/dx0 = -f(x0, h), not the derivative of the
    node sum."""
    layers, x0, xT, h = setup
    f = PortIntegrand(layers)
    a, b = torch.tensor(x0, requires_grad=True), torch.tensor(xT, requires_grad=True)
    z = tq.neural_integral(f, a, b, torch.tensor(h), 20)
    da, db = torch.autograd.grad(z.sum(), [a, b])
    with torch.no_grad():
        torch.testing.assert_close(db, f(torch.tensor(xT), torch.tensor(h)))
        torch.testing.assert_close(da, -f(torch.tensor(x0), torch.tensor(h)))


def test_nothing_with_the_node_axis_is_saved(setup):
    """The forward keeps only its inputs: every tensor saved for the
    backward is no larger than the largest input or parameter."""
    layers, x0, xT, h = setup
    f = PortIntegrand(layers)
    nodes, w = tq.cc_tensors(20, "cpu")
    a, b, hh = (torch.tensor(v, requires_grad=True) for v in (x0, xT, h))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t, lambda t: t):
        z = tq.neural_integral(f, a, b, hh, nodes=nodes, weights=w)
    largest = max(t.numel() for t in (a, b, hh, nodes, *f.parameters()))
    assert saved, "the Function saves its inputs"
    assert max(int(np.prod(s)) for s in saved) <= largest
    assert all(len(s) < 3 for s in saved), saved  # no [B, K, D] or deeper
    # the plain megabatch, by contrast, keeps [B, K, D, width] activations
    saved_plain = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved_plain.append(t.shape) or t, lambda t: t):
        tq.integrate(f, a, b, hh, nodes, w)
    assert max(int(np.prod(s)) for s in saved_plain) >= B * 21 * D * 16
    torch.autograd.grad(z.sum(), [a, b, hh])


def test_plain_function_integrand_gets_endpoint_and_h_gradients():
    """A function (not a module) has no parameters; x and h still get theirs."""
    x = torch.tensor([[0.5, 1.0]], requires_grad=True)
    h = torch.tensor([[2.0, 3.0]], requires_grad=True)
    z = tq.neural_integral(lambda t, hh: torch.exp(t * hh), torch.zeros_like(x), x, h, 30)
    dx, dh = torch.autograd.grad(z.sum(), [x, h])
    torch.testing.assert_close(dx, torch.exp(x * h).detach())
    # d/dh int_0^x e^{t h} dt = (x h e^{x h} - e^{x h} + 1) / h^2
    xd, hd = x.detach(), h.detach()
    want = (xd * hd * torch.exp(xd * hd) - torch.exp(xd * hd) + 1) / hd**2
    torch.testing.assert_close(dh, want, rtol=1e-5, atol=1e-5)
