"""The port's Clenshaw-Curtis engine against the JAX package's."""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.ops import quadrature as tq


@pytest.mark.parametrize("nb_steps", [1, 2, 5, 20, 50, 101])
def test_nodes_and_weights_bit_equal_to_jax(nb_steps):
    from umnn_tpu.ops.quadrature import cc_quadrature

    n_j, w_j = cc_quadrature(nb_steps)
    n_t, w_t = tq.cc_quadrature(nb_steps)
    np.testing.assert_array_equal(n_t, n_j)
    np.testing.assert_array_equal(w_t, w_j)


def test_rejects_zero_steps():
    with pytest.raises(ValueError):
        tq.cc_quadrature(0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 6])
def test_exact_for_low_degree_polynomials(degree):
    """An (N+1)-point rule is exact up to degree N: here N=6, in float64."""
    rng = np.random.RandomState(degree)
    coef = torch.as_tensor(rng.randn(degree + 1))
    x0 = torch.as_tensor(rng.uniform(-2, 0, (3, 2)))
    xT = torch.as_tensor(rng.uniform(0, 2, (3, 2)))
    h = torch.zeros(3, 1, dtype=torch.float64)

    def poly(x, _h):
        return sum(c * x**k for k, c in enumerate(coef))

    def antider(x):
        return sum(c * x ** (k + 1) / (k + 1) for k, c in enumerate(coef))

    z = tq.neural_integral(poly, x0, xT, h, nb_steps=6)
    torch.testing.assert_close(z, antider(xT) - antider(x0), rtol=1e-12, atol=1e-12)


def test_integrate_matches_jax():
    """Same integrand, same inputs: the node megabatch gives JAX's value."""
    import jax.numpy as jnp
    from umnn_tpu.ops.quadrature import integrate_autodiff

    rng = np.random.RandomState(0)
    x0 = rng.uniform(-1, 0, (4, 3)).astype(np.float32)
    xT = rng.uniform(-1, 2, (4, 3)).astype(np.float32)
    h = rng.randn(4, 3).astype(np.float32)

    def f_jax(_p, x, hh):
        return jnp.exp(jnp.sin(x) * hh) + x**2

    def f_torch(x, hh):
        return torch.exp(torch.sin(x) * hh) + x**2

    z_j = integrate_autodiff(f_jax, None, jnp.asarray(x0), jnp.asarray(xT), jnp.asarray(h), 20)
    nodes, weights = tq.cc_tensors(20, "cpu")
    z_t = tq.integrate(
        f_torch, torch.as_tensor(x0), torch.as_tensor(xT), torch.as_tensor(h), nodes, weights
    )
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-6)


def test_integrate_inv_f_matches_jax():
    """``inv_f=True`` integrates ``1/f``, as JAX's ``inv_f`` does."""
    import jax.numpy as jnp
    from umnn_tpu.ops.quadrature import integrate_autodiff

    rng = np.random.RandomState(2)
    x0 = rng.uniform(-1, 0, (4, 3)).astype(np.float32)
    xT = rng.uniform(-1, 2, (4, 3)).astype(np.float32)
    h = rng.randn(4, 3).astype(np.float32)

    def f_jax(_p, x, hh):
        return jnp.exp(jnp.sin(x) * hh) + x**2

    def f_torch(x, hh):
        return torch.exp(torch.sin(x) * hh) + x**2

    z_j = integrate_autodiff(
        f_jax, None, jnp.asarray(x0), jnp.asarray(xT), jnp.asarray(h), 20, inv_f=True
    )
    z_t = tq.neural_integral(
        f_torch, torch.as_tensor(x0), torch.as_tensor(xT), torch.as_tensor(h), 20, inv_f=True
    )
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-6)
