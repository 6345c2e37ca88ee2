"""The port's fused integrand integral against the JAX package's Pallas
kernel (interpret mode, unpacked) and its quadrature oracle.

On CPU tensors the port's wrapper runs its plain version; the CUDA kernel
is held against that plain version on the card by ``chip_smoke.py``.
Tolerances are those of ``tests/test_pallas_kernel.py``: rtol 1e-5,
atol 1e-6 on float32 values of order one.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors

E = 6
NB = 20  # 21 nodes
WIDTHS = [1 + E, 72, 16, 1]  # a 72-wide layer: no 2- or 4-node packing in JAX
SHAPE = (5, 8)  # R = 40 rows, 5 tiles of 8


@pytest.fixture(scope="module")
def setup():
    import jax
    from umnn_tpu.nn.core import mlp_init

    layers = mlp_init(jax.random.PRNGKey(0), WIDTHS)
    layers = [{k: np.array(v) for k, v in l.items()} for l in layers]
    rng = np.random.RandomState(0)
    h = rng.randn(*SHAPE, E).astype(np.float32)
    return layers, h


def _x(case):
    rng = np.random.RandomState(1)
    x = rng.uniform(0.3, 1.5, SHAPE).astype(np.float32)
    if case == "neg":
        return -x
    if case == "zero":
        return np.zeros(SHAPE, np.float32)
    if case == "mixed":
        x[::2] *= -1
        x[:, ::3] = 0
    return x


def _port(layers, x, h, neg_slope):
    nodes, ccw = cc_tensors(NB, "cpu")
    ws = [torch.as_tensor(l["w"].T.copy()) for l in layers]
    bs = [torch.as_tensor(l["b"]) for l in layers]
    return ik.fused_cc_integral(
        ws, bs, torch.as_tensor(x), torch.as_tensor(h), nodes, ccw, neg_slope=neg_slope
    ).numpy()


def _jax_kernel(layers, x, h, neg_slope):
    import jax.numpy as jnp
    from umnn_tpu.ops.integrand_kernel import fused_cc_integral
    from umnn_tpu.ops.quadrature import cc_quadrature

    n, w = cc_quadrature(NB)
    return np.asarray(
        fused_cc_integral(
            [jnp.asarray(l["w"]) for l in layers],
            [jnp.asarray(l["b"]) for l in layers],
            jnp.asarray(x), jnp.asarray(h),
            jnp.asarray(n, jnp.float32), jnp.asarray(w, jnp.float32),
            tile_r=8, interpret=True, neg_slope=neg_slope, pack2=False, pack4=False,
        )
    )


def _jax_oracle(layers, x, h, neg_slope):
    import jax
    import jax.numpy as jnp
    from umnn_tpu.nn.core import ACTIVATIONS, mlp_apply
    from umnn_tpu.ops.quadrature import integrate_autodiff

    def f(p, X, H):
        hidden = lambda v: jnp.where(v > 0, v, neg_slope * v)  # noqa: E731
        return mlp_apply(p, jnp.concatenate([X, H], axis=-1), hidden, ACTIVATIONS["ELUPlus"])

    xf = jnp.asarray(x).reshape(-1, 1)
    hf = jnp.asarray(h).reshape(-1, E)
    params = jax.tree_util.tree_map(jnp.asarray, layers)
    out = integrate_autodiff(f, params, jnp.zeros_like(xf), xf, hf, nb_steps=NB)
    return np.asarray(out).reshape(x.shape)


CASES = [("pos", 0.01), ("zero", 0.01), ("neg", 0.01), ("mixed", 0.01), ("pos", 0.0), ("neg", 0.0)]


@pytest.mark.parametrize("case,neg_slope", CASES)
def test_matches_jax_interpret_kernel(setup, case, neg_slope):
    layers, h = setup
    x = _x(case)
    z_t = _port(layers, x, h, neg_slope)
    z_j = _jax_kernel(layers, x, h, neg_slope)
    assert z_t.shape == x.shape
    np.testing.assert_allclose(z_t, z_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case,neg_slope", CASES)
def test_matches_jax_quadrature_oracle(setup, case, neg_slope):
    layers, h = setup
    x = _x(case)
    np.testing.assert_allclose(
        _port(layers, x, h, neg_slope), _jax_oracle(layers, x, h, neg_slope),
        rtol=1e-5, atol=1e-6,
    )


def test_sign_follows_x(setup):
    """The integrand is positive, so z carries the sign of x, and x=0 gives 0."""
    layers, h = setup
    x = _x("mixed")
    z = _port(layers, x, h, 0.01)
    np.testing.assert_array_equal(np.sign(z), np.sign(x))


def test_single_layer_integrand_raises(setup):
    layers, h = setup
    w = torch.zeros(1, 1 + E)
    b = torch.zeros(1)
    nodes, ccw = cc_tensors(NB, "cpu")
    with pytest.raises(ValueError, match="at least one hidden layer"):
        ik.fused_cc_integral([w], [b], torch.ones(SHAPE), torch.as_tensor(h), nodes, ccw)


def test_tensors_on_several_devices_raise(setup):
    layers, h = setup
    nodes, ccw = cc_tensors(NB, "meta")
    ws = [torch.as_tensor(l["w"].T.copy()) for l in layers]
    bs = [torch.as_tensor(l["b"]) for l in layers]
    with pytest.raises(ValueError, match="several devices"):
        ik.fused_cc_integral(ws, bs, torch.ones(SHAPE), torch.as_tensor(h), nodes, ccw)


def test_cpu_tensors_run_the_plain_version_without_a_launch(setup):
    layers, h = setup
    before = dict(ik.LAUNCHES)
    _port(layers, _x("pos"), h, 0.01)
    assert ik.LAUNCHES == before
