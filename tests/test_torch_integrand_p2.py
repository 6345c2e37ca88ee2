"""The port's fused integral at pack-2 widths (input and hidden layers at most
64 wide) against the JAX package's pack-2 Pallas kernels in interpret mode
(`fused_cc_integral(..., pack2=True, pack4=False)`), and the route rules
(the pack-4 pair's own cases are in `tests/test_torch_integrand_p4.py`).

On CPU tensors the port runs its plain version, which computes the pack-2
kernels' function (``integrand_fwd_p2.cu`` and ``integrand_bwd_p2.cu`` group
nodes in pairs and sum in another order, and are held against that plain
version on the card by ``chip_smoke.py``); JAX's pack-2 kernels pair the
nodes, pad an odd K with a zero-weight node at t = -1, and fold the two
diagonal weight blocks on the host. Both sides give the exact derivative of
the K-node sum. Tolerances as `tests/test_pallas_kernel.py:61,87`: values
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors, padded_cc_quadrature

SHAPE = (3, 5)
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WIDTHS = {"w31_50_50": [31, 50, 50, 1], "w7_40_24": [7, 40, 24, 1]}


@pytest.fixture(scope="module", params=list(WIDTHS), ids=list(WIDTHS))
def setup(request):
    import jax

    from umnn_tpu.nn.core import mlp_init

    widths = WIDTHS[request.param]
    layers = mlp_init(jax.random.PRNGKey(5), widths)
    layers = [{k: np.array(v) for k, v in l.items()} for l in layers]
    h = np.random.RandomState(6).randn(*SHAPE, widths[0] - 1).astype(np.float32)
    return layers, h


def _x(case):
    x = np.random.RandomState(7).uniform(0.3, 2.5, SHAPE).astype(np.float32)
    if case == "neg":
        return -x
    if case == "zero":
        return np.zeros(SHAPE, np.float32)
    if case == "mixed":
        x[::2] *= -1
        x[:, ::3] = 0
    return x


def _jax_nodes(padded):
    import jax.numpy as jnp

    from umnn_tpu.ops.quadrature import cc_quadrature
    from umnn_tpu.ops.quadrature import padded_cc_quadrature as jax_padded

    if padded:
        return jax_padded(50, 100)
    n, w = cc_quadrature(20)  # K = 21: odd, so JAX's pairs end in a padding node
    return jnp.asarray(n, jnp.float32), jnp.asarray(w, jnp.float32)


def _port_nodes(padded):
    return padded_cc_quadrature(50, 100, "cpu") if padded else cc_tensors(20, "cpu")


def _port(layers, x, h, neg_slope, padded):
    ws = [torch.tensor(l["w"].T).requires_grad_() for l in layers]
    bs = [torch.tensor(l["b"]).requires_grad_() for l in layers]
    xt, ht = torch.tensor(x).requires_grad_(), torch.tensor(h).requires_grad_()
    nodes, ccw = _port_nodes(padded)
    z = ik.fused_cc_integral(ws, bs, xt, ht, nodes, ccw, neg_slope=neg_slope, pack2=True)
    grads = torch.autograd.grad(torch.sin(z).sum(), [*ws, *bs, xt, ht])
    n = len(ws)
    return (
        z.detach().numpy(), [g.numpy() for g in grads[:n]],
        [g.numpy() for g in grads[n : 2 * n]], grads[-2].numpy(), grads[-1].numpy(),
    )


def _jax(layers, x, h, neg_slope, padded):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.ops.integrand_kernel import fused_cc_integral

    nodes, ccw = _jax_nodes(padded)

    def integral(ws, bs, xx, hh):
        return fused_cc_integral(
            ws, bs, xx, hh, nodes, ccw, tile_r=8, interpret=True, neg_slope=neg_slope,
            pack2=True, pack4=False,
        )

    ws = [jnp.asarray(l["w"]) for l in layers]
    bs = [jnp.asarray(l["b"]) for l in layers]
    args = (ws, bs, jnp.asarray(x), jnp.asarray(h))
    z = integral(*args)
    g = jax.grad(lambda *a: jnp.sum(jnp.sin(integral(*a))), argnums=(0, 1, 2, 3))(*args)
    return (
        np.asarray(z), [np.asarray(a).T for a in g[0]], [np.asarray(a) for a in g[1]],
        np.asarray(g[2]), np.asarray(g[3]),
    )


CASES = [
    ("pos", 0.01, False), ("neg", 0.01, False), ("zero", 0.01, False),
    ("mixed", 0.01, False), ("pos", 0.0, False), ("mixed", 0.01, True),
]


@pytest.mark.parametrize("case,neg_slope,padded", CASES, ids=[
    "pos", "neg", "zero", "mixed", "relu", "mixed_padded_101_nodes"])
def test_values_and_gradients_match_jax_pack2_kernels(setup, case, neg_slope, padded):
    layers, h = setup
    x = _x(case)
    z, dws, dbs, dx, dh = _port(layers, x, h, neg_slope, padded)
    jz, jws, jbs, jx, jh = _jax(layers, x, h, neg_slope, padded)
    np.testing.assert_allclose(z, jz, **VALUE_TOL)
    for a, b in zip(dws + dbs, jws + jbs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    np.testing.assert_allclose(dx, jx, **GRAD_TOL)
    np.testing.assert_allclose(dh, jh, **GRAD_TOL)
    if case == "zero":
        assert not z.any() and not any(a.any() for a in dws)


def _both_layouts(sizes):
    """JAX-layout ([din, dout]) zero weights and the port's ([dout, din])."""
    import jax.numpy as jnp

    pairs = list(zip(sizes[:-1], sizes[1:]))
    return [jnp.zeros((a, b)) for a, b in pairs], [torch.zeros(b, a) for a, b in pairs]


ROUTE_SHAPES = {
    # tests/test_pallas_kernel.py:187-200 and the pack-4 cases after it
    "uci": [31, 50, 50, 50, 50, 1], "small": [5, 16, 16, 1],
    "mnist": [31, 100, 50, 50, 50, 50, 1], "wide_input": [65, 50, 1],
    "no_hidden": [31, 1], "pack4_boundary": [31, 32, 32, 1],
    "pack4_input_too_wide": [33, 32, 32, 1], "pack4_no_hidden": [5, 1],
    "pack2_boundary": [64, 64, 64, 1], "hidden_65": [31, 65, 1],
}


@pytest.mark.parametrize("sizes", list(ROUTE_SHAPES.values()), ids=list(ROUTE_SHAPES))
def test_pack_rules_agree_with_jax(sizes):
    from umnn_tpu.ops.integrand_kernel import _pack2_applicable, _pack4_applicable

    jax_ws, port_ws = _both_layouts(sizes)
    assert ik._pack2_applicable(port_ws) == _pack2_applicable(jax_ws)
    assert ik._pack4_applicable(port_ws) == _pack4_applicable(jax_ws)


@pytest.mark.parametrize("sizes,route", [
    ([31, 50, 50, 50, 50, 1], "_p2"),  # the calibration integrand
    ([64, 64, 64, 1], "_p2"),
    ([31, 100, 50, 50, 50, 50, 1], ""),  # MNIST
    ([5, 16, 16, 1], "_p4"),  # pack-4 wins over pack-2, as in JAX
], ids=["calibration", "limit_64", "mnist", "pack4_shape"])
def test_auto_route_takes_pack2_where_jax_auto_does(sizes, route):
    assert ik._route(_both_layouts(sizes)[1], None) == route


# the integrands of the repo's flows: the toy driver at the verify widths,
# the __graft_entry__.py flagship, the calibration flow, MNIST
FLOW_INTEGRANDS = {
    "toy": [11, 32, 32, 1], "flagship": [9, 32, 32, 1],
    "calibration": [31, 50, 50, 50, 50, 1], "mnist_flow": [31, 100, 50, 50, 50, 50, 1],
}
AUTO_SHAPES = {**{k: v for k, v in ROUTE_SHAPES.items() if len(v) > 2}, **FLOW_INTEGRANDS}


@pytest.mark.parametrize("sizes", list(AUTO_SHAPES.values()), ids=list(AUTO_SHAPES))
def test_auto_route_is_jax_auto_route(sizes):
    """JAX's auto (`umnn_tpu/ops/integrand_kernel.py:1334-1343`): pack-4
    where it applies, else pack-2 where it applies, else unpacked."""
    from umnn_tpu.ops.integrand_kernel import _pack2_applicable, _pack4_applicable

    jax_ws, port_ws = _both_layouts(sizes)
    want = "_p4" if _pack4_applicable(jax_ws) else "_p2" if _pack2_applicable(jax_ws) else ""
    assert ik._route(port_ws, None, None) == want


@pytest.mark.parametrize("sizes", [[31, 65, 1], [65, 50, 1]], ids=["hidden_65", "input_65"])
def test_pack2_true_on_widths_it_cannot_take_raises(sizes):
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(b, a, generator=g) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [torch.randn(b, generator=g) for b in sizes[1:]]
    x, h = torch.rand(4), torch.randn(4, sizes[0] - 1)
    nodes, ccw = cc_tensors(10, "cpu")
    with pytest.raises(ValueError, match="pack2=True"):
        ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, pack2=True)
    with pytest.raises(ValueError, match="pack2=True"):
        ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, torch.ones(4), pack2=True)
    # the unpacked route still takes them
    assert ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, pack2=False).shape == (4,)


def test_cpu_pack2_route_launches_nothing(setup):
    layers, h = setup
    before = dict(ik.LAUNCHES)
    _port(layers, _x("mixed"), h, 0.01, False)
    assert ik.LAUNCHES == before
    assert set(before) >= {"integrand_fwd_p2", "integrand_bwd_p2"}
