"""The port's fused integral at pack-4 widths (input and hidden layers at most
32 wide) against the JAX package's pack-4 Pallas kernels in interpret mode
(`fused_cc_integral(..., pack4=True)`), and the pack-4 route rules.

On CPU tensors the port runs its plain version, which computes the pack-4
kernels' function (``integrand_fwd_p4.cu`` and ``integrand_bwd_p4.cu`` group
nodes in fours and sum in another order, and are held against that plain
version on the card by ``chip_smoke.py``); JAX's pack-4 kernels put four
nodes on one matmul row through diag(W, W, W, W), pad K to a multiple of 4
with zero-weight nodes at t = -1 (K = 17 here: three padding nodes), and
fold the diagonal weight blocks on the host. Both sides give the exact
derivative of the K-node sum. Tolerances as `tests/test_pallas_kernel.py:61,87`:
values rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors, padded_cc_quadrature

SHAPE = (3, 5)
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# the toy driver's integrand at the verify widths, and a narrower one
WIDTHS = {"w11_32_32": [11, 32, 32, 1], "w5_16_16": [5, 16, 16, 1]}
N_STEPS = 16  # K = 17 nodes


@pytest.fixture(scope="module", params=list(WIDTHS), ids=list(WIDTHS))
def setup(request):
    import jax

    from umnn_tpu.nn.core import mlp_init

    widths = WIDTHS[request.param]
    layers = mlp_init(jax.random.PRNGKey(8), widths)
    layers = [{k: np.array(v) for k, v in l.items()} for l in layers]
    h = np.random.RandomState(9).randn(*SHAPE, widths[0] - 1).astype(np.float32)
    return layers, h


def _x(case):
    x = np.random.RandomState(10).uniform(0.3, 2.5, SHAPE).astype(np.float32)
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
    n, w = cc_quadrature(N_STEPS)
    return jnp.asarray(n, jnp.float32), jnp.asarray(w, jnp.float32)


def _port_nodes(padded):
    return padded_cc_quadrature(50, 100, "cpu") if padded else cc_tensors(N_STEPS, "cpu")


def _port(layers, x, h, neg_slope, padded):
    ws = [torch.tensor(l["w"].T).requires_grad_() for l in layers]
    bs = [torch.tensor(l["b"]).requires_grad_() for l in layers]
    xt, ht = torch.tensor(x).requires_grad_(), torch.tensor(h).requires_grad_()
    nodes, ccw = _port_nodes(padded)
    z = ik.fused_cc_integral(ws, bs, xt, ht, nodes, ccw, neg_slope=neg_slope, pack4=True)
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
            pack4=True,
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
def test_values_and_gradients_match_jax_pack4_kernels(setup, case, neg_slope, padded):
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


def _ws(sizes):
    return [torch.zeros(b, a) for a, b in zip(sizes[:-1], sizes[1:])]


@pytest.mark.parametrize("pack2,pack4,route", [
    (None, None, "_p4"),  # auto: pack-4 wins over pack-2
    (True, None, "_p4"),  # ... whatever pack2 says, as in JAX
    (None, False, "_p2"),  # pack4=False falls to pack-2's auto
    (True, False, "_p2"),
    (False, False, ""),
    (False, True, "_p4"),
], ids=["auto", "pack2_true", "pack4_false", "pack2_only", "unpacked", "pack4_true"])
def test_pack4_route_rules_follow_jax(pack2, pack4, route):
    assert ik._route(_ws([11, 32, 32, 1]), pack2, pack4) == route


@pytest.mark.parametrize("sizes", [[31, 33, 1], [33, 32, 1]], ids=["hidden_33", "input_33"])
def test_pack4_true_on_widths_it_cannot_take_raises(sizes):
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(b, a, generator=g) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [torch.randn(b, generator=g) for b in sizes[1:]]
    x, h = torch.rand(4), torch.randn(4, sizes[0] - 1)
    nodes, ccw = cc_tensors(10, "cpu")
    with pytest.raises(ValueError, match="pack4=True"):
        ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, pack4=True)
    with pytest.raises(ValueError, match="pack4=True"):
        ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, torch.ones(4), pack4=True)
    # auto takes them on the pack-2 pair
    assert ik._route(ws, None, None) == "_p2"
    assert ik.fused_cc_integral(ws, bs, x, h, nodes, ccw).shape == (4,)


def test_cpu_pack4_route_launches_nothing(setup):
    layers, h = setup
    before = dict(ik.LAUNCHES)
    _port(layers, _x("mixed"), h, 0.01, False)
    assert ik.LAUNCHES == before
    assert set(before) >= {"integrand_fwd_p4", "integrand_bwd_p4"}


def test_block_pack_fields_reach_the_integral(monkeypatch):
    """UMNNMAF's pack2/pack4 (JAX's pallas_pack2/pallas_pack4) go to
    fused_cc_integral on the kernel route, one block at a time."""
    from umnn_tpu_torch.models import umnn_maf
    from umnn_tpu_torch.models.flow import UMNNMAFFlow

    seen, real = [], umnn_maf.fused_cc_integral

    def spy(*args, **kw):
        seen.append((kw["pack2"], kw["pack4"]))
        return real(*args, **kw)

    monkeypatch.setattr(umnn_maf, "fused_cc_integral", spy)
    flow = UMNNMAFFlow(nb_flow=2, nb_in=2, hidden_derivative=(40,), hidden_embedding=(8,),
                       embedding_s=2, backend="kernel", device="cpu")
    flow.blocks[1].pack2, flow.blocks[1].pack4 = True, False
    with torch.no_grad():
        flow.compute_ll(torch.randn(4, 2))
        assert seen == [(None, None), (True, False)]
        flow.blocks[0].pack4 = True  # a 40-wide layer: pack-4 cannot take it
        with pytest.raises(ValueError, match="pack4=True"):
            flow.compute_ll(torch.randn(4, 2))
