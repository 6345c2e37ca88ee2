"""The integrands the staged kernel pairs refuse, which the streamed pair
(``csrc/integrand_wide.cu``) takes on the card: a hidden layer wider than 128
and more than MAX_LAYERS (8) layers.

On CPU tensors the port runs its plain versions, the functions the streamed
pair computes (``chip_smoke.py``'s phase ``wide`` holds the pair against them
on the card). Here they are held against the JAX package's unpacked Pallas
kernels in interpret mode (`fused_cc_integral(..., pack2=False,
pack4=False)`), which take any width by padding every layer to 128-lane
multiples, on JAX's weights carried over in ``nn.Linear``'s layout and numpy
inputs from a seed. Tolerances as `tests/test_pallas_kernel.py:61,87`: values
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6. Also the streamed
pair's chunk plan, a pure function.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors

SHAPE = (2, 3)
K = 5
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WIDTHS = {"w7_136_24_1": [7, 136, 24, 1], "nine_layers": [7] + [12] * 8 + [1]}


@pytest.fixture(scope="module", params=list(WIDTHS), ids=list(WIDTHS))
def setup(request):
    import jax

    from umnn_tpu.nn.core import mlp_init

    widths = WIDTHS[request.param]
    layers = mlp_init(jax.random.PRNGKey(3), widths)
    layers = [{k: np.array(v) for k, v in l.items()} for l in layers]
    rng = np.random.RandomState(4)
    h = rng.randn(*SHAPE, widths[0] - 1).astype(np.float32)
    g = rng.randn(*SHAPE).astype(np.float32)
    return layers, h, g


def _x(case):
    x = np.random.RandomState(5).uniform(0.3, 2.5, SHAPE).astype(np.float32)
    if case == "mixed":
        x[0] *= -1
        x[1, 1] = 0
    return x


def _port(layers, x, h, g):
    ws = [torch.tensor(l["w"].T).requires_grad_() for l in layers]
    bs = [torch.tensor(l["b"]).requires_grad_() for l in layers]
    xt, ht = torch.tensor(x).requires_grad_(), torch.tensor(h).requires_grad_()
    nodes, ccw = cc_tensors(K - 1, "cpu")
    z = ik.fused_cc_integral(ws, bs, xt, ht, nodes, ccw)
    grads = torch.autograd.grad(z, [*ws, *bs, xt, ht], torch.tensor(g))
    direct = ik.fused_cc_integral_bwd(
        [w.detach() for w in ws], [b.detach() for b in bs], xt.detach(), ht.detach(), nodes,
        ccw, torch.tensor(g))
    return z.detach().numpy(), [t.numpy() for t in grads], direct


def _jax(layers, x, h, g):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.ops.integrand_kernel import fused_cc_integral
    from umnn_tpu.ops.quadrature import cc_quadrature

    n, w = cc_quadrature(K - 1)
    nodes, ccw = jnp.asarray(n, jnp.float32), jnp.asarray(w, jnp.float32)

    def integral(ws, bs, xx, hh):
        return fused_cc_integral(ws, bs, xx, hh, nodes, ccw, tile_r=8, interpret=True,
                                 pack2=False, pack4=False)

    args = ([jnp.asarray(l["w"]) for l in layers], [jnp.asarray(l["b"]) for l in layers],
            jnp.asarray(x), jnp.asarray(h))
    z, vjp = jax.vjp(integral, *args)
    dws, dbs, dx, dh = vjp(jnp.asarray(g))
    return np.asarray(z), [np.asarray(a).T for a in dws] + [np.asarray(a) for a in dbs] + [
        np.asarray(dx), np.asarray(dh)]


@pytest.mark.parametrize("case", ["pos", "mixed"])
def test_values_and_gradients_match_jax_unpacked_kernels(setup, case):
    layers, h, g = setup
    x = _x(case)
    z, grads, direct = _port(layers, x, h, g)
    jz, jgrads = _jax(layers, x, h, g)
    np.testing.assert_allclose(z, jz, **VALUE_TOL)
    assert len(grads) == len(jgrads)
    for a, b in zip(grads, jgrads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    # the backward's own entry point gives the same gradients, and S
    dws, dbs, dx, dh, S = direct
    for a, b in zip([*dws, *dbs, dx, dh], jgrads):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL)
    want_S = np.divide(2 * jz, x, out=np.zeros_like(jz), where=x != 0)
    np.testing.assert_allclose(S.numpy()[x != 0], want_S[x != 0], rtol=1e-5, atol=1e-6)


def test_values_past_128_in_the_last_hidden_layer_match_jax():
    """7-136-1: values only. JAX's unpacked backward cannot take a last
    hidden layer past 128 lanes (the output layer's dW row is kept in one
    128-lane row of a padded block, `umnn_tpu/ops/integrand_kernel.py:
    273-278`, which fails to broadcast in interpret mode); the card holds
    the streamed pair's gradients at 31-129-1 against float64."""
    import jax
    import jax.numpy as jnp

    from umnn_tpu.nn.core import mlp_init
    from umnn_tpu.ops.integrand_kernel import fused_cc_integral
    from umnn_tpu.ops.quadrature import cc_quadrature

    layers = mlp_init(jax.random.PRNGKey(3), [7, 136, 1])
    rng = np.random.RandomState(4)
    h = rng.randn(*SHAPE, 6).astype(np.float32)
    x = _x("mixed")
    n, w = cc_quadrature(K - 1)
    jz = fused_cc_integral([l["w"] for l in layers], [l["b"] for l in layers], jnp.asarray(x),
                           jnp.asarray(h), jnp.asarray(n, jnp.float32),
                           jnp.asarray(w, jnp.float32), tile_r=8, interpret=True, pack2=False,
                           pack4=False)
    nodes, ccw = cc_tensors(K - 1, "cpu")
    z = ik.fused_cc_integral([torch.tensor(np.array(l["w"]).T) for l in layers],
                             [torch.tensor(np.array(l["b"])) for l in layers], torch.tensor(x),
                             torch.tensor(h), nodes, ccw)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **VALUE_TOL)


def test_both_sets_are_ones_the_staged_kernels_refuse():
    """Past 128 wide (MAX_WIDTH of the unpacked pair) and past MAX_LAYERS."""
    wide, deep = WIDTHS["w7_136_24_1"], WIDTHS["nine_layers"]
    assert max(wide[1:-1]) > 128
    assert len(deep) - 1 > 8


@pytest.mark.parametrize("R, K_, widths, budget", [
    (3000, 51, [31, 256, 256, 256, 256, 1], ik.WIDE_BUDGET),   # two chunks
    (64, 51, [31, 129, 1], ik.WIDE_BUDGET),                    # one chunk
    (1003, 7, [5, 300, 200, 1], 7 * 300 * 2 * 4 * 10),         # ten rows a chunk
    (5, 101, [5, 4096, 4096, 1], 1),                           # a row past the budget
    (0, 51, [31, 129, 1], ik.WIDE_BUDGET),                     # no rows, no chunk
], ids=["timing_block", "one_chunk", "ragged_last", "row_past_budget", "empty"])
def test_chunk_plan_covers_every_row_once_in_order_within_the_budget(R, K_, widths, budget):
    chunks = ik._wide_chunks(R, K_, widths, budget)
    covered = [r for a, b in chunks for r in range(a, b)]
    assert covered == list(range(R))
    assert all(b > a for a, b in chunks)
    per_row = 4 * (len(widths) - 2) * K_ * max(widths[1:-1])
    sizes = [b - a for a, b in chunks]
    assert all(n * per_row <= budget or n == 1 for n in sizes)
    # as few chunks as the budget allows: all but the last are full
    assert all(n == sizes[0] for n in sizes[:-1])
    if len(sizes) > 1:
        assert (sizes[0] + 1) * per_row > budget
