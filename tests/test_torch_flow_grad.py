"""Gradients of the port's UMNN-MAF flow against the JAX package's, on the
same weights (made in JAX, carried across by the bridge, scaling 0 as JAX's
init makes it) and the same inputs.

The port's ``"kernel"`` backend (on the CPU: the fused integral's plain
version under autograd, the exact derivative of the node sum) is held
against JAX's ``"pallas"`` (interpret mode); ``"torch"`` (the Leibniz-rule
backward) against JAX's ``"xla"``. Tolerance on every parameter gradient
of ``-mean(compute_ll)``: rtol 1e-4, atol 1e-5. The loss sums 8 dimensions
x 2 blocks of float32 terms of order one to ten, each gradient entry sums
16 rows, and the two packages round matmuls and node sums in other orders.
Measured on the CPU: max abs error 1.9e-6 (kernel route) and 1.3e-5
(Leibniz route, on a gradient of order 1e2), at most 6% of the tolerance.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.models.flow import UMNNMAFFlow

CFG = dict(
    nb_flow=2, nb_in=8, hidden_derivative=(24, 24), hidden_embedding=(32, 32),
    embedding_s=4, nb_steps=20,
)
B = 16
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SCALE_PAST_CLIP = 4.0  # drives some of block 0's z past +-10


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    params = JaxFlow(**CFG).init(jax.random.PRNGKey(1))
    return [jax.tree_util.tree_map(np.asarray, p) for p in params]


@pytest.fixture(scope="module")
def x():
    return (1.5 * np.random.RandomState(2).randn(B, CFG["nb_in"])).astype(np.float32)


def _jax_grads(params, x, backend, **cfg):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    flow = JaxFlow(**{**CFG, **cfg}, backend=backend)
    loss = lambda p: -jnp.mean(flow.compute_ll(p, jnp.asarray(x))[0])  # noqa: E731
    value, grads = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    return float(value), grads


def _port_grads(params, x, backend, **cfg):
    flow = load_jax_flow_params(
        UMNNMAFFlow(**{**CFG, **cfg}, backend=backend, device="cpu"), params
    )
    loss = -flow.compute_ll(torch.as_tensor(x))[0].mean()
    loss.backward()
    return loss.item(), flow


def _compare(flow, grads):
    n = 0
    for block, g in zip(flow.blocks, grads):
        if g is None:  # a block left out of the loss
            n += sum(1 for _ in block.parameters())
            continue
        assert block.scaling.grad is None and not block.scaling.requires_grad
        np.testing.assert_array_equal(np.asarray(g["scaling"]), 0.0)  # stop_gradient
        for name, layers in (("made", block.net.made.layers), ("integrand", block.net.integrand.layers)):
            for layer, lg in zip(layers, g["net"][name]["layers"]):
                np.testing.assert_allclose(
                    layer.weight.grad.numpy(), np.asarray(lg["w"]).T, **GRAD_TOL
                )
                np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(lg["b"]), **GRAD_TOL)
                n += 2
    assert n == sum(1 for _ in flow.parameters())


@pytest.mark.parametrize("port,jax_backend", [("kernel", "pallas"), ("torch", "xla")])
def test_every_parameter_gradient_matches_jax(jax_params, x, port, jax_backend):
    v_j, g_j = _jax_grads(jax_params, x, jax_backend)
    v_t, flow = _port_grads(jax_params, x, port)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    _compare(flow, g_j)


def test_the_two_routes_differ_only_by_the_quadrature_error(jax_params, x):
    """The kernel route differentiates the node sum (x's node path
    included); the Leibniz route takes f(x) for dz/dx. At 21 nodes the
    two parameter gradients agree to the quadrature's accuracy."""
    _, flow_k = _port_grads(jax_params, x, "kernel")
    _, flow_t = _port_grads(jax_params, x, "torch")
    gaps = [
        float((a.grad - b.grad).abs().max() / (b.grad.abs().max() + 1e-12))
        for a, b in zip(flow_k.parameters(), flow_t.parameters())
    ]
    assert 0.0 < max(gaps) < 1e-2


def test_clip_passes_no_gradient_beyond_ten(jax_params, x):
    """A block's ``torch.clamp(z, -10, 10)`` passes no gradient where
    |z| > 10, as ``jnp.clip``: on inputs that drive some z past the guard,
    the block's gradients still match JAX's."""
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.umnn_maf import UMNNMAF as JaxBlock

    cfg = {k: v for k, v in CFG.items() if k not in ("nb_flow", "nb_in")}
    big = SCALE_PAST_CLIP * x
    block_j = JaxBlock(input_size=CFG["nb_in"], backend="xla", **cfg)
    loss_j = lambda p: -jnp.mean(block_j.compute_ll(p, jnp.asarray(big))[0])  # noqa: E731
    p0 = jax.tree_util.tree_map(jnp.asarray, jax_params[0])
    v_j, g_j = jax.value_and_grad(loss_j)(p0)

    flow = load_jax_flow_params(UMNNMAFFlow(**CFG, backend="torch", device="cpu"), jax_params)
    ll, z = flow.blocks[0].compute_ll(torch.as_tensor(big))
    loss = -ll.mean()
    loss.backward()
    clipped = z.abs() == 10.0
    assert clipped.any() and not clipped.all()
    np.testing.assert_allclose(loss.item(), float(v_j), rtol=1e-5)
    _compare(flow, [g_j, None])
