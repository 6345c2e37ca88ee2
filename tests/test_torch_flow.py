"""The port's UMNN-MAF flow against the JAX package's, on the same weights.

Weights are made in JAX and carried across by the bridge; inputs come from
numpy. Tolerance on ``ll``: rtol 1e-5, atol 1e-4, because ``ll`` sums
D=8 per-dimension terms of two blocks, each term a float32 value of order
one to ten whose rounding differs between the two packages (matmul
blocking, the order of the node sum); ``z`` and bpp are per-element and
held to atol 1e-5.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import flow_params_to_numpy, load_jax_flow_params
from umnn_tpu_torch.models.flow import UMNNMAFFlow

CFG = dict(
    nb_flow=2, nb_in=8, hidden_derivative=(24, 24), hidden_embedding=(32, 32),
    embedding_s=4, nb_steps=20,
)
B = 16
LL_TOL = dict(rtol=1e-5, atol=1e-4)
Z_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    params = JaxFlow(**CFG).init(jax.random.PRNGKey(0))
    # a non-zero frozen scaling, so that the exp(s) factor is exercised
    rng = np.random.RandomState(5)
    return [
        {**jax.tree_util.tree_map(np.asarray, p), "scaling": 0.1 * rng.randn(CFG["nb_in"]).astype(np.float32)}
        for p in params
    ]


@pytest.fixture(scope="module")
def x():
    return (2.0 * np.random.RandomState(1).randn(B, CFG["nb_in"])).astype(np.float32)


def _jax_flow(backend):
    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    return JaxFlow(**CFG, backend=backend)


def _port_flow(jax_params, backend):
    return load_jax_flow_params(UMNNMAFFlow(**CFG, backend=backend, device="cpu"), jax_params)


@pytest.mark.parametrize("backend", ["torch", "kernel", "auto"])
def test_compute_ll_matches_jax_xla(jax_params, x, backend):
    ll_j, z_j = _jax_flow("xla").compute_ll(jax_params, x)
    with torch.no_grad():
        ll_t, z_t = _port_flow(jax_params, backend).compute_ll(torch.as_tensor(x))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), **LL_TOL)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **Z_TOL)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_compute_bpp_matches_jax_xla(jax_params, x, backend):
    bpp_j, ll_j, _ = _jax_flow("xla").compute_bpp(jax_params, x)
    with torch.no_grad():
        bpp_t, ll_t, _ = _port_flow(jax_params, backend).compute_bpp(torch.as_tensor(x))
    assert np.isfinite(bpp_t.numpy()).all()
    np.testing.assert_allclose(bpp_t.numpy(), np.asarray(bpp_j), **Z_TOL)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), **LL_TOL)


def test_compute_ll_matches_jax_pallas_interpret(jax_params, x):
    """JAX's fused-kernel path (interpret mode on the CPU) against the port's
    kernel backend (its plain version on the CPU)."""
    ll_j, z_j = _jax_flow("pallas").compute_ll(jax_params, x)
    with torch.no_grad():
        ll_t, z_t = _port_flow(jax_params, "kernel").compute_ll(torch.as_tensor(x))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), **LL_TOL)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **Z_TOL)


def test_forward_log_jac_and_ll_bis_match_jax(jax_params, x):
    flow_j = _jax_flow("xla")
    flow_t = _port_flow(jax_params, "torch")
    xt = torch.as_tensor(x)
    with torch.no_grad():
        np.testing.assert_allclose(
            flow_t(xt).numpy(), np.asarray(flow_j.forward(jax_params, x)), **Z_TOL
        )
        np.testing.assert_allclose(
            flow_t.compute_log_jac(xt).numpy(),
            np.asarray(flow_j.compute_log_jac(jax_params, x)), **Z_TOL,
        )
        lb_t, z_t = flow_t.compute_ll_bis(xt)
    lb_j, z_j = flow_j.compute_ll_bis(jax_params, x)
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_j), **Z_TOL)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **Z_TOL)


def test_block_compute_ll_clips_like_jax(jax_params, x):
    from umnn_tpu.models.umnn_maf import UMNNMAF as JaxBlock

    cfg = {k: v for k, v in CFG.items() if k not in ("nb_flow", "nb_in")}
    block_j = JaxBlock(input_size=CFG["nb_in"], backend="xla", **cfg)
    block_t = _port_flow(jax_params, "torch").blocks[0]
    big = 20.0 * x  # drives some z past the +-10 guard
    ll_j, z_j = block_j.compute_ll(jax_params[0], big)
    with torch.no_grad():
        ll_t, z_t = block_t.compute_ll(torch.as_tensor(big))
    assert np.abs(np.asarray(z_j)).max() == 10.0
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **Z_TOL)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize(
    "cfg", [dict(act_func="Sigmoid"), dict(hidden_derivative=())], ids=["not_elu", "no_hidden_layer"]
)
def test_kernel_backend_raises_for_an_integrand_it_cannot_take(x, cfg):
    """The kernel route never falls back to the plain quadrature."""
    flow = UMNNMAFFlow(**{**CFG, **cfg}, backend="kernel", device="cpu")
    with torch.no_grad(), pytest.raises(ValueError):
        flow.compute_ll(torch.as_tensor(x))


def test_auto_backend_on_cpu_takes_the_plain_path_for_any_integrand(x):
    kw = {**CFG, "act_func": "Sigmoid", "seed": 3, "device": "cpu"}
    with torch.no_grad():
        ll_a, z_a = UMNNMAFFlow(**kw, backend="auto").compute_ll(torch.as_tensor(x))
        ll_t, z_t = UMNNMAFFlow(**kw, backend="torch").compute_ll(torch.as_tensor(x))
    assert torch.equal(ll_a, ll_t) and torch.equal(z_a, z_t)


def test_bridge_round_trip(jax_params):
    back = flow_params_to_numpy(_port_flow(jax_params, "torch"))
    for p, q in zip(back, jax_params):
        np.testing.assert_array_equal(p["scaling"], q["scaling"])
        for name in ("made", "integrand"):
            for a, b in zip(p["net"][name]["layers"], q["net"][name]["layers"]):
                np.testing.assert_array_equal(a["w"], b["w"])
                np.testing.assert_array_equal(a["b"], b["b"])


def test_bridge_rejects_other_widths(jax_params):
    other = UMNNMAFFlow(**{**CFG, "hidden_derivative": (24, 16)}, device="cpu")
    with pytest.raises(ValueError):
        load_jax_flow_params(other, jax_params)


def test_synthetic_mnist_ar1_equals_jax():
    from umnn_tpu.data.images import synthetic_mnist_ar1 as jax_ar1

    from umnn_tpu_torch.data.images import synthetic_mnist_ar1

    kw = dict(rho=0.7, seed=3, n=(6, 2, 5), d=20)
    data_t, floor_t = synthetic_mnist_ar1(**kw)
    data_j, floor_j = jax_ar1(**kw)
    assert floor_t == floor_j
    for name in ("trn_x", "val_x", "tst_x"):
        np.testing.assert_array_equal(getattr(data_t, name), getattr(data_j, name))
