"""The port's inversion and sampling against the JAX package's, on the same
weights: the Gaussian MADE, the block's and the flow's Jacobi-Newton and
gridded bisection inverses, the flow's ``compute_log_jac_bis``,
``logit_back``, and the route the inverses take to the integral.

Tolerances. The two packages' forwards agree to about 1e-6 here, so their
inverses do too: Newton against JAX within atol 1e-4, its round trip
``max|invert(forward(x)) - x|`` within 2e-4 at 30 iterations (the floor
PARITY_RUNS.md §6 measured on the JAX package at the UCI configuration).
Bisection: the bracket shrinks to one grid cell a round, ``2 x_bound /
(C - 1)^iters``, 2.9e-8 after 10 rounds of 10 candidates, so what is left
is the float32 forward's floor; the routes round the integral differently,
and where two candidates tie to rounding the argmin may take the other,
which costs at most a cell of that round and still brackets the root. So
port against JAX within atol 1e-4 (a few final brackets plus the forward
floor, with room), the round trip within 3e-3 at 10 iterations (the same
section's bisection floor).
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.data.images import ALPHA, logit_back
from umnn_tpu_torch.models import umnn_maf
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.made import MADE

# tests/test_umnn_maf.py's SMALL block
SMALL = dict(embedding_s=4, hidden_embedding=(24, 24), hidden_derivative=(24, 24), nb_steps=20)
NEWTON_ATOL = 1e-4
NEWTON_ROUND_TRIP = 2e-4
BISECT_ATOL = 1e-4
BISECT_ROUND_TRIP = 3e-3
ROWS = 16


def _jax_flow(nb_flow, nb_in, cond_in, seed):
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    flow = JaxFlow(nb_flow=nb_flow, nb_in=nb_in, cond_in=cond_in, **SMALL)
    params = flow.init(jax.random.PRNGKey(seed))
    np_params = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    return flow, params, np_params


def _port_flow(np_params, nb_flow, nb_in, cond_in, backend="auto"):
    flow = UMNNMAFFlow(nb_flow=nb_flow, nb_in=nb_in, cond_in=cond_in, backend=backend,
                       device="cpu", **SMALL)
    return load_jax_flow_params(flow, np_params)


def _inputs(nb_in, cond_in, seed):
    """``x`` as PARITY_RUNS.md §6's sweep draws it (1.5 N(0, 1) clipped to
    +-6), and a context."""
    rs = np.random.RandomState(seed)
    x = np.clip(1.5 * rs.randn(ROWS, nb_in), -6, 6).astype(np.float32)
    ctx = rs.randn(ROWS, cond_in).astype(np.float32) if cond_in else None
    return x, ctx


def _tensor(a):
    return None if a is None else torch.as_tensor(a.copy())


# --- the Gaussian MADE -------------------------------------------------------


def _gaussian_made(nin, hidden, seed):
    import jax

    from umnn_tpu.nn.made import MADE as JaxMADE

    made_j = JaxMADE(nin, tuple(hidden), 2 * nin)
    params = jax.tree_util.tree_map(np.asarray, made_j.init(jax.random.PRNGKey(seed)))
    made_t = MADE(nin, hidden, 2 * nin, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer, p in zip(made_t.layers, params["layers"]):
            layer.weight.copy_(torch.tensor(p["w"].T))
            layer.bias.copy_(torch.tensor(p["b"]))
    return made_j, params, made_t


@pytest.mark.parametrize("nin,hidden", [(6, (48, 48)), (4, (32,)), (5, (20, 20, 20))])
def test_gaussian_made_forward_and_log_likelihood_match_jax(nin, hidden):
    made_j, params, made_t = _gaussian_made(nin, hidden, seed=nin)
    x = np.random.RandomState(nin).randn(7, nin).astype(np.float32)
    z_j = np.asarray(made_j.forward_gaussian(params, x))
    ll_j, zl_j = (np.asarray(a) for a in made_j.log_likelihood(params, x))
    with torch.no_grad():
        z_t = made_t.forward_gaussian(torch.as_tensor(x)).numpy()
        ll_t, zl_t = (a.numpy() for a in made_t.log_likelihood(torch.as_tensor(x)))
    np.testing.assert_allclose(z_t, z_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(zl_t, zl_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5)


@pytest.mark.parametrize("nin,hidden", [(6, (48, 48)), (4, (32,)), (5, (20, 20, 20))])
def test_gaussian_made_invert_round_trips_and_matches_jax(nin, hidden):
    made_j, params, made_t = _gaussian_made(nin, hidden, seed=nin + 10)
    x = np.random.RandomState(nin + 10).randn(7, nin).astype(np.float32)
    with torch.no_grad():
        z = made_t.forward_gaussian(torch.as_tensor(x))
    x_rec = made_t.invert(z)
    np.testing.assert_allclose(x_rec.numpy(), x, rtol=1e-4, atol=1e-5)  # tests/test_made.py:79
    x_jax = np.asarray(made_j.invert(params, z.numpy()))
    np.testing.assert_allclose(x_rec.numpy(), x_jax, rtol=1e-4, atol=1e-5)


def test_gaussian_made_invert_refuses_a_non_gaussian_made():
    made = MADE(4, (16,), 12, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Gaussian MADE"):
        made.invert(torch.zeros(2, 4))


# --- block and flow inverses ---------------------------------------------------


CASES = [(1, 3, 0), (2, 6, 0), (1, 4, 2), (2, 4, 3)]  # (blocks, D, cond_in)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"blocks{c[0]}_D{c[1]}_cond{c[2]}")
def case(request):
    nb_flow, nb_in, cond_in = request.param
    flow_j, params, np_params = _jax_flow(nb_flow, nb_in, cond_in, seed=nb_flow + nb_in + cond_in)
    x, ctx = _inputs(nb_in, cond_in, seed=nb_in + cond_in)
    flow_t = _port_flow(np_params, nb_flow, nb_in, cond_in)
    with torch.no_grad():
        z = flow_t(torch.as_tensor(x), _tensor(ctx))
    return flow_j, params, flow_t, x, ctx, z


@pytest.mark.parametrize("method,iters,atol,round_trip", [
    ("newton", 30, NEWTON_ATOL, NEWTON_ROUND_TRIP),
    ("bisection", 10, BISECT_ATOL, BISECT_ROUND_TRIP),
])
def test_flow_invert_matches_jax_and_round_trips(case, method, iters, atol, round_trip):
    import jax.numpy as jnp

    flow_j, params, flow_t, x, ctx, z = case
    x_t = flow_t.invert(z, iters=iters, context=_tensor(ctx), method=method)
    x_j = np.asarray(flow_j.invert(params, jnp.asarray(z.numpy()), iters=iters,
                                   context=None if ctx is None else jnp.asarray(ctx),
                                   method=method))
    assert not x_t.requires_grad and not x_t.is_inference()
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=atol)
    assert np.abs(x_t.numpy() - x).max() <= round_trip
    with torch.no_grad():
        z_back = flow_t(x_t, _tensor(ctx))
    assert float((z_back - z).abs().max()) <= round_trip


@pytest.mark.parametrize("method,iters,atol,round_trip", [
    ("newton", 30, NEWTON_ATOL, NEWTON_ROUND_TRIP),
    ("bisection", 10, BISECT_ATOL, BISECT_ROUND_TRIP),
])
def test_block_invert_matches_jax_and_round_trips(case, method, iters, atol, round_trip):
    import jax.numpy as jnp

    flow_j, params, flow_t, x, ctx, _ = case
    block_t, block_j, p = flow_t.blocks[0], flow_j.block, params[0]
    jctx = None if ctx is None else jnp.asarray(ctx)
    with torch.no_grad():
        z = block_t(torch.as_tensor(x), _tensor(ctx))
    if method == "newton":
        x_t = block_t.invert_newton(z, iters, _tensor(ctx))
        x_j = block_j.invert_newton(p, jnp.asarray(z.numpy()), iters, jctx)
    else:
        x_t = block_t.invert(z, iters, _tensor(ctx))
        x_j = block_j.invert(p, jnp.asarray(z.numpy()), iters, jctx)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=atol)
    assert np.abs(x_t.numpy() - x).max() <= round_trip


def test_flow_compute_log_jac_bis_matches_jax(case):
    import jax.numpy as jnp

    flow_j, params, flow_t, x, ctx, _ = case
    z_j, lj_j = flow_j.compute_log_jac_bis(params, jnp.asarray(x),
                                           None if ctx is None else jnp.asarray(ctx))
    with torch.no_grad():
        z_t, lj_t = flow_t.compute_log_jac_bis(torch.as_tensor(x), _tensor(ctx))
        ll_t, z_ll = flow_t.compute_ll(torch.as_tensor(x), _tensor(ctx))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lj_t.numpy(), np.asarray(lj_j), rtol=1e-5, atol=1e-6)
    # the same z as compute_ll's, and its log-Jacobian sums to the same ll
    torch.testing.assert_close(z_t, z_ll)
    gauss = -0.5 * (np.log(2 * np.pi) + z_t.numpy() ** 2).sum(-1)
    np.testing.assert_allclose(lj_t.numpy().sum(-1) + gauss, ll_t.numpy(), rtol=1e-5)


def test_sample_inverts_draws_of_its_generator(case):
    _, _, flow_t, _, ctx, _ = case
    n = ROWS
    c = _tensor(ctx)
    s1 = flow_t.sample(n, torch.Generator().manual_seed(5), iters=4, context=c)
    s2 = flow_t.sample(n, torch.Generator().manual_seed(5), iters=4, context=c)
    z = torch.randn(n, flow_t.nb_in, generator=torch.Generator().manual_seed(5))
    assert s1.shape == (n, flow_t.nb_in) and bool(torch.isfinite(s1).all())
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    torch.testing.assert_close(s1, flow_t.invert(z, 4, c), rtol=0, atol=0)
    newton = flow_t.sample(n, torch.Generator().manual_seed(5), iters=30, context=c,
                           method="newton")
    assert bool(torch.isfinite(newton).all())


def test_invert_refuses_an_unknown_method(case):
    _, _, flow_t, _, _, z = case
    with pytest.raises(ValueError, match="method"):
        flow_t.invert(z, method="secant")


# --- what the inverses call ------------------------------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """``fused_cc_integral`` as the block calls it, recorded: the shapes of
    its ``x`` and ``h`` and whether inference mode was on; it still
    computes (the plain version, on CPU tensors)."""
    calls = []
    real = umnn_maf.fused_cc_integral

    def record(ws, bs, x, h, *args, **kw):
        calls.append((tuple(x.shape), tuple(h.shape), torch.is_inference_mode_enabled(),
                      x.is_contiguous() and h.is_contiguous()))
        return real(ws, bs, x, h, *args, **kw)

    monkeypatch.setattr(umnn_maf, "fused_cc_integral", record)
    return calls


@pytest.mark.parametrize("nb_flow,nb_in,cond_in", [(2, 4, 0), (1, 3, 2)])
def test_inverses_call_fused_cc_integral_on_the_kernel_route(recorded, nb_flow, nb_in, cond_in):
    """On the kernel route (``backend="kernel"``; ``"auto"`` on the card)
    bisection computes its candidates' integrals with one
    ``fused_cc_integral`` call a round, ``x [B, C]``, ``h [B, C, e]``
    contiguous: blocks x D x iters calls; Newton one call an iteration on
    the block's ``x [B, D]``, ``h [B, D, e]``: blocks x iters; all under
    inference mode. On the CPU the wrapper runs its plain version, so the
    inverses agree with the plain route's."""
    _, _, np_params = _jax_flow(nb_flow, nb_in, cond_in, seed=3)
    x, ctx = _inputs(nb_in, cond_in, seed=4)
    kernel = _port_flow(np_params, nb_flow, nb_in, cond_in, backend="kernel")
    plain = _port_flow(np_params, nb_flow, nb_in, cond_in, backend="torch")
    with torch.no_grad():
        z = plain(torch.as_tensor(x), _tensor(ctx))
    e, C, iters = SMALL["embedding_s"], 7, 5
    recorded.clear()
    x_k = kernel.invert(z, iters, _tensor(ctx), nb_candidates=C)
    assert recorded == [((ROWS, C), (ROWS, C, e), True, True)] * (nb_flow * nb_in * iters)
    recorded.clear()
    x_p = plain.invert(z, iters, _tensor(ctx), nb_candidates=C)
    assert recorded == []  # the plain route computes JAX's integrate itself
    np.testing.assert_allclose(x_k.numpy(), x_p.numpy(), rtol=0, atol=BISECT_ATOL)
    x_n = kernel.invert(z, 30, _tensor(ctx), method="newton")
    assert recorded == [((ROWS, nb_in), (ROWS, nb_in, e), True, True)] * (nb_flow * 30)
    np.testing.assert_allclose(x_n.numpy(), plain.invert(z, 30, _tensor(ctx), method="newton"),
                               rtol=0, atol=NEWTON_ATOL)


def test_the_candidate_grid_is_jax_linspace_to_the_bit():
    import jax.numpy as jnp

    for n in (1, 2, 7, 10, 11, 20, 33, 101):
        want = np.asarray(jnp.linspace(0.0, 1.0, n))
        got = umnn_maf._unit_grid(n, torch.float32, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


# --- logit_back ------------------------------------------------------------------


def test_logit_back_matches_jax_bit_for_bit():
    from umnn_tpu.data.images import ALPHA as JAX_ALPHA
    from umnn_tpu.data.images import logit_back as jax_logit_back

    assert ALPHA == JAX_ALPHA
    x = (np.random.RandomState(0).randn(5, 784) * 6).astype(np.float32)
    x[0, :4] = [0.0, -14.0, 14.0, 40.0]
    want = jax_logit_back(x)
    for given in (x, torch.as_tensor(x)):
        got = logit_back(given)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
