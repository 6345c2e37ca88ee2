"""The node-sequential "CC" solver, the quadrature oracle, and the
accumulation and evaluation steps of the port, against the JAX package's
`umnn_tpu/ops/quadrature.py:183-248`, `umnn_tpu/models/umnn_maf.py:318-332`
and `umnn_tpu/training/loops.py:209-266`.

Tolerances as `tests/test_pallas_kernel.py:61,87`: values rtol 1e-5,
gradients rtol 1e-4 (atol 1e-6 for entries near 0). The accumulation
step's gradients are read from a transformation that keeps them as its
state, so JAX's are exact, not recovered from updated parameters.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import flow_params_to_numpy, load_jax_flow_params
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.core import MLP
from umnn_tpu_torch.ops import quadrature as tq
from umnn_tpu_torch.training import loops as tl

VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SIZES = [3, 16, 16, 1]  # [x, h] of width 1 + 2 -> one positive value
FLOW = dict(nb_in=4, hidden_derivative=(16, 16), hidden_embedding=(16,), embedding_s=3,
            nb_steps=12)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# --- integrate_sequential and integrate_autodiff ---------------------------------


def _mlp_case():
    import jax

    from umnn_tpu.nn.core import mlp_init

    layers = jax.tree_util.tree_map(np.asarray, mlp_init(jax.random.PRNGKey(1), SIZES))
    mlp = MLP(SIZES, torch.Generator(), "LeakyReLU", "ELUPlus", device="cpu")
    with torch.no_grad():
        for layer, lp in zip(mlp.layers, layers):
            layer.weight.copy_(torch.tensor(lp["w"].T))
            layer.bias.copy_(torch.tensor(lp["b"]))
    rng = np.random.RandomState(2)
    x0 = rng.uniform(-1.0, 0.0, (6, 1)).astype(np.float32)
    xT = rng.uniform(0.0, 2.0, (6, 1)).astype(np.float32)
    h = rng.randn(6, 2).astype(np.float32)
    g = rng.randn(6, 1).astype(np.float32)
    return layers, mlp, x0, xT, h, g


@pytest.mark.parametrize("inv_f", [False, True])
@pytest.mark.parametrize("rule", ["sequential", "autodiff"])
def test_quadrature_rules_match_jax_values_and_gradients(rule, inv_f):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.nn.core import ACTIVATIONS, mlp_apply
    from umnn_tpu.ops import quadrature as jq

    layers, mlp, x0, xT, h, g = _mlp_case()
    n_steps = 10

    def f_j(p, xx, hh):
        return mlp_apply(p, jnp.concatenate([xx, hh], -1), ACTIVATIONS["LeakyReLU"],
                         ACTIVATIONS["ELUPlus"])

    def loss_j(p, a, b, hh):
        if rule == "sequential":
            n, w = jq.cc_quadrature(n_steps)
            z = jq.integrate_sequential(f_j, p, a, b, hh, jnp.asarray(n, jnp.float32),
                                        jnp.asarray(w, jnp.float32), inv_f)
        else:
            z = jq.integrate_autodiff(f_j, p, a, b, hh, n_steps, inv_f)
        return jnp.sum(z * g), z

    (_, z_j), grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True)(
        layers, jnp.asarray(x0), jnp.asarray(xT), jnp.asarray(h))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x0, xT, h)]

    def f_t(xx, hh):
        return mlp(torch.cat([xx, hh], -1))

    if rule == "sequential":
        nodes, weights = tq.cc_tensors(n_steps, "cpu")
        z = tq.integrate_sequential(f_t, *leaves, nodes, weights, inv_f)
    else:
        z = tq.integrate_autodiff(f_t, *leaves, n_steps, inv_f)
    (z * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), **VALUE_TOL)
    dlayers, *dleaves = grads_j
    for layer, lp in zip(mlp.layers, dlayers):
        np.testing.assert_allclose(layer.weight.grad.numpy().T, np.asarray(lp["w"]), **GRAD_TOL)
        np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(lp["b"]), **GRAD_TOL)
    for t, want in zip(leaves, dleaves):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD_TOL)


def test_sequential_matches_the_megabatch_and_keeps_no_graph_in_inference():
    _, mlp, x0, xT, h, _ = _mlp_case()
    nodes, weights = tq.cc_tensors(10, "cpu")

    def f_t(xx, hh):
        return mlp(torch.cat([xx, hh], -1))

    args = [torch.tensor(a) for a in (x0, xT, h)]
    with torch.inference_mode():
        z_seq = tq.integrate_sequential(f_t, *args, nodes, weights)
        z_all = tq.integrate(f_t, *args, nodes, weights)
    assert z_seq.grad_fn is None
    np.testing.assert_allclose(z_seq.numpy(), z_all.numpy(), **VALUE_TOL)


# --- the "CC" solver in the block and the flow -------------------------------------


def _jax_flow(solver, nb_flow, cond_in, backend="xla"):
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    model = JaxFlow(nb_flow=nb_flow, solver=solver, cond_in=cond_in, backend=backend, **FLOW)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(4)))
    return model, params


def _grads_tree(flow):
    """The flow's gradients in the JAX layout (scaling: zero, as JAX's
    stop_gradient makes it)."""
    out = []
    for block in flow.blocks:
        net = {name: {"layers": [{"w": l.weight.grad.numpy().T, "b": l.bias.grad.numpy()}
                                 for l in layers]}
               for name, layers in (("made", block.net.made.layers),
                                    ("integrand", block.net.integrand.layers))}
        out.append({"net": net, "scaling": np.zeros_like(block.scaling.numpy())})
    return out


def _batch(nb_in, cond_in, rows=8, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, nb_in).astype(np.float32)
    ctx = np.eye(cond_in, dtype=np.float32)[rng.randint(0, cond_in, rows)] if cond_in else None
    return x, ctx


def _port_ll_and_grads(flow, x, ctx):
    flow.zero_grad(set_to_none=True)
    ll, _ = flow.compute_ll(torch.tensor(x), None if ctx is None else torch.tensor(ctx))
    (-ll.mean()).backward()
    return ll.detach().numpy(), _grads_tree(flow)


def _assert_trees_close(got, want, tol):
    import jax

    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                   jax.tree_util.tree_leaves(want), strict=True)):
        np.testing.assert_allclose(a, b, **tol, err_msg=f"leaf {i}")


@pytest.mark.parametrize("nb_flow,cond_in", [(1, 0), (2, 3)], ids=["block", "conditional_flow"])
def test_cc_solver_matches_jax_cc(nb_flow, cond_in):
    import jax
    import jax.numpy as jnp

    model, params = _jax_flow("CC", nb_flow, cond_in)
    x, ctx = _batch(FLOW["nb_in"], cond_in)

    def loss(p):
        ll, _ = model.compute_ll(p, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
        return -jnp.mean(ll), ll

    (_, ll_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    flow = load_jax_flow_params(UMNNMAFFlow(nb_flow=nb_flow, solver="CC", cond_in=cond_in,
                                            device="cpu", **FLOW), params)
    ll_t, g_t = _port_ll_and_grads(flow, x, ctx)
    np.testing.assert_allclose(ll_t, np.asarray(ll_j), **VALUE_TOL)
    _assert_trees_close(g_t, jax.tree_util.tree_map(np.asarray, g_j), GRAD_TOL)


def test_cc_solver_matches_ccparallel_and_never_takes_the_kernel(monkeypatch):
    """"CC" against the kernel route (its plain version on the CPU): both
    differentiate the K-node sum, so values and every gradient agree; the
    Leibniz route agrees in value. "CC" under "kernel" calls no integrand
    kernel wrapper."""
    from umnn_tpu_torch.models import umnn_maf

    _, params = _jax_flow("CC", 2, 0)
    x, _ = _batch(FLOW["nb_in"], 0)
    flows = {
        name: load_jax_flow_params(UMNNMAFFlow(nb_flow=2, solver=solver, backend=backend,
                                               device="cpu", **FLOW), params)
        for name, solver, backend in (("cc", "CC", "kernel"), ("kernel", "CCParallel", "kernel"),
                                      ("torch", "CCParallel", "torch"))
    }
    ll_k, g_k = _port_ll_and_grads(flows["kernel"], x, None)
    ll_p, _ = _port_ll_and_grads(flows["torch"], x, None)

    def refuse(*args, **kw):
        raise AssertionError("the CC solver called the kernel wrapper")

    monkeypatch.setattr(umnn_maf, "fused_cc_integral", refuse)
    ll_c, g_c = _port_ll_and_grads(flows["cc"], x, None)
    np.testing.assert_allclose(ll_c, ll_k, **VALUE_TOL)
    np.testing.assert_allclose(ll_c, ll_p, **VALUE_TOL)
    _assert_trees_close(g_c, g_k, GRAD_TOL)


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="solver"):
        UMNNMAFFlow(nb_flow=1, solver="RK4", device="cpu", **FLOW)


# --- the accumulation and evaluation steps -----------------------------------------


def _grads_as_state():
    """An optax transformation whose state after an update is the gradient
    it was given, and whose update is zero."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u),
    )


def _accum_pair(accum, optimizer_j, port_optimizer):
    """JAX's and the port's accumulation steps on the same flow and loss."""
    import jax.numpy as jnp

    from umnn_tpu.training.loops import make_accum_train_step as jax_accum

    model, params = _jax_flow("CCParallel", 2, 0)

    def loss_j(p, xb):
        return -jnp.mean(model.compute_ll(p, xb)[0])

    flow = load_jax_flow_params(UMNNMAFFlow(nb_flow=2, backend="torch", device="cpu", **FLOW),
                                params)
    step_t = tl.make_accum_train_step(lambda xb: -flow.compute_ll(xb)[0].mean(),
                                      port_optimizer(flow), accum)
    return jax_accum(loss_j, optimizer_j, accum), params, step_t, flow


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_step_loss_and_averaged_gradients_match_jax(accum):
    import jax
    import jax.numpy as jnp

    opt_j = _grads_as_state()
    step_j, params, step_t, flow = _accum_pair(
        accum, opt_j, lambda f: tl.make_optimizer(f.parameters(), "adam", 1e-3, 0.0, None))
    x, _ = _batch(FLOW["nb_in"], 0, rows=16)
    _, grads_j, loss_j = step_j(params, opt_j.init(params), jnp.asarray(x))
    loss_t = step_t(torch.tensor(x))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _assert_trees_close(_grads_tree(flow), jax.tree_util.tree_map(np.asarray, grads_j), GRAD_TOL)


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_step_parameters_after_five_steps_match_jax(accum):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.training.loops import make_optimizer as jax_make_optimizer

    opt_j = jax_make_optimizer("adam", lr=1e-3, weight_decay=1e-2, grad_clip=1.0)
    step_j, params, step_t, flow = _accum_pair(
        accum, opt_j, lambda f: tl.make_optimizer(f.parameters(), "adam", 1e-3, 1e-2, 1.0))
    state = opt_j.init(params)
    rng = np.random.RandomState(6)
    for _ in range(5):
        x = rng.randn(16, FLOW["nb_in"]).astype(np.float32)
        params, state, loss_j = step_j(params, state, jnp.asarray(x))
        loss_t = step_t(torch.tensor(x))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _assert_trees_close(flow_params_to_numpy(flow), jax.tree_util.tree_map(np.asarray, params),
                        dict(rtol=1e-6, atol=1e-7))


def test_accum_step_refuses_a_batch_that_does_not_split():
    flow = UMNNMAFFlow(nb_flow=1, backend="torch", device="cpu", **FLOW)
    before = [p.detach().clone() for p in flow.parameters()]
    step = tl.make_accum_train_step(lambda xb: -flow.compute_ll(xb)[0].mean(),
                                    tl.make_optimizer(flow.parameters()), 3)
    with pytest.raises(ValueError, match="3 equal microbatches"):
        step(torch.randn(8, FLOW["nb_in"]))
    with pytest.raises(ValueError, match="3 equal microbatches"):
        step(torch.randn(9, FLOW["nb_in"]), torch.zeros(6))
    assert all(torch.equal(a, b) for a, b in zip(before, flow.parameters()))


def test_eval_step_matches_jax_and_keeps_no_graph():
    import jax.numpy as jnp

    from umnn_tpu.training.loops import make_eval_step as jax_eval_step

    model, params = _jax_flow("CCParallel", 2, 0)
    flow = load_jax_flow_params(UMNNMAFFlow(nb_flow=2, backend="torch", device="cpu", **FLOW),
                                params)
    x, _ = _batch(FLOW["nb_in"], 0)
    want = jax_eval_step(lambda p, xb: -jnp.mean(model.compute_ll(p, xb)[0]))(
        params, jnp.asarray(x))
    got = tl.make_eval_step(lambda xb: -flow.compute_ll(xb)[0].mean())(torch.tensor(x))
    assert got.grad_fn is None and not got.requires_grad
    assert all(p.grad is None for p in flow.parameters())
    np.testing.assert_allclose(float(got), float(want), **VALUE_TOL)
