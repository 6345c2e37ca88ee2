"""The port's MonotonicNN, its weight bridge and its driver against the JAX
package's `umnn_tpu/models/monotonic.py` and `examples/train_monotonic.py`.

On the CPU JAX's ``"auto"`` integrates with ``neural_integral``
(``pallas_available()`` is false), so the whole model is held against JAX's
``backend="xla"``, and the port's kernel route (its plain version on CPU
tensors, ReLU: ``neg_slope=0``) against JAX's ``fused_cc_integral(...,
interpret=True, neg_slope=0.0)`` at the widths of the three kernel pairs
JAX's auto picks. Tolerances as `tests/test_pallas_kernel.py:61,87`: values
rtol 1e-5, gradients rtol 1e-4 (atol 1e-6 for entries near 0).

The two routes differ in x's gradient by design: the kernel route
differentiates the K-node sum, x's node path included; the Leibniz route
takes ``f(x)`` for it. Their parameter and h gradients are both the
derivative of the same sum, so those are held to each other.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_monotonic_params, monotonic_params_to_numpy
from umnn_tpu_torch.examples import train_monotonic
from umnn_tpu_torch.models.monotonic import MonotonicNN
from umnn_tpu_torch.nn.core import MLP
from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors

ROOT = Path(__file__).resolve().parent.parent
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B = 16
# (in_d, hidden): the driver's widths (the unpacked pair on the card), the
# pack-2 and pack-4 widths, tests/test_end_to_end_fit.py's in_d = 2, and
# in_d = 1 (no conditioning input)
MODELS = {
    "driver": (3, (100, 100, 100)),
    "pack2": (3, (64, 64)),
    "pack4": (3, (32, 32)),
    "in2": (2, (64, 64)),
    "in1": (1, (16, 16)),
}
NB_STEPS = 20


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_model(in_d, hidden, key=0, backend="xla"):
    import jax

    from umnn_tpu.models.monotonic import MonotonicNN as JaxMonotonicNN

    model = JaxMonotonicNN(in_d, hidden, nb_steps=NB_STEPS, backend=backend)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(key)))
    return model, params


def _port_model(in_d, hidden, params, backend):
    model = MonotonicNN(in_d, hidden, nb_steps=NB_STEPS, backend=backend, device="cpu")
    return load_jax_monotonic_params(model, params)


def _inputs(in_d, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2.0, 2.0, (B, 1)).astype(np.float32)
    h = rng.randn(B, in_d - 1).astype(np.float32)
    g = rng.randn(B, 1).astype(np.float32)
    return x, h, g


def _jax_value_and_grads(model, params, x, h, g):
    import jax
    import jax.numpy as jnp

    def loss(p, xx, hh):
        y = model.apply(p, xx, hh)
        return jnp.sum(y * g), y

    (_, y), (gp, gx, gh) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(h))
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx), np.asarray(gh)


def _port_value_and_grads(model, x, h, g):
    xt = torch.tensor(x, requires_grad=True)
    ht = torch.tensor(h, requires_grad=True)
    model.zero_grad(set_to_none=True)
    y = model(xt, ht)
    (y * torch.tensor(g)).sum().backward()
    grads = {"integrand": {"layers": [{"w": l.weight.grad.numpy().T, "b": l.bias.grad.numpy()}
                                      for l in model.integrand.layers]},
             "hnet": [{"w": l.weight.grad.numpy().T, "b": l.bias.grad.numpy()}
                      for l in model.hnet.layers]}
    return y.detach().numpy(), grads, xt.grad.numpy(), ht.grad.numpy()


def _assert_tree_close(got, want, tol, what):
    import jax

    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                   jax.tree_util.tree_leaves(want), strict=True)):
        np.testing.assert_allclose(a, b, **tol, err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax_xla_on_bridged_weights(name):
    in_d, hidden = MODELS[name]
    jmodel, params = _jax_model(in_d, hidden)
    x, h, g = _inputs(in_d)
    y_j, gp_j, gx_j, gh_j = _jax_value_and_grads(jmodel, params, x, h, g)
    y_t, gp_t, gx_t, gh_t = _port_value_and_grads(_port_model(in_d, hidden, params, "torch"),
                                                 x, h, g)
    np.testing.assert_allclose(y_t, y_j, **VALUE_TOL)
    _assert_tree_close(gp_t, gp_j, GRAD_TOL, name)
    np.testing.assert_allclose(gx_t, gx_j, **GRAD_TOL)
    np.testing.assert_allclose(gh_t, gh_j, **GRAD_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_kernel_route_matches_the_torch_route(name):
    """Values, and every parameter and h gradient; "auto" on the CPU is the
    torch route."""
    in_d, hidden = MODELS[name]
    _, params = _jax_model(in_d, hidden)
    x, h, g = _inputs(in_d, seed=4)
    y_k, gp_k, _, gh_k = _port_value_and_grads(_port_model(in_d, hidden, params, "kernel"),
                                              x, h, g)
    y_t, gp_t, _, gh_t = _port_value_and_grads(_port_model(in_d, hidden, params, "torch"),
                                              x, h, g)
    y_a, *_ = _port_value_and_grads(_port_model(in_d, hidden, params, "auto"), x, h, g)
    np.testing.assert_allclose(y_k, y_t, **VALUE_TOL)
    np.testing.assert_array_equal(y_a, y_t)
    _assert_tree_close(gp_k, gp_t, GRAD_TOL, name)
    np.testing.assert_allclose(gh_k, gh_t, **GRAD_TOL)


# the integrand widths [1 + e, ..., 1] of MODELS' three kernel pairs, and
# the pair JAX's auto (and the port's route) picks for each
KERNEL_WIDTHS = {
    "unpacked": ([3, 100, 100, 100, 1], ""),
    "pack2": ([3, 64, 64, 1], "_p2"),
    "pack4": ([3, 32, 32, 1], "_p4"),
}


@pytest.mark.parametrize("name", list(KERNEL_WIDTHS))
def test_slope0_plain_kernel_matches_jax_interpret_mode(name):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.nn.core import mlp_init
    from umnn_tpu.ops.integrand_kernel import fused_cc_integral as jax_fused
    from umnn_tpu.ops.quadrature import cc_quadrature

    widths, route = KERNEL_WIDTHS[name]
    layers = mlp_init(jax.random.PRNGKey(5), widths)
    ws_j = [np.asarray(l["w"]) for l in layers]
    bs_j = [np.asarray(l["b"]) for l in layers]
    rng = np.random.RandomState(6)
    rows = 10
    x = rng.uniform(-2.0, 2.0, rows).astype(np.float32)
    h = rng.randn(rows, widths[0] - 1).astype(np.float32)
    g = rng.randn(rows).astype(np.float32)
    n_np, w_np = cc_quadrature(NB_STEPS)
    nodes_j, ccw_j = jnp.asarray(n_np, jnp.float32), jnp.asarray(w_np, jnp.float32)

    def loss_j(ws, bs, xx, hh):
        z = jax_fused(ws, bs, xx, hh, nodes_j, ccw_j, tile_r=8, interpret=True, neg_slope=0.0)
        return jnp.sum(z * g), z

    (_, z_j), grads_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True)(
        [jnp.asarray(w) for w in ws_j], [jnp.asarray(b) for b in bs_j], jnp.asarray(x),
        jnp.asarray(h))

    ws = [torch.tensor(w.T.copy(), requires_grad=True) for w in ws_j]
    bs = [torch.tensor(b, requires_grad=True) for b in bs_j]
    xt, ht = torch.tensor(x, requires_grad=True), torch.tensor(h, requires_grad=True)
    assert ik._route(ws, None, None) == route
    nodes, ccw = cc_tensors(NB_STEPS, "cpu")
    z = ik.fused_cc_integral(ws, bs, xt, ht, nodes, ccw, neg_slope=0.0)
    (z * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), **VALUE_TOL)
    dws_j, dbs_j, dx_j, dh_j = grads_j
    for w, dw in zip(ws, dws_j):
        np.testing.assert_allclose(w.grad.numpy().T, np.asarray(dw), **GRAD_TOL)
    for b, db in zip(bs, dbs_j):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(db), **GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **GRAD_TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(dh_j), **GRAD_TOL)


def test_no_hidden_layer_raises_on_the_kernel_route_where_jax_falls_back():
    """JAX's "pallas" quietly integrates a one-layer integrand with
    neural_integral; the port's kernel route refuses it before any launch,
    and "torch" computes it as JAX does."""
    jmodel, params = _jax_model(3, ())
    jpallas, _ = _jax_model(3, (), backend="pallas")
    x, h, g = _inputs(3)
    y_j, *_ = _jax_value_and_grads(jmodel, params, x, h, g)
    y_p, *_ = _jax_value_and_grads(jpallas, params, x, h, g)
    np.testing.assert_array_equal(y_p, y_j)
    with pytest.raises(ValueError, match="at least one hidden layer"):
        _port_model(3, (), params, "kernel")(torch.tensor(x), torch.tensor(h))
    y_t, *_ = _port_value_and_grads(_port_model(3, (), params, "torch"), x, h, g)
    np.testing.assert_allclose(y_t, y_j, **VALUE_TOL)


def test_zero_columns_of_h_raise_in_the_kernel_wrapper_and_in_d_1_pads_one():
    """in_d = 1: the wrapper refuses h with no column (no kernel takes it);
    the model's kernel route gives W1 and h one zero column each, the same
    function, and W1's gradient has no column for it."""
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(8, 1, generator=gen), torch.randn(1, 8, generator=gen)]
    bs = [torch.randn(8, generator=gen), torch.randn(1, generator=gen)]
    nodes, ccw = cc_tensors(10, "cpu")
    with pytest.raises(ValueError, match="at least one column of h"):
        ik.fused_cc_integral(ws, bs, torch.rand(5), torch.zeros(5, 0), nodes, ccw, neg_slope=0.0)

    _, params = _jax_model(1, (16, 16))
    model = _port_model(1, (16, 16), params, "kernel")
    x, h, g = _inputs(1)
    _, grads, _, _ = _port_value_and_grads(model, x, h, g)
    assert grads["integrand"]["layers"][0]["w"].shape == (1, 16)


def test_bridge_crosses_both_ways():
    import jax

    jmodel, params = _jax_model(3, (100, 100, 100), key=11)
    model = _port_model(3, (100, 100, 100), params, "torch")
    back = monotonic_params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="hnet"):
        load_jax_monotonic_params(model, {**params, "hnet": params["hnet"][:-1]})


# --- the driver ----------------------------------------------------------------------


def _jax_driver():
    spec = importlib.util.spec_from_file_location("jax_train_monotonic",
                                                  ROOT / "examples" / "train_monotonic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_driver_first_step_matches_jax_from_bridged_parameters():
    """One fixed batch through both models from JAX's initial parameters:
    the target, both MSEs and every gradient, as JAX's driver computes
    them (`examples/train_monotonic.py:49-72`)."""
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.monotonic import MonotonicNN as JaxMonotonicNN
    from umnn_tpu.nn.core import ACTIVATIONS, mlp_apply, mlp_init

    key = jax.random.PRNGKey(0)
    jmodel = JaxMonotonicNN(3, (100, 100, 100), nb_steps=NB_STEPS)
    params_m = jax.tree_util.tree_map(np.asarray, jmodel.init(key))
    params_f = jax.tree_util.tree_map(np.asarray, mlp_init(jax.random.fold_in(key, 1),
                                                           [3, 100, 100, 100, 1]))
    x = np.random.RandomState(7).uniform(-2.0, 2.0, (64, 3)).astype(np.float32)
    y_j = _jax_driver().target(jnp.asarray(x))

    def loss_m(prm):
        pred = jmodel.apply(prm, jnp.asarray(x[:, 0:1]), jnp.asarray(x[:, 1:]))[:, 0]
        return jnp.mean((pred - y_j) ** 2)

    def loss_f(prm):
        pred = mlp_apply(prm, jnp.asarray(x), ACTIVATIONS["ReLU"])[:, 0]
        return jnp.mean((pred - y_j) ** 2)

    lm_j, gm_j = jax.jit(jax.value_and_grad(loss_m))(params_m)
    lf_j, gf_j = jax.jit(jax.value_and_grad(loss_f))(params_f)

    model = _port_model(3, (100, 100, 100), params_m, "auto")
    mlp = MLP([3, 100, 100, 100, 1], torch.Generator(), "ReLU", device="cpu")
    for layer, lp in zip(mlp.layers, params_f):
        with torch.no_grad():
            layer.weight.copy_(torch.tensor(lp["w"].T))
            layer.bias.copy_(torch.tensor(lp["b"]))
    xt = torch.tensor(x)
    y = train_monotonic.target(xt)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **VALUE_TOL)
    lm = train_monotonic.monotonic_mse(model, xt, y)
    lm.backward()
    lf = train_monotonic.mlp_mse(mlp, xt, y)
    lf.backward()
    np.testing.assert_allclose(lm.item(), float(lm_j), rtol=1e-5)
    np.testing.assert_allclose(lf.item(), float(lf_j), rtol=1e-5)
    got_m = {"integrand": {"layers": [{"w": l.weight.grad.numpy().T, "b": l.bias.grad.numpy()}
                                      for l in model.integrand.layers]},
             "hnet": [{"w": l.weight.grad.numpy().T, "b": l.bias.grad.numpy()}
                      for l in model.hnet.layers]}
    got_f = [{"w": l.weight.grad.numpy().T, "b": l.bias.grad.numpy()} for l in mlp.layers]
    _assert_tree_close(got_m, jax.tree_util.tree_map(np.asarray, gm_j), GRAD_TOL, "monotonic")
    _assert_tree_close(got_f, jax.tree_util.tree_map(np.asarray, gf_j), GRAD_TOL, "mlp")


def test_driver_optimizer_matches_jax_on_shared_gradients():
    """Adam at lr 1e-3, no clip, no weight decay (`:45`), five steps of the
    same gradients: parameters within rtol 1e-6, atol 1e-7."""
    import jax.numpy as jnp
    import optax

    from umnn_tpu.training.loops import make_optimizer as jax_make_optimizer

    rng = np.random.RandomState(2)
    init = [rng.randn(5, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[3.0 * rng.randn(*p.shape).astype(np.float32) for p in init] for _ in range(5)]
    opt = jax_make_optimizer("adam", lr=1e-3, grad_clip=None)
    params = [jnp.asarray(p) for p in init]
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update([jnp.asarray(a) for a in g], state, params)
        params = optax.apply_updates(params, updates)
    ours = [torch.nn.Parameter(torch.tensor(p)) for p in init]
    port = train_monotonic.make_optimizer(ours, "adam", 1e-3, grad_clip=None)
    for g in grads:
        for p, a in zip(ours, g):
            p.grad = torch.tensor(a)
        port.step()
    for a, b in zip(ours, params):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_driver_target_is_jax_target():
    import jax.numpy as jnp

    x = np.random.RandomState(8).uniform(-2.0, 2.0, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(train_monotonic.target(torch.tensor(x)).numpy(),
                               np.asarray(_jax_driver().target(jnp.asarray(x))), **VALUE_TOL)


def test_tiny_driver_run_prints_jax_lines_and_is_monotone(capsys):
    rc = train_monotonic.main("-device cpu -nb_epoch 12 -nb_steps 8 -b_size 64".split())
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert [l.split()[1] for l in lines[:-1]] == ["0", "10", "11"]
    for l in lines[:-1]:
        f = l.split()
        assert f[2:4] == ["MSE", "monotonic"] and f[5:7] == ["MSE", "mlp"]
        assert np.isfinite(float(f[4])) and np.isfinite(float(f[7]))
    assert lines[-1] == "monotone in x1: True"


def test_driver_refuses_without_a_card_or_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_monotonic.main(["-nb_epoch", "1"])
