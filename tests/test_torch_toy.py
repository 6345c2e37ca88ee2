"""The port's toy densities, ConditionalMADE, conditional flow and toy
driver against the JAX package's, at small sizes on the CPU.

Data: ``inf_train_gen`` is a copy and must agree bit for bit under the same
``RandomState``. Weights are made in JAX and carried across by the bridge;
inputs come from numpy. Tolerances as `tests/test_torch_flow.py` and
`tests/test_torch_flow_grad.py`: ll rtol 1e-5 / atol 1e-4, every parameter
gradient of ``-mean(compute_ll)`` rtol 1e-4 / atol 1e-5. The port's
``"kernel"`` backend (on the CPU the fused integral's plain version, the
function of the pack-4 kernels) is held against JAX's ``"pallas"``
(interpret mode, which takes the pack-4 kernels at these widths), and
``"torch"`` (Leibniz) against JAX's ``"xla"``. Three Adam steps against
JAX's optimizer at lr 1e-3 (ROADMAP C2: at a larger rate optax's float32
bias correction shows): losses rtol 1e-5, parameters rtol 1e-4 with atol
1e-7 for entries near 0.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.data.toy import TOY_DATASETS, inf_train_gen
from umnn_tpu_torch.examples import train_toy
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.made import ConditionalMADE
from umnn_tpu_torch.training import loops as tl

COND = dict(
    nb_flow=2, nb_in=2, hidden_derivative=(16, 16), hidden_embedding=(16, 16),
    embedding_s=4, nb_steps=16, cond_in=8,
)
B = 16
LL_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# parameters after three Adam steps; atol for entries near 0, whose float32
# rounding differs by a few ulp of the step (2e-8 at |p| = 2e-4, measured)
PARAM_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("data", TOY_DATASETS)
def test_toy_data_matches_jax_bit_for_bit(data):
    from umnn_tpu.data.toy import inf_train_gen as jax_gen

    got = inf_train_gen(data, np.random.RandomState(11), 300)
    want = jax_gen(data, np.random.RandomState(11), 300)
    if data == "conditionnal8gaussians":
        assert got[1].shape == (300, 8) and (got[1].sum(1) == 1).all()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    else:
        assert got.shape == (300, 2) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_conditional_made_matches_jax():
    import jax
    import jax.numpy as jnp

    from umnn_tpu.nn.made import ConditionalMADE as JaxCMADE

    nin, cond_in, hidden, nout = 3, 5, (12, 10), 2 * (3 + 5)
    jmade = JaxCMADE(nin, cond_in, hidden, nout)
    params = jax.tree_util.tree_map(np.asarray, jmade.init(jax.random.PRNGKey(4)))
    made = ConditionalMADE(nin, cond_in, hidden, nout, torch.Generator().manual_seed(0),
                           device="cpu")
    for m_t, m_j in zip(made.masks, jmade._made.masks):
        np.testing.assert_array_equal(m_t.numpy().T, np.asarray(m_j))
    with torch.no_grad():
        for layer, p in zip(made.layers, params["layers"]):
            layer.weight.copy_(torch.tensor(p["w"].T))
            layer.bias.copy_(torch.tensor(p["b"]))
    rng = np.random.RandomState(3)
    x = rng.randn(7, nin).astype(np.float32)
    ctx = rng.randn(7, cond_in).astype(np.float32)
    with torch.no_grad():
        got = made(torch.tensor(x), torch.tensor(ctx)).numpy()
    want = np.asarray(jmade.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    assert got.shape == (7, 2 * nin)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the output of dimension d sees x[:d] only (so none sees the last
    # dimension), and the whole context
    x2 = x.copy()
    x2[:, -1] += 1.0
    ctx2 = ctx.copy()
    ctx2[:, 0] += 1.0
    with torch.no_grad():
        assert np.array_equal(made(torch.tensor(x2), torch.tensor(ctx)).numpy(), got)
        assert (made(torch.tensor(x), torch.tensor(ctx2)).numpy() != got).all()


@pytest.fixture(scope="module")
def cond_params():
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    params = JaxFlow(**COND).init(jax.random.PRNGKey(6))
    return [jax.tree_util.tree_map(np.asarray, p) for p in params]


@pytest.fixture(scope="module")
def cond_batch():
    return inf_train_gen("conditionnal8gaussians", np.random.RandomState(12), B)


def _jax_ll_and_grads(params, batch, backend):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    flow = JaxFlow(**COND, backend=backend)
    x, ctx = (jnp.asarray(a) for a in batch)
    ll = flow.compute_ll(jax.tree_util.tree_map(jnp.asarray, params), x, ctx)[0]
    loss = lambda p: -jnp.mean(flow.compute_ll(p, x, ctx)[0])  # noqa: E731
    grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    return np.asarray(ll), grads


@pytest.mark.parametrize("backend,jax_backend", [("torch", "xla"), ("kernel", "pallas")])
def test_conditional_flow_ll_and_gradients_match_jax(cond_params, cond_batch, backend, jax_backend):
    ll_j, grads_j = _jax_ll_and_grads(cond_params, cond_batch, jax_backend)
    flow = load_jax_flow_params(UMNNMAFFlow(**COND, backend=backend, device="cpu"), cond_params)
    x, ctx = (torch.as_tensor(a) for a in cond_batch)
    ll, _ = flow.compute_ll(x, ctx)
    np.testing.assert_allclose(ll.detach().numpy(), ll_j, **LL_TOL)
    (-ll.mean()).backward()
    n = 0
    for block, g in zip(flow.blocks, grads_j):
        for part in ("made", "integrand"):
            layers = getattr(block.net, part).layers
            for layer, gl in zip(layers, g["net"][part]["layers"]):
                np.testing.assert_allclose(layer.weight.grad.numpy(), np.asarray(gl["w"]).T, **GRAD_TOL)
                np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(gl["b"]), **GRAD_TOL)
                n += 2
    assert n == 2 * 2 * (3 + 3)


def test_conditional_flow_requires_context(cond_params, cond_batch):
    flow = load_jax_flow_params(UMNNMAFFlow(**COND, backend="torch", device="cpu"), cond_params)
    with pytest.raises(ValueError, match="requires context"):
        flow.compute_ll(torch.as_tensor(cond_batch[0]))


TOY = dict(nb_flow=1, nb_in=2, hidden_derivative=(16, 16), hidden_embedding=(16, 16),
           embedding_s=4, nb_steps=16)


def test_three_adam_steps_match_jax():
    import jax
    import jax.numpy as jnp
    import optax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.training.loops import make_optimizer

    jflow = JaxFlow(**TOY, backend="xla")
    params = jflow.init(jax.random.PRNGKey(7))
    flow = load_jax_flow_params(
        UMNNMAFFlow(**TOY, backend="torch", device="cpu"),
        [jax.tree_util.tree_map(np.asarray, p) for p in params],
    )
    rng = np.random.RandomState(13)
    batches = [inf_train_gen("8gaussians", rng, 64) for _ in range(3)]

    opt_j = make_optimizer("adam", lr=1e-3, weight_decay=1e-5)
    state = opt_j.init(params)
    loss_j = lambda p, b: -jnp.mean(jflow.compute_ll(p, b)[0])  # noqa: E731
    losses_j = []
    for b in batches:
        value, grads = jax.value_and_grad(loss_j)(params, jnp.asarray(b))
        updates, state = opt_j.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(value))

    opt = tl.make_optimizer(flow.parameters(), "adam", 1e-3, 1e-5, grad_clip=1.0)
    step = tl.make_train_step(lambda b: -flow.compute_ll(b)[0].mean(), opt)
    losses = [float(step(torch.as_tensor(b))) for b in batches]

    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    block, p = flow.blocks[0], params[0]
    for part in ("made", "integrand"):
        for layer, lp in zip(getattr(block.net, part).layers, p["net"][part]["layers"]):
            np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(lp["w"]).T, **PARAM_TOL)
            np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(lp["b"]), **PARAM_TOL)


VERIFY = "-nb_steps 16 -b_size 256 -hidden_embedding 64 64 -hidden_derivative 32 32 -device cpu"


@pytest.mark.parametrize("data,n_params", [("8gaussians", 7125), ("conditionnal8gaussians", 12837)])
def test_driver_runs_two_epochs_in_jax_format(data, n_params, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        history = train_toy.main(f"-data {data} -nb_epoch 2 {VERIFY}".split())
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"device=cpu params={n_params}" and history["params"] == n_params
    epochs = [l for l in lines if l.startswith("epoch")]
    assert len(epochs) == 2 and len(history["test_nll"]) == 2
    for e, line in enumerate(epochs):
        # JAX's line: f"epoch {epoch:3d}  train NLL {:8.4f}  test NLL {:8.4f}  ({:.2f}s)"
        assert line.startswith(f"epoch {e:3d}  train NLL {history['train_nll'][e]:8.4f}  "
                               f"test NLL {history['test_nll'][e]:8.4f}  (")
    assert all(np.isfinite(history["test_nll"]))


def test_driver_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_toy.main(["-nb_epoch", "1"])
