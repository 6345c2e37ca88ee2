"""The port's Lipschitz controls and the train step's ``post_update``
against the JAX package (`umnn_tpu/models/umnn_maf.py:50-60,115-130,
395-409`, `umnn_tpu/models/flow.py:148-158`, `training/loops.py:128,174`).

Power iteration starts from the vectors JAX draws
(``jax.random.normal(fold_in(fold_in(key, block), layer), (din, 1))``),
fed to the port, so both iterate on the same matrix from the same start:
sigma, the flow's Lipschitz estimate and the projected weights within
rtol 1e-5 (float32 matrix products in another order). Drawn from a
generator, 10 iterations under-estimate a random 50-wide layer's norm by
up to about 18% (2,000 such matrices on the CPU), so a projected layer's
exact norm is held to ``L * (1 + LIP_TOL)``, and never below ``L`` where
the projection acted.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import flow_params_to_numpy, load_jax_flow_params
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.models.umnn_maf import power_iteration_sigma
from umnn_tpu_torch.training import loops as tl

CFG = dict(nb_flow=2, nb_in=4, hidden_derivative=(12, 10), hidden_embedding=(16,),
           embedding_s=3, nb_steps=10)
TOL = dict(rtol=1e-5, atol=1e-7)
LIP_TOL = 0.25


def _jax_flow_and_params(scale: float):
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    jflow = JaxFlow(**CFG, backend="xla")
    params = jflow.init(jax.random.PRNGKey(2))
    # blown up, so that the projection cuts most layers
    params = [
        {**p, "net": {**p["net"], "integrand": jax.tree_util.tree_map(
            lambda a: a * scale, p["net"]["integrand"])}}
        for p in params
    ]
    return jflow, params


def _jax_inits(params, key):
    """The start vectors JAX's flow draws: block i, layer j."""
    import jax

    return [
        [np.asarray(jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, i), j),
                                      (layer["w"].shape[0], 1)))
         for j, layer in enumerate(p["net"]["integrand"]["layers"])]
        for i, p in enumerate(params)
    ]


def _port_flow(params):
    import jax

    return load_jax_flow_params(UMNNMAFFlow(**CFG, backend="torch", device="cpu"),
                                [jax.tree_util.tree_map(np.asarray, p) for p in params])


@pytest.mark.parametrize("shape", [(12, 4), (10, 12), (1, 10), (50, 50)])
def test_power_iteration_matches_jax_from_the_same_start(shape):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.umnn_maf import _power_iteration_sigma

    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    init = np.asarray(jax.random.normal(key, (shape[1], 1)))
    want = float(_power_iteration_sigma(jnp.asarray(w), key))
    got = float(power_iteration_sigma(torch.tensor(w), torch.tensor(init)))
    np.testing.assert_allclose(got, want, **TOL)
    assert got <= float(np.linalg.norm(w, 2)) * (1 + 1e-6)


def test_flow_lipschitz_and_projection_match_jax():
    import jax

    jflow, params = _jax_flow_and_params(3.0)
    key = jax.random.PRNGKey(11)
    inits = _jax_inits(params, key)
    flow = _port_flow(params)
    np.testing.assert_allclose(float(flow.compute_lipschitz(inits=[[torch.tensor(v) for v in b]
                                                                   for b in inits])),
                               float(jflow.compute_lipschitz(params, key)), **TOL)
    flow.force_lipschitz(1.5, inits=[[torch.tensor(v) for v in b] for b in inits])
    projected = jflow.force_lipschitz(params, key, 1.5)
    cut = 0
    for block, p, old_block in zip(flow_params_to_numpy(flow), projected, params):
        for part in ("made", "integrand"):
            for got, want, old in zip(block["net"][part]["layers"], p["net"][part]["layers"],
                                      old_block["net"][part]["layers"]):
                np.testing.assert_allclose(got["w"], np.asarray(want["w"]), **TOL)
                np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))  # kept
                cut += part == "integrand" and not np.allclose(got["w"], np.asarray(old["w"]))
    assert cut >= 4  # the projection acted on most of the 6 layers


def test_projection_from_a_generator_bounds_every_layer():
    flow = UMNNMAFFlow(nb_flow=3, nb_in=5, hidden_derivative=(50, 50, 50), hidden_embedding=(16,),
                       embedding_s=30, device="cpu")
    with torch.no_grad():
        for block in flow.blocks:
            for layer in block.net.integrand.layers:
                layer.weight.mul_(3.0)
    made = [t.clone() for b in flow.blocks for t in b.net.made.parameters()]
    gen = torch.Generator().manual_seed(97)
    state = gen.get_state()
    flow.force_lipschitz(1.5, gen)
    assert not torch.equal(gen.get_state(), state)  # fresh draws
    for block in flow.blocks:
        for layer in block.net.integrand.layers[:-1]:
            norm = float(torch.linalg.matrix_norm(layer.weight.detach(), 2))
            assert 1.5 * (1 - 1e-5) <= norm <= 1.5 * (1 + LIP_TOL)
        # a one-row layer converges at once
        out = block.net.integrand.layers[-1].weight.detach()
        assert float(torch.linalg.matrix_norm(out, 2)) <= 1.5 * (1 + 1e-5)
    assert all(torch.equal(a, b) for a, b in
               zip(made, [t for b in flow.blocks for t in b.net.made.parameters()]))


def test_post_update_runs_after_every_step_also_a_skipped_one():
    """As `tests/test_driver_semantics.py:96,117` checks for JAX: the
    projection follows every step, and a batch the guard skips leaves the
    parameters alone but still gets its post_update, with the step's
    extra arguments."""
    w = torch.nn.Parameter(torch.tensor([2.0, -3.0]))
    opt = tl.make_optimizer([w], "adam", lr=0.1, grad_clip=None)
    seen = []

    def post(tag):
        seen.append(tag)
        with torch.no_grad():
            w.clamp_(-0.5, 0.5)

    step = tl.make_train_step(lambda b, tag: torch.sum((w * b) ** 2), opt, post)
    for i in range(3):
        step(torch.tensor([1.0, 1.0]), f"step{i}")
        assert float(w.detach().abs().max()) <= 0.5 + 1e-6
    with torch.no_grad():
        w.copy_(torch.tensor([2.0, -3.0]))
    moments = {k: v.clone() for k, v in opt.inner.state[w].items()}
    loss = step(torch.tensor([float("nan"), 1.0]), "skipped")
    assert not bool(torch.isfinite(loss))
    assert seen == ["step0", "step1", "step2", "skipped"]
    # the update was skipped (Adam's state unchanged), the projection ran
    assert all(torch.equal(opt.inner.state[w][k], v) for k, v in moments.items())
    assert torch.equal(w.detach(), torch.tensor([0.5, -0.5]))
