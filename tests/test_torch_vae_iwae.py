"""The port's IWAE, ``has_aux`` train step and VAE snapshots against the
JAX package's.

The IWAE step on the same weights and noise (JAX's eps handed to the port)
within rtol 1e-4, atol 1e-4; ``calculate_likelihood``'s assembly (chunks,
the tail chunk at its own size, datapoint-major rows, logsumexp - log S)
on a stub step that returns the same per-row losses in both packages,
within 1e-6 relative; the ``has_aux`` step's loss, aux and updated
parameters after one Adamax step on shared weights within rtol 1e-4, atol
1e-5; float16 snapshots of MMAVAE and IAFVAE crossing both ways with every
leaf equal.
"""

import numpy as np
import pytest
import torch

from torch_vae_cases import (B, FAMILY_TOL, _batch, _family_pair, _jax_loss, _np_tree,
                             _port_loss, _t, patch_jax_eps)
from umnn_tpu_torch.bridge import vae_params_to_numpy
from umnn_tpu_torch.models.vae import iwae as PW
from umnn_tpu_torch.training.checkpoint import load_params_npz, save_params_npz
from umnn_tpu_torch.training.loops import make_optimizer, make_train_step


@pytest.mark.parametrize("family", ["no_flow", "MMAF"])
def test_iwae_step_matches_jax(family, monkeypatch):
    from umnn_tpu.models.vae.iwae import make_iwae_step as jstep

    key = patch_jax_eps(monkeypatch)
    jmodel, params, tmodel = _family_pair(family, "binary")
    x = _batch("binary")
    want = jstep(jmodel)(params, x, key)
    got = PW.make_iwae_step(tmodel)(_t(x), None)
    assert not got.requires_grad and got.is_inference()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FAMILY_TOL)


class _Stub:
    """A model stand-in: the step below ignores it."""

    device = torch.device("cpu")
    input_type = "binary"
    input_size = (1, 2, 2)


def _stub_losses(x_rep, call):
    """Per-row losses that depend on the row's datapoint, its place and the
    call: the assembly's order shows in the result."""
    x = np.asarray(x_rep, np.float64).reshape(len(x_rep), -1)
    return x.sum(1) * 0.7 + 0.01 * np.arange(len(x)) + 0.3 * call


@pytest.mark.parametrize("n_data,data_chunk,minibatch,n_samples",
                         [(5, 2, 3, 9), (4, None, 2, 4), (3, 2, 2, 4), (1, 4, 4, 3)])
def test_calculate_likelihood_assembly_matches_jax(n_data, data_chunk, minibatch, n_samples,
                                                   monkeypatch):
    import jax
    import jax.numpy as jnp
    from umnn_tpu.models.vae import iwae as JW

    calls = {"jax": 0, "port": 0}

    def jax_make(model, mesh=None, apply_kwargs=None):
        def step(params, x_rep, rng):
            calls["jax"] += 1
            return jnp.asarray(_stub_losses(x_rep, calls["jax"]), jnp.float32)
        return step

    def port_make(model, apply_kwargs=None):
        def step(x_rep, generator):
            calls["port"] += 1
            return torch.as_tensor(_stub_losses(x_rep, calls["port"]), dtype=torch.float32)
        return step

    monkeypatch.setattr(JW, "make_iwae_step", jax_make)
    monkeypatch.setattr(PW, "make_iwae_step", port_make)
    x = np.random.RandomState(0).rand(n_data, 1, 2, 2).astype(np.float32)
    ll_j, per_j = JW.calculate_likelihood(None, None, x, jax.random.PRNGKey(0), n_samples,
                                          minibatch, data_chunk=data_chunk)
    ll_t, per_t = PW.calculate_likelihood(_Stub(), x, None, n_samples, minibatch,
                                          data_chunk=data_chunk)
    assert calls["jax"] == calls["port"]
    assert per_t.shape == (n_data,)
    np.testing.assert_allclose(per_t, per_j, rtol=1e-6)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6)


@pytest.mark.parametrize("c,minibatch,world,want", [(2, 2, 3, 3), (1, 2, 3, 3), (3, 4, 2, 3),
                                                    (1, 500, 8, 2), (5, 3, 1, 5)])
def test_pad_chunk_pads_with_the_first_datapoint_to_the_world_size(c, minibatch, world, want):
    xc = np.arange(c, dtype=np.float32)[:, None] + 1
    out = PW.pad_chunk(xc, minibatch, world)
    assert len(out) == want and (len(out) * minibatch) % world == 0
    np.testing.assert_array_equal(out[:c], xc)
    assert (out[c:] == xc[0]).all()


def test_has_aux_step_matches_jax():
    import jax
    import jax.numpy as jnp
    from umnn_tpu.training.loops import make_optimizer as jopt
    from umnn_tpu.training.loops import make_train_step as jstep

    jmodel, params, tmodel = _family_pair("planar", "binary")
    x = _batch("binary")
    key = jax.random.PRNGKey(2)
    eps = np.asarray(jax.random.normal(key, (B, 4), np.float32))

    def jloss(p, xb, k):
        _, (loss, rec, kl, bpd) = _jax_loss(jmodel, p, xb, k, "binary")
        return loss, (rec, kl, bpd)

    optj = jopt("adamax", lr=5e-4, grad_clip=None)
    new_params, _, loss_j, aux_j = jstep(jloss, optj, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), optj.init(params), jnp.asarray(x), key)

    tmodel.reparameterize = lambda mu, var, gen: mu + _t(eps) * torch.sqrt(var)

    def tloss(xb):
        _, (loss, rec, kl, bpd) = _port_loss(tmodel, xb, "binary")
        return loss, (rec, kl, bpd)

    optt = make_optimizer(tmodel.parameters(), "adamax", 5e-4, grad_clip=None)
    loss_t, aux_t = make_train_step(tloss, optt, has_aux=True)(x)
    assert not loss_t.requires_grad and all(not a.requires_grad for a in aux_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4, atol=1e-5)
    for a, b in zip(aux_t, aux_j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-5)
    got = jax.tree_util.tree_leaves(vae_params_to_numpy(tmodel))
    want = jax.tree_util.tree_leaves(_np_tree(new_params))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["MMAF", "iaf"])
def test_float16_snapshot_crosses_both_ways(family, tmp_path):
    import jax
    from umnn_tpu.training.checkpoint import load_params_npz as jload
    from umnn_tpu.training.checkpoint import save_params_npz as jsave

    _, params, tmodel = _family_pair(family, "multinomial")
    jsave(tmp_path / "jax.npz", params)
    load_params_npz(tmp_path / "jax.npz", tmodel)
    got = jax.tree_util.tree_leaves(vae_params_to_numpy(tmodel))
    want = jax.tree_util.tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.astype(np.float16).astype(np.float32))
    # the port's snapshot of other weights, read by JAX
    with torch.no_grad():
        for p in tmodel.parameters():
            p.mul_(1.5)
    save_params_npz(tmp_path / "port.npz", tmodel)
    back = jax.tree_util.tree_leaves(_np_tree(jload(tmp_path / "port.npz", params)))
    for a, b in zip(back, jax.tree_util.tree_leaves(vae_params_to_numpy(tmodel))):
        np.testing.assert_array_equal(a, b.astype(np.float16).astype(np.float32))
