"""The port's VAE families against the JAX package's: forward and losses.

Weights are made in JAX and carried across by the bridge; JAX's
reparameterization noise is drawn from its key and handed to the port
through a patched ``reparameterize``, so that everything downstream of it
can be compared. Tolerance: the 6-tuple and calculate_loss's values rtol
1e-4, atol 1e-4. JAX's flows run with backend "xla", what its "auto" takes on the
CPU; the port's MMAF on "kernel" (its plain version on CPU tensors) and
"torch".
"""

import numpy as np
import pytest
import torch

from torch_vae_cases import (FAMILY_TOL, FLOW_KW, INPUTS, Z, _batch, _family_pair, _jax_loss,
                             _port_loss, _t, patch_jax_eps)
from umnn_tpu_torch.bridge import load_jax_vae_params, vae_params_to_numpy
from umnn_tpu_torch.models.vae.losses import calculate_loss_array
from umnn_tpu_torch.models.vae.vae import VAE, VAE_FAMILIES


@pytest.fixture
def jax_eps(monkeypatch):
    return patch_jax_eps(monkeypatch)


@pytest.mark.parametrize("input_type", list(INPUTS))
@pytest.mark.parametrize("family", sorted(VAE_FAMILIES))
def test_family_forward_and_losses_match_jax(family, input_type, jax_eps):
    from umnn_tpu.models.vae.losses import calculate_loss_array as jarr

    jmodel, params, tmodel = _family_pair(family, input_type)
    x = _batch(input_type)
    out_j, loss_j = _jax_loss(jmodel, params, x, jax_eps, input_type)
    with torch.no_grad():
        out_t, loss_t = _port_loss(tmodel, x, input_type)
        arr_t = calculate_loss_array(out_t[0], _t(x), out_t[1], out_t[2], out_t[4], out_t[5],
                                     out_t[3], input_type, INPUTS[input_type])
    arr_j = jarr(out_j[0], x, out_j[1], out_j[2], out_j[4], out_j[5], out_j[3], input_type,
                 INPUTS[input_type])
    for name, a, b in zip(("x_mean", "z_mu", "z_var", "ldj", "z0", "zk"), out_t, out_j):
        assert a.shape == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FAMILY_TOL, err_msg=name)
    for name, a, b in zip(("loss", "rec", "kl", "bpd"), loss_t, loss_j):
        np.testing.assert_allclose(float(a), float(b), **FAMILY_TOL, err_msg=name)
    np.testing.assert_allclose(arr_t.numpy(), np.asarray(arr_j), **FAMILY_TOL)
    if input_type == "binary":
        assert float(loss_t[3]) == 0.0


def test_mmaf_family_on_both_routes_agrees():
    """MMAVAE on backend "kernel" (the plain version on the CPU) and "torch"."""
    _, params, tk = _family_pair("MMAF", "binary", "kernel")
    tp = load_jax_vae_params(
        VAE_FAMILIES["MMAF"](z_size=Z, **FLOW_KW["MMAF"], backend="torch", device="cpu"), params)
    x = _t(_batch("binary"))
    gk = torch.Generator().manual_seed(0)
    gp = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for a, b in zip(tk(x, gk), tp(x, gp)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **FAMILY_TOL)


def test_bridge_round_trip_and_reparameterize_draws_from_the_generator():
    import jax

    _, params, tmodel = _family_pair("iaf", "binary")
    back = vae_params_to_numpy(tmodel)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    mu, var = torch.zeros(2, 3), torch.ones(2, 3)
    a = VAE.reparameterize(mu, var, torch.Generator().manual_seed(5))
    b = VAE.reparameterize(mu, var, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, VAE.reparameterize(mu, var, None))


def test_multinomial_target_truncates_in_float32():
    """(x * 255) truncated, in float32, as JAX's astype does; the stand-in's
    floor(256 u) / 255 can land one level low."""
    from umnn_tpu.models.vae.losses import multinomial_loss_array as jarr

    from umnn_tpu_torch.models.vae.losses import multinomial_loss_array

    x = (np.arange(256, dtype=np.float32) / np.float32(255.0)).reshape(1, 1, 16, 16)
    x = np.repeat(x, 2, axis=0)
    logits = np.random.RandomState(3).randn(2, 256, 1, 16, 16).astype(np.float32)
    zeros = np.zeros((2, 2), np.float32)
    ones = np.ones((2, 2), np.float32)
    args = (zeros, ones, zeros, zeros, np.zeros(2, np.float32))
    got = multinomial_loss_array(_t(logits), _t(x), *map(_t, args), (1, 16, 16))
    want = jarr(logits, x, *args, (1, 16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_forward_runs_in_ieee_float32_and_leaves_the_callers_flags(monkeypatch):
    """With TF32 on before and after building, every convolution of the
    forward, encoder and decoder sees it off; the caller's flags are back
    after each call, an error included."""
    from umnn_tpu_torch.models.vae import layers as PL

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    for cls in (PL.GatedConv2d, PL.GatedConvTranspose2d):
        real = cls.forward

        def spy(self, x, real=real):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return real(self, x)

        monkeypatch.setattr(cls, "forward", spy)
    model = VAE_FAMILIES["planar"](z_size=Z, num_flows=2, seed=0, device="cpu")
    x = _t(_batch("binary"))
    with torch.no_grad():
        z = model(x, torch.Generator().manual_seed(0))[5]
        model.encode(x)
        model.decode(z)
    assert len(seen) == 2 * 6 + 6 + 6 and not any(a or b for a, b in seen)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(RuntimeError):
        model.decode(torch.zeros(2, Z + 1))
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_forward_takes_the_callers_noise():
    model = VAE(z_size=Z, seed=0, device="cpu")
    x = _t(_batch("binary"))
    eps = torch.randn(len(x), Z, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        drawn = model(x, torch.Generator().manual_seed(4))
        given = model(x, None, eps=eps)
    for a, b in zip(drawn, given):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
