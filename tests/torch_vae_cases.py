"""Shared cases of the VAE parity tests: the families at a small size
on JAX's weights, a batch of each input type, and JAX's noise handed to
the port."""

import numpy as np
import torch

from umnn_tpu_torch.bridge import load_jax_vae_params
from umnn_tpu_torch.models.vae.losses import calculate_loss
from umnn_tpu_torch.models.vae.vae import VAE, VAE_FAMILIES

FAMILY_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_GAP = 1e-4
Z = 4
B = 3
FLOW_KW = {
    "no_flow": {},
    "planar": dict(num_flows=2),
    "orthogonal": dict(num_flows=2, num_ortho_vecs=2),
    "householder": dict(num_flows=2, num_householder=3),
    "triangular": dict(num_flows=3),
    "iaf": dict(num_flows=2, made_h_size=16),
    "MMAF": dict(num_flows=2, made_h_size=16, hidden_derivative=(8, 8),
                 hidden_embedding=(16, 16), embedding_size=4, nb_steps=10),
}
INPUTS = {"binary": (1, 28, 28), "multinomial": (1, 28, 20)}


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _family_pair(family, input_type, backend="kernel"):
    import jax
    from umnn_tpu.models.vae import VAE_FAMILIES as JAX_FAMILIES

    input_size = INPUTS[input_type]
    kw = dict(z_size=Z, input_size=input_size, input_type=input_type, **FLOW_KW[family])
    jkw = dict(kw, backend="xla") if family == "MMAF" else kw
    jmodel = JAX_FAMILIES[family](**jkw)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(0)))
    tkw = dict(kw, backend=backend) if family == "MMAF" else kw
    tmodel = VAE_FAMILIES[family](**tkw, device="cpu")
    load_jax_vae_params(tmodel, params)
    return jmodel, params, tmodel


def _batch(input_type):
    c, h, w = INPUTS[input_type]
    u = np.random.RandomState(21).rand(B, c, h, w)
    if input_type == "binary":
        return (u > 0.5).astype(np.float32)
    return (np.floor(u * 256) / 255.0).astype(np.float32)


def patch_jax_eps(monkeypatch):
    """JAX's noise from key 2, handed to the port's reparameterize."""
    import jax

    key = jax.random.PRNGKey(2)
    eps = np.asarray(jax.random.normal(key, (B, Z), np.float32))
    monkeypatch.setattr(VAE, "reparameterize",
                        staticmethod(lambda mu, var, gen: mu + _t(eps) * torch.sqrt(var)))
    return key


def _jax_loss(jmodel, params, x, key, input_type):
    """JAX's 6-tuple and calculate_loss, compiled as one function."""
    import jax
    import jax.numpy as jnp
    from umnn_tpu.models.vae.losses import calculate_loss as jloss

    def fn(p, xx, k):
        out = jmodel.apply(p, xx, k)
        return out, jloss(out[0], xx, out[1], out[2], out[4], out[5], out[3], input_type,
                          INPUTS[input_type])

    return jax.jit(fn)(params, jnp.asarray(x), key)


def _port_loss(tmodel, x, input_type):
    out = tmodel(_t(x), None)
    loss = calculate_loss(out[0], _t(x), out[1], out[2], out[4], out[5], out[3],
                          input_type, INPUTS[input_type])
    return out, loss


