"""The VAE family with normalizing-flow posteriors.

PyTorch counterpart of `umnn_tpu/models/vae/vae.py`. The encoder is a
gated convnet [32, 32 s2, 64, 64 s2, 64, 256 (the last kernel)] to a
256-wide feature, a linear mean head and a Softplus variance head; the
decoder mirrors it with gated transposed convolutions and a sigmoid
Bernoulli head (binary input), or 256-way logits per subpixel
(multinomial). ``forward(x, generator)`` returns JAX's 6-tuple ``(x_mean,
z_mu, z_var, log_det_j, z0, z_k)``; ``reparameterize(mu, var, generator)``
draws ``eps`` from ``generator``, which lives on the model's device, unless
the forward is handed ``eps`` (a rank's rows of a larger draw);
``transform(h, z0)`` is the posterior's flow alone, amortized on the
encoder's features ``h``.

Families (``VAE_FAMILIES``, JAX's keys): no flow, planar, orthogonal and
Householder Sylvester, triangular Sylvester, IAF and the UMNN MMAF
(``MMAVAE``, whose ``forward`` also takes ``nodes`` and ``weights``). Each
draws its weights from ``torch.Generator``s seeded from ``seed`` (the
encoder and decoder ``seed``, the posterior's layers ``seed + 1``, an IAF
or MMAF flow ``seed + 2``) and
lives on ``device``, the card unless the caller names another. The
forward, ``encode_features`` and ``decode`` run under
:func:`~umnn_tpu_torch.models.vae.layers.ieee_float32`: the convolutions
run in IEEE float32 on the card whatever the caller's TF32 flags, which
they leave as they found them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from umnn_tpu_torch.models.vae import flows as FL
from umnn_tpu_torch.models.vae.layers import (
    GatedConv2d,
    GatedConvTranspose2d,
    conv2d_layer,
    ieee_float32,
)
from umnn_tpu_torch.nn.core import resolve_device, torch_linear_init

__all__ = [
    "FEAT_DIM",
    "HouseholderSylvesterVAE",
    "IAFVAE",
    "MMAVAE",
    "OrthogonalSylvesterVAE",
    "PlanarVAE",
    "TriangularSylvesterVAE",
    "VAE",
    "VAE_FAMILIES",
]

FEAT_DIM = 256  # the encoder's feature width (`vae.py:32`)


def _last_kernel(input_size):
    if list(input_size) in ([1, 28, 28], [3, 28, 28]):
        return (7, 7)
    if list(input_size) == [1, 28, 20]:
        return (7, 5)
    raise ValueError(f"invalid input size {input_size}")


class VAE(nn.Module):
    """The base VAE: gated conv encoder and decoder, no flow (z_0 = z_k)."""

    def __init__(
        self,
        z_size: int = 64,
        input_size: Sequence[int] = (1, 28, 28),
        input_type: str = "binary",
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.z_size = z_size
        self.input_size = tuple(input_size)
        self.input_type = input_type
        self.last_kernel_size = _last_kernel(self.input_size)
        self.seed = seed
        gen = torch.Generator().manual_seed(seed)
        c, lk = self.input_size[0], self.last_kernel_size
        enc = [(c, 32, 5, 1, 2), (32, 32, 5, 2, 2), (32, 64, 5, 1, 2), (64, 64, 5, 2, 2),
               (64, 64, 5, 1, 2), (64, FEAT_DIM, lk, 1, 0)]
        self.q_z_nn = nn.ModuleList(
            GatedConv2d(i, o, k, gen, s, p, device=device) for i, o, k, s, p in enc)
        self.q_z_mean = torch_linear_init(gen, FEAT_DIM, z_size, device)
        self.q_z_var = torch_linear_init(gen, FEAT_DIM, z_size, device)
        dec = [(z_size, 64, lk, 1, 0, 0), (64, 64, 5, 1, 2, 0), (64, 32, 5, 2, 2, 1),
               (32, 32, 5, 1, 2, 0), (32, 32, 5, 2, 2, 1), (32, 32, 5, 1, 2, 0)]
        self.p_x_nn = nn.ModuleList(
            GatedConvTranspose2d(i, o, k, gen, s, p, op, device=device)
            for i, o, k, s, p, op in dec)
        if input_type == "binary":
            head = [conv2d_layer(32, c, 1, gen, device=device)]
        else:
            head = [conv2d_layer(32, 256, 5, gen, padding=2, device=device),
                    conv2d_layer(256, c * 256, 1, gen, device=device)]
        self.p_x_mean = nn.ModuleList(head)

    def posterior_generator(self) -> torch.Generator:
        """The generator a family draws its posterior's layers from, seeded
        apart from the encoder's and decoder's."""
        return torch.Generator().manual_seed(self.seed + 1)

    @property
    def device(self) -> torch.device:
        return self.q_z_mean.weight.device

    @ieee_float32()
    def encode_features(self, x: torch.Tensor) -> torch.Tensor:
        """The gated convnet to a flat 256-wide feature."""
        h = x
        for layer in self.q_z_nn:
            h = layer(h)
        return h.reshape(h.shape[0], -1)

    def _heads(self, h: torch.Tensor):
        return self.q_z_mean(h), F.softplus(self.q_z_var(h))

    def encode(self, x: torch.Tensor):
        mean, var = self._heads(self.encode_features(x))
        if self.input_type == "multinomial":
            var = torch.clamp(var, 0.01, 7.0)  # the Hardtanh bound (`vae.py:117`)
        return mean, var

    @ieee_float32()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = z.reshape(z.shape[0], self.z_size, 1, 1)
        for layer in self.p_x_nn:
            h = layer(h)
        if self.input_type == "binary":
            return torch.sigmoid(self.p_x_mean[0](h))
        return self.p_x_mean[1](self.p_x_mean[0](h))  # raw 256-way logits

    @staticmethod
    def reparameterize(mu: torch.Tensor, var: torch.Tensor, generator: torch.Generator):
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        return mu + eps * torch.sqrt(var)

    def _z0(self, mu, var, generator, eps):
        """:meth:`reparameterize`'s draw, or ``mu + eps sqrt(var)`` on the
        caller's ``eps``."""
        if eps is None:
            return self.reparameterize(mu, var, generator)
        return mu + eps * torch.sqrt(var)

    def transform(self, h: torch.Tensor, z0: torch.Tensor):
        """The posterior's flow from ``z0``, amortized on the features ``h``:
        ``(z_k, log_det_j)``; none here."""
        return z0, torch.zeros(z0.shape[0], dtype=z0.dtype, device=z0.device)

    @ieee_float32()
    def forward(self, x: torch.Tensor, generator: torch.Generator, eps=None):
        z_mu, z_var = self.encode(x)
        z = self._z0(z_mu, z_var, generator, eps)
        return self.decode(z), z_mu, z_var, self.transform(None, z)[1], z, z


class _FlowVAE(VAE):
    """A VAE whose posterior is a flow, :meth:`transform`, amortized on the
    encoder's features (its variance head is not bounded)."""

    @ieee_float32()
    def forward(self, x: torch.Tensor, generator: torch.Generator, eps=None, **quad):
        h = self.encode_features(x)
        z_mu, z_var = self._heads(h)
        z0 = self._z0(z_mu, z_var, generator, eps)
        z_k, ldj = self.transform(h, z0, **quad)
        return self.decode(z_k), z_mu, z_var, ldj, z0, z_k


class PlanarVAE(_FlowVAE):
    """The planar-flow posterior (`vae.py:147-183`)."""

    def __init__(self, z_size=64, input_size=(1, 28, 28), input_type="binary",
                 num_flows: int = 4, seed: int = 0, device=None):
        super().__init__(z_size, input_size, input_type, seed, device)
        self.num_flows = num_flows
        gen, dev, Z = self.posterior_generator(), self.device, self.z_size
        self.amor_u = torch_linear_init(gen, FEAT_DIM, num_flows * Z, dev)
        self.amor_w = torch_linear_init(gen, FEAT_DIM, num_flows * Z, dev)
        self.amor_b = torch_linear_init(gen, FEAT_DIM, num_flows, dev)

    def transform(self, h, z0):
        B, nf, Z = h.shape[0], self.num_flows, self.z_size
        u = self.amor_u(h).reshape(B, nf, Z, 1)
        w = self.amor_w(h).reshape(B, nf, 1, Z)
        b = self.amor_b(h).reshape(B, nf, 1, 1)
        z, ldj = z0, torch.zeros(B, dtype=z0.dtype, device=z0.device)
        for k in range(nf):
            z, ld = FL.planar_flow(z, u[:, k], w[:, k], b[:, k])
            ldj = ldj + ld
        return z, ldj


class _SylvesterVAE(_FlowVAE):
    """The amortization shared by the Sylvester families: ``amor_d`` (strict
    upper triangles), ``amor_diag1`` and ``amor_diag2`` (tanh-bounded
    diagonals), ``amor_b`` and, with ``q_dim``, ``amor_q``
    (`vae.py:186-222`)."""

    def __init__(self, z_size, input_size, input_type, num_flows, m, q_dim, seed, device):
        super().__init__(z_size, input_size, input_type, seed, device)
        self.num_flows = num_flows
        self.m = m
        gen, dev = self.posterior_generator(), self.device
        self.amor_d = torch_linear_init(gen, FEAT_DIM, num_flows * m * m, dev)
        self.amor_diag1 = torch_linear_init(gen, FEAT_DIM, num_flows * m, dev)
        self.amor_diag2 = torch_linear_init(gen, FEAT_DIM, num_flows * m, dev)
        self.amor_b = torch_linear_init(gen, FEAT_DIM, num_flows * m, dev)
        if q_dim:
            self.amor_q = torch_linear_init(gen, FEAT_DIM, num_flows * q_dim, dev)

    def _amortize(self, h):
        B, m, nf = h.shape[0], self.m, self.num_flows
        full_d = self.amor_d(h).reshape(B, m, m, nf)
        diag1 = torch.tanh(self.amor_diag1(h).reshape(B, m, nf))
        diag2 = torch.tanh(self.amor_diag2(h).reshape(B, m, nf))
        triu = torch.triu(torch.ones(m, m, dtype=h.dtype, device=h.device), 1)[None, :, :, None]
        eye = torch.eye(m, dtype=h.dtype, device=h.device)[None, :, :, None]
        r1 = full_d * triu + eye * diag1[:, :, None, :]
        r2 = full_d.transpose(1, 2) * triu + eye * diag2[:, :, None, :]
        b = self.amor_b(h).reshape(B, 1, m, nf)
        return r1, r2, b

    def _q(self, h):
        return None

    def _step(self, k, z, r1, r2, q, b):
        return FL.sylvester_flow(z, r1[..., k], r2[..., k], q[:, k], b[..., k])

    def transform(self, h, z0):
        r1, r2, b = self._amortize(h)
        q = self._q(h)
        z, ldj = z0, torch.zeros(h.shape[0], dtype=z0.dtype, device=z0.device)
        for k in range(self.num_flows):
            z, ld = self._step(k, z, r1, r2, q, b)
            ldj = ldj + ld
        return z, ldj


class OrthogonalSylvesterVAE(_SylvesterVAE):
    """The Sylvester flow with an iteratively orthogonalized Q
    (`vae.py:226-268`)."""

    def __init__(self, z_size=64, input_size=(1, 28, 28), input_type="binary",
                 num_flows: int = 4, num_ortho_vecs: int = 32, seed: int = 0, device=None):
        super().__init__(z_size, input_size, input_type, num_flows, num_ortho_vecs,
                         z_size * num_ortho_vecs, seed, device)

    def _q(self, h):
        B, m = h.shape[0], self.m
        q = self.amor_q(h).reshape(B * self.num_flows, self.z_size * m)
        return FL.iterative_orthogonalize(q, self.z_size, m).reshape(
            B, self.num_flows, self.z_size, m)


class HouseholderSylvesterVAE(_SylvesterVAE):
    """The Sylvester flow with a Householder-product Q (`vae.py:272-314`)."""

    def __init__(self, z_size=64, input_size=(1, 28, 28), input_type="binary",
                 num_flows: int = 4, num_householder: int = 8, seed: int = 0, device=None):
        super().__init__(z_size, input_size, input_type, num_flows, z_size,
                         z_size * num_householder, seed, device)
        self.num_householder = num_householder

    def _q(self, h):
        B, Z = h.shape[0], self.z_size
        q = self.amor_q(h).reshape(B * self.num_flows, -1)
        return FL.householder_orthogonalize(q, Z, self.num_householder).reshape(
            B, self.num_flows, Z, Z)


class TriangularSylvesterVAE(_SylvesterVAE):
    """The Sylvester flow with Q the identity and the reversal in turn
    (`vae.py:318-347`)."""

    def __init__(self, z_size=64, input_size=(1, 28, 28), input_type="binary",
                 num_flows: int = 4, seed: int = 0, device=None):
        super().__init__(z_size, input_size, input_type, num_flows, z_size, 0, seed, device)

    def _step(self, k, z, r1, r2, q, b):
        return FL.triangular_sylvester_flow(z, r1[..., k], r2[..., k], b[..., k],
                                            permute=(k % 2 == 1))


class IAFVAE(_FlowVAE):
    """The IAF posterior with the encoder's context (`vae.py:351-383`)."""

    def __init__(self, z_size=64, input_size=(1, 28, 28), input_type="binary",
                 num_flows: int = 4, made_h_size: int = 320, seed: int = 0, device=None):
        super().__init__(z_size, input_size, input_type, seed, device)
        self.num_flows = num_flows
        self.h_context = torch_linear_init(self.posterior_generator(), FEAT_DIM, made_h_size,
                                           self.device)
        self.flow = FL.IAF(self.z_size, num_flows, 1, made_h_size, seed=seed + 2,
                           device=self.device)

    def transform(self, h, z0):
        return self.flow(z0, self.h_context(h))


class MMAVAE(_FlowVAE):
    """The UMNN-VAE: the MMAF posterior conditioned on the encoder's
    context (`vae.py:387-433`). ``backend``: ``"auto"`` (the kernel pairs
    on the card), ``"kernel"`` or ``"torch"``."""

    def __init__(
        self,
        z_size: int = 64,
        input_size: Sequence[int] = (1, 28, 28),
        input_type: str = "binary",
        num_flows: int = 4,
        made_h_size: int = 320,
        hidden_derivative: Sequence[int] = (50, 50, 50, 50),
        hidden_embedding: Sequence[int] = (512, 512),
        embedding_size: int = 30,
        nb_steps: int = 50,
        backend: str = "auto",
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        super().__init__(z_size, input_size, input_type, seed, device)
        self.num_flows = num_flows
        self.h_context = torch_linear_init(self.posterior_generator(), FEAT_DIM, made_h_size,
                                           self.device)
        self.flow = FL.MMAF(
            self.z_size, num_flows, made_h_size, hidden_derivative, hidden_embedding,
            embedding_size, nb_steps, backend=backend, seed=seed + 2, device=self.device,
        )

    def transform(self, h, z0, nodes=None, weights=None):
        return self.flow(z0, self.h_context(h), nodes, weights)

    def force_lipschitz(self, L: float = 1.5, generator=None) -> None:
        self.flow.force_lipschitz(L, generator)


VAE_FAMILIES = {
    "no_flow": VAE,
    "planar": PlanarVAE,
    "orthogonal": OrthogonalSylvesterVAE,
    "householder": HouseholderSylvesterVAE,
    "triangular": TriangularSylvesterVAE,
    "iaf": IAFVAE,
    "MMAF": MMAVAE,
}
