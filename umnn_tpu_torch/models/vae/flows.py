"""Normalizing flows for the VAE posteriors.

PyTorch counterpart of `umnn_tpu/models/vae/flows.py`: the planar,
Sylvester and triangular Sylvester transforms, functions of amortized
parameters that return ``(z_next, log_det_jacobian)``; the Householder
product and the fixed 30-step iterative orthogonalization, as JAX runs
them (the reference's loop to a tolerance is not followed); ``IAF``, the
masked inverse autoregressive flow; and ``MMAF``, the UMNN flow
conditioned on the encoder's context, whose integrals go to the CUDA
kernel pairs on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.models.vae.layers import MaskedLinear
from umnn_tpu_torch.nn.core import resolve_device

__all__ = [
    "IAF",
    "MMAF",
    "householder_orthogonalize",
    "iterative_orthogonalize",
    "planar_flow",
    "sylvester_flow",
    "triangular_sylvester_flow",
]


def planar_flow(z, u, w, b):
    """``z' = z + u_hat tanh(w^T z + b)`` with the invertibility
    reparameterization of u (`flows.py:27-41`). z ``[B, Z]``, u ``[B, Z, 1]``,
    w ``[B, 1, Z]``, b ``[B, 1, 1]``."""
    zk = z[..., None]
    uw = torch.bmm(w, u)
    m_uw = -1.0 + F.softplus(uw)
    w_norm_sq = torch.sum(w**2, dim=2, keepdim=True)
    u_hat = u + (m_uw - uw) * w.transpose(1, 2) / w_norm_sq
    wzb = torch.bmm(w, zk) + b
    z_next = (zk + u_hat * torch.tanh(wzb))[..., 0]
    psi = w * (1 - torch.tanh(wzb) ** 2)
    log_det = torch.log(torch.abs(1.0 + torch.bmm(psi, u_hat)))[:, 0, 0]
    return z_next, log_det


def sylvester_flow(z, r1, r2, q_ortho, b):
    """``z' = z + Q r1 tanh(r2 Q^T z + b)`` (`flows.py:44-60`). z ``[B, Z]``,
    r1 and r2 ``[B, M, M]`` upper triangular, q_ortho ``[B, Z, M]``,
    b ``[B, 1, M]``."""
    zk = z[:, None, :]
    diag_r1 = torch.diagonal(r1, dim1=1, dim2=2)
    diag_r2 = torch.diagonal(r2, dim1=1, dim2=2)
    qr2 = torch.bmm(q_ortho, r2.transpose(1, 2))  # Q r2^T
    qr1 = torch.bmm(q_ortho, r1)  # Q r1
    r2qzb = torch.bmm(zk, qr2) + b
    z_next = (torch.bmm(torch.tanh(r2qzb), qr1.transpose(1, 2)) + zk)[:, 0, :]
    diag_j = 1.0 + (1 - torch.tanh(r2qzb[:, 0, :]) ** 2) * diag_r1 * diag_r2
    log_det = torch.sum(torch.log(torch.abs(diag_j)), dim=-1)
    return z_next, log_det


def triangular_sylvester_flow(z, r1, r2, b, permute: bool):
    """The Sylvester flow with Q the identity or the reversal permutation
    (`flows.py:63-77`)."""
    zk = z[:, None, :]
    diag_r1 = torch.diagonal(r1, dim1=1, dim2=2)
    diag_r2 = torch.diagonal(r2, dim1=1, dim2=2)
    z_per = torch.flip(zk, dims=(-1,)) if permute else zk
    r2qzb = torch.bmm(z_per, r2.transpose(1, 2)) + b
    zn = torch.bmm(torch.tanh(r2qzb), r1.transpose(1, 2))
    if permute:
        zn = torch.flip(zn, dims=(-1,))
    z_next = (zn + zk)[:, 0, :]
    diag_j = 1.0 + (1 - torch.tanh(r2qzb[:, 0, :]) ** 2) * diag_r1 * diag_r2
    log_det = torch.sum(torch.log(torch.abs(diag_j)), dim=-1)
    return z_next, log_det


def householder_orthogonalize(q: torch.Tensor, z_size: int, num_householder: int) -> torch.Tensor:
    """The product of Householder reflections ``I - 2 v_k v_k^T``, each new
    one multiplied on the left of the running product (`flows.py:80-94`).
    q ``[B, num_householder * z_size]`` to ``[B, Z, Z]``."""
    v = q.reshape(-1, num_householder, z_size)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    eye = torch.eye(z_size, dtype=q.dtype, device=q.device)
    amat = eye[None, None] - 2.0 * v[..., :, None] * v[..., None, :]
    out = amat[:, 0]
    for k in range(1, num_householder):
        out = torch.bmm(amat[:, k], out)
    return out


def iterative_orthogonalize(
    q: torch.Tensor, z_size: int, num_ortho_vecs: int, steps: int = 30
) -> torch.Tensor:
    """Björck's iteration ``A <- A (I + (I - A^T A) / 2)``, exactly ``steps``
    times, from ``q`` scaled to unit norm (`flows.py:97-115`).
    q ``[B, z_size * num_ortho_vecs]`` to ``[B, Z, M]``."""
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    amat = (q / norm).reshape(-1, z_size, num_ortho_vecs)
    eye = torch.eye(num_ortho_vecs, dtype=q.dtype, device=q.device)[None]
    for _ in range(steps):
        tmp = eye + 0.5 * (eye - torch.bmm(amat.transpose(1, 2), amat))
        amat = torch.bmm(amat, tmp)
    return amat


class _IAFStep(nn.Module):
    def __init__(self, z_size, h_size, num_hidden, gen, device):
        super().__init__()
        self.z_feat = MaskedLinear(z_size, h_size, gen, device=device)
        self.zh_feats = nn.ModuleList(
            MaskedLinear(h_size, h_size, gen, device=device) for _ in range(num_hidden)
        )
        self.mean = MaskedLinear(h_size, z_size, gen, diagonal_zeros=True, device=device)
        self.std = MaskedLinear(h_size, z_size, gen, diagonal_zeros=True, device=device)


class IAF(nn.Module):
    """The masked inverse autoregressive flow with sigmoid gating,
    ``z <- sigma(s) z + (1 - sigma(s)) m`` (`flows.py:118-178`): ``z`` is
    reversed before every second flow, the context is added after the
    first masked layer, ``forget_bias`` 1.0, the output masks have
    diagonal zeros. On ``device``, the card unless the caller names
    another."""

    def __init__(
        self, z_size: int, num_flows: int = 2, num_hidden: int = 1, h_size: int = 50,
        forget_bias: float = 1.0, seed: int = 0, device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.forget_bias = forget_bias
        self.flows = nn.ModuleList(
            _IAFStep(z_size, h_size, num_hidden, gen, device) for _ in range(num_flows)
        )

    def forward(self, z: torch.Tensor, h_context: torch.Tensor):
        log_dets = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for i, step in enumerate(self.flows):
            if (i + 1) % 2 == 0:
                z = torch.flip(z, dims=(-1,))
            h = F.elu(step.z_feat(z))
            h = h + h_context
            for layer in step.zh_feats:
                h = F.elu(layer(h))
            mean = step.mean(h)
            gate = torch.sigmoid(step.std(h) + self.forget_bias)
            z = gate * z + (1 - gate) * mean
            log_dets = log_dets + torch.sum(torch.log(gate), dim=-1)
        return z, log_dets


class MMAF(nn.Module):
    """A :class:`UMNNMAFFlow` conditioned on the encoder context
    (``cond_in = h_size``), `flows.py:181-226`.

    ``forward(z, h_context, nodes=None, weights=None)`` returns ``(z_k,
    log_jac.sum(-1))`` through ``compute_log_jac_bis``. Randomized steps
    pass padded nodes and weights at call time. ``backend``: ``"kernel"``,
    ``"torch"`` or ``"auto"`` (JAX's ``"pallas"``, ``"xla"``, ``"auto"``);
    on the kernel route every block's integral is one launch of a kernel
    pair, picked by the integrand's widths.
    """

    def __init__(
        self,
        z_size: int,
        num_flows: int = 2,
        h_size: int = 50,
        hidden_derivative: Sequence[int] = (50, 50, 50, 50),
        hidden_embedding: Sequence[int] = (512, 512),
        embedding_size: int = 30,
        nb_steps: int = 50,
        solver: str = "CCParallel",
        backend: str = "auto",
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.flow = UMNNMAFFlow(
            nb_flow=num_flows, nb_in=z_size, hidden_derivative=tuple(hidden_derivative),
            hidden_embedding=tuple(hidden_embedding), embedding_s=embedding_size,
            nb_steps=nb_steps or 50, backend=backend, seed=seed,
            device=resolve_device(device), cond_in=h_size, solver=solver,
        )

    def forward(self, z, h_context, nodes=None, weights=None):
        z_k, log_jac = self.flow.compute_log_jac_bis(z, h_context, nodes=nodes, weights=weights)
        return z_k, torch.sum(log_jac, dim=-1)

    def force_lipschitz(self, L: float = 1.5, generator=None) -> None:
        """Project the integrand layers in place; nothing unless ``L > 0``."""
        if L > 0:
            self.flow.force_lipschitz(L, generator)
