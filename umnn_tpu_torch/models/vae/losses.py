"""ELBO losses of the VAE family.

PyTorch counterpart of `umnn_tpu/models/vae/losses.py`: binary, BCE with
the probabilities clipped to ``[1e-5, 1 - 1e-5]`` (not torch's
``binary_cross_entropy``, which clamps the log at -100), plus ``beta``
times ``log q(z0) - log p(zk) - ldj``, each term averaged over the batch;
multinomial, the 256-way cross-entropy of each subpixel, its target
``(x * 255)`` truncated to an integer in float32 as JAX's ``astype``
does. The ``_array`` forms return one loss per row, for IWAE.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from umnn_tpu_torch.models.vae.distributions import (
    MAX_EPSILON,
    MIN_EPSILON,
    log_bernoulli,
    log_normal_diag,
    log_normal_standard,
)

__all__ = [
    "NUM_CLASSES",
    "binary_loss",
    "binary_loss_array",
    "bits_per_dim",
    "calculate_loss",
    "calculate_loss_array",
    "multinomial_loss",
    "multinomial_loss_array",
]

NUM_CLASSES = 256


def _flat(x):
    return x.reshape(x.shape[0], -1)


def _kl_terms(z_mu, z_var, z0, zk):
    return log_normal_diag(z0, z_mu, torch.log(z_var)) - log_normal_standard(zk)


def binary_loss(recon_x, x, z_mu, z_var, z0, zk, ldj, beta=1.0):
    """``(loss, bce, kl)``, each averaged over the batch."""
    B = x.shape[0]
    probs = torch.clamp(_flat(recon_x), MIN_EPSILON, MAX_EPSILON)
    bce = -torch.sum(_flat(x) * torch.log(probs) + (1 - _flat(x)) * torch.log(1 - probs))
    kl = torch.sum(_kl_terms(z_mu, z_var, z0, zk)) - torch.sum(ldj)
    loss = bce + beta * kl
    return loss / B, bce / B, kl / B


def _subpixel_ce(x_logit, x, input_size):
    """Per-row cross-entropy of the 256-way subpixel logits."""
    B = x.shape[0]
    c, hh, ww = input_size
    logits = x_logit.reshape(B, NUM_CLASSES, c, hh, ww)
    target = (x * (NUM_CLASSES - 1)).to(torch.int64).reshape(B, 1, c, hh, ww)
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, target).reshape(B, -1).sum(1)


def multinomial_loss(x_logit, x, z_mu, z_var, z0, zk, ldj, input_size, beta=1.0):
    """``(loss, ce, kl)`` of the 256-way subpixel ELBO; x in ``[0, 1]``."""
    B = x.shape[0]
    ce = torch.sum(_subpixel_ce(x_logit, x, input_size))
    kl = torch.sum(_kl_terms(z_mu, z_var, z0, zk)) - torch.sum(ldj)
    loss = ce + beta * kl
    return loss / B, ce / B, kl / B


def binary_loss_array(recon_x, x, z_mu, z_var, z0, zk, ldj, beta=1.0):
    """The binary ELBO of each row."""
    bce = -log_bernoulli(_flat(x), _flat(recon_x))
    return bce + beta * (_kl_terms(z_mu, z_var, z0, zk) - ldj)


def multinomial_loss_array(x_logit, x, z_mu, z_var, z0, zk, ldj, input_size, beta=1.0):
    """The multinomial ELBO of each row."""
    ce = _subpixel_ce(x_logit, x, input_size)
    return ce + beta * (_kl_terms(z_mu, z_var, z0, zk) - ldj)


def bits_per_dim(nats, input_size):
    """Nats to bits per dimension: ``nats / (prod(input_size) ln 2)``."""
    return nats / (float(np.prod(input_size)) * math.log(2.0))


def calculate_loss(x_mean, x, z_mu, z_var, z0, zk, ldj, input_type, input_size, beta=1.0):
    """``(loss, rec, kl, bpd)``: ``bpd`` is the multinomial ELBO's bits per
    dimension, 0 for binary inputs (`losses.py:94-109`)."""
    if input_type == "binary":
        loss, rec, kl = binary_loss(x_mean, x, z_mu, z_var, z0, zk, ldj, beta)
        bpd = torch.zeros((), device=loss.device)
    else:
        loss, rec, kl = multinomial_loss(x_mean, x, z_mu, z_var, z0, zk, ldj, input_size, beta)
        bpd = bits_per_dim(loss, input_size)
    return loss, rec, kl, bpd


def calculate_loss_array(x_mean, x, z_mu, z_var, z0, zk, ldj, input_type, input_size):
    """The ELBO of each row, either input type."""
    if input_type == "binary":
        return binary_loss_array(x_mean, x, z_mu, z_var, z0, zk, ldj)
    return multinomial_loss_array(x_mean, x, z_mu, z_var, z0, zk, ldj, input_size)
