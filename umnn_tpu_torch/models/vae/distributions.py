"""Log-densities of the VAE stack.

PyTorch counterpart of `umnn_tpu/models/vae/distributions.py`.
``log_normal_diag`` and ``log_normal_standard`` leave out the
``-0.5 log(2 pi)`` term, which cancels in the KL of every ELBO here;
``log_normal_normalized`` keeps it. ``log_bernoulli`` clips the
probabilities to ``[MIN_EPSILON, MAX_EPSILON]`` before the logs.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "MAX_EPSILON",
    "MIN_EPSILON",
    "log_bernoulli",
    "log_normal_diag",
    "log_normal_normalized",
    "log_normal_standard",
]

MIN_EPSILON = 1e-5
MAX_EPSILON = 1.0 - 1e-5


def log_normal_diag(x, mean, log_var, reduce_dim=-1):
    log_norm = -0.5 * (log_var + (x - mean) ** 2 * torch.exp(-log_var))
    return torch.sum(log_norm, dim=reduce_dim)


def log_normal_normalized(x, mean, log_var, reduce_dim=-1):
    log_norm = (
        -((x - mean) ** 2) / (2.0 * torch.exp(log_var))
        - 0.5 * log_var
        - 0.5 * math.log(2.0 * math.pi)
    )
    return torch.sum(log_norm, dim=reduce_dim)


def log_normal_standard(x, reduce_dim=-1):
    return torch.sum(-0.5 * x * x, dim=reduce_dim)


def log_bernoulli(x, mean, reduce_dim=-1):
    probs = torch.clamp(mean, MIN_EPSILON, MAX_EPSILON)
    log_bern = x * torch.log(probs) + (1.0 - x) * torch.log(1.0 - probs)
    return torch.sum(log_bern, dim=reduce_dim)
