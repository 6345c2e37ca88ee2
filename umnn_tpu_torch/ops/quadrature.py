"""Clenshaw-Curtis quadrature engine, forward only.

PyTorch counterpart of `umnn_tpu/ops/quadrature.py`: the node/weight rule
(`:62-99`) and the plain node-megabatch quadrature of the reference's
"CCParallel" solver (`integrate`, `neural_integral`, `:130-182,306-331`).
The memory-efficient Leibniz-rule backward (`:252-303`) is not ported yet;
gradients through :func:`integrate` come from autograd over the node sum.

With nodes ``t_i = cos(i*pi/N)`` (from +1 down to -1) and CC weights ``w_i``:

    I(x0, xT) = (xT - x0)/2 * sum_i w_i f(x0 + (xT - x0)(t_i + 1)/2, h)
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["cc_quadrature", "integrate", "neural_integral"]

# f(x, h) -> values, on the last axis; leading batch axes broadcast.
Integrand = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_cc_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def cc_quadrature(nb_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes and weights of (N+1)-point Clenshaw-Curtis quadrature on [-1, 1].

    Nodes are the Chebyshev extrema ``t_i = cos(i*pi/N)``, ordered +1 to -1.
    Weights come from the even Chebyshev moments ``2/(1-k^2)``; both the node
    sum and the moment sum are double-primed, so the k=N moment is halved
    too, which makes the rule exact for polynomials of degree <= N.

    Returns float64 numpy arrays (cast at use sites); cached per step count.
    """
    if nb_steps < 1:
        raise ValueError(f"nb_steps must be >= 1, got {nb_steps}")
    if nb_steps in _cc_cache:
        return _cc_cache[nb_steps]
    n = nb_steps
    i = np.arange(n + 1)
    nodes = np.cos(i * np.pi / n)
    k = i.astype(np.float64)
    with np.errstate(divide="ignore"):
        moments = np.where(i % 2 == 0, 2.0 / (1.0 - k**2), 0.0)
    moments[0] = 1.0  # half of 2/(1-0^2)
    if n % 2 == 0:
        moments[-1] *= 0.5
    cosmat = np.cos(np.outer(i, i) * np.pi / n) * (2.0 / n)
    weights = cosmat @ moments
    weights[0] *= 0.5
    weights[-1] *= 0.5
    _cc_cache[nb_steps] = (nodes, weights)
    return nodes, weights


def cc_tensors(
    nb_steps: int, device: torch.device | str, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cc_quadrature` as tensors on ``device``."""
    nodes, weights = cc_quadrature(nb_steps)
    return (
        torch.as_tensor(nodes, dtype=dtype, device=device),
        torch.as_tensor(weights, dtype=dtype, device=device),
    )


def integrate(
    integrand: Integrand,
    x0: torch.Tensor,
    xT: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    weights: torch.Tensor,
    inv_f: bool = False,
) -> torch.Tensor:
    """Plain Clenshaw-Curtis quadrature over every node in one megabatch.

    ``x0, xT: [..., D]``, ``h: [..., E]`` -> integral ``[..., D]``. The node
    axis is a leading batch axis of one integrand call, shape ``[..., K, D]``.
    """
    half = (xT - x0) * 0.5
    X = x0[..., None, :] + half[..., None, :] * (nodes[:, None] + 1.0)
    K = X.shape[-2]
    h_b = h[..., None, :].expand(*h.shape[:-1], K, h.shape[-1])
    f = integrand(X, h_b)
    if inv_f:
        f = 1.0 / f
    z = torch.einsum("...kd,k->...d", f, weights)
    return z * half


def neural_integral(
    integrand: Integrand,
    x0: torch.Tensor,
    xT: torch.Tensor,
    h: torch.Tensor,
    nb_steps: int | None = None,
    *,
    nodes: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    inv_f: bool = False,
) -> torch.Tensor:
    """``∫_{x0}^{xT} f(t, h) dt``: pass ``nb_steps`` or explicit nodes/weights."""
    if nodes is None or weights is None:
        if nb_steps is None:
            raise ValueError("pass nb_steps or explicit nodes/weights")
        nodes, weights = cc_tensors(nb_steps, xT.device, xT.dtype)
    return integrate(integrand, x0, xT, h, nodes, weights, inv_f)
