"""Masked autoregressive networks: MADE and ConditionalMADE.

PyTorch counterpart of `umnn_tpu/nn/made.py`: :func:`build_made_masks` is a
copy of `:30-76`, :class:`MADE` applies the masks at use, ``w * m``, as
`:121-128` does, with the Gaussian MADE's helpers and its sequential
inverse (`:129-164`), and :class:`ConditionalMADE` is `:166-209`. Masks are
buffers in ``nn.Linear``'s ``[dout, din]`` layout.

Layout contract: for ``nout = k * nin``, output column ``j*nin + d`` is the
j-th output feature of input dimension ``d``; the last mask is tiled k times.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from umnn_tpu_torch.nn.core import resolve_device, torch_linear_init

__all__ = ["build_made_masks", "ConditionalMADE", "MADE"]


def build_made_masks(
    nin: int,
    hidden_sizes: Sequence[int],
    nout: int,
    *,
    natural_ordering: bool = True,
    random_degrees: bool = False,
    seed: int = 0,
) -> tuple[list[np.ndarray], np.ndarray]:
    """MADE connectivity masks, ``masks[l]`` of shape ``[fan_in, fan_out]``.

    Returns ``(masks, input_order)``. Deterministic mode gives hidden unit
    ``i`` the degree ``nin - 1 - (i % nin)``; random mode draws degrees in
    ``[min(prev_degrees), nin - 2]``. Hidden masks connect degree-monotone
    (<=) pairs; the output mask is strict (<) and tiled for ``nout = k*nin``.
    """
    if nout % nin != 0:
        raise ValueError(f"nout ({nout}) must be an integer multiple of nin ({nin})")
    rng = np.random.RandomState(seed)
    L = len(hidden_sizes)
    degrees: dict[int, np.ndarray] = {}
    if random_degrees:
        degrees[-1] = np.arange(nin) if natural_ordering else rng.permutation(nin)
        for l in range(L):
            degrees[l] = rng.randint(degrees[l - 1].min(), nin - 1, size=hidden_sizes[l])
    else:
        degrees[-1] = np.arange(nin)
        for l in range(L):
            degrees[l] = np.array([nin - 1 - (i % nin) for i in range(hidden_sizes[l])])

    masks = [degrees[l - 1][:, None] <= degrees[l][None, :] for l in range(L)]
    out_mask = degrees[L - 1][:, None] < degrees[-1][None, :]
    if nout > nin:
        out_mask = np.concatenate([out_mask] * (nout // nin), axis=1)
    masks.append(out_mask)
    return [m.astype(np.float32) for m in masks], degrees[-1]


class MADE(nn.Module):
    """Masked MLP: output block ``j*nin + d`` depends only on ``x[..., :d]``
    (natural ordering). ReLU between layers, no output activation. On
    ``device``, the card unless the caller names another."""

    def __init__(
        self,
        nin: int,
        hidden_sizes: Sequence[int],
        nout: int,
        gen: torch.Generator,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        masks, order = build_made_masks(nin, hidden_sizes, nout)
        # i_map[d]: the input slot of degree d, the order of inversion (`:111`)
        self.i_map = [int(k) for k in np.argsort(order)]
        sizes = [nin, *hidden_sizes, nout]
        self.layers = nn.ModuleList(
            torch_linear_init(gen, d0, d1, device) for d0, d1 in zip(sizes[:-1], sizes[1:])
        )
        for i, m in enumerate(masks):
            self.register_buffer(f"mask{i}", torch.as_tensor(m.T.copy(), device=device))

    @property
    def masks(self) -> list[torch.Tensor]:
        return [getattr(self, f"mask{i}") for i in range(len(self.layers))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        masks = self.masks
        for layer, m in zip(self.layers[:-1], masks[:-1]):
            x = F.relu(F.linear(x, layer.weight * m, layer.bias))
        return F.linear(x, self.layers[-1].weight * masks[-1], self.layers[-1].bias)

    # --- Gaussian MADE (nout == 2 * nin) -------------------------------------

    def _mu_sigma(self, x: torch.Tensor):
        nin = self.layers[0].in_features
        t = self(x)
        return t[..., :nin], t[..., nin:]

    def forward_gaussian(self, x: torch.Tensor) -> torch.Tensor:
        """``z = (x - mu(x)) exp(-sigma(x))``."""
        mu, sigma = self._mu_sigma(x)
        return (x - mu) * torch.exp(-sigma)

    def log_likelihood(self, x: torch.Tensor):
        """``(ll, z)``: the standard-normal log-density of ``z`` plus the
        log-determinant ``-sum(sigma)``."""
        mu, sigma = self._mu_sigma(x)
        z = (x - mu) * torch.exp(-sigma)
        log_prob_gauss = -0.5 * torch.sum(math.log(2 * math.pi) + z**2, dim=-1)
        return -torch.sum(sigma, dim=-1) + log_prob_gauss, z

    @torch.no_grad()
    def invert(self, z: torch.Tensor) -> torch.Tensor:
        """The x with ``forward_gaussian(x) = z``: one dimension a pass, in
        the order of degrees, each from the dimensions set before it."""
        nin = self.layers[0].in_features
        if self.layers[-1].out_features != 2 * nin:
            raise ValueError("invert requires a Gaussian MADE (nout == 2*nin)")
        u = torch.zeros_like(z)
        for idx in self.i_map:
            t = self(u)
            u[..., idx] = z[..., idx] * torch.exp(t[..., nin + idx]) + t[..., idx]
        return u


class ConditionalMADE(MADE):
    """MADE over ``concat(context, x)`` with the context's outputs stripped.

    The underlying MADE sees ``nin + cond_in`` inputs under natural
    ordering, so every output may depend on the whole context but dimension
    ``d`` of ``x`` only on ``x[..., :d]``. ``nout`` is the underlying MADE's,
    a multiple ``k * (nin + cond_in)``; each output block of that width keeps
    its trailing ``nin`` columns, so the result is ``[..., k * nin]``.
    """

    def __init__(
        self,
        nin: int,
        cond_in: int,
        hidden_sizes: Sequence[int],
        nout: int,
        gen: torch.Generator,
        device: torch.device | str | None = None,
    ):
        super().__init__(nin + cond_in, hidden_sizes, nout, gen, device)
        self.nin, self.cond_in = nin, cond_in

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        out = super().forward(torch.cat([context, x], dim=-1))
        nt = self.nin + self.cond_in
        k = out.shape[-1] // nt
        out = out.reshape(*out.shape[:-1], k, nt)[..., self.cond_in :]
        return out.reshape(*x.shape[:-1], k * self.nin)
