"""UMNNMAFFlow: a stack of UMNN-MAF blocks with a feature reversal between
blocks.

PyTorch counterpart of `umnn_tpu/models/flow.py:26-158`. The forward
composes ``rev . net_k . rev . ... . rev . net_0`` and a trailing reversal
restores the original order; the reversal alternates the autoregressive
direction between blocks. With ``cond_in > 0`` every block is conditioned on
a context (ConditionalMADE embeddings), which each method takes as
``context=`` and hands unchanged to every block. The Lipschitz controls
(`:148-158`) go block by block. ``invert`` runs the blocks' inverses in
reverse, with the reversals in JAX's places (`:126-140`), and ``sample``
inverts standard-normal draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from umnn_tpu_torch.models.umnn_maf import UMNNMAF, bits_per_pixel
from umnn_tpu_torch.nn.core import resolve_device

__all__ = ["UMNNMAFFlow"]


class UMNNMAFFlow(nn.Module):
    """``nb_flow`` UMNN-MAF blocks over ``nb_in`` dimensions.

    Weights are drawn from a ``torch.Generator`` seeded with ``seed``. The
    flow lives on ``device``: CUDA unless the caller names another, and with
    no CUDA device and no ``device`` the constructor raises.
    """

    def __init__(
        self,
        nb_flow: int = 1,
        nb_in: int = 1,
        hidden_derivative: Sequence[int] = (50, 50, 50, 50),
        hidden_embedding: Sequence[int] = (50, 50, 50, 50),
        embedding_s: int = 20,
        nb_steps: int = 50,
        act_func: str = "ELU",
        backend: str = "auto",
        seed: int = 0,
        device: torch.device | str | None = None,
        cond_in: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.nb_in = nb_in
        self.blocks = nn.ModuleList(
            UMNNMAF(
                nb_in, gen, embedding_s, hidden_embedding, hidden_derivative,
                nb_steps, act_func, backend, device, cond_in,
            )
            for _ in range(nb_flow)
        )

    @staticmethod
    def _rev(x: torch.Tensor) -> torch.Tensor:
        return torch.flip(x, dims=(-1,))

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None, **quad) -> torch.Tensor:
        for block in self.blocks:
            x = self._rev(block(x, context, **quad))
        return self._rev(x)

    def _log_jac_and_z(self, x: torch.Tensor, context: torch.Tensor | None, **quad):
        log_jac = torch.zeros_like(x)
        for block in self.blocks:
            log_jac = log_jac + block.compute_log_jac(x, context)
            x = self._rev(block(x, context, **quad))
        return log_jac, self._rev(x)

    def compute_log_jac(
        self, x: torch.Tensor, context: torch.Tensor | None = None, **quad
    ) -> torch.Tensor:
        """Per-dimension log-Jacobians summed over blocks, each in its block's
        own feature order (the sum over dimensions downstream ignores it)."""
        return self._log_jac_and_z(x, context, **quad)[0]

    def compute_log_jac_bis(self, x: torch.Tensor, context: torch.Tensor | None = None, **quad):
        """``(z, summed per-dimension log-Jacobian)``, each block embedding
        ``x`` once for both (`umnn_tpu/models/flow.py:79-88`)."""
        log_jac = torch.zeros_like(x)
        for block in self.blocks:
            x, lj = block.compute_log_jac_bis(x, context, **quad)
            x = self._rev(x)
            log_jac = log_jac + lj
        return self._rev(x), log_jac

    def compute_ll(self, x: torch.Tensor, context: torch.Tensor | None = None, **quad):
        """Exact log-likelihood under a standard-normal base.

        Each block embeds ``x`` once for its transform and again for its
        log-Jacobian, as the JAX flow does.
        """
        log_jac, z = self._log_jac_and_z(x, context, **quad)
        log_prob_gauss = -0.5 * torch.sum(math.log(2 * math.pi) + z**2, dim=-1)
        return torch.sum(log_jac, dim=-1) + log_prob_gauss, z

    def compute_ll_bis(self, x: torch.Tensor, context: torch.Tensor | None = None, **quad):
        """Per-dimension decomposition of the log-likelihood."""
        log_jac, z = self._log_jac_and_z(x, context, **quad)
        return log_jac - 0.5 * (math.log(2 * math.pi) + z**2), z

    def compute_bpp(
        self, x: torch.Tensor, alpha: float = 1e-6, context: torch.Tensor | None = None
    ):
        """Bits per pixel for logit-dequantized images: ``(bpp, ll, z)``."""
        ll, z = self.compute_ll(x, context)
        return bits_per_pixel(ll, x, alpha), ll, z

    def invert(
        self,
        z: torch.Tensor,
        iters: int = 10,
        context: torch.Tensor | None = None,
        method: str = "bisection",
        **kw,
    ) -> torch.Tensor:
        """The inverse transform: the blocks in reverse, each inverted by
        ``method``, ``"bisection"`` (:meth:`UMNNMAF.invert`, the reference's)
        or ``"newton"`` (:meth:`UMNNMAF.invert_newton`; ``iters`` about 30).
        ``kw`` goes to the block's method (``nb_candidates``, ``x_bound``,
        ``damping``)."""
        if method not in ("bisection", "newton"):
            raise ValueError(f"method {method!r} is not 'bisection' or 'newton'")
        z = self._rev(z)
        for block in reversed(self.blocks):
            inv = block.invert_newton if method == "newton" else block.invert
            z = inv(self._rev(z), iters, context, **kw)
        return z

    def sample(
        self,
        n: int,
        generator: torch.Generator,
        iters: int = 10,
        context: torch.Tensor | None = None,
        method: str = "bisection",
        **kw,
    ) -> torch.Tensor:
        """``n`` samples: ``z ~ N(0, I)`` drawn from ``generator``, which
        lives on the flow's device, then :meth:`invert`."""
        device = self.blocks[0].scaling.device
        z = torch.randn(n, self.nb_in, generator=generator, device=device)
        return self.invert(z, iters, context, method, **kw)

    def compute_lipschitz(self, generator=None, inits=None, nb_iter: int = 10) -> torch.Tensor:
        """Product of the blocks' integrand estimates; ``inits[i][j]``: the
        start vector of block i's layer j, else drawn from ``generator``."""
        L = torch.ones((), device=self.blocks[0].scaling.device)
        for i, block in enumerate(self.blocks):
            L = L * block.compute_lipschitz(generator, inits[i] if inits else None, nb_iter)
        return L

    def force_lipschitz(self, L: float = 1.5, generator=None, inits=None) -> None:
        """Project every block's integrand layers in place."""
        for i, block in enumerate(self.blocks):
            block.force_lipschitz(L, generator, inits[i] if inits else None)
