"""Checks that a trained UMNN flow's reported likelihood is a real density.

PyTorch counterpart of `umnn_tpu/utils/validity.py`. A UMNN-MAF
log-density pairs an exact pointwise Jacobian term with a Clenshaw-Curtis
estimate of z = ∫ f, so a likelihood means something only while (a) the
quadrature resolves the learned integrand and (b) the network is
well-conditioned at the precision it is evaluated in. The JAX package saw
a flow on bsds300 whose NLL moved by 12-24 nats under bfloat16-input
matmuls and fell below the data's entropy floor (PARITY_RUNS §2e). The
report reruns the flow at more nodes and with its parameters and inputs
rounded to bfloat16, and counts the rows whose NLL is not finite.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from umnn_tpu_torch.ops.quadrature import padded_cc_quadrature

__all__ = ["ValidityReport", "density_validity_report"]


@dataclasses.dataclass(frozen=True)
class ValidityReport:
    """Outcomes of :func:`density_validity_report`.

    ``nll``: mean NLL at the base node count (what a driver reports).
    ``node_gap``: |NLL(check steps) − NLL(base steps)|, the quadrature's
    resolution error. ``bf16_gap``: |NLL − NLL with parameters and inputs
    rounded to bfloat16|. ``n_nonfinite``: rows whose NLL is inf or nan at
    the base node count.
    """

    nll: float
    node_gap: float
    bf16_gap: float
    n_nonfinite: int
    rows: int

    def ok(self, node_tol: float = 0.05, bf16_tol: float = 1.0) -> bool:
        """Pass or fail, as the JAX package draws the line: healthy models
        measured node_gap < 1e-3 and bf16_gap < 0.6 nats, the degenerate
        one bf16_gap ≈ 19 nats (PARITY_RUNS §2e)."""
        return (
            self.n_nonfinite == 0
            and bool(np.isfinite(self.nll))
            and self.node_gap < node_tol
            and self.bf16_gap < bf16_tol
        )


def _mean_nll(
    nll_fn: Callable, model, x: torch.Tensor, steps: int, max_steps: int
) -> tuple[float, int]:
    nodes, weights = padded_cc_quadrature(steps, max_steps, x.device)
    with torch.no_grad():
        v = nll_fn(model, x, nodes, weights).cpu().numpy()
    finite = np.isfinite(v)
    mean = float(v[finite].mean()) if finite.any() else float("nan")
    return mean, int((~finite).sum())


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def density_validity_report(
    model,
    x: torch.Tensor,
    *,
    steps: int = 50,
    check_steps: int = 200,
    nll_fn: Optional[Callable] = None,
) -> ValidityReport:
    """Check ``model``'s likelihood on the rows ``x``.

    ``model`` needs ``compute_ll(x, nodes=..., weights=...)`` (``UMNNMAF``
    and ``UMNNMAFFlow`` do); ``nll_fn(model, x, nodes, weights)`` giving
    per-row NLL replaces it. Every evaluation runs in float32 without
    gradients, on the nodes of ``steps`` and of ``check_steps``, both padded
    to the larger count, as the JAX package does:

    * the rows whose NLL is not finite at ``steps``;
    * node convergence: the mean NLL at ``check_steps`` (4x or more is
      meaningful) against ``steps``;
    * bfloat16 sensitivity: every floating parameter and buffer of a copy
      of the model (never the model itself) and the inputs rounded to
      bfloat16 and back to float32, then evaluated at ``steps``.
    """
    if nll_fn is None:
        def nll_fn(m, xb, nodes, weights):
            ll, _ = m.compute_ll(xb, nodes=nodes, weights=weights)
            return -ll

    max_steps = max(steps, check_steps)
    base, n_bad = _mean_nll(nll_fn, model, x, steps, max_steps)
    hi, _ = _mean_nll(nll_fn, model, x, check_steps, max_steps)

    rounded = copy.deepcopy(model)
    with torch.no_grad():
        for t in (*rounded.parameters(), *rounded.buffers()):
            if torch.is_floating_point(t):
                t.copy_(_bf16(t))
    b16, _ = _mean_nll(nll_fn, rounded, _bf16(x), steps, max_steps)
    del rounded

    return ValidityReport(
        nll=base,
        node_gap=abs(hi - base),
        bf16_gap=abs(b16 - base),
        n_nonfinite=n_bad,
        rows=int(x.shape[0]),
    )
