"""Synthetic MNIST-geometry rows with an exact bits-per-pixel floor.

A copy of `umnn_tpu/data/images.py::synthetic_mnist_ar1` (`:122-189`,
numpy and scipy only): logit-space 784-d rows from a raster-order AR(1)
Gaussian copula, made from a seed with no download.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ALPHA", "FlowImageData", "synthetic_mnist_ar1"]

ALPHA = 1e-6  # logit-transform guard


@dataclasses.dataclass
class FlowImageData:
    """Logit-dequantized splits for the 784-d flow (labels all zero here)."""

    trn_x: np.ndarray
    trn_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray
    tst_x: np.ndarray
    tst_y: np.ndarray


def synthetic_mnist_ar1(
    rho: float = 0.7,
    seed: int = 0,
    n: tuple[int, int, int] = (20000, 2000, 5000),
    d: int = 784,
):
    """Correlated 784-d stand-in for MNIST with an exact bits/pixel floor.

    z_1 ~ N(0,1), z_{i+1} = rho*z_i + sqrt(1-rho^2)*eps, pixels y_i = Phi(z_i):
    uniform marginals (an independence model scores exactly 8.0 bpp) and
    mutual information -((d-1)/2)*ln(1-rho^2) nats for the conditioner to
    learn. Pixels go through the ``alpha + (1-2*alpha)*y`` logit map.
    Returns ``(FlowImageData, floor_bpp)``, where ``floor_bpp`` is the bpp of
    the true density on the test split under the flows' bpp formula.
    """
    rng = np.random.RandomState(seed)
    from scipy.stats import norm

    n_tot = sum(n)
    eps = rng.randn(n_tot, d)
    z = np.empty((n_tot, d))
    z[:, 0] = eps[:, 0]
    c = np.sqrt(1.0 - rho * rho)
    for i in range(1, d):
        z[:, i] = rho * z[:, i - 1] + c * eps[:, i]
    y = norm.cdf(z)
    v = ALPHA + (1 - 2 * ALPHA) * y
    x = np.log(v / (1.0 - v))

    # exact log-density of x: log p_y(y) + sum log |dy/dx|
    # p_y(y) = p_z(z) / prod phi(z_i);  dy/dx = sig(x)(1-sig(x))/(1-2a)
    def true_bpp(xs, zs):
        lp_z = norm.logpdf(zs[:, 0]) + norm.logpdf(
            (zs[:, 1:] - rho * zs[:, :-1]) / c
        ).sum(axis=1) - (d - 1) * np.log(c)
        lp_y = lp_z - norm.logpdf(zs).sum(axis=1)
        sig = 1.0 / (1.0 + np.exp(-xs))
        log_dydx = np.log(sig) + np.log1p(-sig) - np.log(1 - 2 * ALPHA)
        ll = lp_y + log_dydx.sum(axis=1)  # log p_x(x)
        bpp = (
            -ll / (d * np.log(2))
            - np.log2(1 - 2 * ALPHA)
            + 8
            + (np.log2(sig) + np.log2(1 - sig)).sum(axis=1) / d
        )
        return float(bpp.mean())

    n1, n2, _ = n
    splits = np.split(x.astype(np.float32), [n1, n1 + n2])
    zeros = [np.zeros(len(s), dtype=np.int64) for s in splits]
    floor = true_bpp(x[n1 + n2 :], z[n1 + n2 :])
    data = FlowImageData(splits[0], zeros[0], splits[1], zeros[1], splits[2], zeros[2])
    return data, floor
