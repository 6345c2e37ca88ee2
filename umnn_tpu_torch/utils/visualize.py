"""Plots of 2-D flows, image grids and training curves.

PyTorch counterpart of `umnn_tpu/utils/visualize.py` (the reference's
`lib/visualize_flow.py:13-141`): the density of a flow on a grid, a
histogram of samples, the flow's displacement field, both side by side,
a grid of images and the curves of a ``MetricsWriter`` stream. The
functions of the flow (``log_prob_fn``, ``transform_fn``) take a float32
tensor of points on ``device`` (the card unless the caller names another)
and are called without a graph; their results come back to numpy.
matplotlib is imported inside each plot, with the ``Agg`` backend, so the
module imports without it and the drawing needs no display.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from umnn_tpu_torch.nn.core import resolve_device

__all__ = [
    "density_grid",
    "image_grid",
    "plot_training_curves",
    "plt_flow",
    "plt_samples",
    "plt_stream",
    "visualize_transform",
]

LOW, HIGH = -4.0, 4.0


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _points(npts: int, low: float, high: float):
    side = np.linspace(low, high, npts)
    xx, yy = np.meshgrid(side, side)
    return xx, yy, np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1).astype(np.float32)


@torch.no_grad()
def _apply(fn: Callable, pts: np.ndarray, device) -> np.ndarray:
    return fn(torch.as_tensor(pts, device=device)).detach().cpu().numpy()


def density_grid(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    npts: int = 300,
    low: float = LOW,
    high: float = HIGH,
    memory: int = 10000,
    device: torch.device | str | None = None,
):
    """``(xx, yy, exp(log p))`` on an ``npts`` x ``npts`` grid, ``memory``
    points a call (`visualize_flow.py:34-57`)."""
    device = resolve_device(device)
    xx, yy, pts = _points(npts, low, high)
    out = [_apply(log_prob_fn, pts[i : i + memory], device) for i in range(0, len(pts), memory)]
    return xx, yy, np.exp(np.concatenate(out)).reshape(npts, npts)


def plt_flow(log_prob_fn, ax=None, npts: int = 300, title: str = "q(x)", device=None):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    _, _, px = density_grid(log_prob_fn, npts, device=device)
    ax.imshow(px, extent=(LOW, HIGH, LOW, HIGH), origin="lower", cmap="inferno")
    ax.set_title(title)
    ax.axis("off")
    return ax


def plt_samples(samples: np.ndarray, ax=None, npts: int = 100, title: str = "x ~ p(x)"):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    ax.hist2d(samples[:, 0], samples[:, 1], range=[[LOW, HIGH], [LOW, HIGH]], bins=npts,
              cmap="inferno")
    ax.set_title(title)
    ax.axis("off")
    return ax


def plt_stream(transform_fn, ax=None, npts: int = 200, title: str = "Density streamflow",
               device=None):
    """Streamplot of the displacement ``z(x) - x`` (`visualize_flow.py:59-67`),
    coloured by its magnitude."""
    plt = _plt()
    device = resolve_device(device)
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    xx, yy, x = _points(npts, LOW, HIGH)
    d = _apply(transform_fn, x, device) - x
    dzx, dzy = d[:, 0].reshape(xx.shape), d[:, 1].reshape(xx.shape)
    ax.streamplot(xx, yy, dzx, dzy, color=(dzx**2 + dzy**2) / 2, cmap="autumn")
    ax.set_title(title)
    return ax


def visualize_transform(
    samples: Optional[np.ndarray],
    log_prob_fn,
    out_path: str | Path,
    npts: int = 300,
    device=None,
):
    """Samples beside the learned density, saved to ``out_path``
    (`visualize_flow.py:97-141`)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2 if samples is not None else 1, figsize=(9, 4))
    axes = np.atleast_1d(axes)
    i = 0
    if samples is not None:
        plt_samples(samples, axes[i], title="data")
        i += 1
    plt_flow(log_prob_fn, axes[i], npts, device=device)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def image_grid(images: np.ndarray, out_path: str | Path, ncols: int = 10):
    """A grid of ``[N, H, W]`` images, saved to ``out_path``."""
    plt = _plt()
    n = len(images)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(ncols, nrows))
    for i, ax in enumerate(np.asarray(axes).reshape(-1)):
        ax.axis("off")
        if i < n:
            ax.imshow(images[i], cmap="gray")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_training_curves(metrics_path: str | Path, out_path: str | Path,
                         tags: Optional[list] = None):
    """One line per tag of a ``MetricsWriter`` stream over its steps, saved
    to ``out_path``."""
    plt = _plt()
    series: dict = {}
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            series.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    if tags is not None:
        series = {t: series[t] for t in tags if t in series}
    fig, ax = plt.subplots(figsize=(6, 4))
    for tag, pts in sorted(series.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], label=tag)
    ax.set_xlabel("epoch")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
