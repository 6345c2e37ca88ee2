"""2-D toy density generators (the FFJORD family).

A copy of `umnn_tpu/data/toy.py` (`:38-161`), which is pure numpy but
cannot be imported without JAX (`umnn_tpu/__init__.py` imports it). Each
generator returns float32 ``[n, 2]``; ``conditionnal8gaussians`` returns
``(x [n, 2], context [n, 8] one-hot)``. The same ``RandomState`` gives the
same samples bit for bit (`tests/test_torch_toy.py`).

The swissroll/circles/moons generators reproduce sklearn's sampling
distributions exactly (the reference calls `sklearn.datasets.make_*`):
swissroll draws noise *before* the /5 rescale (effective sigma 0.2), and
circles/moons place points on *equispaced* angles (linspace) with Gaussian
jitter, not uniformly random angles.
"""

from __future__ import annotations

import numpy as np

__all__ = ["inf_train_gen", "TOY_DATASETS"]

TOY_DATASETS = (
    "8gaussians",
    "swissroll",
    "moons",
    "pinwheel",
    "2spirals",
    "checkerboard",
    "circles",
    "line",
    "line-noisy",
    "cos",
    "joint_gaussian",
    "conditionnal8gaussians",
)


def inf_train_gen(data: str, rng: np.random.RandomState | None = None, batch_size: int = 200):
    """Sample one batch from the named 2-D toy density."""
    if rng is None:
        rng = np.random.RandomState()

    if data == "swissroll":
        # sklearn.datasets.make_swiss_roll(noise=1.0)[:, [0, 2]] / 5:
        # positions (t cos t, t sin t) with unit Gaussian noise added BEFORE
        # the /5 rescale.
        t = 1.5 * np.pi * (1 + 2 * rng.uniform(size=batch_size))
        x = np.stack([t * np.cos(t), t * np.sin(t)], axis=1)
        x += rng.randn(batch_size, 2)
        return (x / 5.0).astype(np.float32)

    if data == "circles":
        # sklearn.datasets.make_circles(factor=.5, noise=0.08) * 3: two rings
        # on equispaced angles linspace(0, 2pi, n, endpoint=False) plus
        # Gaussian jitter.
        n_out = batch_size // 2
        n_in = batch_size - n_out
        ang_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
        ang_in = np.linspace(0, 2 * np.pi, n_in, endpoint=False)
        outer = np.stack([np.cos(ang_out), np.sin(ang_out)], axis=1)
        inner = 0.5 * np.stack([np.cos(ang_in), np.sin(ang_in)], axis=1)
        x = np.concatenate([outer, inner], axis=0)
        x += 0.08 * rng.randn(*x.shape)
        return (x * 3.0).astype(np.float32)

    if data == "moons":
        # sklearn.datasets.make_moons(noise=0.1) * 2 + [-1, -0.2]:
        # equispaced linspace(0, pi) half-circles.
        n_out = batch_size // 2
        n_in = batch_size - n_out
        ang_out = np.linspace(0, np.pi, n_out)
        ang_in = np.linspace(0, np.pi, n_in)
        outer = np.stack([np.cos(ang_out), np.sin(ang_out)], axis=1)
        inner = np.stack([1 - np.cos(ang_in), 1 - np.sin(ang_in) - 0.5], axis=1)
        x = np.concatenate([outer, inner], axis=0)
        x += 0.1 * rng.randn(*x.shape)
        x = x * 2.0 + np.array([-1.0, -0.2])
        return x.astype(np.float32)

    if data == "8gaussians":
        scale = 4.0
        sq2 = 1.0 / np.sqrt(2)
        centers = scale * np.array(
            [
                (1, 0), (-1, 0), (0, 1), (0, -1),
                (sq2, sq2), (sq2, -sq2), (-sq2, sq2), (-sq2, -sq2),
            ]
        )
        idx = rng.randint(0, 8, size=batch_size)
        x = centers[idx] + 0.5 * rng.randn(batch_size, 2)
        return (x / 1.414).astype(np.float32)

    if data == "pinwheel":
        radial_std, tangential_std = 0.3, 0.1
        num_classes, rate = 5, 0.25
        n_per = batch_size // num_classes + 1
        rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
        feats = rng.randn(num_classes * n_per, 2) * np.array(
            [radial_std, tangential_std]
        )
        feats[:, 0] += 1.0
        labels = np.repeat(np.arange(num_classes), n_per)
        angles = rads[labels] + rate * np.exp(feats[:, 0])
        rot = np.stack(
            [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)], axis=1
        ).reshape(-1, 2, 2)
        x = 2 * np.einsum("ni,nij->nj", feats, rot)
        return x[rng.permutation(len(x))[:batch_size]].astype(np.float32)

    if data == "2spirals":
        n = np.sqrt(rng.uniform(size=(batch_size // 2, 1))) * 540 * (2 * np.pi) / 360
        d1x = -np.cos(n) * n + rng.uniform(size=(batch_size // 2, 1)) * 0.5
        d1y = np.sin(n) * n + rng.uniform(size=(batch_size // 2, 1)) * 0.5
        x = np.concatenate(
            [np.hstack([d1x, d1y]), np.hstack([-d1x, -d1y])], axis=0
        ) / 3.0
        x += 0.1 * rng.randn(*x.shape)
        return x[: batch_size].astype(np.float32)

    if data == "checkerboard":
        x1 = rng.uniform(size=batch_size) * 4 - 2
        x2_ = rng.uniform(size=batch_size) - rng.randint(0, 2, size=batch_size) * 2
        x2 = x2_ + np.floor(x1) % 2
        return (np.stack([x1, x2], axis=1) * 2).astype(np.float32)

    if data == "line":
        x = rng.uniform(size=batch_size) * 5 - 2.5
        return np.stack([x, x], axis=1).astype(np.float32)

    if data == "line-noisy":
        x = rng.uniform(size=batch_size) * 5 - 2.5
        y = x + rng.randn(batch_size)
        return np.stack([x, y], axis=1).astype(np.float32)

    if data == "cos":
        x = rng.uniform(size=batch_size) * 5 - 2.5
        return np.stack([x, np.sin(x) * 2.5], axis=1).astype(np.float32)

    if data == "joint_gaussian":
        x2 = rng.randn(batch_size) * 4
        x1 = rng.randn(batch_size) + x2**2 / 4
        return np.stack([x1, x2], axis=1).astype(np.float32)

    if data == "conditionnal8gaussians":
        # 8-Gaussian mixture with the component exposed as a one-hot
        # context: returns (x [B,2]/1.414, context [B,8]).
        scale = 4.0
        sq2 = 1.0 / np.sqrt(2)
        centers = scale * np.array(
            [
                (1, 0), (-1, 0), (0, 1), (0, -1),
                (sq2, sq2), (sq2, -sq2), (-sq2, sq2), (-sq2, -sq2),
            ]
        )
        idx = rng.randint(0, 8, size=batch_size)
        context = np.zeros((batch_size, 8), np.float32)
        context[np.arange(batch_size), idx] = 1.0
        x = centers[idx] + 0.5 * rng.randn(batch_size, 2)
        return (x / 1.414).astype(np.float32), context

    raise ValueError(f"unknown toy dataset: {data}")
