"""Monotone regression: a MonotonicNN against an unconstrained MLP.

PyTorch counterpart of `examples/train_monotonic.py` (the reference's
`MonotonicMLP.py`): both models fit

    y = 0.001 (x1^3 + x1) + x2^2 + sin(x3),   x ~ U(-2, 2)^3,

which increases in x1. The monotonic model is ``MonotonicNN(3, (100, 100,
100))``, its integrand 3-100-100-100-1 with ReLU hidden layers (on the
card, the unpacked kernel pair with ``neg_slope = 0``); the baseline is an
MLP 3-100-100-100-1 with ReLU. Each "epoch" is one Adam step of each
model (no clip, no weight decay) on a fresh batch drawn from a
``torch.Generator`` seeded ``seed + 7`` on the device. The MonotonicNN's
weights come from ``seed``, the MLP's from ``seed + 1``. Every tenth epoch
and the last print JAX's line; at the end the MonotonicNN is evaluated on
``linspace(-2, 2, 101)`` with ``h = 0``, and the run exits 1 unless it
increases strictly there.

Usage, on the card (``-device cpu`` runs it on the CPU):

    python -m umnn_tpu_torch.examples.train_monotonic -nb_epoch 60 -nb_steps 30 -b_size 256
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from umnn_tpu_torch.models.monotonic import MonotonicNN
from umnn_tpu_torch.nn.core import MLP, resolve_device
from umnn_tpu_torch.training.loops import Optimizer, make_optimizer

HIDDEN = (100, 100, 100)
GRID = 101  # points of the monotonicity check


def target(x: torch.Tensor) -> torch.Tensor:
    return 0.001 * (x[:, 0] ** 3 + x[:, 0]) + x[:, 1] ** 2 + torch.sin(x[:, 2])


def monotonic_mse(model: MonotonicNN, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((model(x[:, 0:1], x[:, 1:])[:, 0] - y) ** 2)


def mlp_mse(mlp: MLP, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((mlp(x)[:, 0] - y) ** 2)


def fit_step(loss_fn, net, optimizer: Optimizer, x, y) -> torch.Tensor:
    """One Adam step on ``loss_fn(net, x, y)``; the loss, detached. No
    non-finite guard, as JAX's driver has none."""
    optimizer.zero_grad()
    loss = loss_fn(net, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def is_monotone(model: MonotonicNN, device) -> bool:
    """Whether the model increases strictly in x1 on the grid, with h = 0."""
    xs = torch.linspace(-2.0, 2.0, GRID, device=device)[:, None]
    with torch.no_grad():
        ys = model(xs, torch.zeros(GRID, model.in_d - 1, device=device))[:, 0]
    return bool((ys[1:] - ys[:-1] > 0).all())


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-nb_epoch", type=int, default=100)
    p.add_argument("-nb_steps", type=int, default=50)
    p.add_argument("-b_size", type=int, default=512)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Trains both models, prints JAX's lines; 0 if the MonotonicNN is
    monotone on the grid, else 1."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = MonotonicNN(3, HIDDEN, nb_steps=args.nb_steps, seed=args.seed, device=device)
    mlp = MLP([3, *HIDDEN, 1], torch.Generator().manual_seed(args.seed + 1), "ReLU",
              device=device)
    opt_m = make_optimizer(model.parameters(), "adam", args.lr, grad_clip=None)
    opt_f = make_optimizer(mlp.parameters(), "adam", args.lr, grad_clip=None)
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    for epoch in range(args.nb_epoch):
        x = torch.rand(args.b_size, 3, generator=gen, device=device) * 4.0 - 2.0
        y = target(x)
        t0 = time.time()
        lm = fit_step(monotonic_mse, model, opt_m, x, y)
        lf = fit_step(mlp_mse, mlp, opt_f, x, y)
        if epoch % 10 == 0 or epoch == args.nb_epoch - 1:
            print(
                f"epoch {epoch:4d}  MSE monotonic {float(lm):.5f}  "
                f"MSE mlp {float(lf):.5f}  ({time.time()-t0:.3f}s)",
                flush=True,
            )
    mono = is_monotone(model, device)
    print(f"monotone in x1: {mono}", flush=True)
    return 0 if mono else 1


if __name__ == "__main__":
    sys.exit(main())
