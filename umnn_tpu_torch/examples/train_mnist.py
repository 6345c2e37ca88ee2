"""Trains the UMNN-MAF flow on 784-d MNIST-geometry rows.

PyTorch counterpart of a subset of `examples/train_mnist.py` (`:57-128,
153-300`): the flow at the reference MNIST widths (5 blocks, MADE
[1024]*3, integrand [100,50,50,50,50], e=30, batch 100), loss
``-mean(compute_ll)``, value clip 1.0, Adam with L2 weight decay, and an
optional plateau schedule on the validation bpp. Each epoch scores the
valid and test splits; an in-memory copy of the parameters of the best
valid epoch gives the final test bpp (`:293-298,316-320`). Data: the
synthetic AR(1) copula rows of ``umnn_tpu_torch.data.images`` (no
download), whose exact test bpp floor is printed beside the flow's.

Randomized-steps mode (``-nb_steps <= 0``): each batch draws
``nb_steps ~ 2*U{5,49}`` on 101 padded nodes; evaluation runs at 100 steps.

Not ported yet: checkpoints and ``-load``/``-load_npz``, generation
(``-gen``), the Lipschitz projection, the class-conditional flow, the
uniform synthetic mode and real MNIST.

Usage, on the card (``-device cpu`` runs it on the CPU):

    python -m umnn_tpu_torch.examples.train_mnist -nb_epoch 2 -steps_per_epoch 20

It prints one JSON line per epoch and one at the end (the test bpp of the
best valid epoch's parameters).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from umnn_tpu_torch.data.images import synthetic_mnist_ar1
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.core import resolve_device
from umnn_tpu_torch.ops.quadrature import padded_cc_quadrature
from umnn_tpu_torch.training.loops import (
    ReduceLROnPlateau,
    batch_iter,
    finite_mean,
    make_optimizer,
    make_train_step,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-nb_epoch", type=int, default=500)
    p.add_argument("-nb_flow", type=int, default=5)
    p.add_argument("-nb_steps", type=int, default=50, help="<=0 for randomized")
    p.add_argument("-embedding_s", type=int, default=30)
    p.add_argument("-hidden_embedding", type=int, nargs="+", default=[1024, 1024, 1024])
    p.add_argument("-hidden_derivative", type=int, nargs="+", default=[100, 50, 50, 50, 50])
    p.add_argument("-b_size", type=int, default=100)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-wd", type=float, default=1e-2)
    p.add_argument("-s_rate", type=float, default=0,
                   help="plateau decay factor on valid bpp; 0 keeps the rate fixed")
    p.add_argument("-s_patience", type=int, default=5)
    p.add_argument("-steps_per_epoch", type=int, default=0, help="0: the whole train split")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-ar1_rho", type=float, default=0.7)
    p.add_argument("-ar1_rows", type=int, default=20000,
                   help="train rows (valid and test stay 2000 and 5000)")
    p.add_argument("-device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    data, floor_bpp = synthetic_mnist_ar1(
        rho=args.ar1_rho, seed=args.seed, n=(args.ar1_rows, 2000, 5000)
    )
    random_steps = args.nb_steps <= 0
    eval_steps = 100 if random_steps else args.nb_steps
    max_steps = 100 if random_steps else eval_steps  # 2*U{5,49} tops at 98
    model = UMNNMAFFlow(
        nb_flow=args.nb_flow, nb_in=784, hidden_derivative=tuple(args.hidden_derivative),
        hidden_embedding=tuple(args.hidden_embedding), embedding_s=args.embedding_s,
        nb_steps=eval_steps, seed=args.seed, device=device,
    )
    optimizer = make_optimizer(model.parameters(), "adam", args.lr, args.wd, grad_clip=1.0)

    def loss_fn(x, nodes, weights):
        ll, _ = model.compute_ll(x, nodes=nodes, weights=weights)
        return -ll.mean()

    step = make_train_step(loss_fn, optimizer)
    rng = np.random.RandomState(args.seed + 1)
    plateau = ReduceLROnPlateau(args.s_rate, args.s_patience) if args.s_rate > 0 else None

    @torch.no_grad()
    def eval_bpp(x: np.ndarray) -> float:
        total, n = [], 0
        for xb, nv in batch_iter(x, args.b_size, rng, shuffle=False, with_counts=True):
            bpp, _, _ = model.compute_bpp(torch.as_tensor(xb, device=device))
            total.append(bpp[:nv].sum())
            n += nv
        return float(torch.stack(total).sum()) / max(n, 1)

    def state_copy() -> dict:
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best_valid, best_state = float("inf"), state_copy()
    n_params = sum(p.numel() for p in model.parameters())
    print(json.dumps({"device": str(device), "params": n_params, "floor_bpp": floor_bpp}),
          flush=True)
    for epoch in range(args.nb_epoch):
        t0 = time.perf_counter()
        perm = rng.permutation(len(data.trn_x))
        losses = []
        for i in range(0, len(perm), args.b_size):
            if args.steps_per_epoch and i // args.b_size >= args.steps_per_epoch:
                break
            sel = perm[i : i + args.b_size]
            if len(sel) < args.b_size:
                break
            n_steps = 2 * rng.randint(5, 50) if random_steps else args.nb_steps
            nodes, weights = padded_cc_quadrature(n_steps, max_steps, device)
            losses.append(step(torch.as_tensor(data.trn_x[sel], device=device), nodes, weights))
        train_nll, n_skip = finite_mean(losses)
        valid_bpp = eval_bpp(data.val_x)
        test_bpp = eval_bpp(data.tst_x)
        if valid_bpp < best_valid:
            best_valid, best_state = valid_bpp, state_copy()
        if plateau is not None:
            optimizer.lr = plateau.update(valid_bpp, optimizer.lr)
        print(json.dumps({
            "epoch": epoch, "train_nll": train_nll, "skipped": n_skip,
            "valid_bpp": valid_bpp, "test_bpp": test_bpp, "floor_bpp": floor_bpp,
            "lr": optimizer.lr, "seconds": time.perf_counter() - t0,
        }), flush=True)
    model.load_state_dict(best_state)
    result = {"test_bpp": eval_bpp(data.tst_x), "floor_bpp": floor_bpp}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
