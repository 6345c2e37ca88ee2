"""Known-entropy convergence gate: trains UMNN-MAF on samples whose
differential entropy H is known, and checks that test NLL - H is small.

PyTorch counterpart of `examples/train_calibration.py`. The ground truth is
x = g(A z + b) with z ~ N(0, I_D), A lower-triangular and seeded, and
g(y) = y + c tanh(y) elementwise (strictly monotone for c < 1), so

    H(x) = D/2 log(2 pi e) + log|det A| + E_z[ sum_i log g'((Az+b)_i) ]

with the expectation estimated once by Monte Carlo in float64. The flow
trains at the UCI parity widths (D=6, 5 blocks, e=30, 51 nodes, integrand
[50]*4, MADE [512, 512], batch 500), and

    gap = test NLL - H = KL(p_true || p_model) >= 0

must fall below the gate (0.05 nats). A wrong gradient still trains, but
stops with a visible gap. The epoch loop is JAX's: loss -mean(compute_ll),
Adam with L2 decay and value clip 1.0, the plateau schedule on the valid
NLL, a copy of the best-valid parameters, and the final test NLL on that
copy. At these widths the integral runs on the pack-2 kernel pair
(``csrc/integrand_fwd_p2.cu``, ``csrc/integrand_bwd_p2.cu``) on the card.

Not ported: the data mesh and its shardings (one card needs none) and
``retry_transient``, a workaround for failures of the TPU's compile
service.

Usage, on the card (``-device cpu`` runs it on the CPU):

    python -m umnn_tpu_torch.examples.train_calibration -nb_epoch 150

It writes ``train.log``, ``metrics.jsonl`` and ``args.json`` under
``-folder``, prints one JSON line at the end, and exits 1 if the gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.core import resolve_device
from umnn_tpu_torch.training.loops import (
    ReduceLROnPlateau,
    batch_iter,
    make_optimizer,
    make_train_step,
)
from umnn_tpu_torch.utils.logging import MetricsWriter, get_logger


def make_ground_truth(d: int, seed: int, c: float = 0.5):
    """Seeded ``(sample, H, mc_se)``: a sampler ``sample(rng, n)``, the
    true entropy in nats and the Monte Carlo standard error of its estimate
    (a copy of `examples/train_calibration.py:54-77`)."""
    rng = np.random.RandomState(seed)
    # well-conditioned lower-triangular A: unit diag + small strictly-lower
    A = np.eye(d) + np.tril(0.4 * rng.randn(d, d), k=-1)
    diag_scale = 0.5 + rng.rand(d)  # diag in [0.5, 1.5)
    A = A * diag_scale[:, None]
    b = 0.5 * rng.randn(d)

    def sample(rng_, n):
        z = rng_.randn(n, d)
        y = z @ A.T + b
        return (y + c * np.tanh(y)).astype(np.float32)

    # H(x) = H(z) + log|det A| + E[sum_i log g'(y_i)]
    h_z = 0.5 * d * np.log(2 * np.pi * np.e)
    logdet_a = float(np.sum(np.log(np.abs(np.diag(A)))))
    z = np.random.RandomState(seed + 1).randn(2_000_000, d)
    y = z @ A.T + b
    log_gprime = np.log1p(c * (1.0 - np.tanh(y) ** 2))
    mc = log_gprime.sum(axis=1)
    h = h_z + logdet_a + float(mc.mean())
    mc_se = float(mc.std() / np.sqrt(len(mc)))
    return sample, h, mc_se


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-d", type=int, default=6, help="dimensionality (POWER-like)")
    p.add_argument("-nb_epoch", type=int, default=150)
    p.add_argument("-nb_flow", type=int, default=5)
    p.add_argument("-nb_steps", type=int, default=50)
    p.add_argument("-embedding_s", type=int, default=30)
    p.add_argument("-hidden_embedding", type=int, nargs="+", default=[512, 512])
    p.add_argument("-hidden_derivative", type=int, nargs="+", default=[50, 50, 50, 50])
    p.add_argument("-b_size", type=int, default=500)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-wd", type=float, default=1e-2)
    p.add_argument("-n_train", type=int, default=50000)
    p.add_argument("-n_eval", type=int, default=10000)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-gate", type=float, default=0.05, help="max entropy gap (nats)")
    p.add_argument("-folder", default="build/calibration")
    p.add_argument("-device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def train_epoch(step, x: np.ndarray, b_size: int, rng: np.random.RandomState, device) -> float:
    """One pass over ``x`` in shuffled batches; the mean batch loss."""
    losses = [step(torch.as_tensor(b, device=device)) for b in batch_iter(x, b_size, rng)]
    return float(torch.stack(losses).mean())


@torch.no_grad()
def evaluate(model: UMNNMAFFlow, x: np.ndarray, b_size: int, device) -> float:
    """Mean NLL over the rows of ``x`` (the wrapped-round rows of the last
    batch left out)."""
    total, n = [], 0
    for b, nv in batch_iter(x, b_size, None, shuffle=False, with_counts=True):
        ll, _ = model.compute_ll(torch.as_tensor(b, device=device))
        total.append(-ll[:nv].sum())
        n += nv
    return float(torch.stack(total).sum()) / max(n, 1)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    folder = Path(args.folder)
    folder.mkdir(parents=True, exist_ok=True)
    logger = get_logger("calibration", folder / "train.log")
    metrics = MetricsWriter(folder / "metrics.jsonl")
    (folder / "args.json").write_text(json.dumps(vars(args)))

    sample, h_true, mc_se = make_ground_truth(args.d, args.seed + 1000)
    rng = np.random.RandomState(args.seed + 1)
    trn = sample(rng, args.n_train)
    val = sample(rng, args.n_eval)
    tst = sample(rng, args.n_eval)
    logger.info(
        "ground truth: D=%d  H=%.5f nats (MC SE %.2e)  gate gap < %.3f",
        args.d, h_true, mc_se, args.gate,
    )

    model = UMNNMAFFlow(
        nb_flow=args.nb_flow, nb_in=args.d, hidden_derivative=tuple(args.hidden_derivative),
        hidden_embedding=tuple(args.hidden_embedding), embedding_s=args.embedding_s,
        nb_steps=args.nb_steps, seed=args.seed, device=device,
    )
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("params: %d  device: %s", n_params, device)
    optimizer = make_optimizer(model.parameters(), "adam", args.lr, args.wd, grad_clip=1.0)
    step = make_train_step(lambda b: -model.compute_ll(b)[0].mean(), optimizer)

    plateau = ReduceLROnPlateau()
    best_valid = float("inf")
    best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for epoch in range(args.nb_epoch):
        t0 = time.time()
        train_nll = train_epoch(step, trn, args.b_size, rng, device)
        valid_nll = evaluate(model, val, args.b_size, device)
        metrics.scalar("train_nll", train_nll, epoch)
        metrics.scalar("valid_nll", valid_nll, epoch)
        metrics.scalar("valid_gap", valid_nll - h_true, epoch)
        if valid_nll < best_valid:
            best_valid = valid_nll
            best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        lr = optimizer.lr
        new_lr = plateau.update(valid_nll, lr)
        if new_lr != lr:
            optimizer.lr = new_lr
            logger.info("epoch %d: lr -> %g", epoch, new_lr)
        logger.info(
            "epoch %3d  train NLL %.4f  valid NLL %.4f  gap %.4f  (%.1fs)",
            epoch, train_nll, valid_nll, valid_nll - h_true, time.time() - t0,
        )
    metrics.close()

    model.load_state_dict(best_state)
    test_nll = evaluate(model, tst, args.b_size, device)
    gap = test_nll - h_true
    logger.info(
        "FINAL: test NLL %.5f  H_true %.5f  gap %.5f nats  (gate %.3f: %s)",
        test_nll, h_true, gap, args.gate, "PASS" if gap < args.gate else "FAIL",
    )
    print(json.dumps({
        "d": args.d, "test_nll": test_nll, "h_true": h_true,
        "entropy_gap_nats": gap, "gate": args.gate, "pass": bool(gap < args.gate),
    }), flush=True)
    return 0 if gap < args.gate else 1


if __name__ == "__main__":
    sys.exit(main())
