"""Trains the UMNN-MAF flow on 784-d MNIST-geometry rows, and generates.

PyTorch counterpart of `examples/train_mnist.py` (`:57-368`): the flow at
the reference MNIST widths (5 blocks, MADE [1024]*3, integrand
[100,50,50,50,50], e=30, batch 100), loss ``-mean(compute_ll)``, value
clip 1.0, Adam with L2 weight decay, and an optional plateau schedule on
the validation bpp. Each epoch scores the valid and test splits. Data: the
synthetic AR(1) copula rows of ``umnn_tpu_torch.data.images`` (no
download), whose exact test bpp floor is printed beside the flow's.

Under ``-folder`` (``train.log``, ``metrics.jsonl``, ``args.json`` and
``ckpt/``): a checkpoint of the flow's and the optimizer's states every 5
epochs, with the best-train, best-valid and best-train-valid parameters;
the final test bpp is that of the best-valid checkpoint (`:316-320`).
``-load`` resumes from the latest checkpoint at the epoch after it, with
the checkpointed learning rate unless ``-force_lr`` > 0 replaces it;
``-load_npz`` starts from a float16 snapshot (either package's) with a
fresh optimizer, and ``-load`` wins where both find something.
``-Lipshitz L`` (the reference's spelling) projects each integrand
layer after every step, as the UCI driver does.

Generation (``-gen N``): ``z ~ N(0, I)`` from a generator seeded
``seed + 3``, times ``-temperature`` or, with ``-temp_sweep``, times the
ladder 0.1, 0.2, ..., 1.0 (N // 10 consecutive rows each), inverted by
Jacobi-Newton in ``5 * -nb_iter`` iterations; the generated batch's bpp
and ll are logged and ``logit_back(x)`` is saved as ``generated.npy``,
``[N, 28, 28]``, under ``-folder``.

Randomized-steps mode (``-nb_steps <= 0``): each batch draws
``nb_steps ~ 2*U{5,49}`` on 101 padded nodes; evaluation runs at 100 steps.

Not ported yet: the class-conditional flow (``-conditionnal``), the
uniform synthetic mode (``-synthetic_mode uniform``) and real MNIST, and
the PNG grid of the generated images (``utils/visualize.py``).

Usage, on the card (``-device cpu`` runs it on the CPU):

    python -m umnn_tpu_torch.examples.train_mnist -nb_epoch 2 -steps_per_epoch 20 -gen 10

It prints one JSON line per epoch and event, and one with the final test
bpp; each line also goes to ``train.log``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from umnn_tpu_torch.data.images import logit_back, synthetic_mnist_ar1
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.core import resolve_device
from umnn_tpu_torch.ops.quadrature import padded_cc_quadrature
from umnn_tpu_torch.training.checkpoint import BestTracker, CheckpointManager, load_params_npz
from umnn_tpu_torch.training.loops import (
    ReduceLROnPlateau,
    batch_iter,
    finite_mean,
    make_optimizer,
    make_train_step,
)
from umnn_tpu_torch.utils.logging import MetricsWriter

# -temp_sweep's temperatures, jnp.arange(0.1, 1.1, 0.1) to the bit
TEMPERATURES = np.float32(0.1) + np.arange(10, dtype=np.float32) * np.float32(0.1)


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
    p.add_argument("-force_lr", type=float, default=0,
                   help="with -load, this learning rate instead of the checkpointed one "
                        "(0 keeps it)")
    p.add_argument("-gen", type=int, default=0, help="generate N images at the end")
    p.add_argument("-nb_iter", type=int, default=10,
                   help="inversion iterations / 5 (Newton runs 5 * nb_iter)")
    p.add_argument("-temperature", type=float, default=0.5)
    p.add_argument("-temp_sweep", action="store_true",
                   help="scale generation rows by temperatures 0.1..1.0, N // 10 rows each")
    p.add_argument("-Lipshitz", type=float, default=0,
                   help="max Lipschitz constant of the integrand's layers (0 = off)")
    p.add_argument("-steps_per_epoch", type=int, default=0, help="0: the whole train split")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-folder", default="runs/mnist")
    p.add_argument("-ar1_rho", type=float, default=0.7)
    p.add_argument("-ar1_rows", type=int, default=20000,
                   help="train rows (valid and test stay 2000 and 5000)")
    p.add_argument("-load", action="store_true",
                   help="resume the flow and the optimizer from the folder's latest checkpoint")
    p.add_argument("-load_npz", default="",
                   help="start from a float16 snapshot (either package's), optimizer fresh")
    p.add_argument("-device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    folder = Path(args.folder)
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "args.json").write_text(json.dumps(vars(args)))
    metrics = MetricsWriter(folder / "metrics.jsonl")
    log_file = open(folder / "train.log", "a")

    def log(**record) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        log_file.write(line + "\n")
        log_file.flush()

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

    # the Lipschitz projection after every optimizer step, each from fresh
    # start vectors (`MNISTExperiment.py:166-167`)
    post_update = None
    if args.Lipshitz > 0:
        lip_gen = torch.Generator(device=device).manual_seed(args.seed + 97)

        def post_update(nodes, weights):
            model.force_lipschitz(args.Lipshitz, lip_gen)

    step = make_train_step(loss_fn, optimizer, post_update)
    rng = np.random.RandomState(args.seed + 1)
    plateau = ReduceLROnPlateau(args.s_rate, args.s_patience) if args.s_rate > 0 else None
    ckpt = CheckpointManager(folder / "ckpt")
    best = BestTracker(ckpt)

    if args.load_npz:
        # a start from a float16 snapshot, optimizer fresh; -load below (the
        # full resume) takes precedence where its checkpoint exists
        load_params_npz(args.load_npz, model)
        log(event="load_npz", path=args.load_npz)
    start_epoch = 0
    if args.load:
        restored = ckpt.restore(map_location=device)
        if restored is not None:
            epoch, model_state, opt_state = restored
            model.load_state_dict(model_state)
            optimizer.load_state_dict(opt_state)  # the checkpointed lr wins
            start_epoch = epoch + 1
            if args.force_lr > 0:
                optimizer.lr = args.force_lr
            log(event="resumed", epoch=epoch, lr=optimizer.lr)

    @torch.no_grad()
    def eval_bpp(x: np.ndarray) -> float:
        total, n = [], 0
        for xb, nv in batch_iter(x, args.b_size, rng, shuffle=False, with_counts=True):
            bpp, _, _ = model.compute_bpp(torch.as_tensor(xb, device=device))
            total.append(bpp[:nv].sum())
            n += nv
        return float(torch.stack(total).sum()) / max(n, 1)

    n_params = sum(p.numel() for p in model.parameters())
    log(device=str(device), params=n_params, floor_bpp=floor_bpp)
    for epoch in range(start_epoch, args.nb_epoch):
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
        metrics.scalar("train_nll", train_nll, epoch)
        metrics.scalar("valid_bpp", valid_bpp, epoch)
        metrics.scalar("test_bpp", test_bpp, epoch)
        best.update(train_nll, valid_bpp, model.state_dict())
        if plateau is not None:
            optimizer.lr = plateau.update(valid_bpp, optimizer.lr)
        if epoch % 5 == 0:
            ckpt.save(epoch, model.state_dict(), optimizer.state_dict())
            # the improved stashes go to disk with each periodic save
            best.flush()
        log(epoch=epoch, train_nll=train_nll, skipped=n_skip, valid_bpp=valid_bpp,
            test_bpp=test_bpp, floor_bpp=floor_bpp, lr=optimizer.lr,
            seconds=time.perf_counter() - t0)
    metrics.close()

    best.flush()
    best_state = ckpt.load_best("valid", map_location=device)
    if best_state is not None:
        model.load_state_dict(best_state)
    test_bpp = eval_bpp(data.tst_x)
    result = {"test_bpp": test_bpp, "floor_bpp": floor_bpp, "bpp_gap": test_bpp - floor_bpp}
    log(**result)

    if args.gen > 0:
        # z ~ N(0, T) -> Newton inversion -> pixels (`MNISTExperiment.py:180-196`)
        gen_z = torch.Generator(device=device).manual_seed(args.seed + 3)
        z = torch.randn(args.gen, 784, generator=gen_z, device=device)
        if args.temp_sweep:
            temps = np.repeat(TEMPERATURES, max(args.gen // 10, 1))[: args.gen]
            z = z * torch.as_tensor(temps, device=device)[:, None]
        else:
            z = z * args.temperature
        t0 = time.perf_counter()
        x = model.invert(z, iters=5 * args.nb_iter, method="newton")
        with torch.no_grad():
            gen_bpp, gen_ll, _ = model.compute_bpp(x)
        imgs = logit_back(x).reshape(-1, 28, 28)
        np.save(folder / "generated.npy", imgs)
        result.update(gen_bpp=float(gen_bpp.mean()), gen_ll=float(gen_ll.mean()))
        log(event="generated", images=args.gen, gen_bpp=result["gen_bpp"],
            gen_ll=result["gen_ll"], seconds=time.perf_counter() - t0,
            path=str(folder / "generated.npy"))
    log_file.close()
    return result


if __name__ == "__main__":
    main()
