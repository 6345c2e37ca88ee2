"""UMNN-MAF density estimation on the UCI tabular suite.

PyTorch counterpart of `examples/train_uci.py`, with every flag of its
argparse and the same defaults (those of the reference's
`UCIExperiments.py:196-217`: 5 blocks, MADE [512, 512], integrand
[50, 50, 50, 50], e = 30, 50 CC steps, Adam lr 1e-3 with L2 decay 1e-2,
batch 500, value clip 1.0), plus ``-device``:

* randomized steps (``-nb_steps <= 0``): each batch draws
  ``nb_steps = 2 * U{5, 49}`` on nodes padded to ``MAX_STEPS + 1 = 101``,
  and evaluation runs at 100 steps (`UCIExperiments.py:130-132`);
* the plateau schedule on the valid NLL, best-train / valid /
  train-valid stashes, a checkpoint and a flush of the stashes every 5
  epochs, the loss history as the resume cursor (`-load`), float16
  snapshots (`-load_npz`), evaluation only (`-test`: every best tag, the
  best-train one first);
* ``-Lipshitz L`` (the reference's spelling): after every step, a skipped
  one too, each integrand layer's weight is divided by ``max(sigma / L,
  1)``, sigma from power iteration on a fresh draw of a generator seeded
  with ``seed + 97``;
* the final test NLL on the best-valid parameters, stamped with a
  validity report (node convergence, bfloat16 sensitivity, non-finite
  rows) on the first 2,000 valid rows.

At the default widths every integrand layer is at most 64 wide, so the
integral runs on the pack-2 kernel pair (``csrc/integrand_fwd_p2.cu``,
``csrc/integrand_bwd_p2.cu``) on the card; wider ``-hidden_derivative``
goes to the other pairs as JAX's auto picks them.

Not ported: the data mesh and its shardings (one card needs none) and
``retry_transient``, a workaround for failures of the TPU's compile
service.

Usage, on the card (``-device cpu`` runs it on the CPU):

    python -m umnn_tpu_torch.examples.train_uci -data power -nb_epoch 5

Without the data files (``datasets/data/`` or ``UMNN_DATA_ROOT``) it
trains on the seeded synthetic stand-in of the dataset; ``-synthetic
-synthetic_rows -1`` takes it at the real dataset's size. The GAS and
HEPMASS files need pandas, BSDS300 h5py. It writes ``train.log``,
``metrics.jsonl``, ``args.json`` (``args_eval.json`` with ``-test``) and
``ckpt/`` under ``-folder/<data>``, and prints one JSON line at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from umnn_tpu_torch.data.uci import SYNTH_REAL_ROWS, UCI_DIMS, load_uci
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
from umnn_tpu_torch.training.resume import resume_training_state
from umnn_tpu_torch.utils.logging import MetricsWriter, get_logger
from umnn_tpu_torch.utils.validity import density_validity_report

MAX_STEPS = 100  # randomized mode draws 2*U{5,49}, at most 98; 101 padded nodes


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-data", default="power", choices=sorted(UCI_DIMS))
    p.add_argument("-nb_epoch", type=int, default=500)
    p.add_argument("-nb_flow", type=int, default=5)
    p.add_argument("-nb_steps", type=int, default=50, help="<=0 for randomized")
    p.add_argument("-embedding_s", type=int, default=30)
    p.add_argument("-hidden_embedding", type=int, nargs="+", default=[512, 512])
    p.add_argument("-hidden_derivative", type=int, nargs="+", default=[50, 50, 50, 50])
    p.add_argument("-b_size", type=int, default=500)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-wd", type=float, default=1e-2)
    p.add_argument("-s_rate", type=float, default=0.5, help="plateau decay factor")
    p.add_argument("-s_patience", type=int, default=5,
                   help="epochs with no improvement before the rate is cut")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-folder", default="runs/uci")
    p.add_argument("-load", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("-load_npz", default="",
                   help="start from a float16 snapshot (either package's); with -test, "
                        "evaluate it")
    p.add_argument("-test", action="store_true",
                   help="evaluation only: the test NLL of every best checkpoint (at 100 "
                        "steps in randomized mode), no training")
    p.add_argument("-steps_per_epoch", type=int, default=0, help="0 = full epoch")
    p.add_argument("-Lipshitz", type=float, default=0,
                   help="max Lipschitz constant of the integrand's layers (0 = off)")
    p.add_argument("-synthetic", action="store_true")
    p.add_argument("-synthetic_rows", type=int, default=0,
                   help="synthetic rows before the splits (0 = 20000; -1 = the real "
                        "dataset's size, data/uci.py SYNTH_REAL_ROWS)")
    p.add_argument("-device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def train_epoch(step, trn: np.ndarray, args, rng: np.random.RandomState, max_steps: int,
                device) -> list:
    """One epoch's steps on shuffled batches of ``trn``; the step losses,
    on the device. The host draws in JAX's order: the permutation, then
    one step count per batch in randomized mode."""
    losses = []
    for i, b in enumerate(batch_iter(trn, args.b_size, rng)):
        if args.steps_per_epoch and i >= args.steps_per_epoch:
            break
        # U{5,49}: randint's high is exclusive (`UCIExperiments.py:131`)
        n_steps = 2 * rng.randint(5, 50) if args.nb_steps <= 0 else args.nb_steps
        nodes, weights = padded_cc_quadrature(n_steps, max_steps, device)
        losses.append(step(torch.as_tensor(b, device=device), nodes, weights))
    return losses


@torch.no_grad()
def eval_split(model: UMNNMAFFlow, x: np.ndarray, b_size: int, nodes, weights, device) -> float:
    """Mean NLL over the rows of ``x`` (the wrapped-round rows of the last
    batch left out)."""
    total, n = [], 0
    for b, nv in batch_iter(x, b_size, None, shuffle=False, with_counts=True):
        ll, _ = model.compute_ll(torch.as_tensor(b, device=device), nodes=nodes, weights=weights)
        total.append(-ll[:nv].sum())
        n += nv
    return float(torch.stack(total).sum()) / max(n, 1)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    folder = Path(args.folder) / args.data
    folder.mkdir(parents=True, exist_ok=True)
    logger = get_logger("uci", folder / "train.log")
    metrics = MetricsWriter(folder / "metrics.jsonl")
    # -test re-runs must not overwrite the training run's configuration
    (folder / ("args_eval.json" if args.test else "args.json")).write_text(json.dumps(vars(args)))

    synth_rows = None
    if args.synthetic_rows == -1:
        synth_rows = SYNTH_REAL_ROWS[args.data]
    elif args.synthetic_rows > 0:
        synth_rows = args.synthetic_rows
    data = load_uci(args.data, synthetic=True if args.synthetic else None,
                    synthetic_rows=synth_rows)
    logger.info(
        "dataset %s: dims=%d train=%d valid=%d test=%d",
        data.name, data.n_dims, len(data.trn), len(data.val), len(data.tst),
    )

    random_steps = args.nb_steps <= 0
    eval_steps = 100 if random_steps else args.nb_steps
    # the node axis is padded only in randomized mode: padding nodes still
    # cost integrand evaluations in both sweeps
    max_steps = MAX_STEPS if random_steps else max(eval_steps, args.nb_steps)
    model = UMNNMAFFlow(
        nb_flow=args.nb_flow, nb_in=data.n_dims, hidden_derivative=tuple(args.hidden_derivative),
        hidden_embedding=tuple(args.hidden_embedding), embedding_s=args.embedding_s,
        nb_steps=eval_steps, seed=args.seed, device=device,
    )
    # the frozen scaling counts, as in the JAX package's parameter tree
    n_params = sum(t.numel() for t in model.state_dict().values())
    logger.info("model params: %d  devices: %s", n_params, device)

    optimizer = make_optimizer(model.parameters(), "adam", args.lr, args.wd, grad_clip=1.0)

    def loss_fn(x, nodes, weights):
        ll, _ = model.compute_ll(x, nodes=nodes, weights=weights)
        return -ll.mean()

    # the Lipschitz projection after every optimizer step
    # (`UCIExperiments.py:145-147`), each from fresh start vectors as the
    # reference's fresh torch.randn per forceLipshitz call
    post_update = None
    if args.Lipshitz > 0:
        lip_gen = torch.Generator(device=device).manual_seed(args.seed + 97)

        def post_update(nodes, weights):
            model.force_lipschitz(args.Lipshitz, lip_gen)

    step = make_train_step(loss_fn, optimizer, post_update)
    eval_nodes, eval_weights = padded_cc_quadrature(eval_steps, max_steps, device)

    ckpt = CheckpointManager(folder / "ckpt")
    best = BestTracker(ckpt)
    if args.load_npz:
        # a start from a float16 snapshot, optimizer fresh; a -load below
        # (the full resume) takes precedence where its checkpoint exists
        load_params_npz(args.load_npz, model)
        logger.info("warm-started params from %s (optimizer fresh)", args.load_npz)
    plateau = ReduceLROnPlateau(factor=args.s_rate, patience=args.s_patience)
    history = ckpt.load_history() if args.load else {"train": [], "valid": [], "test": []}
    start_epoch = len(history["valid"])  # the resume cursor
    rng = np.random.RandomState(args.seed + 1)
    lr = args.lr
    if args.load and ckpt.latest_step() is not None:
        lr, start_epoch, history = resume_training_state(
            ckpt, model, optimizer, history=history, plateau=plateau, best=best,
            init_lr=args.lr, logger=logger,
        )

    def eval_nll(x: np.ndarray) -> float:
        return eval_split(model, x, args.b_size, eval_nodes, eval_weights, device)

    if args.test:
        # evaluation only: the reference loads model_best_train.pt and
        # reports its test NLL at 100 steps in randomized mode
        # (`UCIExperiments.py:93-122`); every saved tag is reported, the
        # best-train one first
        results = {}
        if args.load_npz:
            results["npz"] = eval_nll(data.tst)
            logger.info(
                "TEST-ONLY (npz snapshot %s, %d steps): test NLL %.4f over %d rows",
                args.load_npz, eval_steps, results["npz"], len(data.tst),
            )
        for tag in () if args.load_npz else ("train", "valid", "train_valid"):
            loaded = ckpt.load_best(tag, map_location=device)
            if loaded is None:
                continue
            model.load_state_dict(loaded)
            results[tag] = eval_nll(data.tst)
            logger.info(
                "TEST-ONLY (best-%s params, %d steps): test NLL %.4f over %d rows",
                tag, eval_steps, results[tag], len(data.tst),
            )
        if not results:
            logger.info("-test: no best checkpoint found under %s", ckpt.directory)
            return 1
        primary = "train" if "train" in results else next(iter(results))
        print(json.dumps({
            "dataset": data.name, "mode": "test_only", "ckpt": primary,
            "eval_steps": eval_steps, "test_nll": results[primary],
            "test_nll_by_ckpt": results,
        }), flush=True)
        return 0

    for epoch in range(start_epoch, args.nb_epoch):
        t0 = time.time()
        losses = train_epoch(step, data.trn, args, rng, max_steps, device)
        # a batch whose loss overflowed was skipped by the step's guard, so
        # the epoch metric leaves it out
        train_nll, n_skip = finite_mean(losses)
        if n_skip:
            logger.info(
                "epoch %d: %d/%d non-finite batch losses excluded from the "
                "train metric (updates were skipped by the step guard)",
                epoch, n_skip, len(losses),
            )
        valid_nll = eval_nll(data.val)
        history["train"].append(train_nll)
        history["valid"].append(valid_nll)
        metrics.scalar("train_nll", train_nll, epoch)
        metrics.scalar("valid_nll", valid_nll, epoch)
        best.update(train_nll, valid_nll, model.state_dict())
        new_lr = plateau.update(valid_nll, lr)
        if new_lr != lr:
            lr = new_lr
            optimizer.lr = lr
            logger.info("epoch %d: lr -> %g", epoch, lr)
        if epoch % 5 == 0:
            ckpt.save(epoch, model.state_dict(), optimizer.state_dict(), history)
            # the improved stashes go to disk with each periodic save: a
            # killed run would otherwise lose them
            best.flush()
        logger.info(
            "epoch %3d  train NLL %.4f  valid NLL %.4f  lr %g  (%.1fs)",
            epoch, train_nll, valid_nll, lr, time.time() - t0,
        )
    metrics.close()

    best.flush()
    best_state = ckpt.load_best("valid", map_location=device)
    which = "best-valid"
    if best_state is not None:
        model.load_state_dict(best_state)
    else:
        # possible after a resume whose epochs never beat the earlier best
        # (the thresholds come from the history, the parameters do not)
        which = "last-epoch (no best-valid stash on disk)"
    test_nll = eval_nll(data.tst)
    history["test"].append(test_nll)
    ckpt.save(args.nb_epoch, model.state_dict(), optimizer.state_dict(), history)
    logger.info("FINAL test NLL (%s params): %.4f", which, test_nll)
    # the reported NLL's validity: quadrature node convergence and bfloat16
    # sensitivity on a valid slice (PARITY_RUNS §2e: an ill-conditioned
    # flow can report an NLL below the data's entropy floor)
    rep = density_validity_report(
        model, torch.as_tensor(data.val[:2000], device=device),
        steps=eval_steps, check_steps=min(4 * eval_steps, 400),
    )
    logger.info(
        "validity: valid-slice NLL %.4f  node_gap %.4g  bf16_gap %.4g  nonfinite %d -> %s",
        rep.nll, rep.node_gap, rep.bf16_gap, rep.n_nonfinite, "OK" if rep.ok() else "SUSPECT",
    )
    print(json.dumps({
        "dataset": data.name, "test_nll": test_nll,
        "validity": dict(dataclasses.asdict(rep), ok=rep.ok()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
