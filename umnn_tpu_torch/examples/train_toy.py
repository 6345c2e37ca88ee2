"""2-D toy density estimation with a UMNN-MAF flow.

PyTorch counterpart of `examples/train_toy.py` (`:39-170`): the same flags
and defaults, the same data draws (one ``np.random.RandomState(seed)``, 10
training batches per epoch, then a 2,048-row test batch), the same per-epoch
line. ``-data conditionnal8gaussians`` trains a ConditionalMADE-conditioned
flow on the (x, one-hot component) pairs the generator emits: density
estimation of p(x | component). Adam(lr, L2 decay wd) with value clip 1.0.

Checkpoints (``-folder``): the flow's and the optimizer's states under
``<folder>/<data>/ckpt`` every ``-ckpt_every`` epochs and after the last;
``-load`` restores the latest and resumes at the epoch after it (the data
draws start again from the seed, as JAX's do). ``-sample N`` draws N points
at the end by the reference's bisection inversion from a generator seeded
``seed + 1`` (for conditionnal8gaussians the context cycles through the 8
components), prints their mean and std, and with ``-folder`` writes them to
``<folder>/samples_<data>.npy``.

At the default widths ([100]*4, e=10) the integral runs on the
unpacked kernel pair on the card; with every integrand layer at most 32 wide
(``-hidden_derivative 32 32``) it runs on the pack-4 pair
(``csrc/integrand_fwd_p4.cu``, ``csrc/integrand_bwd_p4.cu``), as JAX's auto
picks it; the bisection's candidates run on the same pair's forward.

Not ported yet: the density plot of the samples (``utils/visualize.py``);
not ported, by decision: the data mesh and its shardings (one card needs
none) and ``retry_transient`` (a workaround for failures of the TPU's
compile service).

Usage, on the card (``-device cpu`` runs it on the CPU):

    python -m umnn_tpu_torch.examples.train_toy -data 8gaussians -nb_epoch 6 \\
        -nb_steps 16 -b_size 256 -hidden_embedding 64 64 -hidden_derivative 32 32 -sample 128
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from umnn_tpu_torch.data.toy import TOY_DATASETS, inf_train_gen
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.core import resolve_device
from umnn_tpu_torch.training.checkpoint import CheckpointManager
from umnn_tpu_torch.training.loops import make_optimizer, make_train_step

STEPS_PER_EPOCH = 10
TEST_ROWS = 2048
COND_IN = 8  # conditionnal8gaussians: one-hot over the 8 mixture components


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-data", default="8gaussians", choices=list(TOY_DATASETS))
    p.add_argument("-nb_epoch", type=int, default=50)
    p.add_argument("-nb_flow", type=int, default=1)
    p.add_argument("-nb_steps", type=int, default=20)
    p.add_argument("-embedding_s", type=int, default=10)
    p.add_argument("-hidden_embedding", type=int, nargs="+", default=[100, 100, 100, 100])
    p.add_argument("-hidden_derivative", type=int, nargs="+", default=[100, 100, 100, 100])
    p.add_argument("-b_size", type=int, default=512)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-wd", type=float, default=1e-5)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-sample", type=int, default=0, help="draw N samples at the end")
    p.add_argument("-folder", default="")
    p.add_argument("-load", action="store_true", help="resume from checkpoint")
    p.add_argument("-ckpt_every", type=int, default=100, help="checkpoint cadence in epochs")
    p.add_argument("-device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Trains, samples, and prints JAX's lines; returns the parameter count,
    the per-epoch train and test NLLs and the samples (None without
    ``-sample``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    conditional = args.data == "conditionnal8gaussians"

    def gen(rng_, n):
        out = inf_train_gen(args.data, rng_, n)
        if conditional:
            return torch.as_tensor(out[0], device=device), torch.as_tensor(out[1], device=device)
        return torch.as_tensor(out[:, :2], device=device), None

    rng = np.random.RandomState(args.seed)
    model = UMNNMAFFlow(
        nb_flow=args.nb_flow, nb_in=2, hidden_derivative=tuple(args.hidden_derivative),
        hidden_embedding=tuple(args.hidden_embedding), embedding_s=args.embedding_s,
        nb_steps=args.nb_steps, seed=args.seed, device=device,
        cond_in=COND_IN if conditional else 0,
    )
    n_params = sum(p.numel() for p in model.parameters())
    print(f"device={device} params={n_params}", flush=True)

    def loss_fn(batch, ctx):
        return -model.compute_ll(batch, ctx)[0].mean()

    optimizer = make_optimizer(model.parameters(), "adam", args.lr, args.wd, grad_clip=1.0)
    step = make_train_step(loss_fn, optimizer)
    ckpt = None
    start_epoch = 0
    if args.folder:
        ckpt = CheckpointManager(Path(args.folder) / args.data / "ckpt")
        if args.load:
            # resume: the model's and the optimizer's states
            restored = ckpt.restore(map_location=device)
            if restored is not None:
                epoch, model_state, opt_state = restored
                model.load_state_dict(model_state)
                optimizer.load_state_dict(opt_state)
                start_epoch = epoch + 1
                print(f"resumed from epoch {epoch}", flush=True)

    history = {"params": n_params, "train_nll": [], "test_nll": [], "samples": None}
    for epoch in range(start_epoch, args.nb_epoch):
        t0 = time.time()
        losses = [step(*gen(rng, args.b_size)) for _ in range(STEPS_PER_EPOCH)]
        with torch.no_grad():
            test_nll = float(loss_fn(*gen(rng, TEST_ROWS)))
        train_nll = float(torch.stack(losses).mean())
        history["train_nll"].append(train_nll)
        history["test_nll"].append(test_nll)
        print(
            f"epoch {epoch:3d}  train NLL {train_nll:8.4f}  "
            f"test NLL {test_nll:8.4f}  ({time.time()-t0:.2f}s)",
            flush=True,
        )
        if ckpt is not None and epoch % args.ckpt_every == 0:
            ckpt.save(epoch, model.state_dict(), optimizer.state_dict())

    if ckpt is not None:
        ckpt.save(max(args.nb_epoch - 1, 0), model.state_dict(), optimizer.state_dict())

    if args.sample > 0:
        t0 = time.time()
        gen_z = torch.Generator(device=device).manual_seed(args.seed + 1)
        ctx = None
        if conditional:
            # one sample per mixture component, cycling
            ctx = torch.eye(COND_IN, device=device)[torch.arange(args.sample, device=device) % COND_IN]
        samples = model.sample(args.sample, gen_z, context=ctx).cpu().numpy()
        print(
            f"sampled {args.sample} points in {time.time()-t0:.1f}s  "
            f"mean={samples.mean(0)}  std={samples.std(0)}",
            flush=True,
        )
        if args.folder:
            out = Path(args.folder)
            out.mkdir(parents=True, exist_ok=True)
            np.save(out / f"samples_{args.data}.npy", samples)
        history["samples"] = samples
    return history


if __name__ == "__main__":
    main()
