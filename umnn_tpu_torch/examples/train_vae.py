"""Trains a VAE with a normalizing-flow posterior, the UMNN MMAF among them.

PyTorch counterpart of `examples/train_vae.py`, with its flags and
defaults: Adamax (5e-4, eps 1e-7, no clip), the beta warm-up
``min((epoch + 1) / warmup, max_beta)``, a bernoulli(data) draw per
training batch for Omniglot (from the driver's ``RandomState(seed + 1)``),
early stopping after ``-early_stopping_epochs`` epochs past the warm-up
without a better validation ELBO, a ``ValueError`` on a non-finite
validation loss, the Lipschitz projection of the MMAF's integrand after
every step for ``-Lipshitz > 0``, reconstruction and prior-sample grids
each ``-plot_every`` epochs, and the final test ELBO and IWAE
log-likelihood of the best-valid parameters.

MMAF quadrature: ``-steps 0`` draws ``2 * randint(10, 50)`` steps a
training batch on nodes padded to 100 steps; static steps are unpadded;
validation, test, reconstruction and IWAE always run at 100 steps. On the
card every block's integral is one launch of a kernel pair (the unpacked
pair at the default integrand 31-100-50-50-50-1). The whole run, its
backward passes included, is IEEE float32: ``main`` runs under
``ieee_float32`` and puts the caller's TF32 flags back when it returns.

Data (``umnn_tpu_torch.data.images.load_vae_dataset``): the dataset's
files under ``$UMNN_DATA_ROOT`` where present, else its seeded stand-in;
``-synthetic`` takes the stand-in. Under ``-folder/<dataset>_<flow>``:
``train.log``, ``metrics.jsonl``, ``args.json`` (``args_eval.json`` with
``-eval_only``), ``ckpt/best_valid`` and ``reconstruction/`` grids where
matplotlib is installed (else a "plots skipped" line). ``-eval_only``
evaluates the best-valid checkpoint; ``-load_npz`` starts from a float16
snapshot of either package (with ``-eval_only``, evaluates it).

Usage, on the card (``-device cpu`` runs it on the CPU):

    python -m umnn_tpu_torch.examples.train_vae -flow MMAF -synthetic -nb_epoch 2

The last line of its output is one JSON object with the final metrics;
``main(argv)`` returns the exit code.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from umnn_tpu_torch.data.images import VAE_DATASETS, load_vae_dataset
from umnn_tpu_torch.models.vae import VAE_FAMILIES, calculate_loss, calculate_loss_array
from umnn_tpu_torch.models.vae.iwae import calculate_likelihood
from umnn_tpu_torch.models.vae.layers import ieee_float32
from umnn_tpu_torch.models.vae.losses import bits_per_dim
from umnn_tpu_torch.nn.core import resolve_device
from umnn_tpu_torch.ops.quadrature import padded_cc_quadrature
from umnn_tpu_torch.training.checkpoint import CheckpointManager, load_params_npz
from umnn_tpu_torch.training.loops import batch_iter, make_optimizer, make_train_step
from umnn_tpu_torch.utils.logging import MetricsWriter, get_logger

EVAL_STEPS = 100  # MMAF's quadrature steps in evaluation (`training.py:91-94`)
MAX_STEPS = 100  # -steps 0 draws 2 * U{10, 49}, at most 98; padded to 100


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-dataset", default="mnist", choices=sorted(VAE_DATASETS))
    p.add_argument("-flow", default="no_flow", choices=sorted(VAE_FAMILIES))
    p.add_argument("-nb_epoch", type=int, default=2000)
    p.add_argument("-z_size", type=int, default=64)
    p.add_argument("-num_flows", type=int, default=4)
    p.add_argument("-made_h_size", type=int, default=320)
    p.add_argument("-num_ortho_vecs", type=int, default=32)
    p.add_argument("-num_householder", type=int, default=8)
    p.add_argument("-hidden_embedding", type=int, nargs="+", default=[512, 512])
    p.add_argument("-hidden_derivative", type=int, nargs="+", default=[100, 50, 50, 50])
    p.add_argument("-embedding_size", type=int, default=30)
    p.add_argument("-steps", type=int, default=50, help="0: randomized steps")
    p.add_argument("-lr", type=float, default=5e-4)
    p.add_argument("-b_size", type=int, default=100)
    p.add_argument("-warmup", type=int, default=100)
    p.add_argument("-max_beta", type=float, default=1.0)
    p.add_argument("-early_stopping_epochs", type=int, default=35)
    p.add_argument("-Lipshitz", type=float, default=0.0)
    p.add_argument("-iwae_samples", type=int, default=5000)
    p.add_argument("-iwae_minibatch", type=int, default=500)
    p.add_argument("-iwae_test_points", type=int, default=0, help="0 = all")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-folder", default="runs/vae")
    p.add_argument("-synthetic", action="store_true")
    p.add_argument("-eval_only", action="store_true",
                   help="skip training: load the best-valid checkpoint from -folder and run "
                        "the final test ELBO and IWAE")
    p.add_argument("-plot_every", type=int, default=1,
                   help="reconstruction and prior-sample grids every N epochs (0 = off)")
    p.add_argument("-load_npz", default="",
                   help="start from a float16 snapshot (either package's); with -eval_only, "
                        "evaluate it")
    p.add_argument("-device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def build_model(args, data, device) -> torch.nn.Module:
    """The family of ``-flow`` at the flags' sizes, on ``device``."""
    kw = dict(z_size=args.z_size, input_size=data.input_size, input_type=data.input_type,
              seed=args.seed, device=device)
    fam = args.flow
    if fam in ("planar", "triangular"):
        kw["num_flows"] = args.num_flows
    elif fam == "orthogonal":
        kw.update(num_flows=args.num_flows, num_ortho_vecs=args.num_ortho_vecs)
    elif fam == "householder":
        kw.update(num_flows=args.num_flows, num_householder=args.num_householder)
    elif fam == "iaf":
        kw.update(num_flows=args.num_flows, made_h_size=args.made_h_size)
    elif fam == "MMAF":
        kw.update(num_flows=args.num_flows, made_h_size=args.made_h_size,
                  hidden_derivative=tuple(args.hidden_derivative),
                  hidden_embedding=tuple(args.hidden_embedding),
                  embedding_size=args.embedding_size,
                  nb_steps=args.steps if args.steps > 0 else 50)
    return VAE_FAMILIES[fam](**kw)


@ieee_float32()
def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    folder = Path(args.folder) / f"{args.dataset}_{args.flow}"
    folder.mkdir(parents=True, exist_ok=True)
    logger = get_logger("vae", folder / "train.log")
    metrics = MetricsWriter(folder / "metrics.jsonl")
    # an evaluation run keeps the training run's arguments
    (folder / ("args_eval.json" if args.eval_only else "args.json")).write_text(
        json.dumps(vars(args)))

    data = load_vae_dataset(args.dataset, synthetic=True if args.synthetic else None)
    c, hh, ww = data.input_size
    logger.info("dataset %s (%s): %s train=%d valid=%d test=%d", args.dataset, data.input_type,
                data.input_size, len(data.trn), len(data.val), len(data.tst))
    model = build_model(args, data, device)
    is_mmaf = args.flow == "MMAF"
    random_steps = is_mmaf and args.steps == 0
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model %s params: %d device: %s", args.flow, n_params, device)
    optimizer = make_optimizer(model.parameters(), "adamax", args.lr, grad_clip=None)

    # MMAF trains at its (possibly random) step count and evaluates at 100
    quad = {}
    if is_mmaf:
        quad = dict(zip(("nodes", "weights"), padded_cc_quadrature(EVAL_STEPS, MAX_STEPS, device)))

    def images(batch: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(batch, device=device).reshape(-1, c, hh, ww)

    def loss_fn(batch, gen, beta, nodes, weights):
        x = images(batch)
        kw = dict(nodes=nodes, weights=weights) if is_mmaf else {}
        x_mean, z_mu, z_var, ldj, z0, zk = model(x, gen, **kw)
        loss, rec, kl, bpd = calculate_loss(x_mean, x, z_mu, z_var, z0, zk, ldj,
                                            data.input_type, data.input_size, beta)
        return loss, (rec, kl, bpd)

    # the projection after every optimizer step, each from fresh start
    # vectors (`training.py:46-48`)
    post_update = None
    if is_mmaf and args.Lipshitz > 0:
        lip_gen = torch.Generator(device=device).manual_seed(args.seed + 0x11B)

        def post_update(gen, beta, nodes, weights):
            model.force_lipschitz(args.Lipshitz, lip_gen)

    train_step = make_train_step(loss_fn, optimizer, post_update, has_aux=True)

    @torch.inference_mode()
    def eval_rows(batch, gen) -> torch.Tensor:
        """The ELBO of each row, MMAF at 100 steps."""
        x = images(batch)
        x_mean, z_mu, z_var, ldj, z0, zk = model(x, gen, **quad)
        return calculate_loss_array(x_mean, x, z_mu, z_var, z0, zk, ldj,
                                    data.input_type, data.input_size)

    def eval_split(x: np.ndarray, gen) -> float:
        total, n = [], 0
        for b, nv in batch_iter(x, args.b_size, rng_np, shuffle=False, with_counts=True):
            total.append(eval_rows(b, gen)[:nv].sum())
            n += nv
        return float(torch.stack(total).sum()) / max(n, 1)

    def to_pixels(x_mean: torch.Tensor) -> np.ndarray:
        """A decoder mean as ``[N, H, W(, C)]`` images in [0, 1];
        multinomial: argmax / 255."""
        x = x_mean.detach().cpu().numpy()
        if data.input_type == "multinomial":
            x = x.reshape(-1, 256, c, hh, ww).argmax(axis=1) / 255.0
        x = x.reshape(-1, c, hh, ww)
        return x[:, 0] if c == 1 else np.moveaxis(x, 1, -1)

    ckpt = CheckpointManager(folder / "ckpt")
    rng_np = np.random.RandomState(args.seed + 1)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    best_valid, patience, best_state = float("inf"), 0, None

    if args.load_npz:
        load_params_npz(args.load_npz, model)  # the optimizer starts fresh
        logger.info("warm-started params from %s (optimizer fresh)", args.load_npz)
    if args.eval_only and not args.load_npz:
        best_state = ckpt.load_best("valid", map_location=device)
        if best_state is None:
            logger.info("-eval_only: no best_valid checkpoint under %s", ckpt.directory)
            return 1
        logger.info("eval-only: loaded best-valid checkpoint from %s", ckpt.directory)

    for epoch in range(0 if args.eval_only else args.nb_epoch):
        t0 = time.time()
        beta = min((epoch + 1) / max(args.warmup, 1), args.max_beta)
        losses = []
        for b in batch_iter(data.trn, args.b_size, rng_np):
            if data.dynamic_binarization:
                b = rng_np.binomial(1, b).astype(np.float32)
            nodes = weights = None
            if random_steps:
                nodes, weights = padded_cc_quadrature(2 * rng_np.randint(10, 50), MAX_STEPS, device)
            elif is_mmaf:
                nodes, weights = padded_cc_quadrature(args.steps, args.steps, device)
            loss, _ = train_step(b, gen, beta, nodes, weights)
            losses.append(loss)
        train_loss = float(torch.stack(losses).mean())
        valid_loss = eval_split(data.val, gen)
        if not np.isfinite(valid_loss):
            raise ValueError(f"NaN/inf validation loss at epoch {epoch}")
        metrics.scalar("train_loss", train_loss, epoch)
        metrics.scalar("valid_loss", valid_loss, epoch)
        bpd_line = ""
        if data.input_type == "multinomial":
            valid_bpd = float(bits_per_dim(valid_loss, data.input_size))
            metrics.scalar("valid_bpd", valid_bpd, epoch)
            bpd_line = f"  valid bpd {valid_bpd:.4f}"
        logger.info("epoch %3d  beta %.3f  train %.2f  valid %.2f%s  (%.1fs)", epoch, beta,
                    train_loss, valid_loss, bpd_line, time.time() - t0)
        if args.plot_every and epoch % args.plot_every == 0:
            # the decodes run outside the try: only a missing matplotlib is skipped
            vb = data.val[: args.b_size]
            with torch.inference_mode():
                recon = to_pixels(model(images(vb), gen, **quad)[0])
                zs = torch.randn(9, args.z_size, generator=gen, device=device)
                prior = to_pixels(model.decode(zs))
            try:
                from umnn_tpu_torch.utils.visualize import image_grid

                rdir = folder / "reconstruction"
                rdir.mkdir(exist_ok=True)
                if epoch == 0:
                    real = vb.reshape(-1, c, hh, ww)
                    real = real[:, 0] if c == 1 else np.moveaxis(real, 1, -1)
                    image_grid(real[:9], rdir / "real.png", ncols=3)
                image_grid(recon[:9], rdir / f"{epoch}_elbo_{valid_loss:.4f}.png", ncols=3)
                image_grid(prior, rdir / f"{epoch}_prior_samples.png", ncols=3)
            except ImportError as e:  # no matplotlib
                logger.info("plots skipped: %s", e)
        if valid_loss < best_valid:
            best_valid, patience = valid_loss, 0
            best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            ckpt.save_best("valid", best_state)
        elif args.warmup < epoch:
            patience += 1
            if patience > args.early_stopping_epochs:
                logger.info("early stopping at epoch %d", epoch)
                break
    metrics.close()

    # the final evaluation on the best parameters: the test ELBO, then IWAE
    if best_state is not None:
        model.load_state_dict(best_state)
    test_elbo = eval_split(data.tst, gen)
    tst = data.tst[: args.iwae_test_points] if args.iwae_test_points else data.tst
    n_s = args.iwae_samples if args.dataset != "caltech" else 2000
    ll_mean, _ = calculate_likelihood(
        model, tst.reshape(-1, c, hh, ww), gen, n_samples=n_s, minibatch=args.iwae_minibatch,
        apply_kwargs=quad or None,
    )
    logger.info("FINAL test ELBO: %.4f  test IWAE ll: %.4f (S=%d)", test_elbo, ll_mean, n_s)
    out = {"dataset": args.dataset, "flow": args.flow,
           "best_valid_elbo": None if np.isinf(best_valid) else best_valid,
           "test_elbo": test_elbo, "test_iwae_ll": ll_mean, "iwae_samples": n_s}
    if data.input_type == "multinomial":
        bpd_elbo = float(bits_per_dim(test_elbo, data.input_size))
        bpd_ll = float(bits_per_dim(-ll_mean, data.input_size))
        logger.info("====> Test set bpd (elbo): %.4f", bpd_elbo)
        logger.info("====> Test set bpd (log-likelihood): %.4f", bpd_ll)
        out.update(test_bpd_elbo=bpd_elbo, test_bpd_ll=bpd_ll)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
