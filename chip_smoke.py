#!/usr/bin/env python3
"""Smoke run of the PyTorch port (umnn_tpu_torch) on one NVIDIA card.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It needs only this file, the ``umnn_tpu_torch/`` package, torch, numpy and
scipy. Phases, each printing one flushed JSON line:

1. env     the card, its power limit, torch and CUDA versions;
2. build   the CUDA sources, compiled with one nvcc call from a clean build
           directory;
3. kernel  the forward integrand kernel against its plain PyTorch version
           on the card, at one MNIST block's shape and at edge cases (one
           hidden layer, the widest sets 31-128-128-1 and 31-128-128-76-1,
           widths that divide none of its column groups, K = 1, 2, 21 and
           101 padded, fewer row tiles than blocks); bit-identical reruns;
           a 129-wide integrand, also as a flow under backend="kernel" and
           "auto", goes to the streamed pair (one launch of integrand_fwd_wide,
           values against the plain version and backend="torch"); a non-ELU
           integrand raises and launches nothing; its launch shape;
4. bwd     the backward integrand kernel, through the autograd Function and
           through its wrapper, against its plain version, at the MNIST
           block and edge cases (widths that divide none of its register
           tiles, the widest sets it takes, ragged row and pair tiles at
           K = 51 and 101); bit-identical reruns; widths it refuses go to the
           streamed pair, and the forward with it; its
           launch shape (threads, shared bytes, registers, resident blocks
           per SM);
5. slice   the full-width 5-block MNIST UMNN-MAF flow (random weights from a
           seed) scores 100 synthetic MNIST-geometry rows with compute_bpp
           on the kernel path, held against the plain quadrature path; the
           forward kernel's launch count over one compute_ll must be 5;
6. train   the same flow trains: gradients of -mean(compute_ll) on the
           kernel route against the plain (Leibniz) route, one Adam step
           with 5 launches of each unpacked kernel and none of the pack-2
           pair, then ten steps on fresh batches with finite, falling loss;
7. kernel_p2  the pack-2 forward kernel against its plain version at one
           block of the calibration flow (3,000 rows, 51 nodes, widths
           31-50-50-50-50-1) and edge cases (101 padded nodes, an even K,
           x = 0, x < 0, 77 rows, ReLU, the 64-wide limit) and those of its
           persistent grid (fewer rows than SMs, a last row tile of one row,
           K = 1 and 2, one hidden layer 31-64-1, eight 64-wide layers at
           K = 51 and 101 on smaller pair tiles); pack2=True on a 65-wide
           layer raises, a 32-wide integrand goes to the pack-4 pair; its
           launch shape;
8. bwd_p2  the pack-2 backward kernel, through the autograd Function and
           through its wrapper, against the float64 plain version at the
           same cases; bit-identical reruns; its launch shape;
9. calibration  the full-width known-entropy calibration flow (random
           weights from a seed): gradients on the kernel route against the
           Leibniz route, 5 + 5 pack-2 launches per training step and none
           of the unpacked pair, then the port's calibration driver for 5
           epochs on full data, which must pass its 0.05-nat gate;
10. uci    the UCI driver's flow on BSDS300 at full width (D = 63, 5 blocks,
           MADE [512, 512], integrand 31-50-50-50-50-1, batch 500: 31,500
           rows; random weights from a seed; the synthetic stand-in at the
           real dataset's 1,234,568 rows): gradients of the two routes at
           K = 51 and at a randomized step's 101 padded nodes; 5 + 5 pack-2
           launches a step at both, 5 forward launches an evaluation, 15 in
           the validity report; examples/train_uci.py for 3 epochs of 40
           randomized steps (epoch NLLs finite, valid NLL falling, no
           non-finite row, launches as counted, test NLL beside the
           synthetic floor), a -load to epoch 4 (resumed at epoch 3 with the
           saved parameters and rate), -test (every best tag) and a
           -Lipshitz 1.5 run (every integrand layer's exact norm within
           LIP_TOL of the bound), and the projection of a full-width flow on
           the card; then the pack-2 pair at the driver's blocks against its
           plain versions (forward and backward at R = 31,500, K = 51 and
           101; forward at the validity report's 126,000 rows and 401
           nodes), with device times beside their bounds, and
           uci_train_step_ms at both node counts with the device's idle
           share;
11. kernel_p4  the pack-4 forward kernel against its plain version at the
           toy flow's block (512 rows, 17 nodes, widths 11-32-32-1), a
           4,096-row block and the flagship's block (192 rows, 21 nodes,
           widths 9-32-32-1), and edge cases (K = 16, 18, 19, 101 padded
           nodes, x = 0, x < 0, 77 rows, ReLU, the 32-wide limit, eight
           layers) and those of its persistent grid (100 rows, fewer than
           the SMs; 513 rows, a last row tile of one row; K = 1 and 2; eight
           layers at K = 101 and 500, one row's items in several item tiles;
           one row, a grid of one block); pack4=True on a 33-wide layer
           raises; auto takes the pack-4, pack-2 and unpacked pairs where
           JAX's auto does; bit-identical reruns; its launch shape;
12. bwd_p4 the pack-4 backward kernel, through the autograd Function and
           through its wrapper, against the float64 plain version at the
           same cases, by bwd_p2's rule; bit-identical reruns; its launch
           shape (with the partial-sum slices);
13. toy    the flagship flow (2 blocks, D = 6) and the toy flow at the
           verify widths: gradients on the kernel route against the
           Leibniz route, 2 + 2 and 1 + 1 pack-4 launches per training
           step and no other integrand kernel (and the flagship step's
           device launches of all kernels); then the port's toy driver
           for 6 epochs on 8gaussians and on conditionnal8gaussians, whose
           test NLL must fall;
14. wide   the streamed pair (integrand_wide.cu), which takes what the
           staged pairs refuse: values and gradients (by bwd_p2's rule,
           through the wrapper and the autograd Function) at a 129-wide
           integrand, the timing block (3,000 rows, 51 nodes, widths
           31-256-256-256-256-1, two row chunks), 31-128-128-128-128-1 (past
           227 KB in the staged forward), nine 64- and nine 24-wide layers
           (the pack-2 and pack-4 routes past MAX_LAYERS), K = 1, K = 2 on
           the unpacked route's eight 64-wide layers, 101 padded nodes, ReLU
           and x = 0, and the product kernel's edges (77 rows, 31-129-129-1,
           a last chunk of 3 rows, a dW product in 20 slices, h at an
           address no multiple of 16 bytes), each call one launch of the
           pair; bit-identical reruns; a 129-wide flow under "auto" and
           "kernel" against "torch" (ll and every parameter gradient, 1 + 1
           launches per step); the main path at full width, the training
           step of examples/train_uci.py's flow with -hidden_derivative 256
           256 256 256 against "torch" (5 + 5 launches, its step time on
           both routes); at the timing block its device time per kernel and
           launch (ops/wide_split.py), CUDA kernels per call, the bound and
           cuBLAS's time for the same products;
15. timing CUDA-event medians of whole calls and profiler device times of
           every kernel, their plain versions, compute_bpp and a training
           step of each flow, beside the kernels' bounds; the unpacked pair
           also at the calibration block, and the pack-2 and unpacked pairs
           beside the pack-4 pair at the toy and 4,096-row blocks, as the
           comparison routes, with the pack-4 pair's shares of its bounds,
           the launch floor at its launch shapes (launch_floor_ms) and the
           host breakdown of its calls (host_breakdown); the unpacked pair's
           shares of their bounds and launch shapes, and the forward's
           device time beside its acceptance limit (not enforced);
16. monotonic  MonotonicNN (examples/train_monotonic.py's model, ReLU
           integrand) at the driver's widths 3-100-100-100-1 (the
           unpacked pair), at 3-64-64-1 (pack-2), 3-32-32-1 (pack-4) and at
           in_d = 1, R = 512, K = 51: values and gradients on the kernel
           route against backend="torch", one forward and one backward
           launch a training step, increasing in x1; h with no column
           refused before any launch; the unpacked pair at that block
           against its plain versions, device times beside bounds;
           monotonic_train_step_ms with the device's idle share; the
           driver at the verify command (exit 0, monotone, MSE falling,
           61 + 60 launches); the class-conditional MNIST flow at full
           width (cond_in = 10, batch 100 of the uniform stand-in): its
           routes' gradients, 5 + 5 launches a step, and its driver with
           -conditionnal -synthetic for one short epoch and -gen 10; the
           CC solver on the calibration flow (values within KERNEL_TOL of
           the kernel route, no integrand kernel) and its inference peak
           memory at the MNIST flow below the node megabatch's; the
           accumulation step with 4 microbatches against one backward of
           the batch, 20 + 20 launches, with both peaks;
17. vae    the VAE stack (examples/train_vae.py) at the driver's defaults:
           MMAVAE with z 64, 4 flows, the 320-wide context, MADE [512, 512],
           integrand 31-100-50-50-50-1, batch 100 of the binary stand-in
           (R = 6,400): the kernel route against backend="torch" on the
           same weights and noise (x_mean, ldj, loss, every gradient) at
           K = 51 and at 101 padded nodes, and at the pack-2 widths
           31-50-50-50-50-1; 4 + 4 launches of one pair a training step and
           4 forwards an evaluation batch, h of 30 columns; the pairs at
           these blocks and the unpacked forward at an IWAE call's R =
           256,000, K = 101 against their plain versions, device times
           beside bounds; vae_train_step_ms with the device's idle share;
           one step of the planar, orthogonal, Householder, triangular and
           IAF families with each flow's log-det against float64 autodiff;
           the driver (-flow MMAF -synthetic, 2 epochs, 8 IWAE points of
           1,000 samples), whose IWAE NLL may not lie 2 nats below the
           stand-in's optimum 784 ln 2, on Freyfaces (bpd not below 7.95)
           and -eval_only, each run switching TF32 off itself; the
           data-parallel step under an NCCL group of one against the plain
           step;
18. sample inversion and sampling: at the UCI parity configuration (the
           calibration flow, batch 500, D = 6, 5 blocks; the pack-2 forward)
           the reference's bisection (10 rounds of 10 candidates) and
           Jacobi-Newton (30 iterations), at the MNIST configuration at full
           width (batch 100, D = 784; the unpacked forward) Newton on 5
           blocks and bisection on 1 (the cut; once on 5, the kernel route,
           39,200 launches and its round trip), each from z = forward(x) on
           the kernel route and the plain route (backend="torch"), three
           calls each (CUDA events, samples/s): launches exactly blocks x D x
           iters (bisection) or blocks x iters (Newton) of the forward and
           nothing else, none on the plain route; the x- and z-space round
           trips within 3e-3 (bisection) and 2e-4 (Newton), the routes within
           the same of each other; a profiler trace of one call (device busy
           time, idle share, the forward's device time a launch beside its
           bound); a Newton inversion keeps no graph and no gradient; then
           the toy driver with -sample 128 on 8gaussians and
           conditionnal8gaussians (the pack-4 forward): its launches, finite
           samples written under -folder, their round trip under the saved
           parameters, their z against the driver's draws, samples/s of both
           routes. It runs last: its long traces and many unprofiled
           launches once made a later exact-count trace lose a launch.

Then a ``kernels`` line, the nvidia-smi name and power limit, and a last
line ``{"ok": true, "device": {...}}``. Any failed check raises, and the
run exits non-zero with its traceback; with no CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from umnn_tpu_torch import UMNNMAFFlow
from umnn_tpu_torch.data.images import load_mnist_flow, load_vae_dataset, synthetic_mnist_ar1
from umnn_tpu_torch.data.toy import inf_train_gen
from umnn_tpu_torch.data import uci
from umnn_tpu_torch.examples import (
    train_calibration,
    train_mnist,
    train_monotonic,
    train_toy,
    train_uci,
    train_vae,
)
from umnn_tpu_torch.models import umnn_maf
from umnn_tpu_torch.models.monotonic import MonotonicNN
from umnn_tpu_torch.models.vae import MMAVAE, VAE_FAMILIES, calculate_loss
from umnn_tpu_torch.models.vae import layers as vae_layers
from umnn_tpu_torch.nn.core import torch_linear_init
from umnn_tpu_torch.ops import _build, wide_split
from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors, padded_cc_quadrature
from umnn_tpu_torch.parallel import multihost
from umnn_tpu_torch.training.checkpoint import CheckpointManager
from umnn_tpu_torch.training.loops import make_accum_train_step, make_optimizer, make_train_step

T0 = time.perf_counter()
BUDGET_S = 600.0  # the run stops with an error past this, half the caller's limit

# The widest configuration the repo trains: examples/train_mnist.py defaults.
MNIST = dict(
    nb_flow=5, nb_in=784, hidden_derivative=(100, 50, 50, 50, 50),
    hidden_embedding=(1024, 1024, 1024), embedding_s=30, nb_steps=50,
)
BATCH = 100
TRAIN_STEPS = 10
WIDTHS = [1 + MNIST["embedding_s"], *MNIST["hidden_derivative"], 1]
# The known-entropy calibration flow: examples/train_calibration.py's
# defaults (the UCI parity widths). Its integrand is at most 64 wide, so it
# runs on the pack-2 kernel pair.
CALIB = dict(
    nb_flow=5, nb_in=6, hidden_derivative=(50, 50, 50, 50), hidden_embedding=(512, 512),
    embedding_s=30, nb_steps=50,
)
CALIB_BATCH = 500
CALIB_WIDTHS = [1 + CALIB["embedding_s"], *CALIB["hidden_derivative"], 1]
CALIB_EPOCHS = 5  # the short gate at full width on full data
# The UCI driver's flow on BSDS300 (examples/train_uci.py's defaults, D = 63),
# batch 500: 31,500 folded rows through the calibration widths, so the pack-2
# pair. Rows: the synthetic stand-in at the real dataset's size
# (-synthetic_rows -1). Randomized steps pad to 101 nodes; the validity
# report takes 2,000 valid rows (126,000 folded) on nodes padded to 401.
UCI = dict(CALIB, nb_in=uci.UCI_DIMS["bsds300"])
UCI_BATCH = 500
UCI_WIDTHS = CALIB_WIDTHS
UCI_ARGV = "-data bsds300 -synthetic -synthetic_rows -1 -nb_steps 0".split()
UCI_EPOCHS, UCI_STEPS = 3, 40  # the driver's short run (-steps_per_epoch)
UCI_VALID_ROWS = 2000  # the validity report's slice (examples/train_uci.py:332)
# The Lipschitz run's bound, and the tolerance on each projected layer's
# exact spectral norm. Power iteration (10 steps from a random start, the
# reference's rule) approaches sigma from below, so a layer divided by
# sigma_est / L ends at L * sigma / sigma_est: on 2,000 random matrices of
# the integrand's shapes (CPU) sigma / sigma_est reached 1.18, and 1.11
# after 200 steps of perturbation and projection.
LIP_L = 1.5
LIP_TOL = 0.25
# The toy flow at the verify widths of examples/train_toy.py (the repo's
# verify command without its -sample). Its integrand is at most 32 wide, so
# it runs on the pack-4 kernel pair.
TOY = dict(nb_flow=1, nb_in=2, hidden_derivative=(32, 32), hidden_embedding=(64, 64),
           embedding_s=10, nb_steps=16)
TOY_BATCH = 256
TOY_WIDTHS = [1 + TOY["embedding_s"], *TOY["hidden_derivative"], 1]
TOY_ARGV = "-nb_epoch 6 -nb_steps 16 -b_size 256 -hidden_embedding 64 64 -hidden_derivative 32 32"
# Test NLL at epochs 0 and 5 of the JAX package's driver (examples/train_toy.py)
# at TOY_ARGV, run on a CPU on the XLA route: a quality yardstick, not the port's.
JAX_CPU_TOY_NLL = {"8gaussians": (5.3267, 4.3366), "conditionnal8gaussians": (5.2626, 4.0331)}
# Inversion (phase sample): the reference's bisection, 10 rounds of 10
# candidates, and Jacobi-Newton at 30 iterations, with the round-trip floors
# PARITY_RUNS.md §6 measured on the JAX package at the UCI configuration
# (VERDICT.md:243-247): max|invert(forward(x)) - x| at most 3e-3 and 2e-4 on
# x = 1.5 N(0, 1) clipped to +-6. The same limits hold z-space round trips
# (that section's z-space errors: 7.2e-4 and 5.5e-4 bisection, 2.5e-5 and
# 8.7e-5 Newton, UCI and MNIST) and the kernel route against the plain one:
# each lies within its limit of the true x, and the final bracket, 2 x 50 /
# 9^10 = 2.9e-8, adds nothing, so a larger gap means a route left its floor.
SAMPLE_ITERS = {"bisection": 10, "newton": 30}
NB_CANDIDATES = 10
ROUND_TRIP = {"bisection": 3e-3, "newton": 2e-4}
# MNIST bisection is 784 x 10 launches a block, 6 to 8 s a call on either
# route: the phase runs it once at full depth on the kernel route, and its
# three calls on each route on one block of the five (the cut; PERF.md §4)
MNIST_BISECT_BLOCKS = 1
TOY_SAMPLES = 128  # the verify command's -sample 128
# What may stay allocated after an inversion beyond its result: the MNIST
# flow's gradients would be 540 MB
MEM_SLACK = 1 << 20
# The __graft_entry__.py flagship (:20-31): D = 6, 2 blocks, batch 32 (192 rows).
FLAGSHIP = dict(nb_flow=2, nb_in=6, hidden_derivative=(32, 32), hidden_embedding=(64, 64),
                embedding_s=8, nb_steps=20)
FLAGSHIP_BATCH = 32
FLAGSHIP_WIDTHS = [1 + FLAGSHIP["embedding_s"], *FLAGSHIP["hidden_derivative"], 1]
B2048 = 2048  # scripts/pack4_ab.py's larger toy batch (e = 8): 4,096 folded rows
# The streamed pair (csrc/integrand_wide.cu) takes what the staged pairs
# refuse. Its timing block: the calibration block's rows and nodes (R = 3,000,
# K = 51) through a 256-wide, 4-hidden-layer integrand, two row chunks.
WIDE_WIDTHS = [31, 256, 256, 256, 256, 1]
# A flow whose integrand no staged pair takes: the calibration flow's
# dimensions and embedding, one block, one 129-wide hidden layer; a batch of
# standard normal rows from a seed. Its training step is the streamed pair's
# main path.
WIDE_FLOW = dict(nb_flow=1, nb_in=6, hidden_derivative=(129,), hidden_embedding=(64, 64),
                 embedding_s=30, nb_steps=50)
WIDE_BATCH = 500
# The streamed pair's main path at full width: examples/train_uci.py's
# defaults (the calibration flow's) with -hidden_derivative 256 256 256 256,
# the timing block's integrand, batch 500; standard normal rows from a seed.
WIDE_TRAIN_FLOW = dict(CALIB, hidden_derivative=(256, 256, 256, 256))
# The monotonic regressor of examples/train_monotonic.py at its default
# flags: MonotonicNN(3, (100, 100, 100)), batch 512, K = 51, ReLU hidden
# layers; its integrand 3-100-100-100-1 runs on the unpacked pair. The
# driver runs at the verify command. MONO_CASES: the model at the driver's
# widths, at widths the pack-2 and pack-4 pairs take, and at in_d = 1 (h
# with no column: the model gives W1 and h a zero column), with the
# forward and backward kernel each must launch once a training step.
MONO_IN, MONO_HIDDEN, MONO_BATCH, MONO_STEPS = 3, (100, 100, 100), 512, 50
MONO_WIDTHS = [MONO_IN, *MONO_HIDDEN, 1]
MONO_ARGV = "-nb_epoch 60 -nb_steps 30 -b_size 256"
MONO_CASES = {
    "driver_widths": (MONO_IN, MONO_HIDDEN, "integrand_fwd", "integrand_bwd"),
    "pack2_3_64_64_1": (MONO_IN, (64, 64), "integrand_fwd_p2", "integrand_bwd_p2"),
    "pack4_3_32_32_1": (MONO_IN, (32, 32), "integrand_fwd_p4", "integrand_bwd_p4"),
    "in_d_1": (1, MONO_HIDDEN, "integrand_fwd", "integrand_bwd"),
}
# The class-conditional MNIST driver, one short epoch on the uniform
# stand-in (1,000 train, 200 valid and 200 test rows), then 10 images.
COND_ARGV = ("-conditionnal -synthetic -nb_epoch 1 -steps_per_epoch 3 -gen 10 -device cuda")
ACCUM_STEPS = 4  # make_accum_train_step's microbatches at the MNIST batch
NONE_LAUNCHED = {k: 0 for k in ik.LAUNCHES}
UNPACKED = {"pack2": False, "pack4": False}  # the unpacked pair at any width
# The VAE stack of examples/train_vae.py at the driver's defaults: MMAVAE
# with z 64, 4 flows, the encoder's 320-wide context, MADE [512, 512],
# embedding 30 and the integrand 31-100-50-50-50-1 (the unpacked pair),
# batch 100 of the binary stand-in: R = 6,400 integrand rows a block. The
# class default integrand (50, 50, 50, 50) takes the pack-2 pair. An IWAE
# call at the driver's -iwae_minibatch 500 evaluates 8 datapoints x 500
# particles: R = 256,000 rows at K = 101. The stand-ins' optima: fair
# independent bits cost 784 ln 2 nats a row, uniform 256-level subpixels
# 8 bits a dimension; no model scores better in expectation.
VAE_KW = dict(z_size=64, num_flows=4, made_h_size=320, hidden_embedding=(512, 512),
              embedding_size=30)
VAE_HIDDEN = (100, 50, 50, 50)  # -hidden_derivative's default
VAE_P2_HIDDEN = (50, 50, 50, 50)  # MMAVAE's class default
VAE_BATCH = 100
VAE_WIDTHS = [1 + VAE_KW["embedding_size"], *VAE_HIDDEN, 1]
VAE_P2_WIDTHS = [1 + VAE_KW["embedding_size"], *VAE_P2_HIDDEN, 1]
VAE_ROWS = VAE_BATCH * VAE_KW["z_size"]
IWAE_ROWS = 8 * 500 * VAE_KW["z_size"]
VAE_RANDOM_STEPS = 60  # one draw of -steps 0's 2 * U{10, 49}, padded to 100
VAE_FAMILY_KW = {"planar": {}, "orthogonal": {"num_ortho_vecs": 32},
                 "householder": {"num_householder": 8}, "triangular": {},
                 "iaf": {"made_h_size": 320}}
LOGDET_TOL = dict(rtol=1e-6, atol=1e-6)  # float64 autodiff against the flow's own log-det
BITS_NATS = 784 * np.log(2.0)  # the binary stand-in's optimum, nats a row
VAE_NLL_SLACK = 2.0
FREY_BPD_SLACK = 0.05
VAE_IWAE_ARGV = "-iwae_samples 1000 -iwae_minibatch 500 -iwae_test_points 8".split()
VAE_DRIVER_ARGV = ["-flow", "MMAF", "-synthetic", "-nb_epoch", "2", *VAE_IWAE_ARGV]
FREY_DRIVER_ARGV = ["-dataset", "freyfaces", "-flow", "MMAF", "-synthetic", "-nb_epoch", "1",
                    *VAE_IWAE_ARGV]


# Forward kernel against its plain version, both float32 with IEEE FMA on
# the card: they differ only in the order of sums (the kernel's
# k-sequential FMA chain and in-order node sum against cuBLAS blocking and
# torch.sum), a few ulp per layer, so about 1e-6 relative; atol covers z
# near 0, where |z| ~ |x|.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# Backward kernel against its plain version run in float64 on the same
# inputs, per output tensor, in max norm. The float32 plain version is no
# sharper a reference than the kernel: at the MNIST block's largest |x|
# (logits up to about 12) the node sums and dh cancel large terms, and its
# own error against float64 reaches 1e-5 of dx and several 1e-6 of dW (a
# CPU study of the two at MNIST widths). So each kernel output may be off
# float64 by the larger of a floor and BWD_PLAIN_FACTOR times the float32
# plain version's own error. The floor: 1e-5 of the output's largest value
# for the per-row outputs (dx, dh, S: sums of 51 nodes x up to 100
# features), 1e-4 for dW and db (an entry sums up to R*K = 4.0e6 terms).
# The factor 8: the kernel sums each block's partials in sequence, the
# plain version in pairwise reductions; in the CPU study the kernel's db
# error was up to 5x the plain version's, its other errors below it.
BWD_ROW_SCALE = 1e-5
BWD_PARAM_SCALE = 1e-4
BWD_PLAIN_FACTOR = 8.0
# LeakyReLU kinks, for the pack-2 backward's cases. Where a hidden
# pre-activation of some (row, node) lies within float32 rounding of 0, the
# kernel's float32 sums may land on the other side of 0 than the float64
# ones, and the derivative of that item's term then differs by (1 - slope)
# of it: both are derivatives of the function on one side of the kink.
# Phase bwd_p2 failed on the card at x < 0 (1,000 rows) for this alone: the
# kernel's dW0 error against float64 was 1.06 of the hold limit, the
# float32 plain version's 0.003 of it. So phase bwd_p2 holds the kernel
# against the float64 backward taken on the kernel's own sides of 0
# (kernel_branches: its float32 forward, FMA by FMA in its order), by the
# hold rule, with no row or item left out; and reports how many items its
# float32 sums put on the other side of 0, and its error against float64's
# own sides, unchecked.
# Whole flow, kernel path against the plain quadrature path: five blocks in
# sequence, each block's integral error feeding the next block's MADE and
# integrand, and ll summing 784 x 5 per-dimension terms.
SLICE_TOL = dict(rtol=1e-4, atol=1e-3)
# Training gradients, kernel route against the Leibniz route. They differ
# by design: the kernel route differentiates the 51-node sum (x's node path
# included), the Leibniz route takes f(x) for dz/dx and reaches the
# parameters through that endpoint term, so every gradient upstream of x
# carries the quadrature's error, about 1e-4 relative at 51 nodes. Held
# per tensor to 1e-2 of its largest entry.
TRAIN_GRAD_GAP = 1e-2
# The forward kernel's device time at the MNIST block that its redesign was
# to reach, in ms: printed beside the reading in the timing line, never a
# check (a time limit would fail later runs on noise).
FWD_ACCEPT_MS = 4.8

# float32 peak outside the tensor cores, by SKU (NVIDIA data sheets).
FP32_PEAK = [("H100 PCIe", 51.2e12), ("H100 NVL", 60.0e12), ("H100", 66.9e12), ("H200", 66.9e12)]
HBM_BYTES_PER_S = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12), ("H200", 4.8e12)]


def report(phase: str, **kv) -> None:
    elapsed = time.perf_counter() - T0
    print(json.dumps({"phase": phase, "s": round(elapsed, 3), **kv}), flush=True)
    if elapsed > BUDGET_S:
        raise RuntimeError(f"chip_smoke: past its {BUDGET_S} s budget after phase {phase}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sku_rate(table, name: str) -> float:
    for key, rate in table:
        if key in name:
            return rate
    raise RuntimeError(f"no published rate for card {name!r}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> dict:
    """Max abs error, max relative error (where |want| > 1e-3), and the
    largest share of the tolerance used; raises past the tolerance."""
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got.double() - want.double()).abs()
    ref = want.double().abs()
    big = ref > 1e-3
    used = float((err / (tol["atol"] + tol["rtol"] * ref)).max())
    out = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err[big] / ref[big]).max()) if bool(big.any()) else 0.0,
        "tol_used": used,
    }
    check(used <= 1.0, f"{what}: outside {tol}: {out}")
    return out


def worst(errs: dict) -> dict:
    """The largest of each error over a dict of ``compare`` or ``hold`` results."""
    return {k: max(e[k] for e in errs.values()) for k in next(iter(errs.values()))}


def median_ms(fn, n: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def launched_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a copy of ``ik.LAUNCHES``)."""
    return {k: v - before[k] for k, v in ik.LAUNCHES.items() if v != before[k]}


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda]


def device_ms(fn, kernel: str, n: int = 20) -> float:
    """Device time per call of ``kernel``'s CUDA launches (its sweep and, for
    a backward, its reduction), from a torch.profiler trace of ``n`` calls
    after 3 warm-ups: the kernel alone, without the wrapper's host work.
    Every launch must be in the trace, n of the sweep (and n of the
    reduction): a trace that lost one is taken again, at most three times.
    Traces have lost one launch of a window (once among five MNIST backward
    sweeps before; the pack-2 forward at the calibration block in three
    traces in a row after phase uci's traces), so a fill kernel of another
    name opens and closes each window; its count is in the failure's
    message."""
    pattern = re.compile(rf"(?<![A-Za-z_]){kernel}_(kernel|reduce)(?![a-z0-9_])")
    for _ in range(3):
        fn()
    fill = torch.zeros(1, device=torch.cuda.current_device())
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fill.fill_(1.0)
            for _ in range(n):
                fn()
            fill.fill_(2.0)
            torch.cuda.synchronize()
        events = _device_events(prof)
        hits = [e for e in events if pattern.search(e.key)]
        counts = {e.key: e.count for e in hits}
        if any("_kernel" in k for k in counts) and all(c == n for c in counts.values()):
            return sum(e.device_time_total for e in hits) / n / 1e3
        seen.append({"kernel": counts, "fill": sum(e.count for e in events if "fill" in e.key)})
    raise AssertionError(f"profiler: launches of {kernel} seen in {n} calls: {seen}")


# The launch floor's kernels: they do nothing, and are launched at another
# kernel's grid, block and dynamic shared memory, so that a profiler trace
# gives the least device time any kernel of that launch shape takes on this
# card. A yardstick for the integrand kernels at small shapes, where the
# operations bound lies below any launch; built apart from the port's
# library, which holds only the integrand kernels.
LAUNCH_FLOOR_CU = r"""
#include <cuda_runtime.h>

__global__ void empty_kernel() { extern __shared__ float sm[]; }

__global__ void empty_reduce() {}

// empty_kernel<<<grid, threads, smem>>> on `stream`, then, where grid2 > 0,
// empty_reduce<<<grid2, threads2>>> (a backward's sweep and its reduction);
// cudaGetLastError() after them.
extern "C" int umnn_launch_floor(int grid, int threads, int smem, int grid2, int threads2,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(empty_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaStream_t st = (cudaStream_t)stream;
  empty_kernel<<<grid, threads, (size_t)smem, st>>>();
  if (grid2 > 0) empty_reduce<<<grid2, threads2, 0, st>>>();
  return cudaGetLastError();
}
"""


@functools.cache
def launch_floor_library():
    """LAUNCH_FLOOR_CU built with the port's nvcc flags into its own library
    under the build directory, loaded."""
    import ctypes

    out = _build.BUILD_DIR / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    (out / "launch_floor.cu").write_text(LAUNCH_FLOOR_CU)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out / "liblaunch_floor.so"), str(out / "launch_floor.cu")],
                   capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(out / "liblaunch_floor.so"))
    lib.umnn_launch_floor.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.umnn_launch_floor.restype = ctypes.c_int
    return lib


def launch_floor_ms(grid: int, threads: int, smem: int, grid2: int = 0, threads2: int = 0,
                    n: int = 20) -> float:
    """Device time per call of the launch floor's kernels at a kernel's grid,
    block and shared memory (and, with ``grid2``, a second launch at a
    reduction's grid and block), from a profiler trace."""
    lib = launch_floor_library()

    def call():
        rc = lib.umnn_launch_floor(grid, threads, smem, grid2, threads2,
                                   torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"umnn_launch_floor: error {rc}")

    return device_ms(call, "empty", n)


# The steps of a wrapper call timed by host_breakdown: where each is, what it
# is called there, and its label. A step the wrapper does not have is left
# out. Each step's time excludes the steps timed inside it: "launcher" is
# the launchers' own Python, "autograd_function" the autograd Function's
# apply around the forward launcher, "device_context" the entry and exit of
# the device and stream context the launch runs in.
HOST_STEPS = (
    ("ik", "_on_card", "on_card"),
    ("ik", "_route", "route"),
    ("ik", "_check", "check"),
    ("function", "apply", "autograd_function"),
    ("ik", "_launch_fwd", "launcher"),
    ("ik", "_launch_bwd", "launcher"),
    ("ik", "_packed_params", "repack"),
    ("ik", "_layer_pointers", "layer_pointers"),
    ("ik", "_slots", "launch_config"),
    ("ik", "_on", "device_context"),
    ("torch", "empty", "allocations"),
    ("torch", "zeros", "allocations"),
    ("lib", "umnn_integrand_{kernel}_grid", "grid_query"),
    ("lib", "umnn_integrand_{kernel}", "ctypes_launch"),
)


def host_breakdown(call, kernel: str, n: int = 200) -> dict:
    """Host time per call of ``call`` (a wrapper call that launches
    ``kernel``), in microseconds by time.perf_counter: the whole call
    untouched, then with each step of HOST_STEPS timed (``other``: the rest
    of the call), and the host cost of the two CUDA events that time a
    call (made and recorded)."""
    lib = _build.load_library()
    owners = {"ik": ik, "torch": torch, "lib": lib, "function": ik._FusedIntegral}
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        call()
    untouched = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    spent, inner, saved = {}, [0.0], []  # inner: time of the timed steps inside the open ones

    def start():
        inner.append(0.0)
        return time.perf_counter()

    def stop(label, t0):
        elapsed = time.perf_counter() - t0
        spent[label] = spent.get(label, 0.0) + elapsed - inner.pop()
        inner[-1] += elapsed

    def timed(fn, label):
        def wrapper(*args, **kw):
            t0 = start()
            try:
                return fn(*args, **kw)
            finally:
                stop(label, t0)
        return wrapper

    class TimedContext:
        """A context manager of ``fn``, its entry and exit timed."""

        def __init__(self, fn, label, args, kw):
            self.fn, self.label, self.args, self.kw = fn, label, args, kw

        def __enter__(self):
            t0 = start()
            try:
                self.cm = self.fn(*self.args, **self.kw)
                return self.cm.__enter__()
            finally:
                stop(self.label, t0)

        def __exit__(self, *exc):
            t0 = start()
            try:
                return self.cm.__exit__(*exc)
            finally:
                stop(self.label, t0)

    def timed_context(fn, label):
        return lambda *args, **kw: TimedContext(fn, label, args, kw)

    for owner, attr, label in HOST_STEPS:
        obj, attr = owners[owner], attr.format(kernel=kernel)
        if hasattr(obj, attr):
            saved.append((obj, attr, getattr(obj, attr), attr in vars(obj)))
            wrap = timed_context if attr == "_on" else timed
            setattr(obj, attr, wrap(getattr(obj, attr), label))
    try:
        call()
        torch.cuda.synchronize()
        spent.clear()
        t = time.perf_counter()
        for _ in range(n):
            call()
        whole = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
    finally:
        for obj, attr, fn, own in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)  # inherited (the Function's apply): its own again
    steps = {label: s / n * 1e6 for label, s in spent.items()}
    t = time.perf_counter()
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        b.record()
    events = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return {"call_us": untouched, "call_us_steps_timed": whole, **steps,
            "other_us": whole - sum(steps.values()), "event_pair_us": events}


def step_profile(step, *batch, n: int = 5) -> dict:
    """Device time per training step ``step(*batch)``, over ``n`` steps
    after 2 warm-ups: all kernels together, the integrand kernels by name,
    and the number of kernel launches."""
    for _ in range(2):
        step(*batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(*batch)
        torch.cuda.synchronize()
    events = _device_events(prof)
    out = {"device_busy_ms": sum(e.device_time_total for e in events) / n / 1e3,
           "device_launches": sum(e.count for e in events) / n}
    for kernel in ik.LAUNCHES:
        pattern = re.compile(rf"(?<![A-Za-z_]){kernel}_(kernel|reduce)(?![a-z0-9_])")
        out[f"{kernel}_ms"] = sum(
            e.device_time_total for e in events if pattern.search(e.key)) / n / 1e3
    return out


def integrand_inputs(gen: torch.Generator, widths: list, rows: int, dev) -> tuple:
    """Integrand weights at ``widths`` and an embedding for ``rows`` rows."""
    layers = [torch_linear_init(gen, a, b, dev) for a, b in zip(widths[:-1], widths[1:])]
    ws = [l.weight.detach() for l in layers]
    bs = [l.bias.detach() for l in layers]
    h = torch.randn(rows, widths[0] - 1, generator=gen).to(dev)
    return ws, bs, h


def kernel_flops(widths: list, R: int, K: int) -> int:
    """Useful float32 operations of one forward sweep of an integrand of
    ``widths``: the first layer's h part once per row, its x part (rank 1)
    and every later layer once per (row, node)."""
    per_pair = 2 * (widths[1] + sum(a * b for a, b in zip(widths[1:-1], widths[2:])))
    return R * K * per_pair + R * 2 * (widths[0] - 1) * widths[1]


def kernel_bytes(widths: list, R: int, K: int) -> int:
    """x, h and the weights read once, z written once, float32."""
    weights = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    return 4 * (R * widths[0] + R + weights + 2 * K)


def bwd_kernel_flops(widths: list, R: int, K: int) -> int:
    """Useful float32 operations of one backward sweep. Per (row, node): the
    forward again; for each hidden layer after the first, its dW product
    and the dz product into the layer below (2 x 2 x din x dout); the output
    layer's dW row and rank-1 dz (4 x its width); in layer 1 the x column
    of dW1, x's node path and the node sum of dz1 (5 x H1). Per row: the
    first layer's h part, dW1's h part and dh (3 x 2 x e x H1)."""
    e, H1, dl = widths[0] - 1, widths[1], widths[-2]
    hidden = sum(a * b for a, b in zip(widths[1:-2], widths[2:-1]))
    per_pair = kernel_flops(widths, 1, 1) - 2 * e * H1 + 4 * hidden + 4 * dl + 5 * H1
    return R * K * per_pair + R * 3 * 2 * e * H1


def bwd_kernel_bytes(widths: list, R: int, K: int) -> int:
    """x, h, g and the weights read once; dx, dh, S and dW written once."""
    weights = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    return 4 * (2 * R * (widths[0] + 1) + 2 * weights + 2 * K)


def bound(flops: int, nbytes: int, name: str) -> dict:
    ops_ms = flops / sku_rate(FP32_PEAK, name) * 1e3
    bytes_ms = nbytes / sku_rate(HBM_BYTES_PER_S, name) * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_flop": flops, "bound_bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def bwd_through_autograd(ws, bs, x, h, nodes, ccw, g, slope, pack2=None, pack4=None):
    """dws, dbs, dx, dh of ``sum(g * fused_cc_integral(...))``: the forward
    kernel, then the backward kernel through the autograd Function."""
    leaves = [t.detach().requires_grad_() for t in (*ws, *bs, x, h)]
    n = len(ws)
    z = ik.fused_cc_integral(leaves[:n], leaves[n : 2 * n], leaves[-2], leaves[-1], nodes, ccw,
                             neg_slope=slope, pack2=pack2, pack4=pack4)
    grads = torch.autograd.grad(z, leaves, g)
    return list(grads[:n]), list(grads[n : 2 * n]), grads[-2], grads[-1]


def hold(got, plain, want, scale: float, what: str, plain_want=None, enforce=True) -> dict:
    """One backward output of the kernel against float64 ``want``: its max
    error within max(scale * max|want|, BWD_PLAIN_FACTOR * the float32
    plain version's max error against ``plain_want``, by default ``want``)."""
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = float((got.double() - want).abs().max())
    ref = want if plain_want is None else plain_want
    plain_err = float((plain.double() - ref).abs().max())
    limit = max(scale * float(want.abs().max()), BWD_PLAIN_FACTOR * plain_err, 1e-30)
    out = {"max_abs_err": err, "plain_abs_err": plain_err, "tol_used": err / limit}
    check(err <= limit or not enforce, f"{what}: error {out} past {limit}")
    return out


def compare_bwd(got, plain, want, what: str, plain_want=None, enforce=True) -> dict:
    """Errors of (dws, dbs, dx, dh[, S]) against a float64 reference, beside
    the float32 plain version's (against ``plain_want``, by default the
    same reference)."""
    pw = plain_want if plain_want is not None else want
    errs = {}
    for kind, scale, i in (("dW", BWD_PARAM_SCALE, 0), ("db", BWD_PARAM_SCALE, 1)):
        for l, (a, b, c, d) in enumerate(zip(got[i], plain[i], want[i], pw[i])):
            errs[f"{kind}{l}"] = hold(a, b, c, scale, f"{what} {kind}{l}", d, enforce)
    for name, a, b, c, d in zip(("dx", "dh", "S"), got[2:], plain[2:], want[2:], pw[2:]):
        errs[name] = hold(a, b, c, BWD_ROW_SCALE, f"{what} {name}", d, enforce)
    return errs


def bwd_plain64(ws, bs, x, h, nodes, ccw, g, slope, pos=None):
    """The plain backward in float64 on the same (float32) inputs; with
    ``pos`` (kernel_branches), each hidden LeakyReLU on the side of 0 given
    there, not on its float64 pre-activation's."""
    d = [t.double() for t in (*ws, *bs, x, h, nodes, ccw, g)]
    n = len(ws)
    if pos is None:
        return ik.fused_cc_integral_bwd_plain(d[:n], d[n : 2 * n], *d[2 * n :], slope)
    nodes64, ccw64, g64 = d[2 * n + 2 :]
    with torch.enable_grad():
        leaves = [t.requires_grad_() for t in d[: 2 * n + 2]]
        lws, lbs, lx, lh = leaves[:n], leaves[n : 2 * n], leaves[-2], leaves[-1]
        xs = lx.reshape(-1)[:, None] * (nodes64.reshape(-1) + 1.0) * 0.5  # [R, K]
        z = (lh @ lws[0][:, 1:].T + lbs[0])[:, None, :] + xs[..., None] * lws[0][:, 0]
        for side, w, b in zip(pos, lws[1:], lbs[1:]):
            z = torch.where(side, z, slope * z) @ w.T + b
        S = ((torch.nn.functional.elu(z[..., 0]) + 1.0) * ccw64.reshape(-1)).sum(-1)
        out = (S * lx.reshape(-1) * 0.5).reshape(lx.shape)
        grads = torch.autograd.grad(out, leaves, g64)
    return (list(grads[:n]), list(grads[n : 2 * n]), grads[-2], grads[-1],
            S.detach().reshape(lx.shape))


def kernel_branches(ws, bs, x, h, nodes, slope) -> tuple:
    """The side of 0 of every hidden pre-activation, ``[R, K, width]`` per
    hidden layer (True: > 0), as the float32 forward of integrand_bwd_p2.cu
    and integrand_bwd_p4.cu puts it: layer 1's h part an in-order FMA chain plus the bias, its node term
    one FMA, every later layer an in-order FMA chain plus the bias; each FMA
    taken in float64 and rounded once to float32. Also the count of items
    on the other side than the float64 pre-activation's, and of the rows
    that hold one."""
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    R, e = h.shape
    ph = torch.zeros(R, ws[0].shape[0], device=h.device)
    for k in range(e):
        ph = fma(h[:, k, None], ws[0][:, 1 + k], ph)
    ph = ph + bs[0]
    xw = x.reshape(-1)[:, None] * ws[0][:, 0]
    z = fma(((nodes.reshape(-1) + 1.0) * 0.5)[None, :, None], xw[:, None, :], ph[:, None, :])
    pos = [z > 0]
    for w, b in zip(ws[1:-1], bs[1:-1]):
        a = torch.where(pos[-1], z, slope * z)
        acc = torch.zeros(*a.shape[:2], w.shape[0], device=a.device)
        for k in range(w.shape[1]):
            acc = fma(a[..., k, None], w[:, k], acc)
        z = acc + b
        pos.append(z > 0)
    w64, b64 = [w.double() for w in ws], [b.double() for b in bs]
    xs = x.double().reshape(-1)[:, None] * (nodes.double().reshape(-1) + 1.0) * 0.5
    z = (h.double() @ w64[0][:, 1:].T + b64[0])[:, None, :] + xs[..., None] * w64[0][:, 0]
    pos64 = [z > 0]
    for w, b in zip(w64[1:-1], b64[1:-1]):
        z = torch.where(pos64[-1], z, slope * z) @ w.T + b
        pos64.append(z > 0)
    flipped = [p != q for p, q in zip(pos, pos64)]
    rows = torch.stack([f.flatten(1).any(1) for f in flipped]).any(0)
    return pos, sum(int(f.sum()) for f in flipped), int(rows.sum())


def phase_kernel(gen, rows, dev, nodes, ccw):
    K = nodes.numel()
    x_main = rows.reshape(-1).contiguous()  # one MNIST block: R = 78,400
    ws, bs, h_main = integrand_inputs(gen, WIDTHS, x_main.numel(), dev)
    mnist = (ws, bs, nodes, ccw)
    # other integrand shapes the kernel takes: one hidden layer, a 128-wide
    # layer, 21 nodes
    n21 = cc_tensors(20, dev)
    x_other = x_main[:5000]
    ws1, bs1, h1 = integrand_inputs(gen, [31, 100, 1], x_other.numel(), dev)
    ws2, bs2, h2 = integrand_inputs(gen, [31, 128, 64, 1], x_other.numel(), dev)
    # the edges of the persistent design: the widest sets (a 256- and a
    # 64-pair tile), widths that divide none of its column groups, K = 101
    # with padded nodes, K = 1 and 2 (the longest row tiles), fewer row tiles
    # than blocks of the grid
    edge = {w: integrand_inputs(gen, list(w), x_other.numel(), dev)
            for w in ((31, 128, 128, 1), (31, 128, 128, 76, 1), (31, 37, 13, 1))}
    p101 = padded_cc_quadrature(50, 100, dev)
    n1 = (torch.tensor([0.3], device=dev), torch.tensor([2.0], device=dev))
    cases = {
        "mnist_block": (mnist, x_main, h_main, 0.01),
        "x_zero": (mnist, torch.zeros(1000, device=dev), h_main[:1000], 0.01),
        "x_negative": (mnist, -x_main[:1000].abs() - 0.1, h_main[:1000], 0.01),
        "ragged_77_rows": (mnist, x_main[:77], h_main[:77], 0.01),
        "relu_neg_slope_0": (mnist, x_main[:4099], h_main[:4099], 0.0),
        "widths_31_100_1": ((ws1, bs1, nodes, ccw), x_other, h1, 0.01),
        "widths_31_128_64_1_21_nodes": ((ws2, bs2, *n21), x_other, h2, 0.01),
        **{"widths_" + "_".join(map(str, w)): ((ews, ebs, nodes, ccw), x_other, eh, 0.01)
           for w, (ews, ebs, eh) in edge.items()},
        "padded_101_nodes": ((ws, bs, *p101), x_main[:3000], h_main[:3000], 0.01),
        "nodes_1": ((ws, bs, *n1), x_main[:2000], h_main[:2000], 0.01),
        "nodes_2": ((ws, bs, *cc_tensors(1, dev)), x_main[:2000], h_main[:2000], 0.01),
        "rows_1003_below_the_grid": (mnist, x_main[:1003], h_main[:1003], 0.01),
    }
    errs = {}
    with torch.inference_mode():
        for case, ((cws, cbs, cn, cw), x, h, slope) in cases.items():
            before = dict(ik.LAUNCHES)
            got = ik.fused_cc_integral(cws, cbs, x, h, cn, cw, neg_slope=slope, **UNPACKED)
            want = ik.fused_cc_integral_plain(cws, cbs, x, h, cn, cw, neg_slope=slope)
            torch.cuda.synchronize()
            check(launched_since(before) == {"integrand_fwd": 1},
                  f"kernel {case}: launched {launched_since(before)}")
            errs[case] = compare(got, want, KERNEL_TOL, f"kernel {case}")
            if case == "x_zero":
                check(bool((got == 0).all()), "kernel: x=0 must give z=0")
            if case == "x_negative":
                check(bool((got < 0).all()), "kernel: x<0 must give z<0")
        again = ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw)
        first = ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw)
        check(bool(torch.equal(again, first)), "kernel: two runs must agree bit for bit")
        # what the staged pair refuses goes to the streamed pair, under
        # "kernel" and "auto" alike (phase wide holds it against the plain
        # versions); an integrand no pair takes raises and launches nothing
        ws3, bs3, h3 = integrand_inputs(gen, [31, 129, 1], 64, dev)
        small = UMNNMAFFlow(nb_flow=1, nb_in=4, hidden_derivative=(8,), hidden_embedding=(8,),
                            embedding_s=2, act_func="Sigmoid", backend="auto", seed=0)
        wide = {b: UMNNMAFFlow(nb_flow=1, nb_in=4, hidden_derivative=(129,), hidden_embedding=(8,),
                               embedding_s=2, backend=b, seed=0)
                for b in ("kernel", "auto", "torch")}
        routed = {
            "hidden_width_129": lambda: ik.fused_cc_integral(ws3, bs3, x_main[:64], h3, nodes, ccw),
            "hidden_width_129_on_kernel": lambda: wide["kernel"].compute_ll(rows[:8, :4])[0],
            "hidden_width_129_on_auto": lambda: wide["auto"].compute_ll(rows[:8, :4])[0],
        }
        want_routed = {
            "hidden_width_129": ik.fused_cc_integral_plain(ws3, bs3, x_main[:64], h3, nodes, ccw),
            "hidden_width_129_on_kernel": wide["torch"].compute_ll(rows[:8, :4])[0],
        }
        want_routed["hidden_width_129_on_auto"] = want_routed["hidden_width_129_on_kernel"]
        routed_errs = {}
        for case, fn in routed.items():
            before = dict(ik.LAUNCHES)
            got = fn()
            torch.cuda.synchronize()
            check(launched_since(before) == {"integrand_fwd_wide": 1},
                  f"kernel {case}: launched {launched_since(before)}")
            tol = KERNEL_TOL if case == "hidden_width_129" else SLICE_TOL
            routed_errs[case] = compare(got, want_routed[case], tol, f"kernel {case}")
        launched = dict(ik.LAUNCHES)
        refused = {"not_elu_on_auto": lambda: small.compute_ll(rows[:2, :4])}
        for case, fn in refused.items():
            try:
                fn()
            except ValueError:
                continue
            raise AssertionError(f"kernel: {case} must raise, not compute")
        check(ik.LAUNCHES == launched, "kernel: a refused call must launch nothing")
    shape = {f"mnist_{k}_nodes": launch_shape("fwd", WIDTHS, k) for k in (K, p101[0].numel())}
    shape.update({f"widths_{'_'.join(map(str, w))}": launch_shape("fwd", list(w), K) for w in edge})
    report("kernel", rows=x_main.numel(), nodes=K, widths=WIDTHS, tol=KERNEL_TOL, cases=errs,
           to_the_streamed_pair=routed_errs, refused=list(refused), launch_shape=shape)
    return (ws, bs, x_main, h_main), errs


# What each kernel's occupancy helper reports past its first four values.
LAUNCH_SHAPE_KEYS = {
    "fwd": ("pairs_per_tile", "rows_per_row_tile"),
    "bwd": ("dw_sums_on_chip_from_layer",),
    "bwd_p2": ("pairs_per_tile", "rows_per_row_tile"),
    "fwd_p2": ("pairs_per_tile", "rows_per_row_tile", "blocks"),
    "fwd_p4": ("items_per_tile", "rows_per_row_tile", "blocks"),
    "bwd_p4": ("items_per_tile", "rows_per_row_tile", "blocks", "slices"),
}


def launch_shape(kernel: str, widths: list, K: int, rows: int | None = None) -> dict:
    """A staged kernel's launch shape at these widths and node count, from
    its own C helper ``umnn_integrand_{kernel}_occupancy``: threads per
    block, shared bytes, resident blocks and warps per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
    then LAUNCH_SHAPE_KEYS[kernel]. ``rows``: the row count, for a helper
    whose row tile depends on it (its first argument)."""
    import ctypes

    keys = LAUNCH_SHAPE_KEYS[kernel]
    fn = getattr(_build.load_library(), f"umnn_integrand_{kernel}_occupancy")
    head = () if rows is None else (rows,)
    fn.argtypes = [ctypes.c_int] * (1 + len(head)) + [ctypes.c_void_p, ctypes.c_int,
                                                      ctypes.c_void_p]
    fn.restype = ctypes.c_int
    c_widths = (ctypes.c_int * len(widths))(*widths)
    out = (ctypes.c_int * (4 + len(keys)))()
    rc = fn(*head, K, ctypes.cast(c_widths, ctypes.c_void_p), len(widths) - 1,
            ctypes.cast(out, ctypes.c_void_p))
    check(rc == 0, f"umnn_integrand_{kernel}_occupancy {widths} K={K}: error {rc}")
    threads, smem, per_sm, regs, *rest = list(out)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": per_sm,
            "warps_per_sm": per_sm * threads // 32, "registers": regs, **dict(zip(keys, rest))}


def phase_bwd(gen, dev, nodes, ccw, block):
    ws, bs, x_main, h_main = block
    R = x_main.numel()
    g_main = torch.randn(R, generator=gen).to(dev)
    mnist = (ws, bs, nodes, ccw)
    p101 = padded_cc_quadrature(50, 100, dev)  # K = 101, randomized-steps training
    x_other, g_other = x_main[:5000], g_main[:5000]
    ws1, bs1, h1 = integrand_inputs(gen, [31, 100, 1], x_other.numel(), dev)
    ws2, bs2, h2 = integrand_inputs(gen, [31, 128, 64, 1], x_other.numel(), dev)
    # the register tiles' edges: widths that divide none of them, the widest
    # set taken before (every dW/db sum on chip but the 128 x 128 layer's),
    # a set with none on chip, and 1,003 rows (a ragged last row tile; the
    # last pair tile of a row tile is ragged at K = 51 and at K = 101)
    edge = {w: integrand_inputs(gen, list(w), x_other.numel(), dev) for w in (
        (31, 37, 53, 1), (31, 100, 51, 51, 1), (31, 128, 128, 1), (31, 128, 37, 1),
        (31, 128, 128, 76, 1))}
    edge_cases = {
        "widths_" + "_".join(map(str, w)): ((ews, ebs, nodes, ccw), x_other, eh, g_other, 0.01)
        for w, (ews, ebs, eh) in edge.items()
    }
    cases = {
        "mnist_block": (mnist, x_main, h_main, g_main, 0.01),
        "x_zero": (mnist, torch.zeros(1000, device=dev), h_main[:1000], g_main[:1000], 0.01),
        "x_negative": (mnist, -x_main[:1000].abs() - 0.1, h_main[:1000], g_main[:1000], 0.01),
        "ragged_77_rows": (mnist, x_main[:77], h_main[:77], g_main[:77], 0.01),
        "relu_neg_slope_0": (mnist, x_main[:4099], h_main[:4099], g_main[:4099], 0.0),
        "padded_101_nodes": ((ws, bs, *p101), x_main[:3000], h_main[:3000], g_main[:3000], 0.01),
        "widths_31_100_1": ((ws1, bs1, nodes, ccw), x_other, h1, g_other, 0.01),
        "widths_31_128_64_1": ((ws2, bs2, nodes, ccw), x_other, h2, g_other, 0.01),
        **edge_cases,
        "ragged_1003_rows": (mnist, x_main[:1003], h_main[:1003], g_main[:1003], 0.01),
        # a pair tile over more than 3 rows: the collapse's sums over runs
        "nodes_17": ((ws, bs, *cc_tensors(16, dev)), x_main[:2000], h_main[:2000], g_main[:2000],
                     0.01),
        "ragged_1003_rows_101_nodes": ((ws, bs, *p101), x_main[:1003], h_main[:1003],
                                       g_main[:1003], 0.01),
    }
    errs, auto_errs = {}, {}
    for case, ((cws, cbs, cn, cw), x, h, g, slope) in cases.items():
        want = bwd_plain64(cws, cbs, x, h, cn, cw, g, slope)
        plain = ik.fused_cc_integral_bwd_plain(cws, cbs, x, h, cn, cw, g, slope)
        got = ik.fused_cc_integral_bwd(cws, cbs, x, h, cn, cw, g, slope, **UNPACKED)
        torch.cuda.synchronize()
        errs[case] = worst(compare_bwd(got, plain, want, f"bwd {case}"))
        # the forward kernel, then the backward through the autograd Function
        auto = bwd_through_autograd(cws, cbs, x, h, cn, cw, g, slope, **UNPACKED)
        torch.cuda.synchronize()
        auto_errs[case] = worst(compare_bwd(auto, plain[:4], want[:4], f"bwd {case} via autograd"))
        if case == "x_zero":
            check(all(bool((d == 0).all()) for d in got[0]), "bwd: x=0 must give dW=0")
        del want, plain, got, auto
    # two runs agree bit for bit: no atomics, partial sums in a fixed order
    first = ik.fused_cc_integral_bwd(ws, bs, x_main, h_main, nodes, ccw, g_main)
    again = ik.fused_cc_integral_bwd(ws, bs, x_main, h_main, nodes, ccw, g_main)
    check(all(torch.equal(a, b) for a, b in zip(first[0] + first[1] + list(first[2:]),
                                                 again[0] + again[1] + list(again[2:]))),
          "bwd: two runs must agree bit for bit")
    # widths the staged backward refuses go to the streamed pair, also those
    # whose forward alone fits (eight 64-wide layers: 180 KB forward, 246 KB
    # backward): the backward, and the forward with it
    ws3, bs3, h3 = integrand_inputs(gen, [31, 129, 1], 64, dev)
    ws4, bs4, h4 = integrand_inputs(gen, [31] + [64] * 7 + [1], 64, dev)
    x64, g64 = x_main[:64], g_main[:64]
    routed = {
        "hidden_width_129": (lambda: ik.fused_cc_integral_bwd(ws3, bs3, x64, h3, nodes, ccw, g64),
                             {"integrand_bwd_wide": 1}),
        "bwd_smem_eight_64_layers": (
            lambda: bwd_through_autograd(ws4, bs4, x64, h4, nodes, ccw, g64, 0.01, **UNPACKED),
            {"integrand_fwd_wide": 1, "integrand_bwd_wide": 1}),
    }
    for case, (fn, want) in routed.items():
        before = dict(ik.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        check(launched_since(before) == want, f"bwd {case}: launched {launched_since(before)}")
        check(all(bool(torch.isfinite(t).all()) for t in out[0] + out[1] + list(out[2:])),
              f"bwd {case}: non-finite values")
    with torch.inference_mode():  # a forward alone too: a flow's values never change pair
        before = dict(ik.LAUNCHES)
        ik.fused_cc_integral(ws4, bs4, x64, h4, nodes, ccw, **UNPACKED)
        check(launched_since(before) == {"integrand_fwd_wide": 1},
              f"bwd: the forward alone launched {launched_since(before)}")
    shape = {f"mnist_{k}_nodes": launch_shape("bwd", WIDTHS, k)
             for k in (nodes.numel(), p101[0].numel())}
    shape.update({f"widths_{'_'.join(map(str, w))}": launch_shape("bwd", list(w), nodes.numel())
                  for w in ((31, 128, 128, 1), (31, 128, 128, 76, 1))})
    report("bwd", rows=R, nodes=nodes.numel(), widths=WIDTHS, launch_shape=shape,
           reference="plain version in float64",
           tol={"row_scale": BWD_ROW_SCALE, "param_scale": BWD_PARAM_SCALE,
                "plain_factor": BWD_PLAIN_FACTOR},
           cases=errs, cases_via_autograd=auto_errs, to_the_streamed_pair=list(routed))
    return g_main, {**errs, **{f"{k}_autograd": v for k, v in auto_errs.items()}}


def phase_slice(rows, floor_bpp):
    flow = UMNNMAFFlow(**MNIST, backend="auto", seed=0)
    plain = UMNNMAFFlow(**MNIST, backend="torch", seed=0)
    for a, b in zip(flow.state_dict().values(), plain.state_dict().values()):
        check(torch.equal(a, b), "slice: the two flows must share their seeded weights")
    with torch.inference_mode():
        for k in ik.LAUNCHES:
            ik.LAUNCHES[k] = 0
        flow.compute_ll(rows)
        torch.cuda.synchronize()
        launches = dict(ik.LAUNCHES)
        want = {**NONE_LAUNCHED, "integrand_fwd": MNIST["nb_flow"]}
        check(launches == want, f"slice: launches in one compute_ll {launches}, want {want}")
        bpp_k, ll_k, z_k = flow.compute_bpp(rows)
        bpp_p, ll_p, z_p = plain.compute_bpp(rows)
        torch.cuda.synchronize()
    check(ll_k.shape == (BATCH,) and z_k.shape == rows.shape, "slice: output shapes")
    slice_errs = {
        "bpp": compare(bpp_k, bpp_p, SLICE_TOL, "slice bpp"),
        "ll": compare(ll_k, ll_p, SLICE_TOL, "slice ll"),
        "z": compare(z_k, z_p, SLICE_TOL, "slice z"),
    }
    report("slice", batch=BATCH, launches_per_compute_ll=launches,
           mean_bpp_kernel=float(bpp_k.mean()), mean_bpp_plain=float(bpp_p.mean()),
           data_floor_bpp=floor_bpp, tol=SLICE_TOL, errors=slice_errs)
    return flow, plain


def trainer(flow, weight_decay=1e-2):
    optimizer = make_optimizer(flow.parameters(), "adam", lr=1e-3, weight_decay=weight_decay,
                               grad_clip=1.0)
    return make_train_step(lambda *batch: -flow.compute_ll(*batch)[0].mean(), optimizer)


def grad_gaps(model, plain, what: str) -> dict:
    """Every parameter gradient of ``model`` against ``plain``'s (the same
    seeded weights), within TRAIN_GRAD_GAP of its tensor's largest entry
    (in_d = 1: the free net's first weight has no entry)."""
    gaps = {}
    for (pname, a), b in zip(model.named_parameters(), plain.parameters()):
        if a.numel() == 0:
            continue
        check(a.grad is not None and bool(torch.isfinite(a.grad).all()), f"{what}: grad of {pname}")
        gaps[pname] = float((a.grad - b.grad).abs().max() / (b.grad.abs().max() + 1e-30))
    name = max(gaps, key=gaps.get)
    check(gaps[name] <= TRAIN_GRAD_GAP,
          f"{what}: gradient of {name} differs between routes by {gaps[name]}")
    return {"grad_gap_max": gaps[name], "grad_gap_param": name}


def route_gaps(flow, plain, what: str, *batch, **quad) -> tuple:
    """``-mean(compute_ll)`` and its gradients on the kernel route (``flow``)
    against the Leibniz route (``plain``, the same seeded weights): the loss
    within SLICE_TOL, every parameter gradient within TRAIN_GRAD_GAP of its
    tensor's largest entry. Returns the loss's errors and the largest gap.
    ``quad``: ``nodes=`` and ``weights=`` for compute_ll."""
    flow.zero_grad(set_to_none=True)
    plain.zero_grad(set_to_none=True)
    loss_k = -flow.compute_ll(*batch, **quad)[0].mean()
    loss_k.backward()
    loss_p = -plain.compute_ll(*batch, **quad)[0].mean()
    loss_p.backward()
    torch.cuda.synchronize()
    loss_err = compare(loss_k.detach(), loss_p.detach(), SLICE_TOL, f"{what} loss")
    return loss_err, grad_gaps(flow, plain, what)


def step_launches(step, *batch) -> dict:
    """The integrand kernels one training step launches, counts set to 0 first."""
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    step(*batch)
    torch.cuda.synchronize()
    return dict(ik.LAUNCHES)


def phase_train(flow, plain, batches):
    """The main path: the training step of examples/train_mnist.py."""
    x0 = batches[0]
    loss_k = -flow.compute_ll(x0)[0].mean()
    loss_k.backward()
    loss_p = -plain.compute_ll(x0)[0].mean()
    loss_p.backward()
    torch.cuda.synchronize()
    loss_err = compare(loss_k.detach(), loss_p.detach(), SLICE_TOL, "train loss")
    gaps = {}
    for (name, a), b in zip(flow.named_parameters(), plain.parameters()):
        check(a.grad is not None and bool(torch.isfinite(a.grad).all()), f"train: grad of {name}")
        gaps[name] = float((a.grad - b.grad).abs().max() / (b.grad.abs().max() + 1e-30))
    gap_name = max(gaps, key=gaps.get)
    check(gaps[gap_name] <= TRAIN_GRAD_GAP,
          f"train: gradient of {gap_name} differs between routes by {gaps[gap_name]}")
    made_gap = max(v for k, v in gaps.items() if ".made." in k)
    integrand_gap = max(v for k, v in gaps.items() if ".integrand." in k)

    step_k, step_p = trainer(flow), trainer(plain)
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    # the allocator's cached blocks, as earlier phases left them, would
    # decide how it cuts the step's blocks, and so the peak it counts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first_k = step_k(x0)
    torch.cuda.synchronize()
    launches = dict(ik.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    n = MNIST["nb_flow"]
    want = {**NONE_LAUNCHED, "integrand_fwd": n, "integrand_bwd": n}
    check(launches == want, f"train: launches in one step {launches}, want {want}")
    first_p = step_p(x0)
    step_err = compare(first_k, first_p, SLICE_TOL, "train step loss")
    losses = [float(first_k)] + [float(step_k(x)) for x in batches[1:TRAIN_STEPS]]
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(float(np.mean(losses[-3:])) < losses[0], f"train: loss did not fall {losses}")
    report("train", batch=BATCH, launches_per_step=launches, loss=loss_err, step_loss=step_err,
           grad_gap_max=gaps[gap_name], grad_gap_param=gap_name, grad_gap_made=made_gap,
           grad_gap_integrand=integrand_gap, grad_gap_tol=TRAIN_GRAD_GAP,
           losses_kernel_route=losses, peak_mem_bytes_kernel_step=peak_bytes)
    return step_k, step_p, launches, peak_bytes


def calib_block(gen, dev) -> tuple:
    """One calibration block's integral inputs: a 500-row batch of the
    known-entropy data (its 6 dimensions folded into 3,000 rows), integrand
    weights at the calibration widths and h, from seeds."""
    sample, _, _ = train_calibration.make_ground_truth(CALIB["nb_in"], 1000)
    x = torch.as_tensor(sample(np.random.RandomState(1), CALIB_BATCH).reshape(-1), device=dev)
    ws, bs, h = integrand_inputs(gen, CALIB_WIDTHS, x.numel(), dev)
    return ws, bs, x, h


def p2_cases(gen, dev, calib, g=None) -> dict:
    """The pack-2 kernels' cases: the calibration block, 101 padded nodes,
    an even K, x = 0, x < 0, a ragged row count, ReLU, the 64-wide limit."""
    ws, bs, x, h = calib
    gg = g if g is not None else torch.zeros_like(x)
    cal = (ws, bs, *cc_tensors(CALIB["nb_steps"], dev))
    ws64, bs64, h64 = integrand_inputs(gen, [64, 64, 64, 1], 2000, dev)
    cases = {
        "calibration_block": (cal, x, h, gg, 0.01),
        "padded_101_nodes": ((ws, bs, *padded_cc_quadrature(50, 100, dev)), x, h, gg, 0.01),
        "even_50_nodes": ((ws, bs, *cc_tensors(49, dev)), x, h, gg, 0.01),
        "x_zero": (cal, torch.zeros(1000, device=dev), h[:1000], gg[:1000], 0.01),
        "x_negative": (cal, -x[:1000].abs() - 0.1, h[:1000], gg[:1000], 0.01),
        "ragged_77_rows": (cal, x[:77], h[:77], gg[:77], 0.01),
        "relu_neg_slope_0": (cal, x, h, gg, 0.0),
        "widths_64_64_64_1": ((ws64, bs64, *cal[2:]), x[:2000], h64, gg[:2000], 0.01),
    }
    return cases


def p2_grid_cases(dev, calib) -> dict:
    """The pack-2 forward's cases at the edges of its persistent grid, on
    inputs of their own seed: fewer rows than SMs, a last row tile of one row
    (1,001 rows), K = 1 and 2, one hidden layer, eight 64-wide layers on
    smaller pair tiles at K = 51 and 101 padded."""
    ws, bs, x, h = calib
    gen = torch.Generator().manual_seed(13)
    n2, c2 = cc_tensors(1, dev)
    cal = (ws, bs, *cc_tensors(CALIB["nb_steps"], dev))
    ws1, bs1, h1 = integrand_inputs(gen, [31, 64, 1], 3000, dev)
    w8, b8, h8 = integrand_inputs(gen, [64] * 8 + [1], 1000, dev)
    return {
        "fewer_rows_than_sms_20": (cal, x[:20], h[:20], None, 0.01),
        "last_row_tile_of_one_row_1001": (cal, x[:1001], h[:1001], None, 0.01),
        "one_node_K1": ((ws, bs, n2[:1], c2[:1]), x, h, None, 0.01),
        "two_nodes_K2": ((ws, bs, n2, c2), x, h, None, 0.01),
        "one_hidden_layer_31_64_1": ((ws1, bs1, *cal[2:]), x, h1, None, 0.01),
        "eight_layers_64_wide_K51": ((w8, b8, *cal[2:]), x[:1000], h8, None, 0.01),
        "eight_layers_64_wide_K101": ((w8, b8, *padded_cc_quadrature(50, 100, dev)), x[:1000], h8,
                                      None, 0.01),
    }


def phase_kernel_p2(gen, dev, calib):
    """integrand_fwd_p2 against its plain version at the pack-2 cases and
    its grid's edge cases, then what it must refuse or leave to the unpacked
    pair."""
    cases = {**p2_cases(gen, dev, calib), **p2_grid_cases(dev, calib)}
    ws, bs, x_main, h_main = calib
    nodes, ccw = cc_tensors(CALIB["nb_steps"], dev)
    errs = {}
    # the widest and deepest set it takes, at K = 101: its shared memory fits
    import ctypes

    w8 = [64] * 8 + [1]
    smem8 = _build.load_library().umnn_integrand_fwd_p2_smem_bytes(
        101, ctypes.cast((ctypes.c_int * len(w8))(*w8), ctypes.c_void_p), len(w8) - 1)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    check(0 <= smem8 <= optin, f"kernel_p2: eight 64-wide layers at K=101 take {smem8} bytes")
    with torch.inference_mode():
        for case, ((cws, cbs, cn, cw), x, h, _, slope) in cases.items():
            before = dict(ik.LAUNCHES)
            if case.startswith("eight_layers"):
                # the pack-2 backward refuses these widths, so the entry
                # point sends them to the streamed pair: the forward's own
                # launcher takes them
                widths = (h.shape[-1] + 1, *[w.shape[0] for w in cws])
                got = ik._launch_fwd(cws, cbs, x, h, cn, cw, slope, widths, "_p2")
            else:
                got = ik.fused_cc_integral(cws, cbs, x, h, cn, cw, neg_slope=slope, pack2=True)
            want = ik.fused_cc_integral_plain(cws, cbs, x, h, cn, cw, neg_slope=slope)
            torch.cuda.synchronize()
            check(launched_since(before) == {"integrand_fwd_p2": 1},
                  f"kernel_p2 {case}: launched {launched_since(before)}")
            errs[case] = compare(got, want, KERNEL_TOL, f"kernel_p2 {case}")
            if case == "x_zero":
                check(bool((got == 0).all()), "kernel_p2: x=0 must give z=0")
            if case == "x_negative":
                check(bool((got < 0).all()), "kernel_p2: x<0 must give z<0")
        first = ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw, pack2=True)
        again = ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw, pack2=True)
        check(bool(torch.equal(again, first)), "kernel_p2: two runs must agree bit for bit")
        # pack2=True on a 65-wide layer raises before any launch
        before = dict(ik.LAUNCHES)
        ws65, bs65, h65 = integrand_inputs(gen, [31, 65, 1], 64, dev)
        try:
            ik.fused_cc_integral(ws65, bs65, x_main[:64], h65, nodes, ccw, pack2=True)
        except ValueError:
            pass
        else:
            raise AssertionError("kernel_p2: pack2=True on a 65-wide layer must raise")
        check(ik.LAUNCHES == before, "kernel_p2: a refused call must launch nothing")
        # a shape JAX sends to pack-4 goes to the pack-4 pair under auto
        ws32, bs32, h32 = integrand_inputs(gen, [31, 32, 32, 1], 1000, dev)
        z32 = ik.fused_cc_integral(ws32, bs32, x_main[:1000], h32, nodes, ccw)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_fwd_p4": 1},
              f"kernel_p2: a 32-wide integrand under auto launched {launched_since(before)}")
        compare(z32, ik.fused_cc_integral_plain(ws32, bs32, x_main[:1000], h32, nodes, ccw),
                KERNEL_TOL, "kernel_p2 32-wide on the pack-4 pair")
    shape = {"calibration_block": launch_shape("fwd_p2", CALIB_WIDTHS, nodes.numel(),
                                                x_main.numel()),
             "fewer_rows_than_sms_20": launch_shape("fwd_p2", CALIB_WIDTHS, nodes.numel(), 20),
             "eight_layers_64_wide_K101": launch_shape("fwd_p2", w8, 101, 1000)}
    report("kernel_p2", rows=x_main.numel(), nodes=nodes.numel(), widths=CALIB_WIDTHS,
           tol=KERNEL_TOL, cases=errs, refused=["pack2_hidden_width_65"],
           pack4_under_auto=["widths_31_32_32_1"], launch_shape=shape,
           smem_bytes_eight_layers_64_wide_K101={"bytes": smem8, "optin": optin})
    return errs, shape


def phase_bwd_p2(gen, dev, calib):
    """integrand_bwd_p2, through its wrapper and through the autograd
    Function, against the float64 plain version taken on the kernel's sides
    of every LeakyReLU (see the note on LeakyReLU kinks) at the pack-2
    cases; two runs bit-identical."""
    ws, bs, x_main, h_main = calib
    g_main = torch.randn(x_main.numel(), generator=gen).to(dev)
    cases = p2_cases(gen, dev, calib, g_main)
    errs, auto_errs, kinks = {}, {}, {}
    for case, ((cws, cbs, cn, cw), x, h, g, slope) in cases.items():
        args = (cws, cbs, x, h, cn, cw, g, slope)
        pos, items, rows = kernel_branches(cws, cbs, x, h, cn, slope)
        want = bwd_plain64(*args, pos=pos)
        want64 = bwd_plain64(*args)
        plain = ik.fused_cc_integral_bwd_plain(*args)
        before = dict(ik.LAUNCHES)
        got = ik.fused_cc_integral_bwd(*args, pack2=True)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_bwd_p2": 1},
              f"bwd_p2 {case}: launched {launched_since(before)}")
        errs[case] = worst(compare_bwd(got, plain, want, f"bwd_p2 {case}", want64))
        kinks[case] = {"items_on_other_side": items, "rows_holding_one": rows,
                       "against_float64_sides": worst(compare_bwd(
                           got, plain, want64, f"bwd_p2 {case}", enforce=False))}
        before = dict(ik.LAUNCHES)
        auto = bwd_through_autograd(*args, pack2=True)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_fwd_p2": 1, "integrand_bwd_p2": 1},
              f"bwd_p2 {case} via autograd: launched {launched_since(before)}")
        auto_errs[case] = worst(compare_bwd(auto, plain[:4], want[:4],
                                            f"bwd_p2 {case} via autograd", want64[:4]))
        if case == "x_zero":
            check(all(bool((d == 0).all()) for d in got[0]), "bwd_p2: x=0 must give dW=0")
        del want, want64, plain, got, auto, pos
    nodes, ccw = cc_tensors(CALIB["nb_steps"], dev)
    args = (ws, bs, x_main, h_main, nodes, ccw, g_main)
    first = ik.fused_cc_integral_bwd(*args, pack2=True)
    again = ik.fused_cc_integral_bwd(*args, pack2=True)
    check(all(torch.equal(a, b) for a, b in zip(first[0] + first[1] + list(first[2:]),
                                                 again[0] + again[1] + list(again[2:]))),
          "bwd_p2: two runs must agree bit for bit")
    shape = {"calibration_block": launch_shape("bwd_p2", CALIB_WIDTHS, nodes.numel()),
             "padded_101_nodes": launch_shape("bwd_p2", CALIB_WIDTHS, 101),
             "widths_64_64_64_1": launch_shape("bwd_p2", [64, 64, 64, 1], nodes.numel())}
    report("bwd_p2", rows=x_main.numel(), nodes=nodes.numel(), widths=CALIB_WIDTHS,
           launch_shape=shape,
           reference="plain version in float64 on the kernel's sides of each LeakyReLU",
           tol={"row_scale": BWD_ROW_SCALE, "param_scale": BWD_PARAM_SCALE,
                "plain_factor": BWD_PLAIN_FACTOR},
           cases=errs, cases_via_autograd=auto_errs, kinks=kinks)
    return g_main, {**errs, **{f"{k}_autograd": v for k, v in auto_errs.items()}}, shape


def phase_calibration(dev):
    """The main path of the pack-2 pair: the full-width calibration flow's
    gradients against the Leibniz route, the launches of one training step,
    then the port's driver for a short gate on full data."""
    t0 = time.perf_counter()
    sample, _, _ = train_calibration.make_ground_truth(CALIB["nb_in"], 1000)
    x0 = torch.as_tensor(sample(np.random.RandomState(2), CALIB_BATCH), device=dev)
    flow = UMNNMAFFlow(**CALIB, backend="auto", seed=0)
    plain = UMNNMAFFlow(**CALIB, backend="torch", seed=0)
    loss_err, gap = route_gaps(flow, plain, "calibration", x0)

    step_k, step_p = trainer(flow), trainer(plain)
    launches = step_launches(step_k, x0)
    n = CALIB["nb_flow"]
    want = {**NONE_LAUNCHED, "integrand_fwd_p2": n, "integrand_bwd_p2": n}
    check(launches == want, f"calibration: launches in one step {launches}, want {want}")

    folder = _build.BUILD_DIR.parent / "chip_smoke_calibration"
    shutil.rmtree(folder, ignore_errors=True)
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_calibration.main(["-nb_epoch", str(CALIB_EPOCHS), "-folder", str(folder)])
    gate_s = time.perf_counter() - t
    lines = out.getvalue().splitlines()
    result = json.loads(lines[-1])
    check(rc == 0 and result["pass"] is True,
          f"calibration: the {CALIB_EPOCHS}-epoch gate failed: {result}")
    stamps = {}
    for line in (folder / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        stamps.setdefault(rec["step"], rec["ts"])
    ts = [stamps[e] for e in sorted(stamps)]
    report("calibration", batch=CALIB_BATCH, widths=CALIB_WIDTHS, launches_per_step=launches,
           loss=loss_err, **gap, grad_gap_tol=TRAIN_GRAD_GAP, gate_epochs=CALIB_EPOCHS,
           gate_result=result,
           epoch_seconds_after_first=[b - a for a, b in zip(ts, ts[1:])],
           epoch_lines=[l for l in lines if l.startswith("epoch")],
           gate_seconds=gate_s, phase_seconds=time.perf_counter() - t0)
    return step_k, step_p, x0, launches


def uci_trainer(flow):
    """examples/train_uci.py's training step: the loss on the step's nodes."""
    optimizer = make_optimizer(flow.parameters(), "adam", lr=1e-3, weight_decay=1e-2,
                               grad_clip=1.0)
    return make_train_step(
        lambda x, nodes, weights: -flow.compute_ll(x, nodes=nodes, weights=weights)[0].mean(),
        optimizer)


def run_uci(argv: list, folder) -> tuple:
    """examples/train_uci.py's main on ``argv``: its return code, printed
    lines and seconds."""
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_uci.main(UCI_ARGV + argv + ["-folder", str(folder)])
    return rc, out.getvalue().splitlines(), time.perf_counter() - t


def uci_blocks(flow, gen, dev, x0, x_valid, name) -> tuple:
    """The pack-2 pair at the blocks the UCI driver gives it, on the first
    block's own inputs (the flow's integrand weights, its embedding of a
    batch): R = 31,500 at K = 51 and at the padded K = 101 of a randomized
    step, forward and backward against their plain versions (the backward
    by phase bwd_p2's rule), and the forward at the validity report's
    126,000 rows and 401 padded nodes; each one launch of its kernel, with
    its device time beside its bound."""
    block = flow.blocks[0]
    ws = [l.weight.detach() for l in block.net.integrand.layers]
    bs = [l.bias.detach() for l in block.net.integrand.layers]
    e = UCI["embedding_s"]

    def inputs(x):
        with torch.no_grad():
            h = block.net.integrand.fold_embedding(block.embed(x))
        return x.reshape(-1).contiguous(), h.reshape(-1, e).contiguous()

    xb, hb = inputs(x0)
    g = torch.randn(xb.numel(), generator=gen).to(dev)
    R = xb.numel()
    errs, bwd_errs, out = {}, {}, {}
    for label, (nodes, ccw) in (("K51", cc_tensors(UCI["nb_steps"], dev)),
                                ("K101", padded_cc_quadrature(UCI["nb_steps"], 100, dev))):
        K = nodes.numel()
        with torch.inference_mode():
            call = lambda: ik.fused_cc_integral(ws, bs, xb, hb, nodes, ccw)  # noqa: E731
            before = dict(ik.LAUNCHES)
            got = call()
            torch.cuda.synchronize()
            check(launched_since(before) == {"integrand_fwd_p2": 1},
                  f"uci fwd {label}: launched {launched_since(before)}")
            errs[f"uci_{label}"] = compare(
                got, ik.fused_cc_integral_plain(ws, bs, xb, hb, nodes, ccw), KERNEL_TOL,
                f"uci fwd {label}")
            fwd = {"ms": median_ms(call), "device_ms": device_ms(call, "integrand_fwd_p2"),
                   "plain_ms": median_ms(
                       lambda: ik.fused_cc_integral_plain(ws, bs, xb, hb, nodes, ccw), n=5),
                   **bound(kernel_flops(UCI_WIDTHS, R, K), kernel_bytes(UCI_WIDTHS, R, K), name),
                   "launch_shape": launch_shape("fwd_p2", UCI_WIDTHS, K, R)}
        args = (ws, bs, xb, hb, nodes, ccw, g, 0.01)
        pos, items, rows = kernel_branches(ws, bs, xb, hb, nodes, 0.01)
        want = bwd_plain64(*args, pos=pos)
        want64 = bwd_plain64(*args)
        plain = ik.fused_cc_integral_bwd_plain(*args)
        before = dict(ik.LAUNCHES)
        got = ik.fused_cc_integral_bwd(*args)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_bwd_p2": 1},
              f"uci bwd {label}: launched {launched_since(before)}")
        bwd_errs[f"uci_{label}"] = worst(compare_bwd(got, plain, want, f"uci bwd {label}", want64))
        del want, want64, plain, got, pos
        call = lambda: ik.fused_cc_integral_bwd(*args)  # noqa: E731
        bwd = {"ms": median_ms(call, n=10), "device_ms": device_ms(call, "integrand_bwd_p2", n=10),
               "plain_ms": median_ms(lambda: ik.fused_cc_integral_bwd_plain(*args), n=5,
                                     warmup=1),
               **bound(bwd_kernel_flops(UCI_WIDTHS, R, K), bwd_kernel_bytes(UCI_WIDTHS, R, K),
                       name),
               "launch_shape": launch_shape("bwd_p2", UCI_WIDTHS, K),
               "kinks": {"items_on_other_side": items, "rows_holding_one": rows}}
        for part in (fwd, bwd):
            part["device_bound_share"] = part["bound_ms"] / part["device_ms"]
        out[label] = {"rows": R, "nodes": K, "fwd": fwd, "bwd": bwd}
        torch.cuda.empty_cache()

    # the validity report's forward: 2,000 valid rows on 401 padded nodes
    xv, hv = inputs(x_valid)
    nodes, ccw = padded_cc_quadrature(100, 400, dev)
    Rv, Kv = xv.numel(), nodes.numel()
    with torch.inference_mode():
        call = lambda: ik.fused_cc_integral(ws, bs, xv, hv, nodes, ccw)  # noqa: E731
        before = dict(ik.LAUNCHES)
        got = call()
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_fwd_p2": 1},
              f"uci validity fwd: launched {launched_since(before)}")
        step = 21_000  # the plain version's activations, 1.7 GB a layer
        want = torch.cat([ik.fused_cc_integral_plain(ws, bs, xv[a:a + step], hv[a:a + step],
                                                     nodes, ccw) for a in range(0, Rv, step)])
        errs["uci_validity_K401"] = compare(got, want, KERNEL_TOL, "uci validity fwd")
        del got, want
        fwd = {"ms": median_ms(call, n=5), "device_ms": device_ms(call, "integrand_fwd_p2", n=5),
               **bound(kernel_flops(UCI_WIDTHS, Rv, Kv), kernel_bytes(UCI_WIDTHS, Rv, Kv), name),
               "launch_shape": launch_shape("fwd_p2", UCI_WIDTHS, Kv, Rv)}
        fwd["device_bound_share"] = fwd["bound_ms"] / fwd["device_ms"]
    out["validity_K401"] = {"rows": Rv, "nodes": Kv, "fwd": fwd}
    torch.cuda.empty_cache()
    return errs, bwd_errs, out


def uci_driver(data, floor: float, dev) -> tuple:
    """examples/train_uci.py as a user runs it on the phase's data: three
    short epochs, a resume, evaluation only and a Lipschitz run, each held
    to its gates. Returns the report's parts and the first run's launches."""
    n = UCI["nb_flow"]
    # (e) the driver: three short epochs at full data, randomized steps
    folder = _build.BUILD_DIR.parent / "chip_smoke_uci"
    shutil.rmtree(folder, ignore_errors=True)
    short = ["-nb_epoch", str(UCI_EPOCHS), "-steps_per_epoch", str(UCI_STEPS)]
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    rc, lines, train_s = run_uci(short, folder)
    driver_launches = dict(ik.LAUNCHES)
    check(rc == 0, f"uci: train_uci exited {rc}: {lines[-5:]}")
    result = json.loads(lines[-1])
    run = folder / "bsds300"
    records = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
    curve = {tag: [r["value"] for r in records if r["tag"] == tag]
             for tag in ("train_nll", "valid_nll")}
    check(all(len(v) == UCI_EPOCHS and all(np.isfinite(v)) for v in curve.values()),
          f"uci: epoch NLLs {curve}")
    check(curve["valid_nll"][-1] < curve["valid_nll"][0], f"uci: valid NLL did not fall {curve}")
    check(result["validity"]["n_nonfinite"] == 0, f"uci: final line {result}")
    # every batch of 500 a step or an evaluation: 5 forward sweeps each, 5
    # backward sweeps a step; 3 forward calls in the validity report
    evals = UCI_EPOCHS * -(-len(data.val) // UCI_BATCH) + -(-len(data.tst) // UCI_BATCH) + 3
    want = {**NONE_LAUNCHED, "integrand_fwd_p2": n * (UCI_EPOCHS * UCI_STEPS + evals),
            "integrand_bwd_p2": n * UCI_EPOCHS * UCI_STEPS}
    check(driver_launches == want, f"uci: train_uci launched {driver_launches}, want {want}")

    # (f) -load resumes at epoch 3 with the saved parameters and rate
    saved = torch.load(run / "ckpt" / "steps" / str(UCI_EPOCHS) / "state.pt", map_location=dev)
    seen = {}
    real = train_uci.resume_training_state

    def recording(ckpt, model, optimizer, **kw):
        out = real(ckpt, model, optimizer, **kw)
        seen["equal"] = all(torch.equal(model.state_dict()[k], v)
                            for k, v in saved["model"].items())
        seen["lr"], seen["start"] = optimizer.lr, out[1]
        return out

    train_uci.resume_training_state = recording
    try:
        rc, resume_lines, resume_s = run_uci(["-nb_epoch", str(UCI_EPOCHS + 1), "-load",
                                              "-steps_per_epoch", str(UCI_STEPS)], folder)
    finally:
        train_uci.resume_training_state = real
    saved_lr = saved["optimizer"]["param_groups"][0]["lr"]
    check(rc == 0 and seen.get("start") == UCI_EPOCHS and seen["equal"]
          and seen["lr"] == saved_lr, f"uci: resume {seen}, saved lr {saved_lr}")
    check(any(f"resumed at epoch {UCI_EPOCHS}" in l for l in resume_lines),
          "uci: no resume line")
    resumed = json.loads(resume_lines[-1])

    # (g) evaluation only: every best tag
    rc, test_lines, test_s = run_uci(["-test"], folder)
    test_only = json.loads(test_lines[-1])
    check(rc == 0 and set(test_only["test_nll_by_ckpt"]) == {"train", "valid", "train_valid"},
          f"uci: -test gave {test_only}")

    # (h) a Lipschitz run
    lip_folder = _build.BUILD_DIR.parent / "chip_smoke_uci_lipschitz"
    shutil.rmtree(lip_folder, ignore_errors=True)
    rc, lip_lines, lip_s = run_uci(["-nb_epoch", "1", "-steps_per_epoch", "10",
                                    "-Lipshitz", str(LIP_L)], lip_folder)
    check(rc == 0, f"uci: Lipschitz run exited {rc}")
    state = torch.load(lip_folder / "bsds300" / "ckpt" / "steps" / "1" / "state.pt",
                       map_location=dev)["model"]
    norms = {k: float(torch.linalg.matrix_norm(v, 2)) for k, v in state.items()
             if ".integrand." in k and k.endswith("weight")}
    check(len(norms) == n * (len(UCI["hidden_derivative"]) + 1)
          and max(norms.values()) <= LIP_L * (1 + LIP_TOL),
          f"uci: integrand norms after the Lipschitz run {norms}")
    parts = {
        "driver": {"argv": UCI_ARGV + short, "seconds": train_s, "curve": curve,
                   "final": result, "synthetic_floor": floor,
                   "test_nll_minus_floor": result["test_nll"] - floor,
                   "launches": driver_launches,
                   "epoch_lines": [l for l in lines if l.startswith("epoch")]},
        "resume": {"start_epoch": seen["start"], "lr": seen["lr"], "params_equal": seen["equal"],
                   "seconds": resume_s, "final": resumed,
                   "epoch_lines": [l for l in resume_lines if l.startswith("epoch")]},
        "test_only": {"seconds": test_s, "result": test_only},
        "lipschitz": {"L": LIP_L, "tol": LIP_TOL, "seconds": lip_s,
                      "max_norm": max(norms.values()), "final": json.loads(lip_lines[-1])},
    }
    return parts, driver_launches


def phase_uci(gen, dev, name):
    """The UCI driver's main path on BSDS300 at full width: the gradients of
    the two routes at K = 51 and 101, the launches of a training step, of
    an evaluation and of the validity report, the pack-2 pair at the
    driver's blocks, the step's time, then examples/train_uci.py itself:
    three short epochs, a resume, evaluation only, and a Lipschitz run."""
    t0 = time.perf_counter()
    n_rows = uci.SYNTH_REAL_ROWS["bsds300"]
    t = time.perf_counter()
    data = uci.load_uci("bsds300", synthetic=True, synthetic_rows=n_rows)
    data_s = time.perf_counter() - t
    floor = uci.synthetic_floor("bsds300", n_rows=n_rows)
    x0 = torch.as_tensor(data.trn[:UCI_BATCH], device=dev)
    x_valid = torch.as_tensor(data.val[:UCI_VALID_ROWS], device=dev)
    n51 = cc_tensors(UCI["nb_steps"], dev)
    n101 = padded_cc_quadrature(UCI["nb_steps"], train_uci.MAX_STEPS, dev)
    flow = UMNNMAFFlow(**UCI, backend="auto", seed=0)
    plain = UMNNMAFFlow(**UCI, backend="torch", seed=0)

    # (a) the routes' gradients at K = 51 and at a randomized step's 101
    loss51, gap51 = route_gaps(flow, plain, "uci K=51", x0)
    loss101, gap101 = route_gaps(flow, plain, "uci K=101", x0, nodes=n101[0], weights=n101[1])
    del plain
    torch.cuda.empty_cache()

    # (b) the pair each call takes, and its launches
    step = uci_trainer(flow)
    n = UCI["nb_flow"]
    pack2 = {**NONE_LAUNCHED, "integrand_fwd_p2": n, "integrand_bwd_p2": n}
    launches = {"step_K51": step_launches(step, x0, *n51),
                "step_K101": step_launches(step, x0, *n101)}
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    with torch.no_grad():
        flow.compute_ll(x0, nodes=n101[0], weights=n101[1])
    torch.cuda.synchronize()
    launches["eval_K101"] = dict(ik.LAUNCHES)
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    validity = train_uci.density_validity_report(flow, x_valid, steps=100, check_steps=400)
    torch.cuda.synchronize()
    launches["validity_report_K401"] = dict(ik.LAUNCHES)
    for key in ("step_K51", "step_K101"):
        check(launches[key] == pack2, f"uci: {key} launched {launches[key]}, want {pack2}")
    for key, calls in (("eval_K101", 1), ("validity_report_K401", 3)):
        want = {**NONE_LAUNCHED, "integrand_fwd_p2": calls * n}
        check(launches[key] == want, f"uci: {key} launched {launches[key]}, want {want}")
    check(validity.n_nonfinite == 0, f"uci: validity report {validity}")

    # (e)-(h) the driver, before (c) and (d): after this phase's profiler
    # traces, the driver's many launches made later traces lose launches
    # (two calls, one launch of a window each time)
    parts, driver_launches = uci_driver(data, floor, dev)

    # and the projection at full width on the card
    scaled = UMNNMAFFlow(**UCI, seed=1)
    with torch.no_grad():
        for b in scaled.blocks:
            for layer in b.net.integrand.layers:
                layer.weight.mul_(3.0)
    scaled.force_lipschitz(LIP_L, torch.Generator(device=dev).manual_seed(97))
    projected = [float(torch.linalg.matrix_norm(l.weight.detach(), 2))
                 for b in scaled.blocks for l in b.net.integrand.layers]
    check(all(LIP_L * (1 - 1e-5) <= v <= LIP_L * (1 + LIP_TOL) for i, v in enumerate(projected)
              if i % 5 != 4), f"uci: projected norms {projected}")
    check(all(v <= LIP_L * (1 + 1e-5) for v in projected[4::5]), f"uci: output rows {projected}")
    del scaled

    # (c) the pack-2 pair at the driver's blocks
    fwd_errs, bwd_errs, blocks = uci_blocks(flow, gen, dev, x0, x_valid, name)

    # (d) the step's time, at 50 steps and at a randomized step's 101 nodes
    timing = {}
    for label, quad in (("K51", n51), ("K101", n101)):
        ms = median_ms(lambda: step(x0, *quad), n=10, warmup=2)
        profile = step_profile(step, x0, *quad)
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / ms
        timing[label] = {"uci_train_step_ms": ms, **profile}
    del flow, step
    torch.cuda.empty_cache()

    parts["lipschitz"]["scaled_flow_norms"] = {"min": min(projected), "max": max(projected)}
    report("uci", batch=UCI_BATCH, widths=UCI_WIDTHS, nb_in=UCI["nb_in"], rows=n_rows,
           splits=[len(data.trn), len(data.val), len(data.tst)], data_seconds=data_s,
           loss_K51=loss51, **{f"{k}_K51": v for k, v in gap51.items()},
           loss_K101=loss101, **{f"{k}_K101": v for k, v in gap101.items()},
           grad_gap_tol=TRAIN_GRAD_GAP, launches=launches,
           validity_K401=dataclasses.asdict(validity), blocks=blocks, fwd_p2_errs=fwd_errs,
           bwd_p2_errs=bwd_errs, timing=timing, **parts,
           phase_seconds=time.perf_counter() - t0)
    return fwd_errs, bwd_errs, blocks, launches, driver_launches, timing


def toy_rows(n: int, seed: int, dev) -> torch.Tensor:
    """``n`` 8gaussians points folded into ``2 n`` rows of x."""
    return torch.as_tensor(inf_train_gen("8gaussians", np.random.RandomState(seed), n).reshape(-1),
                           device=dev)


def p4_cases(gen, dev) -> dict:
    """The pack-4 kernels' cases: the toy flow's block, a 4,096-row block and
    the flagship's block; K = 16, 18, 19 (the toy block's is 17), 101 padded
    nodes, x = 0, x < 0, a ragged row count, ReLU, the 32-wide limit and
    eight layers (MAX_LAYERS); then the edges of their persistent grids, on
    inputs of their own seed: fewer rows than SMs, a last row tile of one row
    (513 rows in tiles of 4), K = 1 and 2, eight layers at K = 101 padded (a
    row tile of one row) and at K = 500 (one row's items in several item
    tiles), a grid of one block (one row); and last, after a set of a few
    bytes of shared memory is asked (2-1-1, K = 1), the toy widths, asked
    before, at the toy block and at each kernel's largest row tile (one
    wave of them on every resident block), which must still launch."""
    x_toy = toy_rows(TOY_BATCH, 1, dev)
    x_big = toy_rows(B2048, 2, dev)
    ws, bs, h = integrand_inputs(gen, TOY_WIDTHS, x_toy.numel(), dev)
    ws9, bs9, h9 = integrand_inputs(gen, FLAGSHIP_WIDTHS, x_big.numel(), dev)
    x_flag = torch.randn(FLAGSHIP_BATCH * FLAGSHIP["nb_in"], generator=gen).to(dev)
    ws32, bs32, h32 = integrand_inputs(gen, [32, 32, 32, 32, 1], 1000, dev)
    ws8, bs8, h8 = integrand_inputs(gen, [32] * 8 + [1], 1000, dev)
    toy_q = cc_tensors(TOY["nb_steps"], dev)
    toy = (ws, bs, *toy_q)
    return {
        "toy_block": (toy, x_toy, h, 0.01),
        "b2048_block": ((ws9, bs9, *toy_q), x_big, h9, 0.01),
        "flagship_block": ((ws9, bs9, *cc_tensors(FLAGSHIP["nb_steps"], dev)), x_flag,
                           h9[: x_flag.numel()], 0.01),
        "nodes_16": ((ws, bs, *cc_tensors(15, dev)), x_toy, h, 0.01),
        "nodes_18": ((ws, bs, *cc_tensors(17, dev)), x_toy, h, 0.01),
        "nodes_19": ((ws, bs, *cc_tensors(18, dev)), x_toy, h, 0.01),
        "padded_101_nodes": ((ws, bs, *padded_cc_quadrature(50, 100, dev)), x_toy, h, 0.01),
        "x_zero": (toy, torch.zeros_like(x_toy), h, 0.01),
        "x_negative": (toy, -x_toy.abs() - 0.1, h, 0.01),
        "ragged_77_rows": (toy, x_toy[:77], h[:77], 0.01),
        "relu_neg_slope_0": (toy, x_toy, h, 0.0),
        "widths_32_32_32_32_1": ((ws32, bs32, *toy_q), x_big[:1000], h32, 0.01),
        "eight_layers_32_wide": ((ws8, bs8, *toy_q), x_big[:1000], h8, 0.01),
        **p4_grid_cases(dev, toy, x_toy, h, x_big, (ws9, bs9, h9), (ws8, bs8, h8)),
    }


def p4_grid_cases(dev, toy, x_toy, h, x_big, flag, eight) -> dict:
    """The edges of the pack-4 kernels' persistent grids (see p4_cases)."""
    (ws9, bs9, h9), (ws8, bs8, h8) = flag, eight
    n2, c2 = cc_tensors(1, dev)
    x8 = torch.randn(8, generator=torch.Generator().manual_seed(14)).to(dev)
    gen = torch.Generator().manual_seed(15)
    ws_tiny, bs_tiny, h_tiny = integrand_inputs(gen, [2, 1, 1], 64, dev)
    K = toy[2].numel()
    full = {kind: full_row_tile_rows(f"{kind}_p4", TOY_WIDTHS, K) for kind in ("fwd", "bwd")}
    x_full = toy_rows((max(full.values()) + 1) // 2, 15, dev)
    h_full = torch.randn(x_full.numel(), TOY_WIDTHS[0] - 1, generator=gen).to(dev)
    return {
        "fewer_rows_than_sms_100": (toy, x_toy[:100], h[:100], 0.01),
        "last_row_tile_of_one_row_513": ((ws9, bs9, *toy[2:]), x_big[:513], h9[:513], 0.01),
        "one_node_K1": ((*toy[:2], n2[:1], c2[:1]), x_toy, h, 0.01),
        "two_nodes_K2": ((*toy[:2], n2, c2), x_toy, h, 0.01),
        "eight_layers_32_wide_K101": ((ws8, bs8, *padded_cc_quadrature(50, 100, dev)), x8, h8[:8],
                                      0.01),
        "eight_layers_32_wide_K500": ((ws8, bs8, *cc_tensors(499, dev)), x8[:3], h8[:3], 0.01),
        "grid_of_one_block_1_row": (toy, x_toy[:1], h[:1], 0.01),
        "tiny_set_2_1_1_K1": ((ws_tiny, bs_tiny, n2[:1], c2[:1]), x_toy[:64], h_tiny, 0.01),
        "toy_block_after_a_smaller_layout": (toy, x_toy, h, 0.01),
        **{f"toy_{kind}_largest_row_tile_{rows}": (toy, x_full[:rows], h_full[:rows], 0.01)
           for kind, rows in full.items()},
    }


def full_row_tile_rows(kernel: str, widths: list, K: int) -> int:
    """The rows of one wave of ``kernel``'s largest row tiles at these widths
    and K, one on every resident block: ``slots`` x ``t`` for the largest
    ``t`` (at most MAX_TR, 64) that the launch shape at that many rows takes
    as its rows per row tile."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = launch_shape(kernel, widths, K, 1)["blocks_per_sm"] * sms
    tr = max(t for t in range(1, 65)
             if launch_shape(kernel, widths, K, slots * t)["rows_per_row_tile"] == t)
    return slots * tr


P4_SHAPE_CASES = ("toy_block", "b2048_block", "flagship_block", "last_row_tile_of_one_row_513",
                  "eight_layers_32_wide_K101", "eight_layers_32_wide_K500",
                  "grid_of_one_block_1_row")


def p4_shapes(kernel: str, cases: dict) -> dict:
    """A pack-4 kernel's launch shape at the cases that show its grid."""
    out = {}
    for case in (*P4_SHAPE_CASES, *(c for c in cases if "largest_row_tile" in c)):
        (cws, _, cn, _), x, h, _ = cases[case]
        out[case] = launch_shape(kernel, [h.shape[-1] + 1] + [w.shape[0] for w in cws], cn.numel(),
                                 x.numel())
    return out


def phase_kernel_p4(gen, dev):
    """integrand_fwd_p4 against its plain version at the pack-4 cases, then
    the routes: what pack4=True refuses, and where auto sends each pair."""
    cases = p4_cases(gen, dev)
    errs = {}
    with torch.inference_mode():
        for case, ((cws, cbs, cn, cw), x, h, slope) in cases.items():
            before = dict(ik.LAUNCHES)
            got = ik.fused_cc_integral(cws, cbs, x, h, cn, cw, neg_slope=slope, pack4=True)
            want = ik.fused_cc_integral_plain(cws, cbs, x, h, cn, cw, neg_slope=slope)
            torch.cuda.synchronize()
            check(launched_since(before) == {"integrand_fwd_p4": 1},
                  f"kernel_p4 {case}: launched {launched_since(before)}")
            errs[case] = compare(got, want, KERNEL_TOL, f"kernel_p4 {case}")
            if case == "x_zero":
                check(bool((got == 0).all()), "kernel_p4: x=0 must give z=0")
            if case == "x_negative":
                check(bool((got < 0).all()), "kernel_p4: x<0 must give z<0")
        (ws, bs, nodes, ccw), x, h, _ = cases["toy_block"]
        first = ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, pack4=True)
        again = ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, pack4=True)
        check(bool(torch.equal(again, first)), "kernel_p4: two runs must agree bit for bit")
        # pack4=True on a 33-wide layer raises before any launch
        before = dict(ik.LAUNCHES)
        ws33, bs33, h33 = integrand_inputs(gen, [31, 33, 1], 64, dev)
        try:
            ik.fused_cc_integral(ws33, bs33, x[:64], h33, nodes, ccw, pack4=True)
        except ValueError:
            pass
        else:
            raise AssertionError("kernel_p4: pack4=True on a 33-wide layer must raise")
        check(ik.LAUNCHES == before, "kernel_p4: a refused call must launch nothing")
        # auto picks the pair as JAX's auto does; pack4=False falls to pack-2
        routes = {
            "auto_31_32_32_1": ([31, 32, 32, 1], {}, "integrand_fwd_p4"),
            "auto_calibration": (CALIB_WIDTHS, {}, "integrand_fwd_p2"),
            "auto_mnist": (WIDTHS, {}, "integrand_fwd"),
            "pack4_false_toy": (TOY_WIDTHS, {"pack4": False}, "integrand_fwd_p2"),
        }
        xr = cases["b2048_block"][1][:1000]
        for case, (widths, kw, want) in routes.items():
            rws, rbs, rh = integrand_inputs(gen, widths, xr.numel(), dev)
            before = dict(ik.LAUNCHES)
            z = ik.fused_cc_integral(rws, rbs, xr, rh, nodes, ccw, **kw)
            torch.cuda.synchronize()
            check(launched_since(before) == {want: 1},
                  f"kernel_p4 {case}: launched {launched_since(before)}, want {want}")
            compare(z, ik.fused_cc_integral_plain(rws, rbs, xr, rh, nodes, ccw), KERNEL_TOL,
                    f"kernel_p4 {case}")
    shape = p4_shapes("fwd_p4", cases)
    report("kernel_p4", rows=x.numel(), nodes=nodes.numel(), widths=TOY_WIDTHS, tol=KERNEL_TOL,
           cases=errs, refused=["pack4_hidden_width_33"],
           routes={k: v[2] for k, v in routes.items()}, launch_shape=shape)
    return cases, errs, shape


def phase_bwd_p4(gen, dev, cases):
    """integrand_bwd_p4, through its wrapper and through the autograd
    Function, against the float64 plain version taken on the kernel's sides
    of every LeakyReLU (as phase bwd_p2) at the pack-4 cases; two runs
    bit-identical."""
    g_all = torch.randn(2 * B2048, generator=gen).to(dev)
    # cotangents for the cases of more rows than g_all (the largest row tiles)
    more = max(x.numel() for _, x, _, _ in cases.values()) - g_all.numel()
    g_rows = torch.cat([g_all, torch.randn(max(more, 0), generator=torch.Generator().manual_seed(16))
                        .to(dev)])
    errs, auto_errs, kinks = {}, {}, {}
    for case, ((cws, cbs, cn, cw), x, h, slope) in cases.items():
        args = (cws, cbs, x, h, cn, cw, g_rows[: x.numel()], slope)
        pos, items, rows = kernel_branches(cws, cbs, x, h, cn, slope)
        want = bwd_plain64(*args, pos=pos)
        want64 = bwd_plain64(*args)
        plain = ik.fused_cc_integral_bwd_plain(*args)
        before = dict(ik.LAUNCHES)
        got = ik.fused_cc_integral_bwd(*args, pack4=True)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_bwd_p4": 1},
              f"bwd_p4 {case}: launched {launched_since(before)}")
        errs[case] = worst(compare_bwd(got, plain, want, f"bwd_p4 {case}", want64))
        kinks[case] = {"items_on_other_side": items, "rows_holding_one": rows,
                       "against_float64_sides": worst(compare_bwd(
                           got, plain, want64, f"bwd_p4 {case}", enforce=False))}
        before = dict(ik.LAUNCHES)
        auto = bwd_through_autograd(*args, pack4=True)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_fwd_p4": 1, "integrand_bwd_p4": 1},
              f"bwd_p4 {case} via autograd: launched {launched_since(before)}")
        auto_errs[case] = worst(compare_bwd(auto, plain[:4], want[:4],
                                            f"bwd_p4 {case} via autograd", want64[:4]))
        if case == "x_zero":
            check(all(bool((d == 0).all()) for d in got[0]), "bwd_p4: x=0 must give dW=0")
        del want, want64, plain, got, auto, pos
    for case in ("toy_block", "b2048_block"):
        (cws, cbs, cn, cw), x, h, _ = cases[case]
        args = (cws, cbs, x, h, cn, cw, g_all[: x.numel()])
        first = ik.fused_cc_integral_bwd(*args, pack4=True)
        again = ik.fused_cc_integral_bwd(*args, pack4=True)
        check(all(torch.equal(a, b) for a, b in zip(first[0] + first[1] + list(first[2:]),
                                                     again[0] + again[1] + list(again[2:]))),
              f"bwd_p4 {case}: two runs must agree bit for bit")
    shape = p4_shapes("bwd_p4", cases)
    report("bwd_p4", rows=cases["toy_block"][1].numel(), nodes=TOY["nb_steps"] + 1,
           widths=TOY_WIDTHS, launch_shape=shape,
           reference="plain version in float64 on the kernel's sides of each LeakyReLU",
           tol={"row_scale": BWD_ROW_SCALE, "param_scale": BWD_PARAM_SCALE,
                "plain_factor": BWD_PLAIN_FACTOR},
           cases=errs, cases_via_autograd=auto_errs, kinks=kinks)
    return g_all, {**errs, **{f"{k}_autograd": v for k, v in auto_errs.items()}}, shape


def phase_toy(dev):
    """The main path of the pack-4 pair: the flagship and toy flows'
    gradients against the Leibniz route and the launches of one training
    step, then the port's toy driver for 6 epochs, plain and conditional."""
    t0 = time.perf_counter()
    x_flag = torch.as_tensor(
        np.random.RandomState(3).randn(FLAGSHIP_BATCH, FLAGSHIP["nb_in"]).astype(np.float32),
        device=dev)
    flag = UMNNMAFFlow(**FLAGSHIP, backend="auto", seed=0)
    flag_loss, flag_gap = route_gaps(flag, UMNNMAFFlow(**FLAGSHIP, backend="torch", seed=0),
                                     "toy flagship", x_flag)
    flag_step = trainer(flag, 1e-5)
    flag_launches = step_launches(flag_step, x_flag)
    want = {**NONE_LAUNCHED, "integrand_fwd_p4": 2, "integrand_bwd_p4": 2}
    check(flag_launches == want, f"toy: flagship step launched {flag_launches}, want {want}")
    flag_profile = step_profile(flag_step, x_flag)  # its device launches, all kernels

    x_toy = torch.as_tensor(inf_train_gen("8gaussians", np.random.RandomState(4), TOY_BATCH),
                            device=dev)
    flow = UMNNMAFFlow(**TOY, backend="auto", seed=0)
    plain = UMNNMAFFlow(**TOY, backend="torch", seed=0)
    toy_loss, toy_gap = route_gaps(flow, plain, "toy", x_toy)
    step_k, step_p = trainer(flow, 1e-5), trainer(plain, 1e-5)
    launches = step_launches(step_k, x_toy)
    want = {**NONE_LAUNCHED, "integrand_fwd_p4": 1, "integrand_bwd_p4": 1}
    check(launches == want, f"toy: step launched {launches}, want {want}")

    runs = {}
    for data, jax_nll in JAX_CPU_TOY_NLL.items():
        for k in ik.LAUNCHES:
            ik.LAUNCHES[k] = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            history = train_toy.main(f"-data {data} {TOY_ARGV}".split())
        seconds = time.perf_counter() - t
        # 10 steps of 1 + 1 launches and one test batch of 1 per epoch
        want = {**NONE_LAUNCHED, "integrand_fwd_p4": 66, "integrand_bwd_p4": 60}
        check(ik.LAUNCHES == want, f"toy {data}: train_toy launched {ik.LAUNCHES}, want {want}")
        nll = history["test_nll"]
        check(all(np.isfinite(nll)) and nll[-1] < nll[0], f"toy {data}: test NLL {nll}")
        runs[data] = {
            "params": history["params"], "test_nll": nll, "train_nll": history["train_nll"],
            "jax_cpu_xla_test_nll_epochs_0_5": jax_nll, "seconds": seconds,
            "lines": out.getvalue().splitlines(),
        }
    report("toy", flagship_batch=FLAGSHIP_BATCH, flagship_widths=FLAGSHIP_WIDTHS,
           flagship_loss=flag_loss, flagship=flag_gap, flagship_launches_per_step=flag_launches,
           flagship_step_profile=flag_profile,
           toy_batch=TOY_BATCH, toy_widths=TOY_WIDTHS, toy_loss=toy_loss, toy=toy_gap,
           launches_per_step=launches, grad_gap_tol=TRAIN_GRAD_GAP, driver=runs,
           phase_seconds=time.perf_counter() - t0)
    return flow, step_k, step_p, x_toy, launches


def sample_rows(B: int, D: int, seed: int, dev) -> torch.Tensor:
    """``x`` as PARITY_RUNS.md §6's accuracy sweep draws it: 1.5 N(0, 1),
    clipped to +-6."""
    rs = np.random.RandomState(seed)
    return torch.as_tensor(np.clip(1.5 * rs.randn(B, D), -6, 6).astype(np.float32), device=dev)


def inversion_launches(method: str, blocks: int, D: int, kernel: str) -> dict:
    """One inversion's integrand launches: bisection one forward a round,
    blocks x D x iters; Newton one an iteration, blocks x iters; no backward."""
    per_block = D * SAMPLE_ITERS[method] if method == "bisection" else SAMPLE_ITERS[method]
    return {**NONE_LAUNCHED, kernel: blocks * per_block}


def inversion_profile(fn, wall_ms: float) -> dict:
    """Device busy time of one call of ``fn`` from a torch.profiler trace,
    the integrand kernels' share by name, and the idle share against the
    call's unprofiled time ``wall_ms``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy = sum(e.device_time_total for e in events) / 1e3
    out = {"device_busy_ms": busy, "device_launches": sum(e.count for e in events),
           "device_idle_share": 1.0 - busy / wall_ms}
    for kernel in ik.LAUNCHES:
        pattern = re.compile(rf"(?<![A-Za-z_]){kernel}_(kernel|reduce)(?![a-z0-9_])")
        hits = [e for e in events if pattern.search(e.key)]
        if hits:
            out[f"{kernel}_ms"] = sum(e.device_time_total for e in hits) / 1e3
            out[f"{kernel}_launches"] = sum(e.count for e in hits)
            out[f"{kernel}_ms_per_launch"] = out[f"{kernel}_ms"] / out[f"{kernel}_launches"]
    return out


def inversion(kernel_flow, plain_flow, x, method: str, kernel: str, name: str, what: str,
              profile: bool = True) -> dict:
    """``invert(forward(x))`` on the kernel route and the plain route
    (``backend="torch"``, the same weights), three times each (CUDA events,
    median; the counts set to 0 before each call and read after): the
    kernel route launches ``kernel`` as inversion_launches says and nothing
    else, the plain route nothing; each route's x-space and z-space round
    trips within ROUND_TRIP, the routes within ROUND_TRIP of each other;
    samples/s; a profiler trace of one kernel-route call; the forward
    kernel's device time per launch at this inversion's shape, beside its
    bound."""
    B, D = x.shape
    iters = SAMPLE_ITERS[method]
    with torch.no_grad():
        z = kernel_flow(x)
    want = inversion_launches(method, len(kernel_flow.blocks), D, kernel)
    out, xs = {"batch": B, "dims": D, "blocks": len(kernel_flow.blocks), "iters": iters}, {}
    kw = {"nb_candidates": NB_CANDIDATES} if method == "bisection" else {}
    for route, flow in (("kernel", kernel_flow), ("plain", plain_flow)):
        times = []
        for _ in range(3):
            for k in ik.LAUNCHES:
                ik.LAUNCHES[k] = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            x_inv = flow.invert(z, iters, method=method, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            launched = dict(ik.LAUNCHES)
            check(launched == (want if route == "kernel" else NONE_LAUNCHED),
                  f"sample {what} {method} {route}: launched {launched}")
        check(bool(torch.isfinite(x_inv).all()), f"sample {what} {method} {route}: non-finite x")
        with torch.no_grad():
            z_back = flow(x_inv)
        x_rt, z_rt = float((x_inv - x).abs().max()), float((z_back - z).abs().max())
        rows_over = int(((x_inv - x).abs().amax(1) > ROUND_TRIP[method]).sum())
        check(x_rt <= ROUND_TRIP[method] and z_rt <= ROUND_TRIP[method],
              f"sample {what} {method} {route}: round trips x {x_rt}, z {z_rt} past "
              f"{ROUND_TRIP[method]} ({rows_over} rows of {B} past it in x)")
        ms = float(np.median(times))
        out[route] = {"ms": ms, "times_ms": times, "samples_per_s": B / ms * 1e3,
                      "x_round_trip": x_rt, "z_round_trip": z_rt, "launches": launched}
        xs[route] = x_inv
    gap = float((xs["kernel"] - xs["plain"]).abs().max())
    check(gap <= ROUND_TRIP[method], f"sample {what} {method}: the routes differ by {gap}")
    out["route_gap"] = gap
    out["round_trip_limit"] = ROUND_TRIP[method]
    if profile:
        out["profile"] = inversion_profile(lambda: kernel_flow.invert(z, iters, method=method, **kw),
                                           out["kernel"]["ms"])
    # the forward kernel's rows a launch: bisection's candidates, Newton's x
    rows = B * (NB_CANDIDATES if method == "bisection" else D)
    block = kernel_flow.blocks[0]
    layers = block.net.integrand.layers
    widths = [layers[0].in_features, *(l.out_features for l in layers)]
    out["kernel_rows"] = rows
    out["kernel_bound"] = bound(kernel_flops(widths, rows, block.nb_steps + 1),
                                kernel_bytes(widths, rows, block.nb_steps + 1), name)
    return out


def toy_sampling(dev, name) -> dict:
    """The toy driver with -sample 128 on 8gaussians and
    conditionnal8gaussians: launches of the run (training as in phase toy,
    then one pack-4 forward a bisection round), finite samples written
    under -folder, their bisection round trip under the last checkpoint's
    parameters, their z against the driver's draws, and samples/s of both
    routes."""
    runs = {}
    for data in JAX_CPU_TOY_NLL:
        folder = _build.BUILD_DIR.parent / "chip_smoke_sample_toy"
        shutil.rmtree(folder, ignore_errors=True)
        for k in ik.LAUNCHES:
            ik.LAUNCHES[k] = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            history = train_toy.main(
                f"-data {data} {TOY_ARGV} -sample {TOY_SAMPLES} -folder {folder}".split())
        seconds = time.perf_counter() - t
        launched = dict(ik.LAUNCHES)
        sample_launches = inversion_launches("bisection", TOY["nb_flow"], TOY["nb_in"],
                                             "integrand_fwd_p4")["integrand_fwd_p4"]
        # phase toy's 66 + 60 for 6 epochs, then the samples' rounds
        want = {**NONE_LAUNCHED, "integrand_fwd_p4": 66 + sample_launches, "integrand_bwd_p4": 60}
        check(launched == want, f"sample toy {data}: launched {launched}, want {want}")
        samples = history["samples"]
        check(samples.shape == (TOY_SAMPLES, 2) and bool(np.isfinite(samples).all()),
              f"sample toy {data}: samples {samples.shape}")
        check(np.array_equal(np.load(folder / f"samples_{data}.npy"), samples),
              f"sample toy {data}: the saved samples differ")
        cond = train_toy.COND_IN if data == "conditionnal8gaussians" else 0
        flows = {}
        _, state, _ = CheckpointManager(folder / data / "ckpt").restore(map_location=dev)
        for route, backend in (("kernel", "auto"), ("plain", "torch")):
            flows[route] = UMNNMAFFlow(**TOY, backend=backend, seed=0, cond_in=cond)
            flows[route].load_state_dict(state)
        ctx = torch.eye(cond, device=dev)[torch.arange(TOY_SAMPLES, device=dev) % cond] if cond else None
        xs = torch.as_tensor(samples, device=dev)
        z_drawn = torch.randn(TOY_SAMPLES, 2, generator=torch.Generator(device=dev).manual_seed(1),
                              device=dev)
        with torch.no_grad():
            z = flows["kernel"](xs, ctx)
        z_gap = float((z - z_drawn).abs().max())
        for k in ik.LAUNCHES:
            ik.LAUNCHES[k] = 0
        x_rt = float((flows["kernel"].invert(z, SAMPLE_ITERS["bisection"], ctx) - xs).abs().max())
        torch.cuda.synchronize()
        round_trip_launches = dict(ik.LAUNCHES)
        check(round_trip_launches == {**NONE_LAUNCHED, "integrand_fwd_p4": sample_launches},
              f"sample toy {data}: the round trip launched {round_trip_launches}")
        check(x_rt <= ROUND_TRIP["bisection"] and z_gap <= ROUND_TRIP["bisection"],
              f"sample toy {data}: round trip {x_rt}, z against the draws {z_gap}")
        rates = {}
        for route, flow in flows.items():
            draw = lambda f=flow: f.sample(  # noqa: E731
                TOY_SAMPLES, torch.Generator(device=dev).manual_seed(1), context=ctx)
            ms = median_ms(draw, n=3, warmup=1)
            rates[route] = {"ms": ms, "samples_per_s": TOY_SAMPLES / ms * 1e3}
            if route == "kernel":
                rates[route]["profile"] = inversion_profile(draw, ms)
        rows = TOY_SAMPLES * NB_CANDIDATES
        rates["kernel"]["kernel_rows"] = rows
        rates["kernel"]["kernel_bound"] = bound(kernel_flops(TOY_WIDTHS, rows, TOY["nb_steps"] + 1),
                                                kernel_bytes(TOY_WIDTHS, rows, TOY["nb_steps"] + 1),
                                                name)
        runs[data] = {
            "seconds": seconds, "launches": launched, "round_trip_launches": round_trip_launches,
            "sample_line": out.getvalue().splitlines()[-1],
            "mean": samples.mean(0).tolist(), "std": samples.std(0).tolist(),
            "verify_expectation_8gaussians": {"mean": 0.0, "std": 2.0},
            "x_round_trip": x_rt, "z_against_draws": z_gap, "routes": rates,
            "test_nll": history["test_nll"],
        }
    return runs


def phase_sample(dev, name):
    """Inversion and sampling on the card: the UCI parity configuration
    (bisection and Newton, the pack-2 forward), the MNIST configuration at
    full width (Newton at 5 blocks; bisection on MNIST_BISECT_BLOCKS blocks,
    the cut), and the toy driver's -sample 128 (the pack-4 forward); each
    inversion against the plain route, with its launches counted, its
    round trips gated, its samples/s and a profiler trace. Forward-only
    calls under inference mode keep no graph: the result has no grad_fn,
    no parameter gets a gradient, and only the result stays allocated."""
    t0 = time.perf_counter()
    res = {}
    uci_k = UMNNMAFFlow(**CALIB, backend="auto", seed=0)
    uci_p = UMNNMAFFlow(**CALIB, backend="torch", seed=0)
    x_uci = sample_rows(CALIB_BATCH, CALIB["nb_in"], 7, dev)
    for method in ("bisection", "newton"):
        res[f"uci_{method}"] = inversion(uci_k, uci_p, x_uci, method, "integrand_fwd_p2", name,
                                         "uci")
    del uci_k, uci_p

    mnist_k = UMNNMAFFlow(**MNIST, backend="auto", seed=0)
    mnist_p = UMNNMAFFlow(**MNIST, backend="torch", seed=0)
    x_mnist = sample_rows(BATCH, MNIST["nb_in"], 8, dev)
    res["mnist_newton"] = inversion(mnist_k, mnist_p, x_mnist, "newton", "integrand_fwd", name,
                                    "mnist")
    # inference mode: nothing kept for a backward, no gradient buffer
    with torch.no_grad():
        z = mnist_k(x_mnist)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x_inv = mnist_k.invert(z, SAMPLE_ITERS["newton"], method="newton")
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    check(x_inv.grad_fn is None and not x_inv.requires_grad, "sample: the inverse has a graph")
    check(all(p.grad is None for p in mnist_k.parameters()), "sample: a parameter got a gradient")
    check(kept <= x_inv.numel() * 4 + MEM_SLACK,
          f"sample: {kept} bytes stayed allocated after a Newton inversion")
    res["mnist_newton"]["memory"] = {"kept_bytes": kept, "result_bytes": x_inv.numel() * 4,
                                     "peak_over_before_bytes":
                                         torch.cuda.max_memory_allocated() - before}

    # bisection at full depth: one kernel-route call, launches and round trip
    # gated; the routes' three calls each then run on the cut
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    t = time.perf_counter()
    x_inv = mnist_k.invert(z, SAMPLE_ITERS["bisection"], nb_candidates=NB_CANDIDATES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    want = inversion_launches("bisection", MNIST["nb_flow"], MNIST["nb_in"], "integrand_fwd")
    check(dict(ik.LAUNCHES) == want, f"sample mnist bisection at full depth: {ik.LAUNCHES}")
    x_rt = float((x_inv - x_mnist).abs().max())
    check(x_rt <= ROUND_TRIP["bisection"], f"sample mnist bisection at full depth: {x_rt}")
    full = {"seconds": seconds, "samples_per_s": BATCH / seconds, "x_round_trip": x_rt,
            "launches": dict(ik.LAUNCHES)}
    del mnist_k, mnist_p, x_inv, z

    cut = dict(MNIST, nb_flow=MNIST_BISECT_BLOCKS)
    res["mnist_bisection"] = inversion(
        UMNNMAFFlow(**cut, backend="auto", seed=0), UMNNMAFFlow(**cut, backend="torch", seed=0),
        x_mnist, "bisection", "integrand_fwd", name, "mnist")
    res["mnist_bisection"]["cut"] = f"{MNIST_BISECT_BLOCKS} of {MNIST['nb_flow']} blocks"
    res["mnist_bisection"]["full_depth_kernel_route_once"] = full
    res["toy"] = toy_sampling(dev, name)
    # counted: one kernel-route call of each inversion, and each toy round trip
    launches = {k: 0 for k in ik.LAUNCHES}
    counted = [r["kernel"]["launches"] for k, r in res.items() if k != "toy"]
    counted += [run["round_trip_launches"] for run in res["toy"].values()]
    for c in counted:
        for kname, n in c.items():
            launches[kname] += n
    report("sample", device=name, nvidia_smi=nvidia_smi(), nb_candidates=NB_CANDIDATES,
           iters=SAMPLE_ITERS, round_trip_limit=ROUND_TRIP, **res,
           launches_one_call_each=launches, phase_seconds=time.perf_counter() - t0)
    return res, launches


def mono_batch(rows: int, seed: int, dev) -> tuple:
    """A batch of the monotonic driver's regression: x ~ U(-2, 2)^3 from a
    generator on the card, and its target."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(rows, MONO_IN, generator=gen, device=dev) * 4.0 - 2.0
    return x, train_monotonic.target(x)


def mono_case(in_d: int, hidden: tuple, fwd: str, bwd: str, dev) -> dict:
    """One MonotonicNN on both routes at the driver's batch and nodes:
    values within SLICE_TOL, gradients of its MSE within TRAIN_GRAD_GAP,
    exactly one launch of ``fwd`` and of ``bwd`` a training step, strictly
    increasing in x1 on the driver's grid."""
    what = f"monotonic {in_d}-{'-'.join(map(str, hidden))}"
    model = MonotonicNN(in_d, hidden, nb_steps=MONO_STEPS, backend="auto", seed=0)
    plain = MonotonicNN(in_d, hidden, nb_steps=MONO_STEPS, backend="torch", seed=0)
    x, y = mono_batch(MONO_BATCH, 1, dev)
    x = x[:, :in_d]
    loss_k = train_monotonic.monotonic_mse(model, x, y)
    loss_k.backward()
    loss_p = train_monotonic.monotonic_mse(plain, x, y)
    loss_p.backward()
    with torch.no_grad():
        value = compare(model(x[:, :1], x[:, 1:]), plain(x[:, :1], x[:, 1:]), SLICE_TOL,
                        f"{what} values")
    loss = compare(loss_k.detach(), loss_p.detach(), SLICE_TOL, f"{what} loss")
    gaps = grad_gaps(model, plain, what)
    opt = make_optimizer(model.parameters(), "adam", 1e-3, grad_clip=None)
    launches = step_launches(train_monotonic.fit_step, train_monotonic.monotonic_mse, model,
                             opt, x, y)
    want = {**NONE_LAUNCHED, fwd: 1, bwd: 1}
    check(launches == want, f"{what}: launches in one step {launches}, want {want}")
    monotone = train_monotonic.is_monotone(model, dev)
    check(monotone, f"{what}: not increasing in x1 on the driver's grid")
    return {"values": value, "loss": loss, **gaps, "launches_per_step": launches,
            "monotone": monotone}


def run_driver(main, argv: list) -> tuple:
    """A driver's ``main(argv)`` with its stdout captured and its launches
    counted from 0: (result, stdout lines, launches, seconds)."""
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    torch.cuda.synchronize()
    return result, out.getvalue().splitlines(), dict(ik.LAUNCHES), time.perf_counter() - t


def mono_block(dev, name) -> dict:
    """The unpacked pair at the monotonic driver's block (R = 512, K = 51,
    3-100-100-100-1, ReLU) against its plain versions (the forward within
    KERNEL_TOL, the backward against float64 by phase bwd's rule), and the
    device time of one launch of each beside its bound."""
    gen = torch.Generator().manual_seed(11)
    x, _ = mono_batch(MONO_BATCH, 2, dev)
    x, h = x[:, 0].contiguous(), x[:, 1:].contiguous()
    ws, bs, _ = integrand_inputs(gen, MONO_WIDTHS, 1, dev)
    g = torch.randn(MONO_BATCH, generator=gen).to(dev)
    nodes, ccw = cc_tensors(MONO_STEPS, dev)
    K = nodes.numel()
    with torch.inference_mode():
        fwd = lambda: ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, neg_slope=0.0)  # noqa: E731
        plain = lambda: ik.fused_cc_integral_plain(ws, bs, x, h, nodes, ccw, 0.0)  # noqa: E731
        fwd_err = compare(fwd(), plain(), KERNEL_TOL, "monotonic block fwd")
        fwd_t = (median_ms(fwd, n=20, warmup=5), device_ms(fwd, "integrand_fwd"),
                 median_ms(plain, n=20, warmup=5))
    args = (ws, bs, x, h, nodes, ccw, g, 0.0)
    bwd = lambda: ik.fused_cc_integral_bwd(*args)  # noqa: E731
    bwd_err = worst(compare_bwd(bwd(), ik.fused_cc_integral_bwd_plain(*args), bwd_plain64(*args),
                                "monotonic block bwd"))
    bwd_t = (median_ms(bwd, n=20, warmup=5), device_ms(bwd, "integrand_bwd"),
             median_ms(lambda: ik.fused_cc_integral_bwd_plain(*args), n=20, warmup=5))
    out = {}
    for kernel, kind, err, (ms, dms, pms), flops, nbytes in (
        ("integrand_fwd", "fwd", fwd_err, fwd_t, kernel_flops, kernel_bytes),
        ("integrand_bwd", "bwd", bwd_err, bwd_t, bwd_kernel_flops, bwd_kernel_bytes),
    ):
        b = bound(flops(MONO_WIDTHS, MONO_BATCH, K), nbytes(MONO_WIDTHS, MONO_BATCH, K), name)
        out[kernel] = {"rows": MONO_BATCH, "nodes": K, "widths": MONO_WIDTHS, "neg_slope": 0.0,
                       "ms": ms, "device_ms_per_launch": dms, "plain_ms": pms,
                       "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                       "device_bound_share": b["bound_ms"] / dms, "bound": b, **err,
                       "launch_shape": launch_shape(kind, MONO_WIDTHS, K)}
    return out


def cc_solver(x_mnist, dev) -> dict:
    """The node-sequential solver: the calibration flow's values under
    solver="CC" against the "CCParallel" kernel route (KERNEL_TOL) with no
    integrand kernel launched, and the peak memory of an inference-mode
    compute_ll of the full-width MNIST flow under "CC" against
    backend="torch" (the node megabatch), which it must undercut."""
    sample, _, _ = train_calibration.make_ground_truth(CALIB["nb_in"], 1000)
    x = torch.as_tensor(sample(np.random.RandomState(3), CALIB_BATCH), device=dev)
    flow_k = UMNNMAFFlow(**CALIB, backend="auto", seed=0)
    flow_c = UMNNMAFFlow(**CALIB, backend="auto", seed=0, solver="CC")
    with torch.inference_mode():
        ll_k, z_k = flow_k.compute_ll(x)
        for k in ik.LAUNCHES:
            ik.LAUNCHES[k] = 0
        ll_c, z_c = flow_c.compute_ll(x)
        torch.cuda.synchronize()
        launched = dict(ik.LAUNCHES)
    check(launched == NONE_LAUNCHED, f"cc solver: launched {launched}")
    errs = {"ll": compare(ll_c, ll_k, KERNEL_TOL, "cc solver ll"),
            "z": compare(z_c, z_k, KERNEL_TOL, "cc solver z")}
    del flow_k, flow_c
    peaks, lls = {}, {}
    for label, kw in (("cc", {"solver": "CC"}), ("torch", {"backend": "torch"})):
        flow = UMNNMAFFlow(**MNIST, seed=0, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with torch.inference_mode():
            lls[label] = flow.compute_ll(x_mnist)[0]
        torch.cuda.synchronize()
        peaks[label] = {"peak_over_params_bytes": torch.cuda.max_memory_allocated() - base,
                        "seconds": time.perf_counter() - t}
        del flow
    check(peaks["cc"]["peak_over_params_bytes"] < peaks["torch"]["peak_over_params_bytes"],
          f"cc solver: peak memory {peaks}")
    return {"calibration": errs, "launches": launched, "mnist_inference": peaks,
            "mnist_ll_cc_against_torch": compare(lls["cc"], lls["torch"], SLICE_TOL,
                                                 "cc solver mnist ll")}


def accum_step(x) -> dict:
    """make_accum_train_step with ACCUM_STEPS microbatches on the
    full-width MNIST flow at batch 100, against make_train_step's step on
    a flow of the same seeded weights: the loss within rtol 1e-4, every
    averaged gradient within TRAIN_GRAD_GAP of its tensor's largest entry
    (no clip, so each step leaves its gradients in ``.grad``; the
    parameters after Adam are not compared), 5 x ACCUM_STEPS launches of
    each unpacked kernel, and each step's peak memory over what was
    allocated before it (parameters, Adam's new state and the
    activations)."""
    out = {}
    for label in ("single", "accum"):
        flow = UMNNMAFFlow(**MNIST, seed=1)
        loss_fn = lambda xb, f=flow: -f.compute_ll(xb)[0].mean()  # noqa: E731
        opt = make_optimizer(flow.parameters(), grad_clip=None)
        step = (make_train_step(loss_fn, opt) if label == "single"
                else make_accum_train_step(loss_fn, opt, ACCUM_STEPS))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for k in ik.LAUNCHES:
            ik.LAUNCHES[k] = 0
        loss = step(x)
        torch.cuda.synchronize()
        out[label] = {"loss": loss, "launches": dict(ik.LAUNCHES),
                      "peak_over_before_bytes": torch.cuda.max_memory_allocated() - base,
                      "grads": {n: p.grad for n, p in flow.named_parameters()}}
        del flow, opt, step
    single, accum = out["single"], out["accum"]
    n = MNIST["nb_flow"]
    check(single["launches"] == {**NONE_LAUNCHED, "integrand_fwd": n, "integrand_bwd": n},
          f"accum: the single step launched {single['launches']}")
    check(accum["launches"] == {**NONE_LAUNCHED, "integrand_fwd": n * ACCUM_STEPS,
                                "integrand_bwd": n * ACCUM_STEPS},
          f"accum: launches in one step {accum['launches']}")
    loss_err = compare(accum["loss"], single["loss"], dict(rtol=1e-4, atol=0.0), "accum loss")
    gaps = {name: float((g - single["grads"][name]).abs().max()
                        / (single["grads"][name].abs().max() + 1e-30))
            for name, g in accum["grads"].items()}
    worst_name = max(gaps, key=gaps.get)
    check(gaps[worst_name] <= TRAIN_GRAD_GAP,
          f"accum: gradient of {worst_name} off the whole batch's by {gaps[worst_name]}")
    return {"accum_steps": ACCUM_STEPS, "batch": x.shape[0], "loss": loss_err,
            "grad_gap_max": gaps[worst_name], "grad_gap_param": worst_name,
            "launches_per_step": accum["launches"],
            "peak_mem_over_before_bytes": {k: v["peak_over_before_bytes"] for k, v in out.items()}}


def phase_monotonic(dev, name, x_mnist):
    """The slice's paths on the card: MonotonicNN at the driver's widths
    (the unpacked pair, ReLU), at pack-2 and pack-4 widths and at in_d = 1,
    each route against the other; h with no column refused before any
    launch; the unpacked pair at the driver's block against its plain
    versions, with device times; the training step's time and idle share;
    the driver at the verify command; the class-conditional MNIST flow at
    full width and its driver; the CC solver; the accumulation step.
    Returns the block's times and the launches counted in the phase's
    main-path runs (steps and drivers; no comparison call)."""
    t0 = time.perf_counter()
    counted = {k: 0 for k in ik.LAUNCHES}

    def count(launches):
        for k, v in launches.items():
            counted[k] += v

    cases = {}
    for label, (in_d, hidden, fwd, bwd) in MONO_CASES.items():
        cases[label] = mono_case(in_d, hidden, fwd, bwd, dev)
        count(cases[label]["launches_per_step"])
    ws, bs, _ = integrand_inputs(torch.Generator().manual_seed(0), [1, 8, 1], 1, dev)
    nodes, ccw = cc_tensors(MONO_STEPS, dev)
    before = dict(ik.LAUNCHES)
    try:
        ik.fused_cc_integral(ws, bs, torch.ones(4, device=dev), torch.zeros(4, 0, device=dev),
                             nodes, ccw, neg_slope=0.0)
        refused = False
    except ValueError:
        refused = True
    check(refused and launched_since(before) == {}, "monotonic: h with no column was launched")
    block = mono_block(dev, name)

    # the training step at the driver's default, R = 512, K = 51
    model = MonotonicNN(MONO_IN, MONO_HIDDEN, nb_steps=MONO_STEPS, seed=0)
    opt = make_optimizer(model.parameters(), "adam", 1e-3, grad_clip=None)
    x, y = mono_batch(MONO_BATCH, 3, dev)
    step = functools.partial(train_monotonic.fit_step, train_monotonic.monotonic_mse, model,
                             opt, x, y)
    step_ms = median_ms(step, n=20, warmup=5)
    profile = step_profile(step)
    profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / step_ms

    rc, lines, launches, seconds = run_driver(train_monotonic.main, MONO_ARGV.split())
    mse = [float(l.split()[4]) for l in lines if l.startswith("epoch")]
    epochs = int(MONO_ARGV.split()[1])
    # one step a epoch, then the monotonicity check's forward
    want = {**NONE_LAUNCHED, "integrand_fwd": epochs + 1, "integrand_bwd": epochs}
    check(rc == 0 and lines[-1] == "monotone in x1: True", f"monotonic driver: {rc} {lines[-3:]}")
    check(mse[-1] < mse[0], f"monotonic driver: MSE did not fall {mse}")
    check(launches == want, f"monotonic driver: launched {launches}, want {want}")
    count(launches)
    driver = {"argv": MONO_ARGV, "rc": rc, "lines": lines, "launches": launches,
              "seconds": seconds}

    # the class-conditional MNIST flow at full width, on the uniform stand-in
    data = load_mnist_flow(synthetic=True)
    xc = torch.as_tensor(data.tst_x[:BATCH], device=dev)
    ctx = torch.eye(10, device=dev)[torch.as_tensor(data.tst_y[:BATCH], device=dev)]
    flow = UMNNMAFFlow(**MNIST, backend="auto", seed=0, cond_in=10)
    plain = UMNNMAFFlow(**MNIST, backend="torch", seed=0, cond_in=10)
    loss_err, gap = route_gaps(flow, plain, "conditional mnist", xc, ctx)
    del plain
    cond_launches = step_launches(trainer(flow), xc, ctx)
    n = MNIST["nb_flow"]
    check(cond_launches == {**NONE_LAUNCHED, "integrand_fwd": n, "integrand_bwd": n},
          f"conditional mnist: launches in one step {cond_launches}")
    count(cond_launches)
    del flow
    folder = _build.BUILD_DIR.parent / "chip_smoke_mnist_conditional"
    shutil.rmtree(folder, ignore_errors=True)
    result, lines, launches, seconds = run_driver(
        train_mnist.main, COND_ARGV.split() + ["-folder", str(folder)])
    imgs = np.load(folder / "generated.npy")
    check(bool(np.isfinite(result["test_bpp"])) and imgs.shape == (10, 28, 28)
          and bool(np.isfinite(imgs).all()), f"conditional mnist driver: {result} {imgs.shape}")
    count(launches)
    shutil.rmtree(folder, ignore_errors=True)
    cond = {"batch": BATCH, "cond_in": 10, "loss": loss_err, **gap,
            "launches_per_step": cond_launches,
            "driver": {"argv": COND_ARGV, "result": result, "lines": lines,
                       "launches": launches, "seconds": seconds,
                       "generated_shape": list(imgs.shape)}}

    solver = cc_solver(x_mnist, dev)
    accum = accum_step(x_mnist)
    count(accum["launches_per_step"])
    report("monotonic", device=name, nvidia_smi=nvidia_smi(), widths=MONO_WIDTHS,
           batch=MONO_BATCH, nodes=MONO_STEPS + 1, tol=SLICE_TOL, grad_gap_tol=TRAIN_GRAD_GAP,
           cases=cases, h_with_no_column_refused=refused, block=block,
           monotonic_train_step_ms=step_ms, monotonic_train_step_profile=profile,
           driver=driver, conditional_mnist=cond, cc_solver=solver, accum=accum,
           launches_counted=counted, phase_seconds=time.perf_counter() - t0)
    return block, counted


def phase_wide(gen, dev, calib, name):
    """The streamed pair, integrand_fwd_wide and integrand_bwd_wide, on what
    the staged pairs refuse, under backend "auto" (and "kernel" for the
    flow): values against the plain version within KERNEL_TOL, gradients
    through the wrapper and through the autograd Function by bwd_p2's rule
    (float64 on the kernel's sides of each LeakyReLU kink; the pair's
    forward arithmetic is the one kernel_branches models), each call one
    launch of the pair and nothing else; reruns bit-identical; the 129-wide
    flow's ll and parameter gradients against backend="torch"; the main path
    at full width (WIDE_TRAIN_FLOW's training step, counted); at the timing
    block the device time of each kernel and launch, beside the bound and
    cuBLAS's time for the same products."""
    t0 = time.perf_counter()
    x_cal = calib[2]
    n51 = cc_tensors(CALIB["nb_steps"], dev)
    n1 = (torch.tensor([0.3], device=dev), torch.tensor([2.0], device=dev))
    sets = {
        # widths, rows, nodes, neg_slope, route flags
        "widths_31_129_1": ([31, 129, 1], 64, n51, 0.01, {}),
        "timing_block": (WIDE_WIDTHS, x_cal.numel(), n51, 0.01, {}),
        # past 227 KB of shared memory in the staged forward
        "widths_31_128_128_128_128_1": ([31, 128, 128, 128, 128, 1], 1000, n51, 0.01, {}),
        # past MAX_LAYERS on the pack-2 and the pack-4 route
        "nine_64_wide_layers": ([31] + [64] * 8 + [1], 1000, n51, 0.01, {}),
        "nine_24_wide_layers": ([11] + [24] * 8 + [1], 1000, cc_tensors(16, dev), 0.01, {}),
        # K = 1 and 2: no staged backward refuses a set at these K alone (the
        # layouts' own functions, searched on the host), so a 129-wide set
        # and the eight 64-wide layers of the unpacked route (246 KB)
        "widths_31_129_1_nodes_1": ([31, 129, 1], 1000, n1, 0.01, {}),
        "eight_64_wide_layers_unpacked_nodes_2": ([31] + [64] * 7 + [1], 1000, cc_tensors(1, dev),
                                                  0.01, UNPACKED),
        "padded_101_nodes": ([31, 129, 1], 1000, padded_cc_quadrature(50, 100, dev), 0.01, {}),
        "relu_neg_slope_0": ([31, 200, 37, 1], 1000, n51, 0.0, {}),
        "x_zero": ([31, 129, 1], 1000, n51, 0.01, {}),
        # the product kernel's edges: 3,927 items, no multiple of its
        # 128-row tiles; widths no multiple of 4 (its scalar instances); a
        # last chunk of 3 rows (2,570 rows a chunk at these widths); a dW
        # product's 10,200 items in 20 slices of 512; h at an address no
        # multiple of 16 bytes with e = 8 (the scalar instance where the
        # vector one would read misaligned)
        "items_3927": ([31, 256, 256, 1], 77, n51, 0.01, {}),
        "widths_31_129_129_1": ([31, 129, 129, 1], 1000, n51, 0.01, {}),
        "last_chunk_of_3_rows": (WIDE_WIDTHS, 2573, n51, 0.01, {}),
        "dw_in_20_slices": ([31, 129, 64, 1], 200, n51, 0.01, {}),
        "h_misaligned": ([9, 132, 132, 1], 1000, cc_tensors(16, dev), 0.01, {}),
    }
    errs, bwd_errs, auto_errs, kinks = {}, {}, {}, {}
    blocks = {}
    for case, (widths, rows, (nodes, ccw), slope, kw) in sets.items():
        ws, bs, h = integrand_inputs(gen, widths, rows, dev)
        if case == "h_misaligned":
            h = torch.cat([h.new_zeros(1), h.reshape(-1)])[1:].view(h.shape)
            check(h.is_contiguous() and h.data_ptr() % 16 != 0, "wide: h must be misaligned")
        x = torch.zeros(rows, device=dev) if case == "x_zero" else x_cal[:rows]
        g = torch.randn(rows, generator=gen).to(dev)
        with torch.inference_mode():
            before = dict(ik.LAUNCHES)
            got = ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, neg_slope=slope, **kw)
            torch.cuda.synchronize()
            check(launched_since(before) == {"integrand_fwd_wide": 1},
                  f"wide {case}: launched {launched_since(before)}")
            want = ik.fused_cc_integral_plain(ws, bs, x, h, nodes, ccw, neg_slope=slope)
            errs[case] = compare(got, want, KERNEL_TOL, f"wide {case}")
            if case == "x_zero":
                check(bool((got == 0).all()), "wide: x=0 must give z=0")
        args = (ws, bs, x, h, nodes, ccw, g, slope)
        pos, items, n_rows = kernel_branches(ws, bs, x, h, nodes, slope)
        want = bwd_plain64(*args, pos=pos)
        want64 = bwd_plain64(*args)
        plain = ik.fused_cc_integral_bwd_plain(*args)
        before = dict(ik.LAUNCHES)
        got = ik.fused_cc_integral_bwd(*args, **kw)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_bwd_wide": 1},
              f"wide {case} backward: launched {launched_since(before)}")
        bwd_errs[case] = worst(compare_bwd(got, plain, want, f"wide {case}", want64))
        kinks[case] = {"items_on_other_side": items, "rows_holding_one": n_rows}
        before = dict(ik.LAUNCHES)
        auto = bwd_through_autograd(*args, **kw)
        torch.cuda.synchronize()
        check(launched_since(before) == {"integrand_fwd_wide": 1, "integrand_bwd_wide": 1},
              f"wide {case} via autograd: launched {launched_since(before)}")
        auto_errs[case] = worst(compare_bwd(auto, plain[:4], want[:4], f"wide {case} via autograd",
                                            want64[:4]))
        if case == "x_zero":
            check(all(bool((d == 0).all()) for d in got[0]), "wide: x=0 must give dW=0")
        if case == "timing_block":
            blocks[case] = args
        del want, want64, plain, got, auto, pos
    # two runs agree bit for bit: slices of each dW added in order, chunks in order
    ws, bs, x, h, nodes, ccw, g, _ = blocks["timing_block"]
    with torch.inference_mode():
        first = ik.fused_cc_integral(ws, bs, x, h, nodes, ccw)
        check(bool(torch.equal(first, ik.fused_cc_integral(ws, bs, x, h, nodes, ccw))),
              "wide: two forward runs must agree bit for bit")
    first = ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, g)
    again = ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, g)
    check(all(torch.equal(a, b) for a, b in zip(first[0] + first[1] + list(first[2:]),
                                                 again[0] + again[1] + list(again[2:]))),
          "wide: two backward runs must agree bit for bit")
    chunks = len(ik._wide_chunks(x.numel(), nodes.numel(), WIDE_WIDTHS))
    check([b - a for a, b in ik._wide_chunks(2573, nodes.numel(), WIDE_WIDTHS)][-1] == 3,
          "wide: case last_chunk_of_3_rows must end in a chunk of 3 rows")

    # the main path: the 129-wide flow's ll and gradients on the kernel
    # route against the Leibniz route, under "auto" and "kernel"
    x0 = torch.as_tensor(np.random.RandomState(5).randn(WIDE_BATCH, WIDE_FLOW["nb_in"])
                         .astype(np.float32), device=dev)
    plain_flow = UMNNMAFFlow(**WIDE_FLOW, backend="torch", seed=0)
    flows = {}
    for backend in ("auto", "kernel"):
        flow = UMNNMAFFlow(**WIDE_FLOW, backend=backend, seed=0)
        for k in ik.LAUNCHES:
            ik.LAUNCHES[k] = 0
        loss_err, gap = route_gaps(flow, plain_flow, f"wide flow {backend}", x0)
        torch.cuda.synchronize()
        launches = dict(ik.LAUNCHES)
        n = WIDE_FLOW["nb_flow"]
        want = {**NONE_LAUNCHED, "integrand_fwd_wide": n, "integrand_bwd_wide": n}
        check(launches == want, f"wide flow {backend}: launches {launches}, want {want}")
        with torch.inference_mode():
            ll = compare(flow.compute_ll(x0)[0], plain_flow.compute_ll(x0)[0], SLICE_TOL,
                         f"wide flow {backend} ll")
        flows[backend] = {"launches": launches, "loss": loss_err, "ll": ll, **gap}
        plain_flow.zero_grad()

    # the main path at full width: ll and gradients of WIDE_TRAIN_FLOW on
    # the kernel route against the Leibniz route, then its training step,
    # every launch counted from 0
    x1 = torch.as_tensor(np.random.RandomState(6).randn(CALIB_BATCH, CALIB["nb_in"])
                         .astype(np.float32), device=dev)
    flow = UMNNMAFFlow(**WIDE_TRAIN_FLOW, backend="auto", seed=0)
    plain_flow = UMNNMAFFlow(**WIDE_TRAIN_FLOW, backend="torch", seed=0)
    loss_err, gap = route_gaps(flow, plain_flow, "wide train flow", x1)
    with torch.inference_mode():
        ll = compare(flow.compute_ll(x1)[0], plain_flow.compute_ll(x1)[0], SLICE_TOL,
                     "wide train flow ll")
    flow.zero_grad()
    plain_flow.zero_grad()
    step_k, step_p = trainer(flow), trainer(plain_flow)
    launches = step_launches(step_k, x1)
    n = WIDE_TRAIN_FLOW["nb_flow"]
    want = {**NONE_LAUNCHED, "integrand_fwd_wide": n, "integrand_bwd_wide": n}
    check(launches == want, f"wide train flow: launches in one step {launches}, want {want}")
    train = {"widths": [1 + CALIB["embedding_s"], *WIDE_TRAIN_FLOW["hidden_derivative"], 1],
             "batch": CALIB_BATCH, "launches_per_step": launches, "loss": loss_err, "ll": ll,
             **gap, "wide_train_step_ms": median_ms(lambda: step_k(x1), n=5, warmup=1),
             "wide_train_step_plain_ms": median_ms(lambda: step_p(x1), n=5, warmup=1)}
    del flow, plain_flow, step_k, step_p

    # timing at the timing block
    R, K = x.numel(), nodes.numel()
    t = {"rows": R, "nodes": K, "widths": WIDE_WIDTHS, "row_chunks": chunks}
    with torch.inference_mode():
        fwd = lambda: ik.fused_cc_integral(ws, bs, x, h, nodes, ccw)  # noqa: E731
        t["fwd_ms"] = median_ms(fwd, n=5, warmup=1)
        t["fwd_plain_ms"] = median_ms(
            lambda: ik.fused_cc_integral_plain(ws, bs, x, h, nodes, ccw), n=5, warmup=1)
    bwd = lambda: ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, g)  # noqa: E731
    t["bwd_ms"] = median_ms(bwd, n=5, warmup=1)
    t["bwd_plain_ms"] = median_ms(
        lambda: ik.fused_cc_integral_bwd_plain(ws, bs, x, h, nodes, ccw, g), n=5, warmup=1)
    # per kernel and launch (profiler), cuBLAS's time for the same products
    t["split"] = wide_split.measure(ws, bs, x, h, nodes, ccw, g)
    for kind in ("fwd", "bwd"):
        part = t["split"][kind]
        t[f"{kind}_device_ms"] = part["device_ms"]
        t[f"{kind}_kernels_per_call"] = part["kernels_per_call"]
        t[f"{kind}_cublas_ms"] = t["split"][f"{kind}_cublas_ms"]
        t[f"{kind}_product_tflops"] = part["product_gflop"] / part["by_kind"]["gemm"]
    t["fwd_bound"] = bound(kernel_flops(WIDE_WIDTHS, R, K), kernel_bytes(WIDE_WIDTHS, R, K), name)
    t["bwd_bound"] = bound(bwd_kernel_flops(WIDE_WIDTHS, R, K), bwd_kernel_bytes(WIDE_WIDTHS, R, K),
                           name)
    t["fwd_device_bound_share"] = t["fwd_bound"]["bound_ms"] / t["fwd_device_ms"]
    t["bwd_device_bound_share"] = t["bwd_bound"]["bound_ms"] / t["bwd_device_ms"]
    report("wide", tol=KERNEL_TOL, cases=errs, cases_backward=bwd_errs,
           cases_via_autograd=auto_errs, kinks=kinks,
           reference="plain version in float64 on the kernel's sides of each LeakyReLU",
           flow=flows, train_flow=train, timing=t, phase_seconds=time.perf_counter() - t0)
    return (errs, {**bwd_errs, **{f"{k}_autograd": v for k, v in auto_errs.items()}},
            launches, t)



def pack4_host_and_floor(ws, bs, x, h, nodes, ccw, g) -> dict:
    """The host breakdown of a pack-4 forward and backward call on these
    inputs, and the launch floor at each kernel's own launch shape (the
    backward's with its reduction, (P + 31) / 32 blocks of 256 threads)."""
    widths = [h.shape[-1] + 1] + [w.shape[0] for w in ws]
    R, K = x.numel(), nodes.numel()
    P = sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    t = {}
    with torch.inference_mode():
        t["fwd_p4_host_us"] = host_breakdown(
            lambda: ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, pack4=True), "fwd_p4")
    t["bwd_p4_host_us"] = host_breakdown(
        lambda: ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, g, pack4=True), "bwd_p4")
    for kind in ("fwd", "bwd"):
        shape = launch_shape(f"{kind}_p4", widths, K, R)
        t[f"{kind}_p4_launch_shape"] = shape
        launch = (shape["blocks"], shape["threads"], shape["smem_bytes"])
        t[f"{kind}_p4_launch_floor_ms"] = launch_floor_ms(*launch)
    t["bwd_p4_pair_launch_floor_ms"] = launch_floor_ms(*launch, (P + 31) // 32, 256)
    return t


def time_pack4(cases, g_all, flow, step_k, step_p, x_toy, name: str) -> tuple:
    """The pack-4 pair at the toy block (R = 512) and the 4,096-row block,
    beside the pack-2 and unpacked pairs on the same inputs and the plain
    versions, with its host breakdown and launch floors; then the toy
    training step on the Leibniz route and on the kernel route with its
    blocks on each pair in turn (the A/B of scripts/pack4_ab.py), with the
    kernel route's profile."""
    pairs = (("p4", {"pack4": True}, "_p4"), ("p2", {"pack2": True, "pack4": False}, "_p2"),
             ("unpacked", {"pack2": False, "pack4": False}, ""))
    out = {}
    for block in ("toy_block", "b2048_block"):
        (ws, bs, nodes, ccw), x, h, _ = cases[block]
        g = g_all[: x.numel()]
        widths, R, K = [h.shape[1] + 1] + [w.shape[0] for w in ws], x.numel(), nodes.numel()
        t = {"rows": R, "nodes": K, "widths": widths}
        with torch.inference_mode():
            for label, kw, suffix in pairs:
                call = lambda: ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, **kw)  # noqa: E731
                t[f"fwd_{label}_ms"] = median_ms(call, n=20, warmup=5)
                t[f"fwd_{label}_device_ms"] = device_ms(call, f"integrand_fwd{suffix}")
            t["fwd_plain_ms"] = median_ms(
                lambda: ik.fused_cc_integral_plain(ws, bs, x, h, nodes, ccw), n=20, warmup=5)
        for label, kw, suffix in pairs:
            call = lambda: ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, g, **kw)  # noqa: E731
            t[f"bwd_{label}_ms"] = median_ms(call, n=20, warmup=5)
            t[f"bwd_{label}_device_ms"] = device_ms(call, f"integrand_bwd{suffix}")
        t["bwd_plain_ms"] = median_ms(
            lambda: ik.fused_cc_integral_bwd_plain(ws, bs, x, h, nodes, ccw, g), n=10)
        t["fwd_bound"] = bound(kernel_flops(widths, R, K), kernel_bytes(widths, R, K), name)
        t["bwd_bound"] = bound(bwd_kernel_flops(widths, R, K), bwd_kernel_bytes(widths, R, K), name)
        t.update(pack4_host_and_floor(ws, bs, x, h, nodes, ccw, g))
        for kind in ("fwd", "bwd"):
            bound_ms = t[f"{kind}_bound"]["bound_ms"]
            t[f"{kind}_p4_device_bound_share"] = bound_ms / t[f"{kind}_p4_device_ms"]
            t[f"{kind}_p4_device_against_p2"] = t[f"{kind}_p4_device_ms"] / t[f"{kind}_p2_device_ms"]
        out[block] = t
    steps = {"toy_train_step_plain_ms": median_ms(lambda: step_p(x_toy), n=10, warmup=2)}
    for label, kw, suffix in pairs + pairs[::-1]:  # two rounds, the second in reverse
        for block in flow.blocks:
            block.pack2, block.pack4 = kw.get("pack2"), kw.get("pack4")
        launched = step_launches(step_k, x_toy)
        want = {**NONE_LAUNCHED, f"integrand_fwd{suffix}": 1, f"integrand_bwd{suffix}": 1}
        check(launched == want, f"timing: toy step on {label} launched {launched}, want {want}")
        steps.setdefault(f"toy_train_step_{label}_ms", []).append(
            median_ms(lambda: step_k(x_toy), n=10, warmup=2))
    for block in flow.blocks:
        block.pack2 = block.pack4 = None  # auto: the pack-4 pair again
    steps["toy_train_step_ms"] = median_ms(lambda: step_k(x_toy), n=10, warmup=2)
    profile = step_profile(step_k, x_toy)
    profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / steps["toy_train_step_ms"]
    return out, steps, profile


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def vae_batch(dev, n: int = VAE_BATCH) -> torch.Tensor:
    data = load_vae_dataset("mnist", synthetic=True)
    return torch.as_tensor(data.trn[:n], device=dev).reshape(-1, 1, 28, 28)


def vae_loss(model, x, gen, **quad):
    out = model(x, gen, **quad)
    loss = calculate_loss(out[0], x, out[1], out[2], out[4], out[5], out[3], model.input_type,
                          model.input_size)[0]
    return loss, out


def vae_routes(hidden, dev, what: str, **quad) -> tuple:
    """MMAVAE at ``hidden`` on the kernel route ("auto") against "torch"
    (the same seeded weights, the same noise): x_mean, ldj and the loss
    within SLICE_TOL, every gradient within TRAIN_GRAD_GAP. Returns the
    errors and the kernel-route model."""
    kw = dict(VAE_KW, hidden_derivative=hidden, seed=0)
    model = MMAVAE(**kw, backend="auto")
    plain = MMAVAE(**kw, backend="torch")
    x = vae_batch(dev)
    loss_k, out_k = vae_loss(model, x, torch.Generator(device=dev).manual_seed(5), **quad)
    loss_k.backward()
    loss_p, out_p = vae_loss(plain, x, torch.Generator(device=dev).manual_seed(5), **quad)
    loss_p.backward()
    torch.cuda.synchronize()
    res = {"x_mean": compare(out_k[0].detach(), out_p[0].detach(), SLICE_TOL, f"{what} x_mean"),
           "ldj": compare(out_k[3].detach(), out_p[3].detach(), SLICE_TOL, f"{what} ldj"),
           "loss": compare(loss_k.detach(), loss_p.detach(), SLICE_TOL, f"{what} loss"),
           **grad_gaps(model, plain, what)}
    return res, model


def tf32_flags() -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on


@contextlib.contextmanager
def tf32_seen():
    """The TF32 flags at every gated convolution's forward and every
    backward pass run inside the block, appended to the list it yields."""
    seen, real = [], {}
    for cls in (vae_layers.GatedConv2d, vae_layers.GatedConvTranspose2d, torch.Tensor):
        name = "backward" if cls is torch.Tensor else "forward"
        real[cls] = fn = getattr(cls, name)

        def spy(self, *a, fn=fn, **k):
            seen.append(tf32_flags())
            return fn(self, *a, **k)

        setattr(cls, name, spy)
    try:
        yield seen
    finally:
        for cls, fn in real.items():
            setattr(cls, "backward" if cls is torch.Tensor else "forward", fn)


def vae_tf32_unchanged(model, dev) -> dict:
    """The kernel route's forward with the caller's TF32 flags switched on
    after the model was built, against the same forward with them off: the
    model runs in IEEE float32 by itself and gives back the flags as it
    found them. TF32 would move x_mean by about 1e-3."""
    x = vae_batch(dev)
    outs = []
    for on in (False, True):
        set_tf32(on)
        with torch.inference_mode(), tf32_seen() as seen:
            loss, out = vae_loss(model, x, torch.Generator(device=dev).manual_seed(5))
        check(tf32_flags() == (on, on), f"vae: the forward left the TF32 flags {tf32_flags()}")
        check(len(seen) == 12 and not any(map(any, seen)),
              f"vae: a gated convolution ran with the TF32 flags {seen}")
        outs.append((out[0], out[3], loss))
    set_tf32(False)  # main's setting
    diff = {k: float((a - b).abs().max()) for k, a, b in zip(("x_mean", "ldj", "loss"), *outs)}
    check(diff["x_mean"] <= 1e-6 and diff["ldj"] <= 1e-6 * float(outs[0][1].abs().max())
          and diff["loss"] <= 1e-6 * float(outs[0][2].abs()),
          f"vae: the forward under the caller's TF32 differs from IEEE float32 by {diff}")
    return diff


def vae_step(model, dev, **quad):
    """The driver's training step: Adamax, no clip, has_aux."""
    opt = make_optimizer(model.parameters(), "adamax", 5e-4, grad_clip=None)
    gen = torch.Generator(device=dev).manual_seed(7)

    def loss_fn(x):
        loss, _ = vae_loss(model, x, gen, **quad)
        return loss, ()

    return make_train_step(loss_fn, opt, has_aux=True)


def vae_flow_logdet(model, x, dev, what: str) -> dict:
    """The posterior flow's log-det against log|det dz_k/dz_0| from float64
    autodiff on 4 rows, on the model's own features."""
    model = model.double()
    x = x[:4].double()
    with torch.no_grad():
        h = model.encode_features(x)
    z0 = torch.randn(4, model.z_size, dtype=torch.float64, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    with torch.no_grad():
        _, ldj = model.transform(h, z0)
    want = torch.stack([
        torch.linalg.slogdet(torch.autograd.functional.jacobian(
            lambda v: model.transform(h[i : i + 1], v[None])[0][0], z0[i]))[1]
        for i in range(4)])
    model.float()
    return compare(ldj, want, LOGDET_TOL, f"{what} log-det")


def vae_kernel_blocks(dev, name) -> dict:
    """The pairs at the VAE's blocks against their plain versions (forward
    within KERNEL_TOL, backward by phase bwd's rule), with device times
    beside bounds: the unpacked pair at R = 6,400, K = 51 and 101, the
    pack-2 pair at the class default's widths, R = 6,400, K = 51, and the
    unpacked forward at an IWAE call's R = 256,000, K = 101."""
    gen = torch.Generator().manual_seed(19)
    out = {}
    cases = [("unpacked_K51", VAE_WIDTHS, VAE_ROWS, 50, False, True),
             ("unpacked_K101", VAE_WIDTHS, VAE_ROWS, 100, False, True),
             ("pack2_K51", VAE_P2_WIDTHS, VAE_ROWS, 50, True, True),
             ("iwae_unpacked_K101", VAE_WIDTHS, IWAE_ROWS, 100, False, False)]
    for label, widths, R, steps, pack2, with_bwd in cases:
        ws, bs, h = integrand_inputs(gen, widths, R, dev)
        x = (1.5 * torch.randn(R, generator=gen)).to(dev)
        nodes, ccw = cc_tensors(steps, dev)
        K = nodes.numel()
        fk, bk = ("integrand_fwd_p2", "integrand_bwd_p2") if pack2 else ("integrand_fwd",
                                                                         "integrand_bwd")
        with torch.inference_mode():
            fwd = lambda: ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, pack2=pack2)  # noqa: E731
            plain = lambda: ik.fused_cc_integral_plain(ws, bs, x, h, nodes, ccw)  # noqa: E731
            err = compare(fwd(), plain(), KERNEL_TOL, f"vae {label} fwd")
            b = bound(kernel_flops(widths, R, K), kernel_bytes(widths, R, K), name)
            dms = device_ms(fwd, fk, n=10)
            entry = {fk: {"rows": R, "nodes": K, "widths": widths, **err,
                          "ms": median_ms(fwd, n=10), "device_ms_per_launch": dms,
                          "plain_ms": median_ms(plain, n=3, warmup=1), "bound_ms": b["bound_ms"],
                          "bound_by": b["bound_by"], "device_bound_share": b["bound_ms"] / dms}}
        if with_bwd:
            g = torch.randn(R, generator=gen).to(dev)
            args = (ws, bs, x, h, nodes, ccw, g)
            call = lambda: ik.fused_cc_integral_bwd(*args, pack2=pack2)  # noqa: E731
            # the pack-2 backward against float64 on its own sides of each
            # LeakyReLU, as phase bwd_p2 holds it
            pos = kernel_branches(ws, bs, x, h, nodes, 0.01)[0] if pack2 else None
            err = worst(compare_bwd(call(), ik.fused_cc_integral_bwd_plain(*args),
                                    bwd_plain64(*args, 0.01, pos=pos), f"vae {label} bwd",
                                    bwd_plain64(*args, 0.01) if pack2 else None))
            del pos
            b = bound(bwd_kernel_flops(widths, R, K), bwd_kernel_bytes(widths, R, K), name)
            dms = device_ms(call, bk, n=10)
            entry[bk] = {"rows": R, "nodes": K, "widths": widths, **err,
                         "ms": median_ms(call, n=10), "device_ms_per_launch": dms,
                         "plain_ms": median_ms(lambda: ik.fused_cc_integral_bwd_plain(*args),
                                               n=3, warmup=1),
                         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                         "device_bound_share": b["bound_ms"] / dms}
        out[label] = entry
    return out


def phase_vae(dev, name):
    """The VAE slice on the card: MMAVAE's routes at the driver's widths at
    K = 51 and 101 and at the pack-2 widths, with their launches a training
    step and an evaluation batch; the h each launch sees; the pairs at the
    VAE's blocks and an IWAE call's; the training step's time and idle
    share; one step of each other flow family and its log-det against
    float64 autodiff; the driver on the binary and Freyfaces stand-ins
    against their optima, -eval_only; IEEE float32 in the model's forward
    and the driver's whole run with the caller's TF32 flags on; the
    data-parallel step under an NCCL group of one. Returns the blocks'
    times and the launches of the phase's main-path runs."""
    t0 = time.perf_counter()
    counted = {k: 0 for k in ik.LAUNCHES}

    def count(launches):
        for k, v in launches.items():
            counted[k] += v

    routes, model = {}, None
    routes["unpacked_K51"], model = vae_routes(VAE_HIDDEN, dev, "vae K51")
    tf32 = {"forward_max_abs_diff": vae_tf32_unchanged(model, dev)}
    pad_n, pad_w = padded_cc_quadrature(VAE_RANDOM_STEPS, 100, dev)
    routes["unpacked_K101_padded"], _ = vae_routes(VAE_HIDDEN, dev, "vae K101",
                                                   nodes=pad_n, weights=pad_w)
    routes["pack2_K51"], model_p2 = vae_routes(VAE_P2_HIDDEN, dev, "vae pack-2 K51")
    x = vae_batch(dev)

    # launches: a training step at K = 51 and K = 101, an evaluation batch;
    # the h the kernel sees
    seen = []
    real = umnn_maf.fused_cc_integral

    def spy(ws, bs, xx, h, *a, **k):
        seen.append(tuple(h.shape))
        return real(ws, bs, xx, h, *a, **k)

    launches = {}
    for label, m, quad, fk, bk in (
        ("step_K51", model, {}, "integrand_fwd", "integrand_bwd"),
        ("step_K101", model, {"nodes": pad_n, "weights": pad_w}, "integrand_fwd", "integrand_bwd"),
        ("pack2_step_K51", model_p2, {}, "integrand_fwd_p2", "integrand_bwd_p2"),
    ):
        step = vae_step(m, dev, **quad)
        umnn_maf.fused_cc_integral = spy
        try:
            launches[label] = step_launches(step, x)
        finally:
            umnn_maf.fused_cc_integral = real
        n = VAE_KW["num_flows"]
        want = {**NONE_LAUNCHED, fk: n, bk: n}
        check(launches[label] == want, f"vae {label}: launches {launches[label]}, want {want}")
        count(launches[label])
    # h [B, D, e]: R = B * D rows of e = 30 columns each
    check(set(seen) == {(VAE_BATCH, VAE_KW["z_size"], VAE_KW["embedding_size"])},
          f"vae: the kernel saw h of shapes {set(seen)}")
    eval_n, eval_w = padded_cc_quadrature(100, 100, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.inference_mode():
        launches["eval_batch"] = step_launches(
            lambda xx: vae_loss(model, xx, gen, nodes=eval_n, weights=eval_w), x)
    want = {**NONE_LAUNCHED, "integrand_fwd": VAE_KW["num_flows"]}
    check(launches["eval_batch"] == want, f"vae eval: launches {launches['eval_batch']}")
    count(launches["eval_batch"])
    del model_p2

    blocks = vae_kernel_blocks(dev, name)
    step = vae_step(model, dev)
    step_ms = median_ms(lambda: step(x), n=5, warmup=2)
    profile = step_profile(step, x)
    profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / step_ms
    del model, step

    families = {}
    for fam, extra in VAE_FAMILY_KW.items():
        m = VAE_FAMILIES[fam](z_size=VAE_KW["z_size"], num_flows=VAE_KW["num_flows"], seed=0,
                              **extra)
        fstep = vae_step(m, dev)
        loss, _ = fstep(x)
        finite = all(bool(torch.isfinite(p.grad).all()) for p in m.parameters()
                     if p.grad is not None)
        check(bool(torch.isfinite(loss)) and finite, f"vae {fam}: loss {loss} or a gradient")
        families[fam] = {"loss": float(loss), "step_ms": median_ms(lambda: fstep(x), n=3, warmup=1),
                         "log_det": vae_flow_logdet(m, x, dev, f"vae {fam}")}
        del m, fstep

    # the driver, TF32 on before it: it runs in IEEE float32 by itself
    folder = _build.BUILD_DIR.parent / "chip_smoke_vae"
    shutil.rmtree(folder, ignore_errors=True)
    drivers = {}
    for label, argv in (("mnist", VAE_DRIVER_ARGV), ("freyfaces", FREY_DRIVER_ARGV),
                        ("mnist_eval_only", VAE_DRIVER_ARGV + ["-eval_only"])):
        set_tf32(True)
        with tf32_seen() as calls:
            rc, lines, launched, seconds = run_driver(train_vae.main,
                                                      argv + ["-folder", str(folder)])
        check(tf32_flags() == (True, True), f"vae driver {label}: TF32 flags {tf32_flags()}")
        set_tf32(False)
        check(calls and not any(map(any, calls)),
              f"vae driver {label}: a convolution or backward pass ran in TF32")
        tf32[f"driver_{label}_calls_seen"] = len(calls)
        res = json.loads(lines[-1])
        check(rc == 0 and all(np.isfinite(v) for k, v in res.items()
                              if isinstance(v, float)), f"vae driver {label}: {rc} {lines[-3:]}")
        drivers[label] = {"argv": " ".join(argv), "rc": rc, "result": res, "launches": launched,
                          "seconds": seconds, "log": lines[-6:]}
        count(launched)
    nll = -drivers["mnist"]["result"]["test_iwae_ll"]
    check(nll >= BITS_NATS - VAE_NLL_SLACK,
          f"vae driver: test IWAE NLL {nll} below the stand-in's optimum {BITS_NATS}")
    bpd = drivers["freyfaces"]["result"]["test_bpd_ll"]
    check(bpd >= 8.0 - FREY_BPD_SLACK, f"vae driver freyfaces: test bpd {bpd} below 8")
    check(drivers["mnist_eval_only"]["result"]["best_valid_elbo"] is None,
          "vae driver -eval_only trained")
    # launches of the binary run: 6 steps an epoch, one validation and one
    # reconstruction batch an epoch, the test batch and 2 IWAE calls, each a
    # forward of every block
    n = VAE_KW["num_flows"]
    want = {**NONE_LAUNCHED, "integrand_fwd": n * (12 + 2 * 2 + 1 + 2), "integrand_bwd": n * 12}
    check(drivers["mnist"]["launches"] == want,
          f"vae driver: launched {drivers['mnist']['launches']}, want {want}")
    shutil.rmtree(folder, ignore_errors=True)

    # the data-parallel step under an NCCL group of one, then without a group
    port = free_port()
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=1, rank=0)
    try:
        grouped = multihost.run_multihost_step(1, 0, device=dev)
    finally:
        torch.distributed.destroy_process_group()
    alone = multihost.run_multihost_step(1, 0, device=dev)
    dp = {"nccl_group_of_one": grouped, "no_group": alone,
          "max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(grouped["losses"],
                                                                   alone["losses"]))}
    check(dp["max_rel_diff"] <= 1e-6 and grouped["n_devices"] == 1,
          f"vae: the NCCL step differs from the plain one {dp}")
    report("vae", device=name, nvidia_smi=nvidia_smi(), batch=VAE_BATCH, widths=VAE_WIDTHS,
           pack2_widths=VAE_P2_WIDTHS, rows=VAE_ROWS, tol=SLICE_TOL, grad_gap_tol=TRAIN_GRAD_GAP,
           routes=routes, tf32=tf32, launches=launches, kernel_h_shapes=sorted(set(seen)), blocks=blocks,
           vae_train_step_ms=step_ms, vae_train_step_profile=profile, families=families,
           drivers=drivers, iwae_nll=nll, optimum_nats=BITS_NATS, freyfaces_bpd_ll=bpd,
           data_parallel=dp, launches_counted=counted, phase_seconds=time.perf_counter() - t0)
    return blocks, counted


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    report("env", device=name, nvidia_smi=smi, count=torch.cuda.device_count(),
           torch=torch.__version__, cuda=torch.version.cuda)

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    ptxas = _build.ptxas_report()
    report("build", seconds=time.perf_counter() - t, nvcc=_build.find_nvcc(),
           library=str(lib_path.relative_to(_build.BUILD_DIR.parents[1])), ptxas=ptxas)
    gen = torch.Generator().manual_seed(0)
    data, floor_bpp = synthetic_mnist_ar1(seed=0, n=(0, 0, BATCH))
    rows = torch.as_tensor(data.tst_x, device=dev)  # [100, 784] logit space
    train_data, _ = synthetic_mnist_ar1(seed=1, n=(TRAIN_STEPS * BATCH, 0, 10))
    batches = torch.as_tensor(train_data.trn_x, device=dev).split(BATCH)
    nodes, ccw = cc_tensors(MNIST["nb_steps"], dev)
    K = nodes.numel()

    block, fwd_errs = phase_kernel(gen, rows, dev, nodes, ccw)
    g_main, bwd_errs = phase_bwd(gen, dev, nodes, ccw, block)
    flow, plain = phase_slice(rows, floor_bpp)
    step_k, step_p, launches, peak_bytes = phase_train(flow, plain, batches)
    calib = calib_block(gen, dev)
    fwd_p2_errs, fwd_p2_shape = phase_kernel_p2(gen, dev, calib)
    g_calib, bwd_p2_errs, bwd_p2_shape = phase_bwd_p2(gen, dev, calib)
    calib_k, calib_p, calib_x, calib_launches = phase_calibration(dev)
    uci_fwd_errs, uci_bwd_errs, uci_blocks_t, uci_launches, uci_driver_launches, uci_t = \
        phase_uci(gen, dev, name)
    p4c, fwd_p4_errs, fwd_p4_shape = phase_kernel_p4(gen, dev)
    g_p4, bwd_p4_errs, bwd_p4_shape = phase_bwd_p4(gen, dev, p4c)
    toy_flow, toy_k, toy_p, toy_x, toy_launches = phase_toy(dev)
    wide_fwd_errs, wide_bwd_errs, wide_launches, wide_t = phase_wide(gen, dev, calib, name)

    # --- timing -----------------------------------------------------------
    # ``*_ms`` from CUDA events around whole calls (the wrapper's host work
    # included), ``*_device_ms`` from the profiler (the kernel alone).
    ws, bs, x_main, h_main = block
    R = x_main.numel()
    with torch.inference_mode():
        fwd = lambda: ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw)  # noqa: E731
        fwd_ms = median_ms(fwd)
        fwd_device_ms = device_ms(fwd, "integrand_fwd", n=10)
        fwd_plain_ms = median_ms(lambda: ik.fused_cc_integral_plain(ws, bs, x_main, h_main, nodes, ccw))
        bpp_ms = median_ms(lambda: flow.compute_bpp(rows))
        bpp_plain_ms = median_ms(lambda: plain.compute_bpp(rows))
    bwd_args = (ws, bs, x_main, h_main, nodes, ccw, g_main)
    bwd = lambda: ik.fused_cc_integral_bwd(*bwd_args)  # noqa: E731
    bwd_ms = median_ms(bwd)
    bwd_device_ms = device_ms(bwd, "integrand_bwd", n=5)
    bwd_plain_ms = median_ms(lambda: ik.fused_cc_integral_bwd_plain(*bwd_args), n=5, warmup=1)
    train_ms = median_ms(lambda: step_k(batches[0]), n=5, warmup=1)
    train_plain_ms = median_ms(lambda: step_p(batches[0]), n=5, warmup=1)
    fwd_bound = bound(kernel_flops(WIDTHS, R, K), kernel_bytes(WIDTHS, R, K), name)
    bwd_bound = bound(bwd_kernel_flops(WIDTHS, R, K), bwd_kernel_bytes(WIDTHS, R, K), name)

    # the calibration block (R = 3,000, K = 51): the pack-2 pair, the
    # unpacked pair on the same inputs, the plain versions
    cws, cbs, cx, ch = calib
    cn, cc = cc_tensors(CALIB["nb_steps"], dev)
    CR, CK = cx.numel(), cn.numel()
    calib_t = {}
    with torch.inference_mode():
        for label, pack2 in (("fwd_p2", True), ("fwd_unpacked", False)):
            call = lambda: ik.fused_cc_integral(cws, cbs, cx, ch, cn, cc, pack2=pack2)  # noqa: E731
            calib_t[f"{label}_ms"] = median_ms(call, n=20, warmup=5)
            calib_t[f"{label}_device_ms"] = device_ms(
                call, "integrand_fwd_p2" if pack2 else "integrand_fwd")
        calib_t["fwd_plain_ms"] = median_ms(
            lambda: ik.fused_cc_integral_plain(cws, cbs, cx, ch, cn, cc), n=20, warmup=5)
    cargs = (cws, cbs, cx, ch, cn, cc, g_calib)
    for label, pack2 in (("bwd_p2", True), ("bwd_unpacked", False)):
        call = lambda: ik.fused_cc_integral_bwd(*cargs, pack2=pack2)  # noqa: E731
        calib_t[f"{label}_ms"] = median_ms(call, n=20, warmup=5)
        calib_t[f"{label}_device_ms"] = device_ms(
            call, "integrand_bwd_p2" if pack2 else "integrand_bwd")
    calib_t["bwd_plain_ms"] = median_ms(lambda: ik.fused_cc_integral_bwd_plain(*cargs), n=10)
    calib_t["calib_train_step_ms"] = median_ms(lambda: calib_k(calib_x), n=10, warmup=2)
    calib_t["calib_train_step_plain_ms"] = median_ms(lambda: calib_p(calib_x), n=10, warmup=2)
    calib_profile = step_profile(calib_k, calib_x)
    calib_profile["device_idle_share"] = (
        1.0 - calib_profile["device_busy_ms"] / calib_t["calib_train_step_ms"])
    fwd_p2_bound = bound(kernel_flops(CALIB_WIDTHS, CR, CK), kernel_bytes(CALIB_WIDTHS, CR, CK), name)
    bwd_p2_bound = bound(bwd_kernel_flops(CALIB_WIDTHS, CR, CK),
                         bwd_kernel_bytes(CALIB_WIDTHS, CR, CK), name)
    p4_t, toy_t, toy_profile = time_pack4(p4c, g_p4, toy_flow, toy_k, toy_p, toy_x, name)
    report("timing", fwd_kernel_ms=fwd_ms, fwd_kernel_device_ms=fwd_device_ms,
           fwd_plain_ms=fwd_plain_ms, fwd_bound=fwd_bound,
           bwd_kernel_ms=bwd_ms, bwd_kernel_device_ms=bwd_device_ms, bwd_plain_ms=bwd_plain_ms,
           fwd_device_bound_share=fwd_bound["bound_ms"] / fwd_device_ms,
           fwd_launch_shape=launch_shape("fwd", WIDTHS, K),
           fwd_device_ms_against_acceptance={"device_ms": fwd_device_ms, "limit_ms": FWD_ACCEPT_MS,
                                             "within": fwd_device_ms <= FWD_ACCEPT_MS},
           bwd_bound=bwd_bound, bwd_device_bound_share=bwd_bound["bound_ms"] / bwd_device_ms,
           bwd_launch_shape=launch_shape("bwd", WIDTHS, K),
           compute_bpp_ms=bpp_ms, compute_bpp_plain_ms=bpp_plain_ms,
           train_step_ms=train_ms, train_step_plain_ms=train_plain_ms,
           train_step_peak_mem_bytes=peak_bytes,
           fwd_tflops=fwd_bound["bound_flop"] / fwd_ms / 1e9,
           bwd_tflops=bwd_bound["bound_flop"] / bwd_ms / 1e9,
           fwd_device_tflops=fwd_bound["bound_flop"] / fwd_device_ms / 1e9,
           bwd_device_tflops=bwd_bound["bound_flop"] / bwd_device_ms / 1e9,
           calib_rows=CR, calib_nodes=CK, calib=calib_t,
           fwd_p2_bound=fwd_p2_bound, bwd_p2_bound=bwd_p2_bound,
           fwd_p2_tflops=fwd_p2_bound["bound_flop"] / calib_t["fwd_p2_ms"] / 1e9,
           bwd_p2_tflops=bwd_p2_bound["bound_flop"] / calib_t["bwd_p2_ms"] / 1e9,
           fwd_p2_device_tflops=fwd_p2_bound["bound_flop"] / calib_t["fwd_p2_device_ms"] / 1e9,
           bwd_p2_device_tflops=bwd_p2_bound["bound_flop"] / calib_t["bwd_p2_device_ms"] / 1e9,
           fwd_p2_device_bound_share=fwd_p2_bound["bound_ms"] / calib_t["fwd_p2_device_ms"],
           fwd_p2_launch_shape=fwd_p2_shape["calibration_block"],
           bwd_p2_device_bound_share=bwd_p2_bound["bound_ms"] / calib_t["bwd_p2_device_ms"],
           bwd_p2_launch_shape=bwd_p2_shape["calibration_block"],
           calib_train_step_profile=calib_profile, uci_train_step=uci_t, pack4_ab=p4_t,
           toy=toy_t,
           toy_train_step_profile=toy_profile)
    mono_t, mono_launches = phase_monotonic(dev, name, batches[0])
    vae_t, vae_launches = phase_vae(dev, name)
    # last: its ~50,000 unprofiled launches and long traces came before
    # phase wide's exact-count traces once, and one of those lost launches
    sample_res, sample_launches = phase_sample(dev, name)

    # ``ms`` (and its alias ``kernel_ms``) is a CUDA-event median of whole
    # wrapper calls, as in every earlier run; ``device_ms`` the kernel alone.
    def entry(kernel, tpu_kernel, line, errs, ms, dev_ms, plain_ms, b, n_launched,
              source=None, **more):
        # the streamed pair's entries name its file and every kernel of it
        source = source or f"{kernel}.cu"
        kernels = ([k for k in ptxas if k.startswith("integrand_wide_")]
                   if source == "integrand_wide.cu" else [f"{kernel}_kernel"])
        return {
            "name": kernel, "route": "cuda", "source": f"umnn_tpu_torch/csrc/{source}",
            "replaces": f"umnn_tpu/ops/integrand_kernel.py:{line}", "tpu_kernel": tpu_kernel,
            "launches": n_launched,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "tol_used": max(e["tol_used"] for e in errs.values()),
            "ms": ms, "kernel_ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "ptxas": ptxas[kernels[0]] if len(kernels) == 1 else {k: ptxas[k] for k in kernels},
            **more,
        }

    def p2_launches(kernel):
        return {"calibration_step": calib_launches[kernel],
                "uci_step_K51": uci_launches["step_K51"][kernel],
                "uci_step_K101": uci_launches["step_K101"][kernel],
                "uci_driver_run": uci_driver_launches[kernel],
                "monotonic": mono_launches[kernel],
                "vae": vae_launches[kernel],
                "sample": sample_launches[kernel]}

    def vae_times(kernel):
        """The kernel at the VAE's blocks: device ms a launch beside its bound."""
        return {label: block[kernel] for label, block in vae_t.items() if kernel in block}

    def sample_times(kernel):
        """The forward kernel at the sample phase's shapes: device ms a
        launch (profiler), beside its bound, per inversion."""
        runs = {k: r for k, r in sample_res.items() if k != "toy"}
        runs.update({f"toy_{d}": r["routes"]["kernel"] for d, r in sample_res["toy"].items()})
        return {k: {"rows": r["kernel_rows"], "bound_ms": r["kernel_bound"]["bound_ms"],
                    "device_ms_per_launch": r["profile"][f"{kernel}_ms_per_launch"],
                    "launches_in_trace": r["profile"][f"{kernel}_launches"]}
                for k, r in runs.items() if f"{kernel}_ms_per_launch" in r["profile"]}

    toy_block = p4_t["toy_block"]
    kernels = [
        entry("integrand_fwd", "_fwd_kernel", 106, fwd_errs, fwd_ms, fwd_device_ms,
              fwd_plain_ms, fwd_bound, launches["integrand_fwd"],
              launches_by_phase={"train_step": launches["integrand_fwd"],
                                 "monotonic": mono_launches["integrand_fwd"],
                                 "vae": vae_launches["integrand_fwd"],
                                 "sample": sample_launches["integrand_fwd"]},
              monotonic=mono_t["integrand_fwd"], vae=vae_times("integrand_fwd"),
              sample=sample_times("integrand_fwd")),
        entry("integrand_bwd", "_bwd_kernel", 156, bwd_errs, bwd_ms, bwd_device_ms,
              bwd_plain_ms, bwd_bound, launches["integrand_bwd"],
              launches_by_phase={"train_step": launches["integrand_bwd"],
                                 "monotonic": mono_launches["integrand_bwd"],
                                 "vae": vae_launches["integrand_bwd"]},
              monotonic=mono_t["integrand_bwd"], vae=vae_times("integrand_bwd")),
        # the calibration block's figures; the UCI driver's blocks in "uci"
        entry("integrand_fwd_p2", "_fwd_kernel_p2", 333, {**fwd_p2_errs, **uci_fwd_errs},
              calib_t["fwd_p2_ms"], calib_t["fwd_p2_device_ms"], calib_t["fwd_plain_ms"],
              fwd_p2_bound, calib_launches["integrand_fwd_p2"],
              launches_by_phase=p2_launches("integrand_fwd_p2"),
              uci={k: v["fwd"] for k, v in uci_blocks_t.items()},
              vae=vae_times("integrand_fwd_p2"), sample=sample_times("integrand_fwd_p2")),
        entry("integrand_bwd_p2", "_bwd_kernel_p2", 384, {**bwd_p2_errs, **uci_bwd_errs},
              calib_t["bwd_p2_ms"], calib_t["bwd_p2_device_ms"], calib_t["bwd_plain_ms"],
              bwd_p2_bound, calib_launches["integrand_bwd_p2"],
              launches_by_phase=p2_launches("integrand_bwd_p2"),
              uci={k: v["bwd"] for k, v in uci_blocks_t.items() if "bwd" in v},
              vae=vae_times("integrand_bwd_p2")),
        entry("integrand_fwd_p4", "_fwd_kernel_pn", 522, fwd_p4_errs,
              toy_block["fwd_p4_ms"], toy_block["fwd_p4_device_ms"], toy_block["fwd_plain_ms"],
              toy_block["fwd_bound"], toy_launches["integrand_fwd_p4"],
              launches_by_phase={"toy_step": toy_launches["integrand_fwd_p4"],
                                 "monotonic": mono_launches["integrand_fwd_p4"],
                                 "sample": sample_launches["integrand_fwd_p4"]},
              sample=sample_times("integrand_fwd_p4")),
        entry("integrand_bwd_p4", "_bwd_kernel_pn", 573, bwd_p4_errs,
              toy_block["bwd_p4_ms"], toy_block["bwd_p4_device_ms"], toy_block["bwd_plain_ms"],
              toy_block["bwd_bound"], toy_launches["integrand_bwd_p4"],
              launches_by_phase={"toy_step": toy_launches["integrand_bwd_p4"],
                                 "monotonic": mono_launches["integrand_bwd_p4"]}),
        # the port of _fwd_kernel and _bwd_kernel at the widths the staged
        # pairs refuse
        entry("integrand_fwd_wide", "_fwd_kernel", 106, wide_fwd_errs, wide_t["fwd_ms"],
              wide_t["fwd_device_ms"], wide_t["fwd_plain_ms"], wide_t["fwd_bound"],
              wide_launches["integrand_fwd_wide"], "integrand_wide.cu"),
        entry("integrand_bwd_wide", "_bwd_kernel", 156, wide_bwd_errs, wide_t["bwd_ms"],
              wide_t["bwd_device_ms"], wide_t["bwd_plain_ms"], wide_t["bwd_bound"],
              wide_launches["integrand_bwd_wide"], "integrand_wide.cu"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total {time.perf_counter() - T0:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
