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
           on the card, at one MNIST block's shape and at edge cases;
4. bwd     the backward integrand kernel, through the autograd Function and
           through its wrapper, against its plain version, at the MNIST
           block and edge cases; bit-identical reruns; refused widths;
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
           x = 0, x < 0, 77 rows, ReLU, the 64-wide limit); pack2=True on a
           65-wide layer raises, a 32-wide integrand goes to the pack-4 pair;
8. bwd_p2  the pack-2 backward kernel, through the autograd Function and
           through its wrapper, against the float64 plain version at the
           same cases; bit-identical reruns;
9. calibration  the full-width known-entropy calibration flow (random
           weights from a seed): gradients on the kernel route against the
           Leibniz route, 5 + 5 pack-2 launches per training step and none
           of the unpacked pair, then the port's calibration driver for 5
           epochs on full data, which must pass its 0.05-nat gate;
10. kernel_p4  the pack-4 forward kernel against its plain version at the
           toy flow's block (512 rows, 17 nodes, widths 11-32-32-1), a
           4,096-row block and the flagship's block (192 rows, 21 nodes,
           widths 9-32-32-1), and edge cases (K = 16, 18, 19, 101 padded
           nodes, x = 0, x < 0, 77 rows, ReLU, the 32-wide limit, eight
           layers); pack4=True on a 33-wide layer raises; auto takes the
           pack-4, pack-2 and unpacked pairs where JAX's auto does;
11. bwd_p4 the pack-4 backward kernel, through the autograd Function and
           through its wrapper, against the float64 plain version at the
           same cases, by bwd_p2's rule; bit-identical reruns;
12. toy    the flagship flow (2 blocks, D = 6) and the toy flow at the
           verify widths: gradients on the kernel route against the
           Leibniz route, 2 + 2 and 1 + 1 pack-4 launches per training
           step and no other integrand kernel; then the port's toy driver
           for 6 epochs on 8gaussians and on conditionnal8gaussians, whose
           test NLL must fall;
13. timing CUDA-event medians of whole calls and profiler device times of
           every kernel, their plain versions, compute_bpp and a training
           step of each flow, beside the kernels' bounds; the unpacked pair
           also at the calibration block, and the pack-2 and unpacked pairs
           beside the pack-4 pair at the toy and 4,096-row blocks, as the
           comparison routes.

Then a ``kernels`` line, the nvidia-smi name and power limit, and a last
line ``{"ok": true, "device": {...}}``. Any failed check raises, and the
run exits non-zero with its traceback; with no CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import contextlib
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
from umnn_tpu_torch.data.images import synthetic_mnist_ar1
from umnn_tpu_torch.data.toy import inf_train_gen
from umnn_tpu_torch.examples import train_calibration, train_toy
from umnn_tpu_torch.nn.core import torch_linear_init
from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors, padded_cc_quadrature
from umnn_tpu_torch.training.loops import make_optimizer, make_train_step

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
# The __graft_entry__.py flagship (:20-31): D = 6, 2 blocks, batch 32 (192 rows).
FLAGSHIP = dict(nb_flow=2, nb_in=6, hidden_derivative=(32, 32), hidden_embedding=(64, 64),
                embedding_s=8, nb_steps=20)
FLAGSHIP_BATCH = 32
FLAGSHIP_WIDTHS = [1 + FLAGSHIP["embedding_s"], *FLAGSHIP["hidden_derivative"], 1]
B2048 = 2048  # scripts/pack4_ab.py's larger toy batch (e = 8): 4,096 folded rows
NONE_LAUNCHED = {k: 0 for k in ik.LAUNCHES}

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
    reduction): a trace that lost one (seen once on the card, for one of
    five MNIST backward sweeps) is taken again, at most three times."""
    pattern = re.compile(rf"(?<![A-Za-z_]){kernel}_(kernel|reduce)(?![a-z0-9_])")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in _device_events(prof) if pattern.search(e.key)]
        counts = {e.key: e.count for e in hits}
        if any("_kernel" in k for k in counts) and all(c == n for c in counts.values()):
            return sum(e.device_time_total for e in hits) / n / 1e3
    raise AssertionError(f"profiler: launches of {kernel} seen in {n} calls: {counts}")


def step_profile(step, x, n: int = 5) -> dict:
    """Device time per training step, over ``n`` steps after 2 warm-ups:
    all kernels together, the integrand kernels by name, and the number of
    kernel launches."""
    for _ in range(2):
        step(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(x)
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
    cases = {
        "mnist_block": (mnist, x_main, h_main, 0.01),
        "x_zero": (mnist, torch.zeros(1000, device=dev), h_main[:1000], 0.01),
        "x_negative": (mnist, -x_main[:1000].abs() - 0.1, h_main[:1000], 0.01),
        "ragged_77_rows": (mnist, x_main[:77], h_main[:77], 0.01),
        "relu_neg_slope_0": (mnist, x_main[:4099], h_main[:4099], 0.0),
        "widths_31_100_1": ((ws1, bs1, nodes, ccw), x_other, h1, 0.01),
        "widths_31_128_64_1_21_nodes": ((ws2, bs2, *n21), x_other, h2, 0.01),
    }
    errs = {}
    with torch.inference_mode():
        for case, ((cws, cbs, cn, cw), x, h, slope) in cases.items():
            got = ik.fused_cc_integral(cws, cbs, x, h, cn, cw, neg_slope=slope)
            want = ik.fused_cc_integral_plain(cws, cbs, x, h, cn, cw, neg_slope=slope)
            torch.cuda.synchronize()
            errs[case] = compare(got, want, KERNEL_TOL, f"kernel {case}")
            if case == "x_zero":
                check(bool((got == 0).all()), "kernel: x=0 must give z=0")
            if case == "x_negative":
                check(bool((got < 0).all()), "kernel: x<0 must give z<0")
        again = ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw)
        first = ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw)
        check(bool(torch.equal(again, first)), "kernel: two runs must agree bit for bit")
        # what the kernel cannot take raises on the card, and launches nothing
        launched = dict(ik.LAUNCHES)
        ws3, bs3, h3 = integrand_inputs(gen, [31, 129, 1], 64, dev)
        small = UMNNMAFFlow(nb_flow=1, nb_in=4, hidden_derivative=(8,), hidden_embedding=(8,),
                            embedding_s=2, act_func="Sigmoid", backend="auto", seed=0)
        refused = {
            "hidden_width_129": lambda: ik.fused_cc_integral(ws3, bs3, x_main[:64], h3, nodes, ccw),
            "not_elu_on_auto": lambda: small.compute_ll(rows[:2, :4]),
        }
        for case, fn in refused.items():
            try:
                fn()
            except ValueError:
                continue
            raise AssertionError(f"kernel: {case} must raise, not compute")
        check(ik.LAUNCHES == launched, "kernel: a refused call must launch nothing")
    report("kernel", rows=x_main.numel(), nodes=K, widths=WIDTHS, tol=KERNEL_TOL, cases=errs,
           refused=list(refused))
    return (ws, bs, x_main, h_main), errs


def phase_bwd(gen, dev, nodes, ccw, block):
    ws, bs, x_main, h_main = block
    R = x_main.numel()
    g_main = torch.randn(R, generator=gen).to(dev)
    mnist = (ws, bs, nodes, ccw)
    p101 = padded_cc_quadrature(50, 100, dev)  # K = 101, randomized-steps training
    x_other, g_other = x_main[:5000], g_main[:5000]
    ws1, bs1, h1 = integrand_inputs(gen, [31, 100, 1], x_other.numel(), dev)
    ws2, bs2, h2 = integrand_inputs(gen, [31, 128, 64, 1], x_other.numel(), dev)
    cases = {
        "mnist_block": (mnist, x_main, h_main, g_main, 0.01),
        "x_zero": (mnist, torch.zeros(1000, device=dev), h_main[:1000], g_main[:1000], 0.01),
        "x_negative": (mnist, -x_main[:1000].abs() - 0.1, h_main[:1000], g_main[:1000], 0.01),
        "ragged_77_rows": (mnist, x_main[:77], h_main[:77], g_main[:77], 0.01),
        "relu_neg_slope_0": (mnist, x_main[:4099], h_main[:4099], g_main[:4099], 0.0),
        "padded_101_nodes": ((ws, bs, *p101), x_main[:3000], h_main[:3000], g_main[:3000], 0.01),
        "widths_31_100_1": ((ws1, bs1, nodes, ccw), x_other, h1, g_other, 0.01),
        "widths_31_128_64_1": ((ws2, bs2, nodes, ccw), x_other, h2, g_other, 0.01),
    }
    errs, auto_errs = {}, {}
    for case, ((cws, cbs, cn, cw), x, h, g, slope) in cases.items():
        want = bwd_plain64(cws, cbs, x, h, cn, cw, g, slope)
        plain = ik.fused_cc_integral_bwd_plain(cws, cbs, x, h, cn, cw, g, slope)
        got = ik.fused_cc_integral_bwd(cws, cbs, x, h, cn, cw, g, slope)
        torch.cuda.synchronize()
        errs[case] = worst(compare_bwd(got, plain, want, f"bwd {case}"))
        auto = bwd_through_autograd(cws, cbs, x, h, cn, cw, g, slope)
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
    # widths the backward cannot take raise before any launch, also those
    # whose forward alone would fit (eight 64-wide layers: 189 KB forward,
    # 252 KB backward)
    launched = dict(ik.LAUNCHES)
    ws3, bs3, h3 = integrand_inputs(gen, [31, 129, 1], 64, dev)
    ws4, bs4, h4 = integrand_inputs(gen, [31] + [64] * 7 + [1], 64, dev)
    x64, g64 = x_main[:64], g_main[:64]
    refused = {
        "hidden_width_129": lambda: ik.fused_cc_integral_bwd(ws3, bs3, x64, h3, nodes, ccw, g64),
        "bwd_smem_eight_64_layers": lambda: bwd_through_autograd(ws4, bs4, x64, h4, nodes, ccw, g64, 0.01),
    }
    for case, fn in refused.items():
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError(f"bwd: {case} must raise, not compute")
    check(ik.LAUNCHES == launched, "bwd: a refused call must launch nothing")
    with torch.inference_mode():  # the forward alone takes the eight 64-wide layers
        ik.fused_cc_integral(ws4, bs4, x64, h4, nodes, ccw)
    report("bwd", rows=R, nodes=nodes.numel(), widths=WIDTHS,
           reference="plain version in float64",
           tol={"row_scale": BWD_ROW_SCALE, "param_scale": BWD_PARAM_SCALE,
                "plain_factor": BWD_PLAIN_FACTOR},
           cases=errs, cases_via_autograd=auto_errs, refused=list(refused))
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


def route_gaps(flow, plain, what: str, *batch) -> tuple:
    """``-mean(compute_ll)`` and its gradients on the kernel route (``flow``)
    against the Leibniz route (``plain``, the same seeded weights): the loss
    within SLICE_TOL, every parameter gradient within TRAIN_GRAD_GAP of its
    tensor's largest entry. Returns the loss's errors and the largest gap."""
    loss_k = -flow.compute_ll(*batch)[0].mean()
    loss_k.backward()
    loss_p = -plain.compute_ll(*batch)[0].mean()
    loss_p.backward()
    torch.cuda.synchronize()
    loss_err = compare(loss_k.detach(), loss_p.detach(), SLICE_TOL, f"{what} loss")
    gaps = {}
    for (pname, a), b in zip(flow.named_parameters(), plain.parameters()):
        check(a.grad is not None and bool(torch.isfinite(a.grad).all()), f"{what}: grad of {pname}")
        gaps[pname] = float((a.grad - b.grad).abs().max() / (b.grad.abs().max() + 1e-30))
    name = max(gaps, key=gaps.get)
    check(gaps[name] <= TRAIN_GRAD_GAP,
          f"{what}: gradient of {name} differs between routes by {gaps[name]}")
    return loss_err, {"grad_gap_max": gaps[name], "grad_gap_param": name}


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


def phase_kernel_p2(gen, dev, calib):
    """integrand_fwd_p2 against its plain version at the pack-2 cases, then
    what it must refuse or leave to the unpacked pair."""
    cases = p2_cases(gen, dev, calib)
    ws, bs, x_main, h_main = calib
    nodes, ccw = cc_tensors(CALIB["nb_steps"], dev)
    errs = {}
    with torch.inference_mode():
        for case, ((cws, cbs, cn, cw), x, h, _, slope) in cases.items():
            before = dict(ik.LAUNCHES)
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
    report("kernel_p2", rows=x_main.numel(), nodes=nodes.numel(), widths=CALIB_WIDTHS,
           tol=KERNEL_TOL, cases=errs, refused=["pack2_hidden_width_65"],
           pack4_under_auto=["widths_31_32_32_1"])
    return errs


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
    report("bwd_p2", rows=x_main.numel(), nodes=nodes.numel(), widths=CALIB_WIDTHS,
           reference="plain version in float64 on the kernel's sides of each LeakyReLU",
           tol={"row_scale": BWD_ROW_SCALE, "param_scale": BWD_PARAM_SCALE,
                "plain_factor": BWD_PLAIN_FACTOR},
           cases=errs, cases_via_autograd=auto_errs, kinks=kinks)
    return g_main, {**errs, **{f"{k}_autograd": v for k, v in auto_errs.items()}}


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


def toy_rows(n: int, seed: int, dev) -> torch.Tensor:
    """``n`` 8gaussians points folded into ``2 n`` rows of x."""
    return torch.as_tensor(inf_train_gen("8gaussians", np.random.RandomState(seed), n).reshape(-1),
                           device=dev)


def p4_cases(gen, dev) -> dict:
    """The pack-4 kernels' cases: the toy flow's block, a 4,096-row block and
    the flagship's block; K = 16, 18, 19 (the toy block's is 17), 101 padded
    nodes, x = 0, x < 0, a ragged row count, ReLU, the 32-wide limit and
    eight layers (MAX_LAYERS)."""
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
    }


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
    report("kernel_p4", rows=x.numel(), nodes=nodes.numel(), widths=TOY_WIDTHS, tol=KERNEL_TOL,
           cases=errs, refused=["pack4_hidden_width_33"],
           routes={k: v[2] for k, v in routes.items()})
    return cases, errs


def phase_bwd_p4(gen, dev, cases):
    """integrand_bwd_p4, through its wrapper and through the autograd
    Function, against the float64 plain version taken on the kernel's sides
    of every LeakyReLU (as phase bwd_p2) at the pack-4 cases; two runs
    bit-identical."""
    g_all = torch.randn(2 * B2048, generator=gen).to(dev)
    errs, auto_errs, kinks = {}, {}, {}
    for case, ((cws, cbs, cn, cw), x, h, slope) in cases.items():
        args = (cws, cbs, x, h, cn, cw, g_all[: x.numel()], slope)
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
    report("bwd_p4", rows=cases["toy_block"][1].numel(), nodes=TOY["nb_steps"] + 1,
           widths=TOY_WIDTHS,
           reference="plain version in float64 on the kernel's sides of each LeakyReLU",
           tol={"row_scale": BWD_ROW_SCALE, "param_scale": BWD_PARAM_SCALE,
                "plain_factor": BWD_PLAIN_FACTOR},
           cases=errs, cases_via_autograd=auto_errs, kinks=kinks)
    return g_all, {**errs, **{f"{k}_autograd": v for k, v in auto_errs.items()}}


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
    flag_launches = step_launches(trainer(flag, 1e-5), x_flag)
    want = {**NONE_LAUNCHED, "integrand_fwd_p4": 2, "integrand_bwd_p4": 2}
    check(flag_launches == want, f"toy: flagship step launched {flag_launches}, want {want}")

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
           toy_batch=TOY_BATCH, toy_widths=TOY_WIDTHS, toy_loss=toy_loss, toy=toy_gap,
           launches_per_step=launches, grad_gap_tol=TRAIN_GRAD_GAP, driver=runs,
           phase_seconds=time.perf_counter() - t0)
    return flow, step_k, step_p, x_toy, launches


def time_pack4(cases, g_all, flow, step_k, step_p, x_toy, name: str) -> tuple:
    """The pack-4 pair at the toy block (R = 512) and the 4,096-row block,
    beside the pack-2 and unpacked pairs on the same inputs and the plain
    versions; then the toy training step on the Leibniz route and on the
    kernel route with its blocks on each pair in turn (the A/B of
    scripts/pack4_ab.py), with the kernel route's profile."""
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
    fwd_p2_errs = phase_kernel_p2(gen, dev, calib)
    g_calib, bwd_p2_errs = phase_bwd_p2(gen, dev, calib)
    calib_k, calib_p, calib_x, calib_launches = phase_calibration(dev)
    p4c, fwd_p4_errs = phase_kernel_p4(gen, dev)
    g_p4, bwd_p4_errs = phase_bwd_p4(gen, dev, p4c)
    toy_flow, toy_k, toy_p, toy_x, toy_launches = phase_toy(dev)

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
           bwd_bound=bwd_bound, compute_bpp_ms=bpp_ms, compute_bpp_plain_ms=bpp_plain_ms,
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
           calib_train_step_profile=calib_profile, pack4_ab=p4_t, toy=toy_t,
           toy_train_step_profile=toy_profile)

    # ``ms`` (and its alias ``kernel_ms``) is a CUDA-event median of whole
    # wrapper calls, as in every earlier run; ``device_ms`` the kernel alone.
    def entry(kernel, tpu_kernel, line, errs, ms, dev_ms, plain_ms, b, n_launched):
        return {
            "name": kernel, "route": "cuda", "source": f"umnn_tpu_torch/csrc/{kernel}.cu",
            "replaces": f"umnn_tpu/ops/integrand_kernel.py:{line}", "tpu_kernel": tpu_kernel,
            "launches": n_launched,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "tol_used": max(e["tol_used"] for e in errs.values()),
            "ms": ms, "kernel_ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "ptxas": ptxas[f"{kernel}_kernel"],
        }

    toy_block = p4_t["toy_block"]
    kernels = [
        entry("integrand_fwd", "_fwd_kernel", 106, fwd_errs, fwd_ms, fwd_device_ms,
              fwd_plain_ms, fwd_bound, launches["integrand_fwd"]),
        entry("integrand_bwd", "_bwd_kernel", 156, bwd_errs, bwd_ms, bwd_device_ms,
              bwd_plain_ms, bwd_bound, launches["integrand_bwd"]),
        entry("integrand_fwd_p2", "_fwd_kernel_p2", 333, fwd_p2_errs,
              calib_t["fwd_p2_ms"], calib_t["fwd_p2_device_ms"], calib_t["fwd_plain_ms"],
              fwd_p2_bound, calib_launches["integrand_fwd_p2"]),
        entry("integrand_bwd_p2", "_bwd_kernel_p2", 384, bwd_p2_errs,
              calib_t["bwd_p2_ms"], calib_t["bwd_p2_device_ms"], calib_t["bwd_plain_ms"],
              bwd_p2_bound, calib_launches["integrand_bwd_p2"]),
        entry("integrand_fwd_p4", "_fwd_kernel_pn", 522, fwd_p4_errs,
              toy_block["fwd_p4_ms"], toy_block["fwd_p4_device_ms"], toy_block["fwd_plain_ms"],
              toy_block["fwd_bound"], toy_launches["integrand_fwd_p4"]),
        entry("integrand_bwd_p4", "_bwd_kernel_pn", 573, bwd_p4_errs,
              toy_block["bwd_p4_ms"], toy_block["bwd_p4_device_ms"], toy_block["bwd_plain_ms"],
              toy_block["bwd_bound"], toy_launches["integrand_bwd_p4"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total {time.perf_counter() - T0:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
