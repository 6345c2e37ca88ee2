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
           with 5 launches of each kernel, then ten steps on fresh batches
           with finite, falling loss;
7. timing  CUDA-event medians of both kernels, their plain versions,
           compute_bpp and a training step, beside the kernels' bounds.

Then a ``kernels`` line, the nvidia-smi name and power limit, and a last
line ``{"ok": true, "device": {...}}``. Any failed check raises, and the
run exits non-zero with its traceback; with no CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from umnn_tpu_torch import UMNNMAFFlow
from umnn_tpu_torch.data.images import synthetic_mnist_ar1
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


def integrand_inputs(gen: torch.Generator, widths: list, rows: int, dev) -> tuple:
    """Integrand weights at ``widths`` and an embedding for ``rows`` rows."""
    layers = [torch_linear_init(gen, a, b, dev) for a, b in zip(widths[:-1], widths[1:])]
    ws = [l.weight.detach() for l in layers]
    bs = [l.bias.detach() for l in layers]
    h = torch.randn(rows, widths[0] - 1, generator=gen).to(dev)
    return ws, bs, h


def kernel_flops(R: int, K: int) -> int:
    """Useful float32 operations of one forward sweep: the first layer's h
    part once per row, its x part (rank 1) and every later layer once per
    (row, node)."""
    per_pair = 2 * (WIDTHS[1] + sum(a * b for a, b in zip(WIDTHS[1:-1], WIDTHS[2:])))
    return R * K * per_pair + R * 2 * (WIDTHS[0] - 1) * WIDTHS[1]


def kernel_bytes(R: int, K: int) -> int:
    """x, h and the weights read once, z written once, float32."""
    weights = sum(a * b + b for a, b in zip(WIDTHS[:-1], WIDTHS[1:]))
    return 4 * (R * WIDTHS[0] + R + weights + 2 * K)


def bwd_kernel_flops(R: int, K: int) -> int:
    """Useful float32 operations of one backward sweep. Per (row, node): the
    forward again; for each hidden layer after the first, its dW product
    and the dz product into the layer below (2 x 2 x din x dout); the output
    layer's dW row and rank-1 dz (4 x its width); in layer 1 the x column
    of dW1, x's node path and the node sum of dz1 (5 x H1). Per row: the
    first layer's h part, dW1's h part and dh (3 x 2 x e x H1)."""
    e, H1, dl = WIDTHS[0] - 1, WIDTHS[1], WIDTHS[-2]
    hidden = sum(a * b for a, b in zip(WIDTHS[1:-2], WIDTHS[2:-1]))
    per_pair = kernel_flops(1, 1) - 2 * e * H1 + 4 * hidden + 4 * dl + 5 * H1
    return R * K * per_pair + R * 3 * 2 * e * H1


def bwd_kernel_bytes(R: int, K: int) -> int:
    """x, h, g and the weights read once; dx, dh, S and dW written once."""
    weights = sum(a * b + b for a, b in zip(WIDTHS[:-1], WIDTHS[1:]))
    return 4 * (2 * R * (WIDTHS[0] + 1) + 2 * weights + 2 * K)


def bound(flops: int, nbytes: int, name: str) -> dict:
    ops_ms = flops / sku_rate(FP32_PEAK, name) * 1e3
    bytes_ms = nbytes / sku_rate(HBM_BYTES_PER_S, name) * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_flop": flops, "bound_bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def bwd_through_autograd(ws, bs, x, h, nodes, ccw, g, slope):
    """dws, dbs, dx, dh of ``sum(g * fused_cc_integral(...))``: the forward
    kernel, then the backward kernel through the autograd Function."""
    leaves = [t.detach().requires_grad_() for t in (*ws, *bs, x, h)]
    n = len(ws)
    z = ik.fused_cc_integral(leaves[:n], leaves[n : 2 * n], leaves[-2], leaves[-1], nodes, ccw,
                             neg_slope=slope)
    grads = torch.autograd.grad(z, leaves, g)
    return list(grads[:n]), list(grads[n : 2 * n]), grads[-2], grads[-1]


def hold(got, plain, want, scale: float, what: str) -> dict:
    """One backward output of the kernel against float64 ``want``: its max
    error within max(scale * max|want|, BWD_PLAIN_FACTOR * the float32
    plain version's max error)."""
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = float((got.double() - want).abs().max())
    plain_err = float((plain.double() - want).abs().max())
    limit = max(scale * float(want.abs().max()), BWD_PLAIN_FACTOR * plain_err, 1e-30)
    out = {"max_abs_err": err, "plain_abs_err": plain_err, "tol_used": err / limit}
    check(err <= limit, f"{what}: error {out} past {limit}")
    return out


def compare_bwd(got, plain, want, what: str) -> dict:
    """Errors of (dws, dbs, dx, dh[, S]) against the float64 plain version,
    beside the float32 plain version's."""
    errs = {}
    for kind, scale, g, p, w in (("dW", BWD_PARAM_SCALE, got[0], plain[0], want[0]),
                                 ("db", BWD_PARAM_SCALE, got[1], plain[1], want[1])):
        for l, (a, b, c) in enumerate(zip(g, p, w)):
            errs[f"{kind}{l}"] = hold(a, b, c, scale, f"{what} {kind}{l}")
    for name, a, b, c in zip(("dx", "dh", "S"), got[2:], plain[2:], want[2:]):
        errs[name] = hold(a, b, c, BWD_ROW_SCALE, f"{what} {name}")
    return errs


def bwd_plain64(ws, bs, x, h, nodes, ccw, g, slope):
    """The plain backward in float64 on the same (float32) inputs."""
    d = [t.double() for t in (*ws, *bs, x, h, nodes, ccw, g)]
    n = len(ws)
    return ik.fused_cc_integral_bwd_plain(d[:n], d[n : 2 * n], *d[2 * n :], slope)


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
        check(launches == {"integrand_fwd": MNIST["nb_flow"], "integrand_bwd": 0},
              f"slice: launches in one compute_ll {launches}, want {MNIST['nb_flow']} forward")
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


def trainer(flow):
    optimizer = make_optimizer(flow.parameters(), "adam", lr=1e-3, weight_decay=1e-2, grad_clip=1.0)
    return make_train_step(lambda x: -flow.compute_ll(x)[0].mean(), optimizer)


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
    check(launches == {"integrand_fwd": n, "integrand_bwd": n},
          f"train: launches in one step {launches}, want {n} of each kernel")
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
    report("build", seconds=time.perf_counter() - t, nvcc=_build.find_nvcc(),
           library=str(lib_path.relative_to(_build.BUILD_DIR.parents[1])))

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

    # --- timing -----------------------------------------------------------
    ws, bs, x_main, h_main = block
    R = x_main.numel()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw))
        fwd_plain_ms = median_ms(lambda: ik.fused_cc_integral_plain(ws, bs, x_main, h_main, nodes, ccw))
        bpp_ms = median_ms(lambda: flow.compute_bpp(rows))
        bpp_plain_ms = median_ms(lambda: plain.compute_bpp(rows))
    bwd_args = (ws, bs, x_main, h_main, nodes, ccw, g_main)
    bwd_ms = median_ms(lambda: ik.fused_cc_integral_bwd(*bwd_args))
    bwd_plain_ms = median_ms(lambda: ik.fused_cc_integral_bwd_plain(*bwd_args), n=5, warmup=1)
    train_ms = median_ms(lambda: step_k(batches[0]), n=5, warmup=1)
    train_plain_ms = median_ms(lambda: step_p(batches[0]), n=5, warmup=1)
    fwd_bound = bound(kernel_flops(R, K), kernel_bytes(R, K), name)
    bwd_bound = bound(bwd_kernel_flops(R, K), bwd_kernel_bytes(R, K), name)
    report("timing", fwd_kernel_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, fwd_bound=fwd_bound,
           bwd_kernel_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, bwd_bound=bwd_bound,
           compute_bpp_ms=bpp_ms, compute_bpp_plain_ms=bpp_plain_ms,
           train_step_ms=train_ms, train_step_plain_ms=train_plain_ms,
           train_step_peak_mem_bytes=peak_bytes,
           fwd_tflops=fwd_bound["bound_flop"] / fwd_ms / 1e9,
           bwd_tflops=bwd_bound["bound_flop"] / bwd_ms / 1e9)

    def entry(kernel, tpu_kernel, line, errs, ms, plain_ms, b):
        return {
            "name": kernel, "route": "cuda", "source": f"umnn_tpu_torch/csrc/{kernel}.cu",
            "replaces": f"umnn_tpu/ops/integrand_kernel.py:{line}", "tpu_kernel": tpu_kernel,
            "launches": launches[kernel],
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "tol_used": max(e["tol_used"] for e in errs.values()),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
        }

    kernels = [
        entry("integrand_fwd", "_fwd_kernel", 106, fwd_errs, fwd_ms, fwd_plain_ms, fwd_bound),
        entry("integrand_bwd", "_bwd_kernel", 156, bwd_errs, bwd_ms, bwd_plain_ms, bwd_bound),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total {time.perf_counter() - T0:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
