#!/usr/bin/env python3
"""Smoke run of the PyTorch port (umnn_tpu_torch) on one NVIDIA card.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It needs only this file, the ``umnn_tpu_torch/`` package, torch, numpy and
scipy. Phases, each printing one flushed JSON line:

1. env     the card, its power limit, torch and CUDA versions;
2. build   the CUDA sources, compiled with nvcc from a clean build directory;
3. kernel  the integrand kernel against its plain PyTorch version on the
           card, at one MNIST block's shape and at edge cases;
4. slice   the full-width 5-block MNIST UMNN-MAF flow (random weights from a
           seed) scores 100 synthetic MNIST-geometry rows with compute_bpp
           on the kernel path, held against the plain quadrature path; the
           kernel's launch count over one compute_ll must be 5;
5. timing  CUDA-event medians of the kernel, its plain version and
           compute_bpp, beside the kernel's bound.

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
from umnn_tpu_torch.ops.quadrature import cc_tensors

T0 = time.perf_counter()
BUDGET_S = 600.0  # the run stops with an error past this, half the caller's limit

# The widest configuration the repo trains: examples/train_mnist.py defaults.
MNIST = dict(
    nb_flow=5, nb_in=784, hidden_derivative=(100, 50, 50, 50, 50),
    hidden_embedding=(1024, 1024, 1024), embedding_s=30, nb_steps=50,
)
BATCH = 100
WIDTHS = [1 + MNIST["embedding_s"], *MNIST["hidden_derivative"], 1]

# Kernel against its plain version, both float32 with IEEE FMA on the card:
# they differ only in the order of sums (the kernel's k-sequential FMA chain
# and in-order node sum against cuBLAS blocking and torch.sum), a few ulp per
# layer, so about 1e-6 relative; atol covers z near 0, where |z| ~ |x|.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# Whole flow, kernel path against the plain quadrature path: five blocks in
# sequence, each block's integral error feeding the next block's MADE and
# integrand, and ll summing 784 x 5 per-dimension terms.
SLICE_TOL = dict(rtol=1e-4, atol=1e-3)

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
    check(used <= 1.0, f"{what}: outside rtol {tol['rtol']} atol {tol['atol']}: {out}")
    return out


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
    """Useful float32 operations of one sweep: the first layer's h part once
    per row, its x part (rank 1) and every later layer once per (row, node)."""
    per_pair = 2 * (WIDTHS[1] + sum(a * b for a, b in zip(WIDTHS[1:-1], WIDTHS[2:])))
    return R * K * per_pair + R * 2 * (WIDTHS[0] - 1) * WIDTHS[1]


def kernel_bytes(R: int, K: int) -> int:
    """x, h and the weights read once, z written once, float32."""
    weights = sum(a * b + b for a, b in zip(WIDTHS[:-1], WIDTHS[1:]))
    return 4 * (R * WIDTHS[0] + R + weights + 2 * K)


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

    # --- kernel against its plain version --------------------------------
    gen = torch.Generator().manual_seed(0)
    data, floor_bpp = synthetic_mnist_ar1(seed=0, n=(0, 0, BATCH))
    rows = torch.as_tensor(data.tst_x, device=dev)  # [100, 784] logit space
    nodes, ccw = cc_tensors(MNIST["nb_steps"], dev)
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
        launched = ik.LAUNCHES
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

    # --- the slice: full-width MNIST flow, kernel path and plain path ----
    flow = UMNNMAFFlow(**MNIST, backend="auto", seed=0)
    plain = UMNNMAFFlow(**MNIST, backend="torch", seed=0)
    for a, b in zip(flow.state_dict().values(), plain.state_dict().values()):
        check(torch.equal(a, b), "slice: the two flows must share their seeded weights")
    with torch.inference_mode():
        ik.LAUNCHES = 0
        flow.compute_ll(rows)
        torch.cuda.synchronize()
        launches = ik.LAUNCHES
        check(launches == MNIST["nb_flow"],
              f"slice: {launches} kernel launches in one compute_ll, want {MNIST['nb_flow']}")
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

    # --- timing -----------------------------------------------------------
    with torch.inference_mode():
        kernel_ms = median_ms(lambda: ik.fused_cc_integral(ws, bs, x_main, h_main, nodes, ccw))
        plain_ms = median_ms(lambda: ik.fused_cc_integral_plain(ws, bs, x_main, h_main, nodes, ccw))
        bpp_ms = median_ms(lambda: flow.compute_bpp(rows))
        bpp_plain_ms = median_ms(lambda: plain.compute_bpp(rows))
    R = x_main.numel()
    flops, nbytes = kernel_flops(R, K), kernel_bytes(R, K)
    ops_ms = flops / sku_rate(FP32_PEAK, name) * 1e3
    bytes_ms = nbytes / sku_rate(HBM_BYTES_PER_S, name) * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    report("timing", kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
           bound_flop=flops, bound_bytes=nbytes, ops_ms=ops_ms, bytes_ms=bytes_ms,
           compute_bpp_ms=bpp_ms, compute_bpp_plain_ms=bpp_plain_ms,
           flop_rate_tflops=flops / kernel_ms / 1e9)

    kernel = {
        "name": "integrand_fwd",
        "route": "cuda",
        "source": "umnn_tpu_torch/csrc/integrand_fwd.cu",
        "replaces": "umnn_tpu/ops/integrand_kernel.py:106",
        "tpu_kernel": "_fwd_kernel",
        "launches": launches,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "max_rel_err": max(e["max_rel_err"] for e in errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(f"total {time.perf_counter() - T0:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
