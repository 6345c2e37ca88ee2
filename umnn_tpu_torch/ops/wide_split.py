"""Where the streamed pair's device time goes, launch by launch.

:func:`measure` traces forward and backward calls of the port's wrappers
with torch.profiler and gives, for each, its CUDA kernels per call, their
device time, the time of each kind of kernel (``gemm``, ``add``, ``build``,
...) and of each launch in its place within a chunk of rows, summed over the
call's chunks (so each product call site of the forward is its own entry).
Beside it, as a yardstick that the port never calls, cuBLAS's time for the
same products: ``torch.matmul`` in float32 with TF32 off, on the chunks'
shapes and in the kernels' operand layouts, summed per call.
``chip_smoke.py``'s phase ``wide`` reports it at the streamed pair's timing
block. Nothing here runs at import.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from umnn_tpu_torch.ops import integrand_kernel as ik

_KIND = re.compile(r"integrand_wide_([a-z0-9]+)_kernel")


def _kernel_events(prof) -> list:
    """The streamed pair's kernel launches in the trace, in start order."""
    cuda = torch.autograd.DeviceType.CUDA
    hits = [e for e in prof.events() if e.device_type == cuda and _KIND.search(e.name)]
    return sorted(hits, key=lambda e: e.time_range.start)


def launches_per_chunk(widths, backward: bool) -> int:
    """The kernels ``csrc/integrand_wide.cu`` launches for one chunk of rows.
    The forward: the ph product, the build, one product per hidden layer and
    the head. The backward: the forward without its head, then the head, the
    output layer and its add, for each hidden layer its dW product (with db
    beside it), that add and its dz product, then layer 1's collapse, dW1
    product, add, dh product and dx; with h empty (``widths[0] == 1``) there
    is no dW1 or dh product."""
    nl = len(widths) - 1
    if not backward:
        return nl + 1
    return 4 * nl + 2 - (2 if widths[0] == 1 else 0)


def split(fn, chunks: int, per_chunk: int, calls: int = 5) -> dict:
    """Device time of ``calls`` calls of ``fn`` (one call of the streamed
    pair each, over ``chunks`` row chunks of ``per_chunk`` launches), per
    call: in all, per kind of kernel, and per launch in its place within a
    chunk (summed over the chunks). A trace with another number of launches
    is taken again, at most three times."""
    fn()
    torch.cuda.synchronize()
    want = calls * chunks * per_chunk
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        if len(events) == want:
            break
    else:
        raise AssertionError(f"profiler: {len(events)} launches of the streamed pair in "
                             f"{calls} calls of {chunks} chunks, want {want}")
    by_kind, by_place = {}, [["", 0.0] for _ in range(per_chunk)]
    for i, e in enumerate(events):
        kind = _KIND.search(e.name)[1]
        us = e.time_range.elapsed_us()
        by_kind[kind] = by_kind.get(kind, 0.0) + us / calls / 1e3
        by_place[i % per_chunk][0] = kind
        by_place[i % per_chunk][1] += us / calls / 1e3
    return {"kernels_per_call": len(events) // calls,
            "device_ms": sum(e.time_range.elapsed_us() for e in events) / calls / 1e3,
            "by_kind": by_kind, "by_place": by_place}


def products(widths, rows: int, K: int, backward: bool) -> list:
    """The matrix products of one chunk of ``rows`` rows, ``(name, m, k, n,
    a_t, b_t)``: ``C[m, n] = A[m, k] B[k, n]``, with A (B) stored as its
    transpose where ``a_t`` (``b_t``), as the streamed pair reads them."""
    M, e, H1, dl = rows * K, widths[0] - 1, widths[1], widths[-2]
    hidden = list(zip(widths[1:-2], widths[2:-1]))
    out = [("ph", rows, e, H1, False, False)]
    out += [("hidden", M, din, dout, False, False) for din, dout in hidden]
    if backward:
        out.append(("dW_out", 1, M, dl, False, False))
        for din, dout in hidden[::-1]:
            out.append(("dW", dout, M, din, True, False))
            out.append(("dz", M, dout, din, False, True))
        out.append(("dW1_x", H1, rows, 1, True, False))
        out.append(("dW1_h", H1, rows, e, True, False))
        out.append(("dh", rows, H1, e, False, True))
    return out


def cublas_ms(widths, chunks: list, K: int, backward: bool, dev, n: int = 5) -> float:
    """``torch.matmul`` (float32, TF32 off) on every product of a call,
    one chunk after another, CUDA events, median of ``n`` after one warm-up."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = {}

    def operand(rows, cols, transposed):
        key = (rows, cols, transposed)
        if key not in cache:
            shape = (cols, rows) if transposed else (rows, cols)
            t = torch.randn(shape, generator=gen, device=dev)
            cache[key] = t.t() if transposed else t
        return cache[key]

    calls = [(operand(m, k, a_t), operand(k, n_, b_t))
             for a, b in chunks for _, m, k, n_, a_t, b_t in products(widths, b - a, K, backward)]

    def run():
        for a, b in calls:
            torch.matmul(a, b)

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return float(np.median(times))


def measure(ws, bs, x, h, nodes, ccw, g, calls: int = 5) -> dict:
    """The split of a forward and a backward call of the streamed pair on
    these inputs, and the cuBLAS yardstick for the same products."""
    widths = [h.shape[-1] + 1] + [w.shape[0] for w in ws]
    K = nodes.numel()
    chunks = ik._wide_chunks(x.numel(), K, widths)
    with torch.inference_mode():
        fwd = split(lambda: ik.fused_cc_integral(ws, bs, x, h, nodes, ccw), len(chunks),
                    launches_per_chunk(widths, False), calls)
    bwd = split(lambda: ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, g), len(chunks),
                launches_per_chunk(widths, True), calls)
    for part, backward in ((fwd, False), (bwd, True)):
        # the operations of the products with more than one output row and
        # column, the work of the product kernel (`gemm`)
        part["product_gflop"] = sum(
            2 * m * k * n for a, b in chunks for _, m, k, n, _, _ in
            products(widths, b - a, K, backward) if m > 1 and n > 1) / 1e9
    return {"chunks": [b - a for a, b in chunks], "fwd": fwd, "bwd": bwd,
            "fwd_cublas_ms": cublas_ms(widths, chunks, K, False, x.device),
            "bwd_cublas_ms": cublas_ms(widths, chunks, K, True, x.device)}
