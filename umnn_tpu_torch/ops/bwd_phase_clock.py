"""Where the time of ``csrc/integrand_bwd.cu`` goes, phase by phase.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc::

    python -m umnn_tpu_torch.ops.bwd_phase_clock [--rows 78400] [--calls 5]

It compiles a copy of the backward kernel in which thread 0 of every block
adds the ``clock64()`` cycles between consecutive ``__syncthreads()`` to one
counter per barrier, runs the copy on the MNIST block (random weights and
inputs from a seed, widths 31-100-50-50-50-50-1, 51 nodes), and prints the
cycles per SM and call spent before each barrier (here one block per SM),
with the first comment of its phase, and the call time with the clocks in
(a little above ``chip_smoke.py``'s device time: thread 0 adds to the
counters). ptxas's line for the instrumented kernel comes first (its
registers can differ by one or two from the library's build). Nothing here
runs at import. ``ops/fwd_phase_clock.py`` does the same for the forward.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess

import torch

from umnn_tpu_torch.ops import _build

WIDTHS = [31, 100, 50, 50, 50, 50, 1]  # examples/train_mnist.py's integrand
NODES = 51
OUT = _build.BUILD_DIR / "phase_clock"
BWD_MARKERS = ("integrand_bwd_kernel(const float*", "// out[p] = sum over the grid's blocks")


def instrument(src: str, start: str, end: str) -> tuple[str, list[str]]:
    """The kernel source with a counter after every ``__syncthreads()``
    between the markers ``start`` (the kernel's parameter list) and ``end``
    (the first line past the kernel), and for each counter the comment that
    opens its phase (else its first line of code)."""
    start_at = src.index(start)
    end_at = src.index(end, start_at)
    body, labels = src[start_at:end_at], []
    comment = code = None  # the first comment and code lines after the last barrier

    def tick(match: re.Match) -> str:
        nonlocal comment, code
        labels.append(comment or code or "")
        comment = code = None
        return f"__syncthreads(); TICK({len(labels) - 1});"

    out_lines = []
    for line in body.splitlines(keepends=True):
        stripped = line.strip()
        if stripped.startswith("//") and comment is None:
            comment = stripped[2:].strip()
        elif stripped and code is None and "__syncthreads();" not in stripped:
            code = stripped
        out_lines.append(re.sub(r"__syncthreads\(\);", tick, line))
    body = "".join(out_lines).replace(
        "extern __shared__ __align__(16) float sm[];",
        "extern __shared__ __align__(16) float sm[];\n  long long t_prev = clock64();")
    head = (
        '#include "common.cuh"\n'
        "__device__ unsigned long long g_phase[64];\n"
        "#define TICK(i) do { if (threadIdx.x == 0) { const long long t_now = clock64(); "
        "atomicAdd(&g_phase[i], (unsigned long long)(t_now - t_prev)); "
        "t_prev = t_now; } } while (0)\n"
    )
    api = (
        'extern "C" {\n'
        "int umnn_phase_clocks(unsigned long long* out, int clear) {\n"
        "  unsigned long long z[64] = {};\n"
        "  if (clear) return cudaMemcpyToSymbol(g_phase, z, sizeof z);\n"
        "  return cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 64);\n}\n"
    )
    src = src[:start_at] + body + src[end_at:]
    src = src.replace('#include "common.cuh"', head, 1).replace('extern "C" {', api, 1)
    return src, labels


def build(source: str, kernel: str, start: str, end: str) -> tuple[ctypes.CDLL, list[str], str]:
    """The instrumented library of the CUDA source text ``source`` (its
    kernel ``kernel`` between the markers), its phase labels and ptxas's
    line for the kernel."""
    src, labels = instrument(source, start, end)
    out = OUT / kernel
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(_build.CSRC / "common.cuh", out / "common.cuh")
    (out / f"{kernel}_clock.cu").write_text(src)
    lib = out / f"lib{kernel}_clock.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(out / f"{kernel}_clock.cu")],
        capture_output=True, text=True, check=True,
    )
    lines = proc.stderr.splitlines()
    ptxas = next((" | ".join(s.strip() for s in lines[i + 2 : i + 4])
                  for i, s in enumerate(lines) if kernel in s), "")
    return ctypes.CDLL(str(lib)), labels, ptxas


def report(lib: ctypes.CDLL, labels: list[str], call, calls: int, sms: int) -> None:
    """Runs ``call`` once, then ``calls`` times with the counters set to 0,
    and prints the call time and the cycles per SM and call before each
    barrier (all blocks' counts over the card's SMs), with their labels."""
    call()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 64)()
    lib.umnn_phase_clocks(counts, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    torch.cuda.synchronize()
    lib.umnn_phase_clocks(counts, 0)
    per_sm = [counts[i] / (sms * calls) for i in range(len(labels))]
    total = sum(per_sm)
    print(f"ms per call, clocks in: {start.elapsed_time(end) / calls:.3f}", flush=True)
    print(f"cycles per SM and call before each barrier (total {total:.0f}), and the first "
          "comment (else line) of its phase:")
    for i, (cycles, label) in enumerate(zip(per_sm, labels)):
        print(f"  {i:2d} {cycles:14.0f} {100 * cycles / total:5.1f}%  {label[:70]}")


def mnist_inputs(rows: int, dev: torch.device) -> tuple:
    """Seeded integrand weights at WIDTHS, packed as the kernels take them,
    and h, x, a cotangent g for ``rows`` rows, the nodes and weights."""
    from umnn_tpu_torch.nn.core import torch_linear_init
    from umnn_tpu_torch.ops.quadrature import cc_tensors

    gen = torch.Generator().manual_seed(0)
    layers = [torch_linear_init(gen, a, b, dev) for a, b in zip(WIDTHS[:-1], WIDTHS[1:])]
    params = torch.cat([t.detach().reshape(-1) for l in layers
                        for t in (l.weight.T.contiguous(), l.bias)])
    h = torch.randn(rows, WIDTHS[0] - 1, generator=gen).to(dev)
    x = (3 * torch.randn(rows, generator=gen)).to(dev)
    g = torch.randn(rows, generator=gen).to(dev)
    return layers, params, h, x, g, *cc_tensors(NODES - 1, dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=78400)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    lib, labels, ptxas = build((_build.CSRC / "integrand_bwd.cu").read_text(),
                               "integrand_bwd_kernel", *BWD_MARKERS)
    print("ptxas integrand_bwd_kernel:", ptxas, flush=True)

    dev = torch.device("cuda:0")
    _, params, h, x, g, nodes, ccw = mnist_inputs(args.rows, dev)
    R, e = args.rows, WIDTHS[0] - 1
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    P = params.numel()
    partial = torch.empty(blocks * P, device=dev)
    dparams = torch.empty(P, device=dev)
    dx, S = torch.empty(R, device=dev), torch.empty(R, device=dev)
    dh = torch.empty(R, e, device=dev)
    c_widths = (ctypes.c_int * len(WIDTHS))(*WIDTHS)
    fn = lib.umnn_integrand_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call() -> None:
        rc = fn(x.data_ptr(), h.data_ptr(), params.data_ptr(), nodes.data_ptr(), ccw.data_ptr(),
                g.data_ptr(), dx.data_ptr(), dh.data_ptr(), S.data_ptr(), partial.data_ptr(),
                dparams.data_ptr(), R, NODES, blocks, ctypes.cast(c_widths, ctypes.c_void_p),
                len(WIDTHS) - 1, 0.01, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"integrand_bwd launch failed: CUDA error {rc}")

    report(lib, labels, call, args.calls, blocks)


if __name__ == "__main__":
    main()
