"""The bookkeeping of the streamed pair's measurements, without a card.

``umnn_tpu_torch/ops/wide_split.py`` splits a profiler trace of the streamed
pair (``csrc/integrand_wide.cu``) by kernel and by launch, and times cuBLAS
on the products it lists; ``ops/_build.py::parse_ptxas`` reads ptxas's report
of each kernel, the product kernel's template instances included. On the
card ``chip_smoke.py``'s phase ``wide`` prints what they give. Here a trace
is faked from events with known times, the product list is held against the
operation count of ``chip_smoke.py::kernel_flops`` and
``bwd_kernel_flops``, and the parser reads a sample of ptxas's output.
"""

import contextlib
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from umnn_tpu_torch.ops import _build, wide_split

CUDA = torch.autograd.DeviceType.CUDA
DEMANGLED = {
    "gemm": "void (anonymous namespace)::integrand_wide_gemm_kernel<1, 0, true, false>"
            "((anonymous namespace)::Operand, (anonymous namespace)::Operand, float*)",
    "build": "(anonymous namespace)::integrand_wide_build_kernel(float const*, float*)",
    "head": "(anonymous namespace)::integrand_wide_head_kernel(float const*, float*)",
}


def _event(name, start, us, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, elapsed_us=lambda: us))


def _fake_profiler(monkeypatch, traces):
    """torch.profiler.profile giving the traces in turn; no card needed."""
    traces = iter(traces)

    @contextlib.contextmanager
    def profile(**kw):
        events = next(traces)
        yield SimpleNamespace(events=lambda: events)

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


def _trace(calls, chunks, times, other=True):
    """The launches of ``calls`` calls of ``chunks`` chunks, each chunk the
    kinds and microseconds of ``times``, out of order, with other kernels
    and host events between them."""
    events, t = [], 0
    for c in range(calls):
        for k in range(chunks):
            for kind, us in times:
                events.append(_event(DEMANGLED[kind], t, us * (k + 1)))
                t += 10
                if other:
                    events.append(_event("void at::native::vectorized_elementwise_kernel", t, 99))
                    events.append(_event(DEMANGLED[kind], t, 5, torch.autograd.DeviceType.CPU))
                    t += 10
    return events[::-1]


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_split_sums_each_launch_place_over_chunks_and_calls(monkeypatch, chunks):
    times = [("gemm", 10.0), ("build", 2.0), ("gemm", 30.0), ("head", 1.0)]
    _fake_profiler(monkeypatch, [_trace(3, chunks, times)])
    out = wide_split.split(lambda: None, chunks, len(times), calls=3)
    scale = chunks * (chunks + 1) / 2  # chunk k's launches take (k + 1) times as long
    assert out["kernels_per_call"] == 4 * chunks
    assert out["by_place"] == [[kind, pytest.approx(us * scale / 1e3)] for kind, us in times]
    assert out["by_kind"] == {"gemm": pytest.approx(40 * scale / 1e3),
                              "build": pytest.approx(2 * scale / 1e3),
                              "head": pytest.approx(scale / 1e3)}
    assert out["device_ms"] == pytest.approx(43 * scale / 1e3)


def test_split_takes_a_trace_that_lost_a_launch_again(monkeypatch):
    times = [("gemm", 10.0), ("head", 1.0)]
    lost = _trace(2, 2, times, other=False)[1:]
    _fake_profiler(monkeypatch, [lost, _trace(2, 2, times)])
    assert wide_split.split(lambda: None, 2, 2, calls=2)["kernels_per_call"] == 4
    _fake_profiler(monkeypatch, [lost] * 3)
    with pytest.raises(AssertionError, match="launches of the streamed pair"):
        wide_split.split(lambda: None, 2, 2, calls=2)


@pytest.mark.parametrize("calls, chunks, per_chunk", [(2, 2, 3), (2, 1, 2), (4, 2, 2)])
def test_split_refuses_a_trace_of_whole_chunks_too_many_or_too_few(monkeypatch, calls, chunks,
                                                                    per_chunk):
    """Traces of 12, 4 and 16 launches for 2 calls of 2 chunks of 2: each a
    multiple of calls x chunks, so an inferred count per chunk would put
    launches in wrong places."""
    times = [("gemm", 10.0), ("head", 1.0), ("build", 2.0)][:per_chunk]
    _fake_profiler(monkeypatch, [_trace(calls, chunks, times)] * 3)
    with pytest.raises(AssertionError, match="want 8"):
        wide_split.split(lambda: None, 2, 2, calls=2)


@pytest.mark.parametrize("widths, fwd, bwd", [
    ([31, 256, 256, 256, 256, 1], 6, 22),  # the timing block: 12 and 44 in two chunks
    ([31, 129, 1], 3, 10),
    ([1, 64, 64, 1], 4, 12),  # no h: no dW1 or dh product
])
def test_launches_per_chunk_follow_the_widths(widths, fwd, bwd):
    assert wide_split.launches_per_chunk(widths, False) == fwd
    assert wide_split.launches_per_chunk(widths, True) == bwd


@pytest.mark.parametrize("widths", [[31, 256, 256, 256, 256, 1], [31, 129, 1], [9, 64, 37, 1]])
def test_products_count_the_bounds_product_operations(widths):
    """The forward's products are the bound's operations less the work
    outside products, per (row, node) layer 1's x column and the output
    layer; the backward's add, for each hidden layer, dW and dz at the
    forward product's operations, and the output layer's dW row, layer 1's
    dW1 and dh."""
    rows, K = 7, 5
    e, H1, dl = widths[0] - 1, widths[1], widths[-2]

    def ops(backward):
        out = {}
        for name, m, k, n, _, _ in wide_split.products(widths, rows, K, backward):
            out[name] = out.get(name, 0) + 2 * m * k * n
        return out

    fwd, bwd = ops(False), ops(True)
    assert sum(fwd.values()) == (chip_smoke.kernel_flops(widths, rows, K)
                                 - rows * K * 2 * (H1 + dl))
    assert {k: bwd[k] for k in fwd} == fwd
    if len(widths) > 3:
        assert bwd["dW"] == bwd["dz"] == bwd["hidden"]
    else:
        assert "dW" not in bwd and "dz" not in bwd
    assert bwd["dW_out"] == 2 * rows * K * dl
    assert bwd["dW1_x"] == 2 * rows * H1
    assert bwd["dW1_h"] == bwd["dh"] == bwd["ph"] == 2 * rows * e * H1


PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126integrand_wide_gemm_kernelILi1ELi0ELb1ELb0EEEvNS_7OperandES1_PfxxxPKfxiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_126integrand_wide_gemm_kernelILi1ELi0ELb1ELb0EEEvNS_7OperandES1_PfxxxPKfxiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 33792 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126integrand_wide_gemm_kernelILi0ELi0ELb0ELb1EEEvNS_7OperandES1_PfxxxPKfxiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_126integrand_wide_gemm_kernelILi0ELi0ELb0ELb1EEEvNS_7OperandES1_PfxxxPKfxiiiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 33792 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125integrand_wide_add_kernelEPfPKfxix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125integrand_wide_add_kernelEPfPKfxix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, 400 bytes cmem[0]
"""


def test_ptxas_report_names_each_template_instance_with_its_shared_memory():
    assert _build.parse_ptxas(PTXAS) == {
        "integrand_wide_gemm_kernel<1,0,1,0>": {
            "stack_bytes": 0, "spill_stores_bytes": 0, "spill_loads_bytes": 0,
            "registers": 122, "smem_bytes": 33792},
        "integrand_wide_gemm_kernel<0,0,0,1>": {
            "stack_bytes": 8, "spill_stores_bytes": 4, "spill_loads_bytes": 4,
            "registers": 128, "smem_bytes": 33792},
        "integrand_wide_add_kernel": {
            "stack_bytes": 0, "spill_stores_bytes": 0, "spill_loads_bytes": 0,
            "registers": 14},
    }
