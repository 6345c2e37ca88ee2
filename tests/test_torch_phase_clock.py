"""The phase-clock copies of ``integrand_bwd.cu``, ``integrand_bwd_p2.cu``,
``integrand_bwd_p4.cu``, ``integrand_fwd.cu``, ``integrand_fwd_p2.cu`` and
``integrand_fwd_p4.cu`` (``ops/bwd_phase_clock.py``, with ``--kernel bwd``,
``bwd_p2`` and ``bwd_p4``, and ``ops/fwd_phase_clock.py``, with ``--kernel
fwd``, ``fwd_p2`` and ``fwd_p4``).

They are compiled and run only on a card; here the source transformation is
checked for the six kernels: one counter after every barrier of the kernel,
each with the comment that opens its phase, and the rest of the file as it
was.
"""

import re

import pytest

from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops.bwd_phase_clock import (BWD_MARKERS, BWD_P2_MARKERS, BWD_P4_MARKERS,
                                                instrument)
from umnn_tpu_torch.ops.bwd_phase_clock import KERNELS as CLOCKED
from umnn_tpu_torch.ops.fwd_phase_clock import FWD_MARKERS, FWD_P2_MARKERS, FWD_P4_MARKERS
from umnn_tpu_torch.ops.fwd_phase_clock import KERNELS as FWD_CLOCKED

# per kernel: its source, markers, C functions, and phases its labels name
KERNELS = {
    "bwd": ("integrand_bwd.cu", BWD_MARKERS,
            ("umnn_integrand_bwd_smem_bytes", "umnn_integrand_bwd_grid", "umnn_integrand_bwd("),
            ("Forward again", "Layer 1: act[0] now holds dz1")),
    "bwd_p2": ("integrand_bwd_p2.cu", BWD_P2_MARKERS,
               ("umnn_integrand_bwd_p2_smem_bytes", "umnn_integrand_bwd_p2_grid",
                "umnn_integrand_bwd_p2("),
               ("Forward again", "Layer 1: act[0] now holds dz1")),
    "bwd_p4": ("integrand_bwd_p4.cu", BWD_P4_MARKERS,
               ("umnn_integrand_bwd_p4_smem_bytes", "umnn_integrand_bwd_p4_slots",
                "umnn_integrand_bwd_p4_occupancy", "umnn_integrand_bwd_p4("),
               ("Stage the weights", "Forward again", "Hidden layers", "The dz of the layer below",
                "Layer 1: act[0] now holds dz1", "The row tile's node sums")),
    "fwd": ("integrand_fwd.cu", FWD_MARKERS,
            ("umnn_integrand_fwd_smem_bytes", "umnn_integrand_fwd_occupancy",
             "umnn_integrand_fwd("),
            ("Hidden products", "Output layer: each pair's partial sums")),
    "fwd_p2": ("integrand_fwd_p2.cu", FWD_P2_MARKERS,
               ("umnn_integrand_fwd_p2_smem_bytes", "umnn_integrand_fwd_p2_occupancy",
                "umnn_integrand_fwd_p2("),
               ("Stage the weights", "Node-invariant first layer", "Hidden products",
                "Output layer: each node slot's partial sums")),
    "fwd_p4": ("integrand_fwd_p4.cu", FWD_P4_MARKERS,
               ("umnn_integrand_fwd_p4_smem_bytes", "umnn_integrand_fwd_p4_slots",
                "umnn_integrand_fwd_p4_occupancy", "umnn_integrand_fwd_p4("),
               ("Stage the weights", "Node-invariant first layer", "Hidden products",
                "Output layer: f at every item")),
}


def _source(kernel: str) -> str:
    return (_build.CSRC / KERNELS[kernel][0]).read_text()


def _kernel_body(src: str, markers) -> str:
    start = src.index(markers[0])
    return src[start: src.index(markers[1], start)]


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_one_counter_per_barrier_of_the_sweep(kernel):
    src, markers = _source(kernel), KERNELS[kernel][1]
    out, labels = instrument(src, *markers)
    barriers = _kernel_body(src, markers).count("__syncthreads();")
    assert barriers >= 5
    assert len(labels) == barriers
    ticks = [int(i) for i in re.findall(r"__syncthreads\(\); TICK\((\d+)\);",
                                        _kernel_body(out, markers))]
    assert ticks == list(range(barriers))


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_labels_are_the_phases_first_comments(kernel):
    _, labels = instrument(_source(kernel), *KERNELS[kernel][1])
    assert all(labels), labels
    for phase in KERNELS[kernel][3]:
        assert any(label.startswith(phase) for label in labels), (phase, labels)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_the_rest_of_the_file_is_unchanged(kernel):
    src, markers = _source(kernel), KERNELS[kernel][1]
    out, _ = instrument(src, *markers)

    def head(text):  # from the first namespace to the kernel
        return text[text.index("namespace {"): text.index(markers[0])]

    assert head(out) == head(src)
    assert "#define TICK(i)" in out[: out.index("namespace {")]
    for name in KERNELS[kernel][2]:
        assert name in out
    assert "int umnn_phase_clocks(unsigned long long* out, int clear)" in out
    assert "long long t_prev = clock64();" in out


@pytest.mark.parametrize("kernel", ["bwd", "bwd_p2", "bwd_p4"])
def test_the_clock_script_names_each_backward_by_its_file(kernel):
    assert CLOCKED[kernel][:2] == KERNELS[kernel][:2]


@pytest.mark.parametrize("kernel", ["fwd", "fwd_p2", "fwd_p4"])
def test_the_clock_script_names_each_forward_by_its_file_and_block(kernel):
    """Each forward is clocked on its backward's block: the MNIST block for
    the unpacked pair, the calibration block for the pack-2 pair, the
    4,096-row block for the pack-4 pair."""
    assert FWD_CLOCKED[kernel][:2] == KERNELS[kernel][:2]
    assert FWD_CLOCKED[kernel][2:] == CLOCKED[kernel.replace("fwd", "bwd")][2:]
