"""The phase-clock copy of ``integrand_bwd.cu`` (``ops/bwd_phase_clock.py``).

It is compiled and run only on a card; here the source transformation is
checked: one counter after every barrier of the sweep kernel, each with
the comment that opens its phase, and the rest of the file as it was.
"""

import re

from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops.bwd_phase_clock import instrument

SRC = (_build.CSRC / "integrand_bwd.cu").read_text()


def _kernel_body(src: str) -> str:
    return src[src.index("integrand_bwd_kernel(const float*"):
               src.index("// out[p] = sum over the grid's blocks")]


def test_one_counter_per_barrier_of_the_sweep():
    out, labels = instrument(SRC)
    barriers = _kernel_body(SRC).count("__syncthreads();")
    assert barriers >= 5
    assert len(labels) == barriers
    ticks = [int(i) for i in re.findall(r"__syncthreads\(\); TICK\((\d+)\);", _kernel_body(out))]
    assert ticks == list(range(barriers))


def test_labels_are_the_phases_first_comments():
    _, labels = instrument(SRC)
    assert all(labels), labels
    assert any(label.startswith("Forward again") for label in labels)
    assert any(label.startswith("Layer 1: act[0] now holds dz1") for label in labels)


def test_the_rest_of_the_file_is_unchanged():
    out, _ = instrument(SRC)

    def head(src):  # from the first namespace to the kernel
        return src[src.index("namespace {"): src.index("integrand_bwd_kernel(const float*")]

    assert head(out) == head(SRC)
    assert "#define TICK(i)" in out[: out.index("namespace {")]
    for name in ("umnn_integrand_bwd_smem_bytes", "umnn_integrand_bwd_grid", "umnn_integrand_bwd("):
        assert name in out
    assert "int umnn_phase_clocks(unsigned long long* out, int clear)" in out
    assert "long long t_prev = clock64();" in out
