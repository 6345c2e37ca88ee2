"""The pack-4 route's host path: what one call of the wrapper asks of the C
library and hands to the launchers.

The pack-4 kernels read each layer's own weight and bias tensor, so the
route packs nothing: the launcher gets the layers' addresses, w0, b0, w1,
b1, .... The C helpers (whether a kernel takes the widths; its resident
blocks, which also sets its shared memory on the card) are asked once per
widths, K and device, not once per call. The other routes still pack the
weights into one buffer on every call. The CUDA library cannot be built
here, so it is stubbed, and the wrapper is driven on CPU tensors as if they
lay on the card; on the card ``chip_smoke.py``'s phases ``kernel_p4``,
``bwd_p4`` and ``toy`` run the real one.
"""

import contextlib
import ctypes
from types import SimpleNamespace

import pytest
import torch

from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops import integrand_kernel as ik

SLOTS = 5


class FakeLibrary:
    """Every helper takes every width (4 bytes of shared memory); every
    helper call and every launch, with its arguments, is recorded."""

    def __init__(self):
        self.asked, self.launched = [], []
        for route in ("", "_p2", "_p4", "_wide"):
            for kind in ("fwd", "bwd"):
                kernel = f"{kind}{route}"
                setattr(self, f"umnn_integrand_{kernel}", self._launcher(kernel))
                if route != "_wide":
                    setattr(self, f"umnn_integrand_{kernel}_smem_bytes",
                            self._helper(kernel, "smem_bytes", 4))
        for kind in ("fwd", "bwd"):
            setattr(self, f"umnn_integrand_{kind}_p4_slots",
                    self._helper(f"{kind}_p4", "slots", SLOTS))
        self.umnn_integrand_bwd_grid = lambda R: 3
        self.umnn_integrand_bwd_p2_grid = lambda R, K, ptr, n: 3

    def _helper(self, kernel, what, value):
        def helper(K, ptr, n_layers):
            widths = list(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[: n_layers + 1])
            self.asked.append((what, kernel, tuple(widths), K))
            return value
        return helper

    def _launcher(self, kernel):
        def launch(*args):
            self.launched.append((kernel, args))
            return 0
        return launch

    def umnn_integrand_wide_scratch_floats(self, rows, K, ptr, n_layers):
        return 4


@pytest.fixture
def lib(monkeypatch):
    """The stubbed library, the wrapper taking CPU tensors for CUDA ones, and
    a record of every packing of the weights."""
    fake = FakeLibrary()
    fake.packed = []
    monkeypatch.setattr(_build, "load_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(shared_memory_per_block_optin=232448))
    on_card = ik._on_card
    monkeypatch.setattr(ik, "_on_card", lambda *args: on_card(*args) or True)
    monkeypatch.setattr(ik, "_on", lambda device: contextlib.nullcontext(0))
    packed_params = ik._packed_params

    def packing(ws, bs):
        fake.packed.append(len(ws))
        return packed_params(ws, bs)

    monkeypatch.setattr(ik, "_packed_params", packing)
    return fake


def _inputs(widths, rows=3, K=17):
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(b, a, generator=gen) for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.randn(b, generator=gen) for b in widths[1:]]
    x = torch.randn(rows, generator=gen)
    h = torch.randn(rows, widths[0] - 1, generator=gen)
    nodes, ccw = torch.linspace(-1, 1, K), torch.full((K,), 2.0 / K)
    return ws, bs, x, h, nodes, ccw


def _step(ws, bs, x, h, nodes, ccw, **route):
    """A forward and its backward through the autograd Function."""
    ws = [w.requires_grad_() for w in ws]
    z = ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, **route)
    torch.autograd.grad(z.sum(), ws)
    return ws


@pytest.mark.parametrize("widths", [[11, 32, 32, 1], [9, 32, 32, 1], [5, 7, 13, 30, 1]],
                         ids=["toy", "flagship", "uneven"])
def test_the_pack4_route_passes_each_layers_own_tensors_and_packs_nothing(lib, widths):
    ws, bs, x, h, nodes, ccw = _inputs(widths)
    ws = _step(ws, bs, x, h, nodes, ccw)
    assert [k for k, _ in lib.launched] == ["fwd_p4", "bwd_p4"]
    assert lib.packed == []
    want = [t.data_ptr() for w, b in zip(ws, bs) for t in (w, b)]
    for kernel, args in lib.launched:
        assert list(args[2]) == want, kernel  # the layers' addresses, w0, b0, w1, b1, ...
    # the resident blocks go to both launchers: the forward's after its K,
    # the backward's after R and K, which is also its partial sums' slices
    fwd_args, bwd_args = lib.launched[0][1], lib.launched[1][1]
    assert fwd_args[6:9] == (x.numel(), nodes.numel(), SLOTS)
    assert bwd_args[11:14] == (x.numel(), nodes.numel(), SLOTS)


def test_two_calls_with_the_same_widths_and_K_ask_the_helpers_once(lib):
    widths = [11, 32, 32, 1]
    args = _inputs(widths)
    _step(*args)
    _step(*args)
    ik.fused_cc_integral_bwd(*args, torch.ones(3))
    key = (tuple(widths), 17)
    assert sorted(lib.asked) == sorted(
        [("smem_bytes", "fwd_p4", *key), ("smem_bytes", "bwd_p4", *key),
         ("slots", "fwd_p4", *key), ("slots", "bwd_p4", *key)])
    assert [k for k, _ in lib.launched] == ["fwd_p4", "bwd_p4"] * 2 + ["bwd_p4"]
    # another K is asked again, once
    _step(*_inputs(widths, K=21))
    _step(*_inputs(widths, K=21))
    assert len(lib.asked) == 8


@pytest.mark.parametrize("widths, route, launched", [
    ([31, 100, 50, 1], {}, ["fwd", "bwd"]),
    ([31, 50, 50, 1], {}, ["fwd_p2", "bwd_p2"]),
    ([11, 32, 32, 1], {"pack4": False}, ["fwd_p2", "bwd_p2"]),
    ([11, 32, 32, 1], {"pack2": False, "pack4": False}, ["fwd", "bwd"]),
    ([31, 129, 1], {}, ["fwd_wide", "bwd_wide"]),
], ids=["unpacked", "pack2", "pack4_false", "unpacked_at_toy_widths", "streamed"])
def test_every_other_route_still_packs_the_weights_on_each_call(lib, widths, route, launched):
    if route == {} and widths[1] == 129:
        # the stub's helpers take every width: make the unpacked ones refuse it
        lib.umnn_integrand_fwd_smem_bytes = lambda K, ptr, n: -1
    args = _inputs(widths)
    _step(*args, **route)
    _step(*args, **route)
    assert [k for k, _ in lib.launched] == launched * 2
    assert lib.packed == [len(widths) - 1] * 4
    for kernel, call in lib.launched:
        assert isinstance(call[2], int), kernel  # the packed buffer's address


@pytest.mark.parametrize("route", [{}, {"pack4": False}], ids=["pack4", "pack2"])
def test_no_rows_give_zero_gradients_without_a_launch(lib, route):
    ws, bs, _, _, nodes, ccw = _inputs([11, 32, 32, 1])
    x, h = torch.zeros(0), torch.zeros(0, 10)
    dws, dbs, dx, dh, S = ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, torch.zeros(0),
                                                   **route)
    assert lib.launched == []
    assert all(bool((d == 0).all()) for d in dws + dbs)
    assert dx.shape == x.shape and dh.shape == h.shape and S.shape == x.shape
