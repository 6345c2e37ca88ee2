"""The port's VAE layers and flows against the JAX package's.

Weights are made in JAX and copied across. Tolerances: layers rtol 1e-5,
atol 1e-6 per call; masks bit for bit; flow functions' z and log-det rtol
1e-5, atol 1e-5, and each log-det against float64 autodiff; MMAF those of
tests/test_torch_flow.py (z atol 1e-5, log-det rtol 1e-5, atol 1e-4).
JAX's flows run with backend "xla", what its "auto" takes on the CPU; the
port's MMAF on "kernel" (its plain version on CPU tensors) and "torch".
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.models.vae import flows as PF
from umnn_tpu_torch.models.vae import layers as PL

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
FLOW_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


# --- layers -------------------------------------------------------------------


def _jax_conv(key, cin, cout, k):
    from umnn_tpu.models.vae.layers import conv_init

    return _np_tree(conv_init(key, cin, cout, k))


def test_conv2d_matches_jax():
    import jax
    from umnn_tpu.models.vae.layers import conv2d

    p = _jax_conv(jax.random.PRNGKey(0), 3, 5, 5)
    x = np.random.RandomState(0).randn(2, 3, 14, 14).astype(np.float32)
    layer = PL.conv2d_layer(3, 5, 5, torch.Generator(), stride=2, padding=2, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(_t(p["w"]))
        layer.bias.copy_(_t(p["b"]))
        got = layer(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(conv2d(p, x, 2, 2)), **LAYER_TOL)


# the decoder's three geometries: 7x7 from 1x1; 5x5 stride 2, padding 2,
# output padding 1; 5x5 stride 1, padding 2
CONV_T = {"first": (8, 6, 7, 1, 0, 0, 1), "up": (6, 4, 5, 2, 2, 1, 7),
          "same": (4, 4, 5, 1, 2, 0, 14)}


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("geom", list(CONV_T))
def test_conv_transpose2d_matches_jax(geom, gated):
    import jax
    from umnn_tpu.models.vae.layers import (conv_transpose2d, gated_conv_init,
                                            gated_conv_transpose2d)

    cin, cout, k, s, pd, op, hw = CONV_T[geom]
    x = np.random.RandomState(1).randn(2, cin, hw, hw).astype(np.float32)
    p = _np_tree(gated_conv_init(jax.random.PRNGKey(3), cin, cout, k))
    layer = PL.GatedConvTranspose2d(cin, cout, k, torch.Generator(), s, pd, op, device="cpu")
    load = {"h": layer.h, "g": layer.g}
    with torch.no_grad():
        for name, conv in load.items():
            conv.weight.copy_(_t(np.swapaxes(p[name]["w"], 0, 1)))
            conv.bias.copy_(_t(p[name]["b"]))
        if gated:
            got = layer(_t(x))
            want = gated_conv_transpose2d(p, x, s, pd, op)
        else:
            got = layer.h(_t(x))
            want = conv_transpose2d(p["h"], x, s, pd, op)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_gated_conv2d_matches_jax():
    import jax
    from umnn_tpu.models.vae.layers import gated_conv2d, gated_conv_init

    p = _np_tree(gated_conv_init(jax.random.PRNGKey(4), 2, 3, (7, 5)))
    x = np.random.RandomState(2).randn(2, 2, 7, 5).astype(np.float32)
    layer = PL.GatedConv2d(2, 3, (7, 5), torch.Generator(), device="cpu")
    with torch.no_grad():
        for name in ("h", "g"):
            getattr(layer, name).weight.copy_(_t(p[name]["w"]))
            getattr(layer, name).bias.copy_(_t(p[name]["b"]))
        got = layer(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(gated_conv2d(p, x)), **LAYER_TOL)


@pytest.mark.parametrize("n_in,n_out", [(4, 16), (16, 16), (16, 4), (6, 3)])
@pytest.mark.parametrize("diag", [False, True])
def test_block_mask_is_jax_bit_for_bit(n_in, n_out, diag):
    from umnn_tpu.models.vae.layers import build_block_mask

    np.testing.assert_array_equal(PL.build_block_mask(n_in, n_out, diag),
                                  build_block_mask(n_in, n_out, diag))


@pytest.mark.parametrize("n_in,n_out,k", [(2, 4, (3, 3)), (4, 2, (5, 5)), (3, 3, (3, 5))])
@pytest.mark.parametrize("diag", [False, True])
def test_pixelcnn_mask_is_jax_bit_for_bit(n_in, n_out, k, diag):
    from umnn_tpu.models.vae.layers import build_pixelcnn_mask

    np.testing.assert_array_equal(PL.build_pixelcnn_mask(n_in, n_out, k, diag),
                                  build_pixelcnn_mask(n_in, n_out, k, diag))


def test_masked_linear_matches_jax():
    import jax
    from umnn_tpu.models.vae.layers import build_block_mask, masked_linear, masked_linear_init

    p = _np_tree(masked_linear_init(jax.random.PRNGKey(5), 4, 8))
    p["b"] = np.random.RandomState(3).randn(8).astype(np.float32)
    x = np.random.RandomState(4).randn(5, 4).astype(np.float32)
    layer = PL.MaskedLinear(4, 8, torch.Generator(), device="cpu")
    assert "mask" in dict(layer.named_buffers())
    with torch.no_grad():
        layer.weight.copy_(_t(p["w"].T))
        layer.bias.copy_(_t(p["b"]))
        got = layer(_t(x))
    want = masked_linear(p, build_block_mask(4, 8), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_masked_conv2d_matches_jax():
    import jax
    from umnn_tpu.models.vae.layers import build_pixelcnn_mask, masked_conv2d, masked_conv2d_init

    p = _np_tree(masked_conv2d_init(jax.random.PRNGKey(6), 2, 4, (3, 3)))
    p["b"] = np.random.RandomState(5).randn(4).astype(np.float32)
    x = np.random.RandomState(6).randn(2, 2, 6, 6).astype(np.float32)
    layer = PL.MaskedConv2d(2, 4, torch.Generator(), (3, 3), device="cpu")
    assert "mask" in dict(layer.named_buffers())
    with torch.no_grad():
        layer.weight.copy_(_t(p["w"]))
        layer.bias.copy_(_t(p["b"]))
        got = layer(_t(x))
    want = masked_conv2d(p, build_pixelcnn_mask(2, 4, (3, 3)), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# --- flows --------------------------------------------------------------------


def _flow_inputs(kind: str, seed: int = 0, Zd: int = 5, M: int = 3, Bn: int = 4):
    """Amortized parameters of one flow, the Sylvester diagonals tanh-bounded
    as the families make them."""
    r = np.random.RandomState(seed)
    f = lambda *s: (0.5 * r.randn(*s)).astype(np.float32)  # noqa: E731
    z = f(Bn, Zd)
    if kind == "planar":
        return z, (f(Bn, Zd, 1), f(Bn, 1, Zd), f(Bn, 1, 1))
    m = Zd if kind == "triangular" else M
    triu = np.triu(np.ones((m, m), np.float32), 1)
    r1 = f(Bn, m, m) * triu + np.eye(m, dtype=np.float32) * np.tanh(f(Bn, m, 1))
    r2 = f(Bn, m, m) * triu + np.eye(m, dtype=np.float32) * np.tanh(f(Bn, m, 1))
    b = f(Bn, 1, m)
    if kind == "triangular":
        return z, (r1, r2, b)
    q = np.linalg.qr(r.randn(Bn, Zd, m))[0].astype(np.float32)
    return z, (r1, r2, q, b)


FLOW_FUNCS = {
    "planar": ("planar_flow", {}),
    "sylvester": ("sylvester_flow", {}),
    "triangular": ("triangular_sylvester_flow", {"permute": False}),
    "triangular_permuted": ("triangular_sylvester_flow", {"permute": True}),
}


def _flow_kind(case):
    return "triangular" if case.startswith("triangular") else case


@pytest.mark.parametrize("case", list(FLOW_FUNCS))
def test_flow_function_matches_jax(case):
    from umnn_tpu.models.vae import flows as JF

    fname, kw = FLOW_FUNCS[case]
    z, args = _flow_inputs(_flow_kind(case))
    zj, ldj = getattr(JF, fname)(z, *args, **kw)
    zt, ldt = getattr(PF, fname)(_t(z), *map(_t, args), **kw)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **FLOW_TOL)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), **FLOW_TOL)


def _logdet_of_jacobian(fn, z):
    """log|det dz'/dz| of each row, float64 autodiff."""
    out = []
    for row in torch.as_tensor(z, dtype=torch.float64):
        J = torch.autograd.functional.jacobian(lambda v: fn(v[None])[0], row)
        out.append(torch.linalg.slogdet(J)[1])
    return torch.stack(out)


@pytest.mark.parametrize("case", list(FLOW_FUNCS))
def test_flow_log_det_matches_float64_autodiff(case):
    fname, kw = FLOW_FUNCS[case]
    z, args = _flow_inputs(_flow_kind(case), seed=1)
    a64 = [torch.as_tensor(a, dtype=torch.float64) for a in args]
    if case == "sylvester":  # Q orthonormal in float64: the log-det assumes it
        a64[2] = torch.linalg.qr(a64[2])[0]
    per_row = []
    for i in range(len(z)):
        rows = [a[i : i + 1] for a in a64]
        per_row.append(_logdet_of_jacobian(
            lambda v: getattr(PF, fname)(v, *rows, **kw)[0], z[i : i + 1])[0])
    _, ld = getattr(PF, fname)(torch.as_tensor(z, dtype=torch.float64), *a64, **kw)
    np.testing.assert_allclose(ld.numpy(), torch.stack(per_row).numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kind", ["householder", "iterative"])
def test_orthogonalizers_match_jax_and_are_orthogonal(kind):
    from umnn_tpu.models.vae import flows as JF

    r = np.random.RandomState(7)
    if kind == "householder":
        q = r.randn(3, 4 * 6).astype(np.float32)
        want = JF.householder_orthogonalize(q, 6, 4)
        got = PF.householder_orthogonalize(_t(q), 6, 4)
    else:
        q = r.randn(3, 6 * 3).astype(np.float32)
        want = JF.iterative_orthogonalize(q, 6, 3)
        got = PF.iterative_orthogonalize(_t(q), 6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOW_TOL)
    qtq = got.transpose(1, 2) @ got
    np.testing.assert_allclose(qtq.numpy(), np.broadcast_to(np.eye(qtq.shape[-1]), qtq.shape),
                               atol=1e-5)


def test_householder_order_is_left_multiplication():
    """Each new reflection multiplies the running product on the left."""
    r = np.random.RandomState(8)
    q = torch.as_tensor(r.randn(1, 2 * 3))
    v = q.reshape(2, 3)
    v = v / v.norm(dim=-1, keepdim=True)
    H = [torch.eye(3, dtype=q.dtype) - 2 * torch.outer(vk, vk) for vk in v]
    torch.testing.assert_close(PF.householder_orthogonalize(q, 3, 2)[0], H[1] @ H[0])


def _iaf_pair(seed=0):
    import jax
    from umnn_tpu.models.vae.flows import IAF as JIAF

    jiaf = JIAF(z_size=4, num_flows=3, num_hidden=1, h_size=16)
    params = _np_tree(jiaf.init(jax.random.PRNGKey(seed)))
    r = np.random.RandomState(seed + 1)
    for fp in params["flows"]:  # non-zero biases
        for lp in [fp["z_feat"], fp["mean"], fp["std"], *fp["zh_feats"]]:
            lp["b"] = (0.1 * r.randn(*lp["b"].shape)).astype(np.float32)
    tiaf = PF.IAF(4, 3, 1, 16, device="cpu")
    with torch.no_grad():
        for step, fp in zip(tiaf.flows, params["flows"]):
            pairs = [(step.z_feat, fp["z_feat"]), (step.mean, fp["mean"]), (step.std, fp["std"])]
            pairs += list(zip(step.zh_feats, fp["zh_feats"]))
            for layer, lp in pairs:
                layer.weight.copy_(_t(lp["w"].T))
                layer.bias.copy_(_t(lp["b"]))
    return jiaf, params, tiaf


def test_iaf_matches_jax_and_its_log_det_is_exact():
    jiaf, params, tiaf = _iaf_pair()
    r = np.random.RandomState(9)
    z = r.randn(3, 4).astype(np.float32)
    h = r.randn(3, 16).astype(np.float32)
    zj, ldj = jiaf.apply(params, z, h)
    with torch.no_grad():
        zt, ldt = tiaf(_t(z), _t(h))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **FLOW_TOL)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), **FLOW_TOL)
    tiaf = tiaf.double()
    h64 = torch.as_tensor(h, dtype=torch.float64)
    for i in range(3):
        want = _logdet_of_jacobian(lambda v: tiaf(v, h64[i : i + 1])[0], z[i : i + 1])[0]
        _, got = tiaf(torch.as_tensor(z[i : i + 1], dtype=torch.float64), h64[i : i + 1])
        np.testing.assert_allclose(float(got[0]), float(want), rtol=1e-9, atol=1e-9)


def test_iaf_step_is_autoregressive():
    """One IAF step: output d depends only on inputs < d (the Jacobian is
    lower triangular with the gate on the diagonal)."""
    _, _, tiaf = _iaf_pair(seed=3)
    tiaf.flows = tiaf.flows[:1]
    tiaf = tiaf.double()
    z = torch.randn(4, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    h = torch.zeros(1, 16, dtype=torch.float64)
    J = torch.autograd.functional.jacobian(lambda v: tiaf(v[None], h)[0][0], z)
    assert float(torch.triu(J, 1).abs().max()) == 0.0


def _mmaf_pair(backend):
    import jax
    from umnn_tpu.models.vae.flows import MMAF as JMMAF

    kw = dict(z_size=4, num_flows=2, h_size=6, hidden_derivative=(8, 8),
              hidden_embedding=(16, 16), embedding_size=4, nb_steps=30)
    jm = JMMAF(**kw, backend="xla")
    params = _np_tree(jm.init(jax.random.PRNGKey(12)))
    r = np.random.RandomState(13)
    for p in params:
        p["scaling"] = (0.1 * r.randn(4)).astype(np.float32)
    tm = PF.MMAF(4, 2, 6, (8, 8), (16, 16), 4, 30, backend=backend, device="cpu")
    from umnn_tpu_torch.bridge import load_jax_flow_params

    load_jax_flow_params(tm.flow, params)
    return jm, params, tm


@pytest.mark.parametrize("padded", [False, True], ids=["K31", "K101_padded_31"])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_mmaf_matches_jax(backend, padded):
    from umnn_tpu.ops.quadrature import padded_cc_quadrature as jpad

    from umnn_tpu_torch.ops.quadrature import padded_cc_quadrature

    jm, params, tm = _mmaf_pair(backend)
    r = np.random.RandomState(14)
    z = r.randn(5, 4).astype(np.float32)
    h = r.randn(5, 6).astype(np.float32)
    quad_j, quad_t = {}, {}
    if padded:
        nj, wj = jpad(30, 100)
        quad_j = dict(nodes=nj, weights=wj)
        quad_t = dict(zip(("nodes", "weights"), padded_cc_quadrature(30, 100, "cpu")))
        assert quad_t["nodes"].numel() == 101
    zj, ldj = jm.apply(params, z, h, **quad_j)
    with torch.no_grad():
        zt, ldt = tm(_t(z), _t(h), **quad_t)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-5, atol=1e-4)


def test_mmaf_force_lipschitz_does_nothing_unless_positive():
    _, _, tm = _mmaf_pair("torch")
    before = [p.detach().clone() for p in tm.parameters()]
    tm.force_lipschitz(0.0)
    assert all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))
    tm.force_lipschitz(0.1, torch.Generator().manual_seed(0))
    assert not all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))


