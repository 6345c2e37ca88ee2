"""The port's likelihood-validity report against the JAX package's
`umnn_tpu/utils/validity.py`, on the flow of `tests/test_validity.py`
carried across by the bridge, on the same rows.

Both evaluate in float32 (the port's bf16 check rounds a copy of the flow
and the rows to bfloat16 and back, as JAX rounds its parameter tree), so
``nll`` agrees within rtol 1e-5 and ``node_gap`` and ``bf16_gap``, each the
difference of two such means, within atol 1e-4; ``n_nonfinite``, ``rows``
and ``ok()`` exactly. Weights up to 3x JAX's init are compared. At 4x and
beyond the flow is ill-conditioned: rows whose integrand ends in ELU+1 of a
pre-activation near -17 sit at float32's last step below 1 (0 or 2^-24),
so log f moves by 6.4 nats per dimension on float32 noise, and JAX's jitted
evaluation gives NaN on every row; there both reports must only fail.
"""

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.utils.validity import ValidityReport, density_validity_report

CFG = dict(nb_flow=2, nb_in=4, hidden_embedding=(24, 24), hidden_derivative=(16, 16),
           embedding_s=4, nb_steps=20)
GAP_ATOL = 1e-4


def _reports(scale: float, backend: str):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.utils.validity import density_validity_report as jax_report

    jflow = JaxFlow(**CFG, backend="xla")
    params = jax.tree_util.tree_map(lambda a: a * scale, jflow.init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    want = jax_report(jflow, params, jnp.asarray(x), steps=20, check_steps=100)
    flow = load_jax_flow_params(UMNNMAFFlow(**CFG, backend=backend, device="cpu"),
                                [jax.tree_util.tree_map(np.asarray, p) for p in params])
    before = {k: v.clone() for k, v in flow.state_dict().items()}
    got = density_validity_report(flow, torch.tensor(x), steps=20, check_steps=100)
    # the bf16 check rounds a copy, never the flow itself
    assert all(torch.equal(v, before[k]) for k, v in flow.state_dict().items())
    return got, want


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("scale", [1.0, 3.0], ids=["init", "init_x3"])
def test_report_matches_jax(scale, backend):
    got, want = _reports(scale, backend)
    assert isinstance(got, ValidityReport)
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-5)
    assert abs(got.node_gap - want.node_gap) <= GAP_ATOL
    assert abs(got.bf16_gap - want.bf16_gap) <= GAP_ATOL
    assert (got.n_nonfinite, got.rows) == (want.n_nonfinite, want.rows) == (0, 64)
    assert got.ok() and want.ok()


def test_an_ill_conditioned_flow_fails_in_both():
    got, want = _reports(8.0, "torch")
    assert not got.ok() and not want.ok()
    assert got.bf16_gap > 1.0 and got.node_gap > 0.05


def test_custom_nll_fn_and_ok_thresholds():
    flow = UMNNMAFFlow(**CFG, backend="torch", device="cpu")
    x = torch.tensor(np.random.RandomState(1).randn(32, 4).astype(np.float32))
    calls = []

    def nll_fn(m, xb, nodes, weights):
        calls.append(nodes.numel())
        return -m.compute_ll(xb, nodes=nodes, weights=weights)[0]

    rep = density_validity_report(flow, x, nll_fn=nll_fn, steps=10, check_steps=40)
    assert calls == [41, 41, 41]  # both counts padded to the larger, as in JAX
    assert rep.ok() and rep.rows == 32
    assert not ValidityReport(1.0, 0.06, 0.0, 0, 1).ok()
    assert not ValidityReport(1.0, 0.0, 1.0, 0, 1).ok()
    assert not ValidityReport(1.0, 0.0, 0.0, 1, 1).ok()
    assert not ValidityReport(float("nan"), 0.0, 0.0, 0, 1).ok()
