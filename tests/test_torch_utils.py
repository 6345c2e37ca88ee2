"""The port's utilities against the JAX package's `umnn_tpu/utils`:
``AverageMeter`` (`logging.py:71-84`), the timing helpers and trace of
`profiling.py`, and the plots of `visualize.py` (matplotlib is installed
here; the plots' log-densities are computed in torch).
"""

import json

import numpy as np
import pytest
import torch

from umnn_tpu_torch.utils import profiling, visualize
from umnn_tpu_torch.utils.logging import AverageMeter, MetricsWriter


def _log_density(pts: np.ndarray) -> np.ndarray:
    """A two-component Gaussian mixture's log-density, in float32."""
    a = -0.5 * np.sum((pts - 1.0) ** 2, axis=1)
    b = -0.5 * np.sum((pts + 1.5) ** 2 / 0.5, axis=1)
    return (np.logaddexp(a, b) - np.log(2 * np.pi)).astype(np.float32)


def test_average_meter_matches_jax():
    from umnn_tpu.utils.logging import AverageMeter as JaxMeter

    ours, theirs = AverageMeter(), JaxMeter()
    assert ours.avg == theirs.avg == 0.0
    for value, n in ((1.5, 1), (2.0, 3), (-0.25, 2)):
        ours.update(value, n)
        theirs.update(value, n)
    assert (ours.sum, ours.count, ours.avg) == (theirs.sum, theirs.count, theirs.avg)


def test_timed_steps_and_device_time_keys_and_units():
    x = torch.randn(64, 64)
    stats = profiling.timed_steps(lambda: x @ x, n=4)
    assert set(stats) == {"mean_s", "min_s", "max_s", "total_s"}
    assert 0.0 <= stats["min_s"] <= stats["mean_s"] <= stats["max_s"] <= stats["total_s"] < 10.0
    assert stats["total_s"] == pytest.approx(4 * stats["mean_s"])
    seconds = profiling.device_time(lambda a: (a @ a, {"b": a}), x, iters=5)
    assert 0.0 <= seconds < 10.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr") as path:
        torch.randn(32, 32) @ torch.randn(32, 32)
    events = json.loads(path.read_text())["traceEvents"]
    assert path == tmp_path / "tr" / "trace.json" and len(events) > 0


def test_density_grid_matches_jax_on_one_log_density():
    import jax.numpy as jnp

    from umnn_tpu.utils.visualize import density_grid as jax_density_grid

    xx, yy, px = visualize.density_grid(
        lambda t: torch.as_tensor(_log_density(t.numpy())), npts=41, memory=300, device="cpu")
    xx_j, yy_j, px_j = jax_density_grid(lambda p: jnp.asarray(_log_density(np.asarray(p))),
                                        npts=41, memory=300)
    np.testing.assert_array_equal(xx, xx_j)
    np.testing.assert_array_equal(yy, yy_j)
    assert px.dtype == np.asarray(px_j).dtype and px.shape == (41, 41)
    np.testing.assert_array_equal(px, np.asarray(px_j))


def test_plots_write_pngs(tmp_path):
    def log_prob(t):
        return torch.as_tensor(_log_density(t.numpy()))

    samples = np.random.RandomState(0).randn(200, 2).astype(np.float32)
    paths = [
        visualize.visualize_transform(samples, log_prob, tmp_path / "density.png", npts=30,
                                      device="cpu"),
        visualize.visualize_transform(None, log_prob, tmp_path / "density_only.png", npts=30,
                                      device="cpu"),
        visualize.image_grid(np.random.RandomState(1).rand(12, 28, 28), tmp_path / "grid.png",
                             ncols=5),
    ]
    metrics = MetricsWriter(tmp_path / "metrics.jsonl")
    for step in range(3):
        metrics.scalar("train_nll", 3.0 - step, step)
        metrics.scalar("valid_bpp", 5.0 - step, step)
    metrics.close()
    paths.append(visualize.plot_training_curves(tmp_path / "metrics.jsonl",
                                                tmp_path / "curves.png", tags=["train_nll"]))
    for path in paths:
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    ax = visualize.plt_stream(lambda t: t * 1.5, npts=12, device="cpu")
    assert ax.get_title() == "Density streamflow"
