"""The port's optimizer, train step and loop helpers against the JAX
package's `umnn_tpu/training/loops.py`, and the MNIST training driver.

The optimizers are compared on shared gradients, not over whole training
steps: Adam's first steps move each parameter by about ``lr*sign(g)``, so
a whole-step comparison would turn float32 noise in near-zero gradients
into differences of order lr. Parameters after 5 steps: rtol 1e-6, atol
1e-7. The one known gap: optax takes Adam's bias correction ``1 - 0.999^t``
in float32 (1.3e-5 relative off at t=1), torch in float64, which moves an
update of lr = 1e-3 by about 7e-9 per step.
"""

import json

import numpy as np
import pytest
import torch

from umnn_tpu_torch.training import loops as tl

SHAPES = [(3, 4), (4,), (2, 2, 3)]
STEPS = 5


def _init():
    rng = np.random.RandomState(0)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _grads():
    rng = np.random.RandomState(1)
    # scale 3: many entries above the value clip of 1.0
    return [[3.0 * rng.randn(*s).astype(np.float32) for s in SHAPES] for _ in range(STEPS)]


def _jax_run(name, lr, wd, clip):
    import jax.numpy as jnp
    import optax

    from umnn_tpu.training.loops import make_optimizer

    params = [jnp.asarray(p) for p in _init()]
    opt = make_optimizer(name, lr=lr, weight_decay=wd, grad_clip=clip)
    state = opt.init(params)
    for g in _grads():
        updates, state = opt.update([jnp.asarray(a) for a in g], state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _port_run(name, lr, wd, clip):
    params = [torch.nn.Parameter(torch.tensor(p)) for p in _init()]
    opt = tl.make_optimizer(params, name, lr, wd, clip)
    for g in _grads():
        for p, a in zip(params, g):
            p.grad = torch.tensor(a)
        opt.step()
    return [p.detach().numpy() for p in params]


@pytest.mark.parametrize(
    "name,lr,wd,clip",
    [("adam", 1e-3, 1e-2, 1.0), ("adam", 1e-3, 0.0, None), ("adamax", 1e-3, 1e-2, 1.0)],
    ids=["adam_wd_clip", "adam_plain", "adamax_wd_ignored"],
)
def test_optimizer_matches_jax_on_shared_gradients(name, lr, wd, clip):
    got, want = _port_run(name, lr, wd, clip), _jax_run(name, lr, wd, clip)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert any(not np.allclose(a, p) for a, p in zip(got, _init()))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        tl.make_optimizer([torch.nn.Parameter(torch.zeros(2))], "sgd")


def _batches():
    rng = np.random.RandomState(3)
    out = []
    for i in range(4):
        x = rng.randn(8, 3).astype(np.float32)
        if i == 1:
            x[2, 1] = np.nan  # a diverged batch
        out.append((x, rng.randn(8).astype(np.float32)))
    return out


def test_train_step_matches_jax_and_skips_a_non_finite_batch():
    import jax.numpy as jnp

    from umnn_tpu.training.loops import make_optimizer, make_train_step

    w0, b0 = np.array([0.5, -0.3, 0.2], np.float32), np.float32(0.1)

    def loss_j(p, batch):
        x, y = batch
        return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)

    opt_j = make_optimizer("adam", 1e-3, 1e-2, 1.0)
    params_j = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state_j = opt_j.init(params_j)
    step_j = make_train_step(loss_j, opt_j)

    w, b = torch.nn.Parameter(torch.tensor(w0)), torch.nn.Parameter(torch.tensor(b0))
    opt = tl.make_optimizer([w, b], "adam", 1e-3, 1e-2, 1.0)
    step = tl.make_train_step(lambda x, y: torch.mean((x @ w + b - y) ** 2), opt)

    losses_j, losses = [], []
    for i, (x, y) in enumerate(_batches()):
        params_j, state_j, lj = step_j(params_j, state_j, (jnp.asarray(x), jnp.asarray(y)))
        before = [t.detach().clone() for t in (w, b)]
        moments = {k: v.clone() if torch.is_tensor(v) else v for k, v in opt.inner.state[w].items()}
        lt = step(torch.tensor(x), torch.tensor(y))
        losses_j.append(lj)
        losses.append(lt)
        if i == 1:  # the NaN batch leaves parameters, moments and step count alone
            assert not torch.isfinite(lt)
            assert all(torch.equal(a, t) for a, t in zip(before, (w, b)))
            for k, v in opt.inner.state[w].items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(moments[k])), k
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params_j["w"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b.item(), float(params_j["b"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(torch.stack(losses).numpy(), np.asarray(losses_j), rtol=1e-6)
    assert float(opt.inner.state[w]["step"]) == 3


def test_finite_mean_matches_jax():
    import jax.numpy as jnp

    from umnn_tpu.training.loops import finite_mean

    vals = [1.5, np.nan, 2.25, np.inf, -0.5]
    want = finite_mean([jnp.asarray(v, jnp.float32) for v in vals])
    assert tl.finite_mean([torch.tensor(v, dtype=torch.float32) for v in vals]) == want
    assert tl.finite_mean([torch.tensor(np.nan)]) == (float("inf"), 1)


@pytest.mark.parametrize("shuffle,with_counts", [(True, False), (False, True), (True, True)])
def test_batch_iter_matches_jax(shuffle, with_counts):
    from umnn_tpu.training.loops import batch_iter

    x = np.arange(23 * 2).reshape(23, 2)
    got = list(tl.batch_iter(x, 5, np.random.RandomState(4), shuffle, with_counts))
    want = list(batch_iter(x, 5, np.random.RandomState(4), shuffle, with_counts))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        if with_counts:
            assert a[1] == b[1]
            a, b = a[0], b[0]
        np.testing.assert_array_equal(a, b)


def test_plateau_schedule_matches_jax():
    from umnn_tpu.training.loops import ReduceLROnPlateau

    metrics = [5.0, 4.0, 3.99, 3.98, 3.97, 2.0, 2.0, 1.99, 1.98, 1.97, 1.96]
    ours, theirs = tl.ReduceLROnPlateau(0.5, 2), ReduceLROnPlateau(0.5, 2)
    lr_a = lr_b = 1e-3
    for m in metrics:
        lr_a, lr_b = ours.update(m, lr_a), theirs.update(m, lr_b)
        assert lr_a == lr_b
    assert lr_a < 1e-3


TINY = (
    "-device cpu -nb_flow 2 -hidden_embedding 16 -hidden_derivative 8 8 -embedding_s 2 "
    "-ar1_rows 200 -steps_per_epoch 3 -nb_epoch 2 -nb_steps 4"
)


def test_driver_trains_at_a_tiny_size(capsys, tmp_path):
    from umnn_tpu_torch.examples import train_mnist

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = train_mnist.main(TINY.split() + ["-folder", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    epochs = [l for l in lines if "epoch" in l]
    assert [l["epoch"] for l in epochs] == [0, 1]
    for l in epochs:
        assert np.isfinite(l["train_nll"]) and np.isfinite(l["valid_bpp"]) and l["skipped"] == 0
    assert np.isfinite(result["test_bpp"]) and result["floor_bpp"] < 8.0


def test_driver_without_device_raises_when_cuda_is_absent(monkeypatch):
    from umnn_tpu_torch.examples import train_mnist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY.split() if a not in ("-device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mnist.main(argv)


def test_driver_scores_test_bpp_every_epoch_and_finally_on_the_best_valid_epoch(capsys, tmp_path):
    from umnn_tpu_torch.examples import train_mnist

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        # lr 0.02: the valid bpp rises in the last epoch, so the best epoch is not the last
        result = train_mnist.main(TINY.replace("-nb_epoch 2", "-nb_epoch 4").split()
                                  + ["-lr", "0.02", "-folder", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    epochs = [l for l in lines if "epoch" in l]
    assert len(epochs) == 4 and all(np.isfinite(l["test_bpp"]) for l in epochs)
    best = min(epochs, key=lambda l: l["valid_bpp"])
    assert result["test_bpp"] == best["test_bpp"]
    if best is not epochs[-1]:
        assert result["test_bpp"] != epochs[-1]["test_bpp"]
