"""The port's checkpoints, snapshots and resume against the JAX package's
`umnn_tpu/training/checkpoint.py` and `umnn_tpu/training/resume.py`.

Float16 snapshots cross both ways with equal leaves (each side's float16
rounding of the same float32 values, compared exactly), for the plain and
the conditional flow; the port writes JAX's tree description too. The
best-checkpoint policy and the three resume cases of
`tests/test_resume.py` run on both packages with the same numbers; the
replayed learning rate agrees to float32 rounding (JAX keeps it in
float32, rtol 1e-6).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import flow_params_to_numpy
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.training import loops as tl
from umnn_tpu_torch.training.checkpoint import (
    BestTracker,
    CheckpointManager,
    _flatten,
    load_params_npz,
    save_params_npz,
)
from umnn_tpu_torch.training.resume import resume_training_state

CFG = dict(nb_flow=2, nb_in=3, hidden_derivative=(8, 8), hidden_embedding=(16,),
           embedding_s=2, nb_steps=10)


def _jax_params(cond_in: int, seed: int):
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    params = JaxFlow(**CFG, cond_in=cond_in).init(jax.random.PRNGKey(seed))
    params = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    rng = np.random.RandomState(seed)
    for p in params:  # a scaling that is not zero, so that it is carried
        p["scaling"] = rng.randn(*p["scaling"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("cond_in", [0, 3], ids=["plain", "conditional"])
def test_a_jax_snapshot_loads_into_the_port(cond_in, tmp_path):
    from umnn_tpu.training.checkpoint import save_params_npz as jax_save

    params = _jax_params(cond_in, 1)
    path = jax_save(tmp_path / "jax.f16.npz", params)
    flow = UMNNMAFFlow(**CFG, cond_in=cond_in, device="cpu")
    assert load_params_npz(path, flow) is flow
    got = _flatten(flow_params_to_numpy(flow))
    want = [np.asarray(a, np.float16).astype(np.float32) for a in _flatten(params)]
    assert len(got) == len(want) == 22  # per block: 3 integrand and 2 MADE layers, scaling
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for block, p in zip(flow.blocks, params):
        np.testing.assert_array_equal(block.scaling.numpy(),
                                      p["scaling"].astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("cond_in", [0, 3], ids=["plain", "conditional"])
def test_a_port_snapshot_loads_into_jax(cond_in, tmp_path):
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.training.checkpoint import load_params_npz as jax_load

    flow = UMNNMAFFlow(**CFG, cond_in=cond_in, seed=5, device="cpu")
    with torch.no_grad():
        for block in flow.blocks:
            block.scaling.normal_(generator=torch.Generator().manual_seed(2))
    path = save_params_npz(tmp_path / "port.f16.npz", flow)
    template = JaxFlow(**CFG, cond_in=cond_in).init(jax.random.PRNGKey(0))
    loaded = jax_load(path, template)
    got = [np.asarray(a) for a in jax.tree_util.tree_leaves(loaded)]
    want = [a.astype(np.float16).astype(np.float32) for a in _flatten(flow_params_to_numpy(flow))]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with np.load(path) as data:
        assert str(data["__treedef__"]) == str(jax.tree_util.tree_structure(template))
        assert all(data[k].dtype == np.float16 for k in data.files if k.startswith("leaf_"))


def test_snapshots_round_trip_in_the_port(tmp_path):
    src = UMNNMAFFlow(**CFG, seed=1, device="cpu")
    dst = UMNNMAFFlow(**CFG, seed=2, device="cpu")
    load_params_npz(save_params_npz(tmp_path / "a.npz", src, dtype=np.float32), dst)
    for (k, a), b in zip(src.state_dict().items(), dst.state_dict().values()):
        assert torch.equal(a, b), k


def test_a_snapshot_of_another_configuration_is_refused(tmp_path):
    path = save_params_npz(tmp_path / "one_block.npz", UMNNMAFFlow(**{**CFG, "nb_flow": 1},
                                                                    device="cpu"))
    with pytest.raises(ValueError, match="snapshot has 11 leaves, template has 22"):
        load_params_npz(path, UMNNMAFFlow(**CFG, device="cpu"))
    wide = save_params_npz(tmp_path / "wide.npz", UMNNMAFFlow(**{**CFG, "hidden_derivative": (9, 8)},
                                                              device="cpu"))
    with pytest.raises(ValueError, match=r"leaf_0 shape \(9,\) != template \(8,\)"):
        load_params_npz(wide, UMNNMAFFlow(**CFG, device="cpu"))


def _module(values):
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.tensor(values, dtype=torch.float32))
    return m


def test_checkpoint_manager_saves_restores_and_keeps_the_newest(tmp_path):
    ckpt = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert ckpt.restore() is None and ckpt.latest_step() is None
    assert ckpt.load_history() == {"train": [], "valid": [], "test": []}
    model = _module([1.0, 2.0])
    opt = tl.make_optimizer(model.parameters(), "adam", lr=1e-3)
    model.w.grad = torch.tensor([0.5, -0.5])
    opt.step()
    opt.lr = 2.5e-4
    for step in (0, 5, 10):
        ckpt.save(step, model.state_dict(), opt.state_dict(), {"train": [step], "valid": [], "test": []})
    assert ckpt.all_steps() == [5, 10] and ckpt.latest_step() == 10
    assert ckpt.load_history()["train"] == [10]
    step, model_state, opt_state = ckpt.restore()
    assert step == 10 and torch.equal(model_state["w"], model.w.detach())
    fresh = tl.make_optimizer(_module([0.0, 0.0]).parameters(), "adam", lr=1e-3)
    fresh.load_state_dict(opt_state)
    assert fresh.lr == 2.5e-4
    assert ckpt.restore(5)[0] == 5
    ckpt.delete_steps_from(6)
    assert ckpt.all_steps() == [5]
    (tmp_path / "ckpt" / "steps" / "7").mkdir()  # not a checkpoint of this package
    assert ckpt.latest_step() == 5
    for tag in ("train", "valid", "train_valid"):
        assert ckpt.load_best(tag) is None
        ckpt.save_best(tag, {"w": torch.tensor([float(len(tag))])})
    assert {p.name for p in (tmp_path / "ckpt").iterdir()} == {
        "steps", "history.json", "best_train", "best_valid", "best_train_valid"}
    assert float(ckpt.load_best("train_valid")["w"]) == 11.0


LOSSES = [(5.0, 5.0), (4.0, 4.5), (4.2, 4.1), (3.9, 4.3), (3.8, 3.0), (3.9, 2.9)]


def test_best_tracker_stashes_as_jax_does(tmp_path):
    import jax.numpy as jnp

    from umnn_tpu.training.checkpoint import BestTracker as JaxBest
    from umnn_tpu.training.checkpoint import CheckpointManager as JaxManager

    best = BestTracker(CheckpointManager(tmp_path / "port"))
    jbest = JaxBest(JaxManager(tmp_path / "jax"))
    model = _module([0.0])
    for i, (t, v) in enumerate(LOSSES):
        with torch.no_grad():
            model.w.fill_(float(i))
        best.update(t, v, model.state_dict())
        jbest.update(t, v, {"w": jnp.asarray([float(i)])})
        assert set(best._pending) == set(jbest._pending)
        assert {k: float(s["w"]) for k, s in best._pending.items()} == {
            k: float(p["w"][0]) for k, p in jbest._pending.items()}
        assert (best.best_train, best.best_valid) == (jbest.best_train, jbest.best_valid)
    # stashes are copies: the live parameter moves on, the stash stays
    with torch.no_grad():
        model.w.fill_(-1.0)
    assert float(best.best_params("valid", None)["w"]) == 5.0
    best.flush()
    assert not best._pending
    assert {k: float(best.manager.load_best(k)["w"]) for k in ("train", "valid", "train_valid")} == {
        "train": 4.0, "valid": 5.0, "train_valid": 4.0}


def _setup(tmp_path, poisoned: bool):
    """The port's copy of `tests/test_resume.py::_setup`."""
    model = _module([1.0, 2.0])
    opt = tl.make_optimizer(model.parameters(), "adam", lr=1e-3)
    ckpt = CheckpointManager(tmp_path / "ckpt")
    history = {"train": [5.1, 4.95, 4.9, 4.89], "valid": [5.0, 4.9, 4.89, 4.88], "test": []}
    good = _module([0.5, 0.5])
    ckpt.save_best("valid", good.state_dict())

    def saved_opt(lr):
        o = tl.make_optimizer(good.parameters(), "adam", lr=lr)
        return o.state_dict()

    if poisoned:
        bad = _module([np.nan, np.nan])
        history["train"] += [float("nan")] * 3
        history["valid"] += [float("nan")] * 3
        ckpt.save(4, good.state_dict(), saved_opt(5e-4))
        ckpt.save(5, bad.state_dict(), saved_opt(1.5625e-5), history)
    else:
        ckpt.save(4, good.state_dict(), saved_opt(5e-4), history)
    return model, opt, ckpt, history


def _jax_resume(tmp_path, poisoned: bool):
    sys.path.insert(0, str(Path(__file__).parent))
    from test_resume import _setup as jax_setup  # the JAX package's own setup

    from umnn_tpu.training.checkpoint import BestTracker as JaxBest
    from umnn_tpu.training.loops import ReduceLROnPlateau
    from umnn_tpu.training.resume import resume_training_state as jax_resume

    optimizer, params, opt_state, ckpt, history = jax_setup(tmp_path / "jax", poisoned)
    plateau = ReduceLROnPlateau(factor=0.5, patience=1)
    best = JaxBest(ckpt)
    params, opt_state, lr, start, history = jax_resume(
        ckpt, optimizer, template_params=params, template_opt_state=opt_state,
        history=history, plateau=plateau, best=best, init_lr=1e-3,
    )
    return np.asarray(params["w"]), lr, start, history, plateau, best


def _port_resume(tmp_path, poisoned: bool):
    model, opt, ckpt, history = _setup(tmp_path / "port", poisoned)
    plateau = tl.ReduceLROnPlateau(factor=0.5, patience=1)
    best = BestTracker(ckpt)
    lr, start, history = resume_training_state(
        ckpt, model, opt, history=history, plateau=plateau, best=best, init_lr=1e-3,
    )
    return model, opt, ckpt, lr, start, history, plateau, best


@pytest.mark.parametrize("poisoned", [False, True], ids=["normal", "non_finite_with_fallback"])
def test_resume_matches_jax(tmp_path, poisoned):
    model, opt, ckpt, lr, start, history, plateau, best = _port_resume(tmp_path, poisoned)
    jw, jlr, jstart, jhistory, jplateau, jbest = _jax_resume(tmp_path, poisoned)
    assert start == jstart == 4
    np.testing.assert_array_equal(model.w.detach().numpy(), jw)
    np.testing.assert_allclose(lr, jlr, rtol=1e-6)
    assert opt.lr == lr
    assert history == jhistory
    assert (plateau.best, plateau.bad_epochs) == (jplateau.best, jplateau.bad_epochs)
    assert (best.best_train, best.best_valid) == (jbest.best_train, jbest.best_valid)
    best.update(4.95, 4.95, model.state_dict())
    assert not best._pending
    if poisoned:
        # fresh moments at the replayed rate, the NaN checkpoints gone
        assert not opt.inner.state
        assert ckpt.latest_step() is None or ckpt.latest_step() < 4
        ckpt.save(4, model.state_dict(), opt.state_dict(), history)
        assert ckpt.latest_step() == 4
    else:
        assert lr == 5e-4


def test_resume_from_a_non_finite_checkpoint_without_fallback_raises(tmp_path):
    model = _module([1.0])
    opt = tl.make_optimizer(model.parameters(), "adam", lr=1e-3)
    ckpt = CheckpointManager(tmp_path / "ckpt")
    history = {"train": [float("nan")], "valid": [float("nan")], "test": []}
    ckpt.save(0, _module([np.nan]).state_dict(), opt.state_dict(), history)
    with pytest.raises(RuntimeError, match="no best-valid fallback"):
        resume_training_state(ckpt, model, opt, history=history,
                              plateau=tl.ReduceLROnPlateau(), init_lr=1e-3)
    assert json.loads((tmp_path / "ckpt" / "history.json").read_text())["valid"] != []
