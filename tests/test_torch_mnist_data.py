"""The port's MNIST data (`umnn_tpu_torch/data/images.py`), its downloader
(`umnn_tpu_torch/data/download.py`) and the MNIST driver's data and
class-conditional flags, against the JAX package's `umnn_tpu/data/images.py`
and `examples/train_mnist.py`.

The idx files are written by the tests, raw and gzipped; the loaders give
the same bytes and, from one seed, the same float32 bits as JAX's. The
downloader runs only against ``file://`` URLs of test-written files.
"""

import gzip
import io
import json
import struct
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.data import download, images
from umnn_tpu_torch.examples import train_mnist
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.training.checkpoint import CheckpointManager

NAMES = images.MNIST_FILES
MNIST = ("-device cpu -nb_flow 1 -hidden_embedding 16 -hidden_derivative 8 8 -embedding_s 2 "
         "-steps_per_epoch 2 -nb_steps 4")
COND_FLOW = dict(nb_flow=1, nb_in=784, hidden_derivative=(8, 8), hidden_embedding=(16,),
                 embedding_s=2, nb_steps=4, cond_in=10)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _idx_bytes(a: np.ndarray) -> bytes:
    magic = 0x0800 | a.ndim  # unsigned bytes, then the number of dimensions
    return struct.pack(">I", magic) + struct.pack(">" + "I" * a.ndim, *a.shape) + a.tobytes()


def _mnist_arrays(n_train=60, n_test=12, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n_train, 28, 28)).astype(np.uint8),
            rng.randint(0, 10, n_train).astype(np.uint8),
            rng.randint(0, 256, (n_test, 28, 28)).astype(np.uint8),
            rng.randint(0, 10, n_test).astype(np.uint8))


def _write_mnist(root: Path, gz: bool, arrays=None) -> tuple:
    arrays = arrays or _mnist_arrays()
    d = root / "mnist"
    d.mkdir(parents=True, exist_ok=True)
    for name, a in zip(NAMES, arrays):
        if gz:
            (d / (name + ".gz")).write_bytes(gzip.compress(_idx_bytes(a)))
        else:
            (d / name).write_bytes(_idx_bytes(a))
    return arrays


def _assert_flow_data_equal(got, want):
    for field in ("trn_x", "trn_y", "val_x", "val_y", "tst_x", "tst_y"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_read_idx_and_load_mnist_raw_match_jax_byte_for_byte(tmp_path, gz):
    from umnn_tpu.data import images as jax_images

    arrays = _write_mnist(tmp_path, gz)
    got = images.load_mnist_raw(tmp_path)
    want = jax_images.load_mnist_raw(tmp_path)
    for a, b, orig in zip(got, want, arrays):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == orig.shape
        assert a.tobytes() == b.tobytes() == orig.tobytes()
    path = tmp_path / "mnist" / (NAMES[0] + (".gz" if gz else ""))
    assert images._read_idx(path).tobytes() == jax_images._read_idx(path).tobytes()


def test_load_mnist_raw_names_the_first_missing_file(tmp_path):
    _write_mnist(tmp_path, gz=False)
    (tmp_path / "mnist" / NAMES[2]).unlink()
    with pytest.raises(FileNotFoundError, match=NAMES[2]):
        images.load_mnist_raw(tmp_path)


def test_add_uniform_noise_and_logit_is_jax_bit_for_bit():
    from umnn_tpu.data import images as jax_images

    x = np.random.RandomState(1).randint(0, 256, (7, 784)).astype(np.uint8)
    got = images.add_uniform_noise_and_logit(x, np.random.RandomState(5))
    want = jax_images.add_uniform_noise_and_logit(x, np.random.RandomState(5))
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_load_mnist_flow_stand_in_is_jax_bit_for_bit(tmp_path, seed):
    """synthetic=True, and synthetic=None where the files are absent: 1,200
    train images split 1,000 / 200, 200 test, labels and noise from the
    seed."""
    from umnn_tpu.data import images as jax_images

    got = images.load_mnist_flow(tmp_path, seed=seed, synthetic=True)
    _assert_flow_data_equal(got, jax_images.load_mnist_flow(tmp_path, seed=seed, synthetic=True))
    assert (len(got.trn_x), len(got.val_x), len(got.tst_x)) == (1000, 200, 200)
    _assert_flow_data_equal(images.load_mnist_flow(tmp_path, seed=seed, synthetic=None), got)


def test_load_mnist_flow_from_files_is_jax_bit_for_bit(tmp_path):
    from umnn_tpu.data import images as jax_images

    _write_mnist(tmp_path, gz=True)
    for synthetic in (None, False):
        got = images.load_mnist_flow(tmp_path, seed=2, synthetic=synthetic)
        _assert_flow_data_equal(got, jax_images.load_mnist_flow(tmp_path, seed=2,
                                                                synthetic=synthetic))
        assert (len(got.trn_x), len(got.val_x), len(got.tst_x)) == (50, 10, 12)


def test_load_mnist_flow_without_files_and_synthetic_false_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        images.load_mnist_flow(tmp_path, synthetic=False)


# --- the driver --------------------------------------------------------------------


def _mnist(argv: list, capsys):
    result = train_mnist.main(MNIST.split() + argv)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    return result, lines


def test_driver_default_data_rule(tmp_path, capsys, monkeypatch):
    """No -synthetic: the files where present (here test-written ones), else
    the uniform stand-in; -synthetic: the stand-in, with no floor."""
    _, lines = _mnist(["-nb_epoch", "0", "-synthetic", "-folder", str(tmp_path / "a")], capsys)
    head = lines[0]
    assert (head["train"], head["valid"], head["test"]) == (1000, 200, 200)
    assert head["floor_bpp"] is None
    result, lines = _mnist(["-nb_epoch", "0", "-folder", str(tmp_path / "b")], capsys)
    assert (lines[0]["train"], lines[0]["valid"], lines[0]["test"]) == (1000, 200, 200)
    assert set(result) == {"test_bpp"} and np.isfinite(result["test_bpp"])

    _write_mnist(tmp_path / "data", gz=False)
    real = images.load_mnist_flow
    monkeypatch.setattr(train_mnist, "load_mnist_flow",
                        lambda synthetic=None: real(tmp_path / "data", synthetic=synthetic))
    _, lines = _mnist(["-nb_epoch", "0", "-folder", str(tmp_path / "c")], capsys)
    assert (lines[0]["train"], lines[0]["valid"], lines[0]["test"]) == (50, 10, 12)


def test_conditional_driver_trains_and_generates_with_its_context(tmp_path, capsys):
    result, lines = _mnist(["-conditionnal", "-synthetic", "-nb_epoch", "1", "-gen", "10",
                            "-nb_iter", "2", "-folder", str(tmp_path)], capsys)
    epochs = [l for l in lines if "epoch" in l and "event" not in l]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train_nll"])
    assert np.isfinite(epochs[0]["valid_bpp"]) and np.isfinite(result["test_bpp"])
    imgs = np.load(tmp_path / "generated.npy")
    assert imgs.shape == (10, 28, 28) and np.isfinite(imgs).all()
    assert (tmp_path / "0.5images.png").stat().st_size > 0  # matplotlib is installed here

    # the best-valid parameters, z * 0.5 from the seed + 3 generator, row i
    # of class i % 10, 5 * nb_iter Newton iterations
    flow = UMNNMAFFlow(**COND_FLOW, device="cpu")
    flow.load_state_dict(CheckpointManager(tmp_path / "ckpt").load_best("valid"))
    z = torch.randn(10, 784, generator=torch.Generator().manual_seed(3)) * 0.5
    ctx = torch.eye(10)[torch.arange(10) % 10]
    x = flow.invert(z, 10, ctx, method="newton")
    np.testing.assert_array_equal(imgs, images.logit_back(x).reshape(-1, 28, 28))
    with torch.no_grad():
        bpp, _, _ = flow.compute_bpp(x, context=ctx)
    assert result["gen_bpp"] == pytest.approx(float(bpp.mean()), rel=1e-6)


def test_conditional_flow_compute_ll_matches_jax_on_bridged_weights():
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    data = images.load_mnist_flow(synthetic=True)
    x, y = data.tst_x[:6], data.tst_y[:6]
    model = JaxFlow(**COND_FLOW, backend="xla")
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(3)))
    ll_j, z_j = model.compute_ll(params, jnp.asarray(x), context=jax.nn.one_hot(y, 10))
    flow = load_jax_flow_params(UMNNMAFFlow(**COND_FLOW, device="cpu"), params)
    with torch.no_grad():
        ll, z = flow.compute_ll(torch.tensor(x), torch.eye(10)[torch.as_tensor(y)])
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-5)


# --- the downloader ------------------------------------------------------------------


def test_download_mnist_from_file_urls_into_the_loaders_layout(tmp_path, monkeypatch):
    src = tmp_path / "src"
    arrays = _write_mnist(src, gz=True)
    monkeypatch.setitem(download.URLS, "mnist", [
        ((src / "mnist" / (n + ".gz")).as_uri(), f"mnist/{n}.gz") for n in NAMES])
    root = tmp_path / "root"
    download.download("MNIST", root)
    for n in NAMES:
        assert (root / "mnist" / n).exists() and (root / "mnist" / (n + ".gz")).exists()
    for got, want in zip(images.load_mnist_raw(root), arrays):
        assert got.tobytes() == want.tobytes()
    download.download("mnist", root)  # present files are kept, not fetched again


def test_download_tabular_hoists_the_tarball_and_main_reports_failure(tmp_path, monkeypatch,
                                                                     capsys):
    power = np.arange(12.0).reshape(4, 3)
    buf = io.BytesIO()
    np.save(buf, power)
    tar_path = tmp_path / "data.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        info = tarfile.TarInfo("data/power/data.npy")
        info.size = len(buf.getvalue())
        tf.addfile(info, io.BytesIO(buf.getvalue()))
    monkeypatch.setattr(download, "MAF_DATA_URL", tar_path.as_uri())
    root = tmp_path / "root"
    download.download("power", root)
    np.testing.assert_array_equal(np.load(root / "power" / "data.npy"), power)
    assert not (root / "data").exists()
    with pytest.raises(KeyError, match="unknown dataset"):
        download.download("cifar", root)
    assert download.main(["cifar"]) == 1
    assert "could not download cifar" in capsys.readouterr().err
