"""The port's VAE datasets against the JAX package's, bit for bit: the four
seeded stand-ins, and the real-file branches on files this test writes
(``.amat`` text, a pickled Freyfaces array, ``.mat`` files for Omniglot
and Caltech), with Omniglot's seed-777 binarization and JAX's three-way
``synthetic`` rule."""

import pickle

import numpy as np
import pytest
import scipy.io

from umnn_tpu_torch.data import images as PI

NAMES = ["mnist", "freyfaces", "omniglot", "caltech"]


def _same(a, b):
    for f in ("trn", "val", "tst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert tuple(a.input_size) == tuple(b.input_size)
    assert a.input_type == b.input_type
    assert a.dynamic_binarization == b.dynamic_binarization


@pytest.mark.parametrize("name", NAMES)
def test_stand_in_matches_jax_bit_for_bit(name, tmp_path):
    from umnn_tpu.data import images as JI

    _same(PI.load_vae_dataset(name, root=tmp_path, synthetic=True),
          JI.load_vae_dataset(name, root=tmp_path, synthetic=True))
    # no file and synthetic=None: the stand-in too; synthetic=False raises
    _same(PI.load_vae_dataset(name, root=tmp_path), JI.load_vae_dataset(name, root=tmp_path))
    with pytest.raises(FileNotFoundError):
        PI.load_vae_dataset(name, root=tmp_path, synthetic=False)


def _write(name, root, r):
    if name == "mnist":
        d = root / "mnist_static"
        d.mkdir(parents=True)
        for split, n in (("train", 7), ("valid", 3), ("test", 4)):
            np.savetxt(d / f"binarized_mnist_{split}.amat", (r.rand(n, 784) > 0.5).astype(int),
                       fmt="%d")
    elif name == "freyfaces":
        d = root / "freyfaces"
        d.mkdir(parents=True)
        faces = r.randint(0, 256, size=(2000, 560)).astype(np.uint8)
        with open(d / "freyfaces.pkl", "wb") as f:
            pickle.dump((faces, None), f)
    elif name == "omniglot":
        d = root / "omniglot"
        d.mkdir(parents=True)
        scipy.io.savemat(d / "chardata.mat", {"data": r.rand(784, 1400), "testdata": r.rand(784, 9)})
    else:
        d = root / "caltech"
        d.mkdir(parents=True)
        scipy.io.savemat(d / "caltech101_silhouettes_28_split1.mat", {
            f"{s}_data": (r.rand(n, 784) > 0.5).astype(np.float64)
            for s, n in (("train", 6), ("val", 3), ("test", 2))})


@pytest.mark.parametrize("name", NAMES)
def test_real_file_branch_matches_jax_bit_for_bit(name, tmp_path):
    from umnn_tpu.data import images as JI

    _write(name, tmp_path, np.random.RandomState(NAMES.index(name)))
    got = PI.load_vae_dataset(name, root=tmp_path, synthetic=False)
    after_port = np.random.rand()
    want = JI.load_vae_dataset(name, root=tmp_path)
    after_jax = np.random.rand()
    _same(got, want)
    assert len(got.trn) != 600  # the file, not the stand-in
    if name == "omniglot":
        # np.random.seed(777) reset numpy's global generator in both
        assert after_port == after_jax
        assert set(np.unique(got.val)) <= {0.0, 1.0} and len(got.val) == 1345
    if name == "caltech":
        raw = scipy.io.loadmat(tmp_path / "caltech" / "caltech101_silhouettes_28_split1.mat")
        np.testing.assert_array_equal(got.tst, 1.0 - PI._fortran_reshape(
            raw["test_data"].astype(np.float32)))


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        PI.load_vae_dataset("cifar")
