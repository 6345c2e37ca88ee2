"""The port's UCI data module against the JAX package's `umnn_tpu/data/uci.py`.

It is a copy and must agree bit for bit: the synthetic stand-ins and their
exact floors of all five datasets at two row counts, and the five
real-file loaders on small files written here in the layouts
`tests/test_data_real_branches.py` writes (the real files are downloads).
pandas (GAS, HEPMASS) and h5py (BSDS300) are imported by those loaders
only, so their tests skip where the package is missing.
"""

import numpy as np
import pytest

from umnn_tpu_torch.data import uci

DATASETS = sorted(uci.UCI_DIMS)


def test_constants_match_jax():
    from umnn_tpu.data import uci as juci

    assert uci.UCI_DIMS == juci.UCI_DIMS
    assert uci.SYNTH_REAL_ROWS == juci.SYNTH_REAL_ROWS
    assert uci.DEFAULT_ROOT == juci.DEFAULT_ROOT


def _same(a, b):
    for split in ("trn", "val", "tst"):
        x, y = getattr(a, split), getattr(b, split)
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    assert a.name == b.name and a.n_dims == b.n_dims


@pytest.mark.parametrize("n_rows", [None, 3001], ids=["20000_rows", "3001_rows"])
@pytest.mark.parametrize("name", DATASETS)
def test_synthetic_data_and_floor_match_jax_bit_for_bit(name, n_rows):
    from umnn_tpu.data import uci as juci

    _same(uci._synthetic(name, n_rows=n_rows), juci._synthetic(name, n_rows=n_rows))
    assert uci.synthetic_floor(name, n_rows=n_rows) == juci.synthetic_floor(name, n_rows=n_rows)


def _write_power(root):
    (root / "power").mkdir()
    np.save(root / "power" / "data.npy", np.random.RandomState(7).randn(60, 8) * 3.0)


def _write_gas(root):
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(0)
    n = 200
    base = rng.randn(n)
    df = pd.DataFrame({
        "Time": np.arange(n, dtype=float), "Meth": rng.randn(n), "Eth": rng.randn(n),
        "CO": rng.randn(n), "A": base, "B": base + 1e-6 * rng.randn(n),
        "C": -base + 1e-6 * rng.randn(n), "D": rng.randn(n),
    })
    (root / "gas").mkdir()
    df.to_pickle(root / "gas" / "ethylene_CO.pickle")


def _write_hepmass(root):
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(1)
    n = 80
    f_cont = rng.randn(n, 3)
    f_disc = rng.randn(n)
    f_disc[:10] = f_disc.min() - 1.0
    trn = pd.DataFrame({
        "label": np.array([1.0, 0.0]).repeat(n // 2), "f0": f_cont[:, 0], "f1": f_disc,
        "f2": f_cont[:, 1], "f3": f_cont[:, 2],
    })
    tst = trn.copy()
    tst["junk"] = np.ones(n)
    (root / "hepmass").mkdir()
    trn.to_csv(root / "hepmass" / "1000_train.csv", index=False)
    tst.to_csv(root / "hepmass" / "1000_test.csv", index=False)


def _write_miniboone(root):
    (root / "miniboone").mkdir()
    np.save(root / "miniboone" / "data.npy", np.random.RandomState(3).randn(100, 5))


def _write_bsds300(root):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(5)
    (root / "BSDS300").mkdir()
    with h5py.File(root / "BSDS300" / "BSDS300.hdf5", "w") as f:
        for split, n in (("train", 40), ("validation", 10), ("test", 12)):
            f[split] = rng.rand(n, 63)


WRITERS = {
    "power": _write_power, "gas": _write_gas, "hepmass": _write_hepmass,
    "miniboone": _write_miniboone, "bsds300": _write_bsds300,
}


@pytest.mark.parametrize("name", DATASETS)
def test_real_file_loaders_match_jax_byte_for_byte(name, tmp_path):
    from umnn_tpu.data import uci as juci

    WRITERS[name](tmp_path)
    assert uci.uci_available(name, tmp_path) and juci.uci_available(name, tmp_path)
    got = uci.load_uci(name, root=tmp_path, synthetic=False)
    _same(got, juci.load_uci(name, root=tmp_path, synthetic=False))
    assert got.name == name and len(got.trn) > len(got.val) > 0


def test_load_uci_rules(tmp_path):
    """synthetic=True forces the stand-in, None takes it where the files are
    missing, False requires the files; an unknown name raises."""
    from umnn_tpu.data import uci as juci

    _write_miniboone(tmp_path)
    forced = uci.load_uci("miniboone", root=tmp_path, synthetic=True, synthetic_rows=500)
    assert forced.name == "synthetic-miniboone" and forced.n_dims == 43
    _same(forced, juci.load_uci("miniboone", root=tmp_path, synthetic=True, synthetic_rows=500))
    assert uci.load_uci("miniboone", root=tmp_path).name == "miniboone"
    auto = uci.load_uci("power", root=tmp_path, synthetic_rows=400)
    assert auto.name == "synthetic-power" and len(auto.trn) + len(auto.val) + len(auto.tst) == 400
    with pytest.raises(FileNotFoundError):
        uci.load_uci("power", root=tmp_path, synthetic=False)
    with pytest.raises(ValueError, match="unknown dataset"):
        uci.load_uci("cifar", root=tmp_path)
    assert uci.load_uci("POWER", root=tmp_path, synthetic_rows=400).name == "synthetic-power"
