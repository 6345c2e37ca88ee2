"""UCI tabular datasets with the reference preprocessing, and their
synthetic stand-ins.

A copy of `umnn_tpu/data/uci.py` (numpy only; the GAS and HEPMASS loaders
import pandas and the BSDS300 loader h5py inside themselves, so the module
imports without either). Each real-file loader replicates the MAF-lineage
preprocessing of `datasets/{power,gas,hepmass,miniboone,bsds300}.py` in
AWehenkel/UMNN, byte for byte:

* POWER: seed-42 shuffle, drop columns 3 then 1, add uniform noise
  (gap 1e-3, voltage 1e-2, sub-metering U[0,1)x3, time 0), 10%/10% tail
  splits, z-score by train+valid moments (`power.py:30-74`);
* GAS: drop Meth/Eth/Time, iteratively drop the first column whose
  corr > 0.98 row-count exceeds 1, z-score by full-frame moments, then
  10%/10% tail splits (`gas.py:39-72`);
* HEPMASS: keep class-1 rows of 1000_{train,test}.csv, drop the label and
  the test set's spurious last column, z-score by train moments, drop
  features whose smallest value repeats > 5 times in train, 10%
  validation tail (`hepmass.py:42-92`);
* MINIBOONE: pre-cleaned data.npy, 10%/10% tails, z-score by train+valid
  moments (`miniboone.py:27-69`);
* BSDS300: hdf5 patches used as-is (`bsds300.py:7-34`).

Data files live under ``root`` (default ``datasets/data/``, or the
``UMNN_DATA_ROOT`` variable); when absent, ``load_uci(name)`` gives a
seeded synthetic stand-in with the right dimensionality, whose exact
optimal test NLL :func:`synthetic_floor` computes. Arrays are numpy
float32; the drivers move batches to the device.
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter
from pathlib import Path

import numpy as np

__all__ = [
    "TabularData",
    "UCI_DIMS",
    "SYNTH_REAL_ROWS",
    "load_uci",
    "uci_available",
    "synthetic_floor",
]

UCI_DIMS = {"power": 6, "gas": 8, "hepmass": 21, "miniboone": 43, "bsds300": 63}

# Total synthetic rows that reproduce the REAL datasets' train-split sizes
# through the same 10%/10% tail splits (train = 0.81*n): the real train rows
# are power 1,659,917 / gas 852,174 / hepmass 315,123 / miniboone 29,556 /
# bsds300 1,000,000 (`datasets/{power,gas,hepmass,miniboone,bsds300}.py`,
# MAF-lineage splits). Data-starved stand-ins (20k rows for a 43-d density)
# cannot gate convergence — matching the real row counts makes the exact
# synthetic floors reachable (VERDICT r2 next-step #1).
SYNTH_REAL_ROWS = {
    "power": 2_049_280,
    "gas": 1_052_065,
    "hepmass": 389_041,
    "miniboone": 36_488,
    "bsds300": 1_234_568,
}

DEFAULT_ROOT = os.environ.get("UMNN_DATA_ROOT", "datasets/data")


@dataclasses.dataclass
class TabularData:
    """Train/valid/test float32 arrays (the reference's Data{x,N} pattern)."""

    trn: np.ndarray
    val: np.ndarray
    tst: np.ndarray
    name: str = ""

    @property
    def n_dims(self) -> int:
        return self.trn.shape[1]


def uci_available(name: str, root: str | Path = DEFAULT_ROOT) -> bool:
    root = Path(root)
    paths = {
        "power": root / "power" / "data.npy",
        "gas": root / "gas" / "ethylene_CO.pickle",
        "hepmass": root / "hepmass" / "1000_train.csv",
        "miniboone": root / "miniboone" / "data.npy",
        "bsds300": root / "BSDS300" / "BSDS300.hdf5",
    }
    return paths[name].exists()


def _tail_splits_10_10(data: np.ndarray):
    n_test = int(0.1 * data.shape[0])
    test = data[-n_test:]
    rest = data[:-n_test]
    n_val = int(0.1 * rest.shape[0])
    return rest[:-n_val], rest[-n_val:], test


def _zscore_by_train_valid(trn, val, tst):
    joint = np.vstack([trn, val])
    mu, s = joint.mean(axis=0), joint.std(axis=0)
    return (trn - mu) / s, (val - mu) / s, (tst - mu) / s


def _load_power(root: Path) -> TabularData:
    rng = np.random.RandomState(42)
    data = np.load(root / "power" / "data.npy")
    rng.shuffle(data)
    n = data.shape[0]
    data = np.delete(data, 3, axis=1)
    data = np.delete(data, 1, axis=1)
    # RNG draw ORDER matches the reference exactly (voltage before gap,
    # `power.py:43-45`) even though the noise columns stack gap-first —
    # byte-equivalence requires consuming the seed-42 stream identically.
    voltage_noise = 0.01 * rng.rand(n, 1)
    gap_noise = 0.001 * rng.rand(n, 1)
    sm_noise = rng.rand(n, 3)
    noise = np.hstack([gap_noise, voltage_noise, sm_noise, np.zeros((n, 1))])
    data = data + noise
    trn, val, tst = _tail_splits_10_10(data)
    trn, val, tst = _zscore_by_train_valid(trn, val, tst)
    return TabularData(*(a.astype(np.float32) for a in (trn, val, tst)), "power")


def _load_gas(root: Path) -> TabularData:
    import pandas as pd

    data = pd.read_pickle(root / "gas" / "ethylene_CO.pickle")
    data = data.drop(columns=["Meth", "Eth", "Time"])

    def corr_counts(df):
        # signed threshold, NOT abs: the reference counts C > 0.98
        # (`gas.py:40-42`) so strongly anti-correlated pairs never trigger
        # a column drop
        return (df.corr() > 0.98).to_numpy().sum(axis=1)

    counts = corr_counts(data)
    while np.any(counts > 1):
        data = data.drop(columns=[data.columns[np.where(counts > 1)[0][0]]])
        counts = corr_counts(data)
    data = ((data - data.mean()) / data.std()).to_numpy()
    n_test = int(0.1 * data.shape[0])
    tst = data[-n_test:]
    rest = data[:-n_test]
    n_val = int(0.1 * rest.shape[0])
    trn, val = rest[:-n_val], rest[-n_val:]
    return TabularData(*(a.astype(np.float32) for a in (trn, val, tst)), "gas")


def _load_hepmass(root: Path) -> TabularData:
    import pandas as pd

    trn = pd.read_csv(root / "hepmass" / "1000_train.csv", index_col=False)
    tst = pd.read_csv(root / "hepmass" / "1000_test.csv", index_col=False)
    trn = trn[trn[trn.columns[0]] == 1].drop(columns=[trn.columns[0]])
    tst = tst[tst[tst.columns[0]] == 1].drop(columns=[tst.columns[0]])
    tst = tst.drop(columns=[tst.columns[-1]])  # dataset artifact
    mu, s = trn.mean(), trn.std()
    trn, tst = ((trn - mu) / s).to_numpy(), ((tst - mu) / s).to_numpy()
    drop = [
        i
        for i, feature in enumerate(trn.T)
        # the count of the SMALLEST value repeating > 5x flags a
        # quasi-discrete feature — the reference sorts Counter items by
        # value-key and takes entry [0] (`hepmass.py:75-81`), i.e. the
        # minimum's multiplicity, not the most-common value's; replicated
        # verbatim because the dropped-column set defines the 21-d layout
        if np.array(sorted(Counter(feature).items()))[0, 1] > 5
    ]
    keep = [i for i in range(trn.shape[1]) if i not in drop]
    trn, tst = trn[:, keep], tst[:, keep]
    n_val = int(0.1 * trn.shape[0])
    trn, val = trn[:-n_val], trn[-n_val:]
    return TabularData(*(a.astype(np.float32) for a in (trn, val, tst)), "hepmass")


def _load_miniboone(root: Path) -> TabularData:
    data = np.load(root / "miniboone" / "data.npy")
    trn, val, tst = _tail_splits_10_10(data)
    trn, val, tst = _zscore_by_train_valid(trn, val, tst)
    return TabularData(*(a.astype(np.float32) for a in (trn, val, tst)), "miniboone")


def _load_bsds300(root: Path) -> TabularData:
    import h5py

    with h5py.File(root / "BSDS300" / "BSDS300.hdf5", "r") as f:
        return TabularData(
            np.asarray(f["train"], np.float32),
            np.asarray(f["validation"], np.float32),
            np.asarray(f["test"], np.float32),
            "bsds300",
        )


def _synthetic_draw(name: str, seed: int = 0, n_rows: int | None = None):
    """The seeded synthetic draw shared by :func:`_synthetic` and
    :func:`synthetic_floor` — one source of truth so the data and its exact
    floor can never drift apart.

    Returns ``(data [n,d] pre-z-score, centers [3,d], A [d,d])``: a
    3-component Gaussian mixture with shared covariance ``A^T A``. Note the
    mixture-assignment draw consumes ``n`` values BEFORE centers/A, so
    different row counts give (deliberately unchanged, r2-compatible at
    n=20000) different mixture parameters — data and floor always share one
    draw, which is the invariant that matters.
    """
    d = UCI_DIMS[name]
    rng = np.random.RandomState(seed)
    n = 20000 if n_rows is None else int(n_rows)
    mix = rng.randint(0, 3, size=n)
    centers = rng.randn(3, d) * 2.0
    A = rng.randn(d, d) * 0.3
    data = centers[mix] + rng.randn(n, d) @ A
    return data, centers, A


def _synthetic(name: str, seed: int = 0, n_rows: int | None = None) -> TabularData:
    """Seeded synthetic stand-in (correlated Gaussian mixture) with the real
    dataset's dimensionality — for tests/benchmarks when files are absent.
    ``n_rows`` overrides the 20k default (pass ``SYNTH_REAL_ROWS[name]`` to
    match the real dataset's train-split size)."""
    data, _, _ = _synthetic_draw(name, seed, n_rows)
    trn, val, tst = _tail_splits_10_10(data)
    trn, val, tst = _zscore_by_train_valid(trn, val, tst)
    return TabularData(
        *(a.astype(np.float32) for a in (trn, val, tst)), f"synthetic-{name}"
    )


def synthetic_floor(name: str, seed: int = 0, n_rows: int | None = None) -> float:
    """Exact optimal test NLL (nats) of the synthetic stand-in: the average
    negative log-density of the TRUE generating mixture on the test split,
    after the z-scoring affine map. Any model's test NLL exceeds this by its
    KL divergence from the truth — an absolute convergence target needing no
    real data (``scripts/synthetic_floor.py`` prints these).
    """
    data, centers, A = _synthetic_draw(name, seed, n_rows)
    d = data.shape[1]
    trn, val, tst = _tail_splits_10_10(data)
    joint = np.vstack([trn, val])
    s = joint.std(axis=0)
    # density of y = (x - mu)/s: log p_y(y) = log p_x(x) + sum log s
    cov = A.T @ A
    _, logdet = np.linalg.slogdet(cov)
    prec = np.linalg.inv(cov)
    lps = []
    for k in range(3):
        diff = tst - centers[k]
        m2 = np.einsum("ni,ij,nj->n", diff, prec, diff)
        lps.append(-0.5 * (m2 + d * np.log(2 * np.pi) + logdet))
    lp = np.logaddexp.reduce(np.stack(lps), axis=0) - np.log(3)
    return float(-(lp + np.log(s).sum()).mean())


_LOADERS = {
    "power": _load_power,
    "gas": _load_gas,
    "hepmass": _load_hepmass,
    "miniboone": _load_miniboone,
    "bsds300": _load_bsds300,
}


def load_uci(
    name: str,
    root: str | Path = DEFAULT_ROOT,
    synthetic: bool | None = None,
    synthetic_rows: int | None = None,
) -> TabularData:
    """Load a UCI dataset; fall back to the synthetic stand-in when files
    are missing (synthetic=None -> auto, True -> force, False -> require).
    ``synthetic_rows`` sets the stand-in's total row count (None = 20000)."""
    name = name.lower()
    if name not in _LOADERS:
        raise ValueError(f"unknown dataset {name}; choose from {sorted(_LOADERS)}")
    if synthetic is True:
        return _synthetic(name, n_rows=synthetic_rows)
    if not uci_available(name, root):
        if synthetic is False:
            raise FileNotFoundError(
                f"{name} files not found under {root}; see "
                f"reference download_datasets.py for sources"
            )
        return _synthetic(name, n_rows=synthetic_rows)
    return _LOADERS[name](Path(root))
