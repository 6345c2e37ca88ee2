"""MNIST for the 784-d flow: the raw idx files, the logit-dequantized
splits, their uniform stand-in, the AR(1) rows with an exact bits-per-pixel
floor, and the way back from logit space to pixels.

Copies of `umnn_tpu/data/images.py` (numpy and scipy only):
``add_uniform_noise_and_logit`` (`:35-40`), ``logit_back`` (`:42-45`),
``_read_idx`` and ``load_mnist_raw`` (`:51-78`), ``load_mnist_flow``
(`:93-119`), with its seeded uniform stand-in where the files are absent,
and ``synthetic_mnist_ar1`` (`:122-189`): logit-space 784-d rows from a
raster-order AR(1) Gaussian copula, made from a seed with no download.
The files are read from ``<root>/mnist``, ``root`` being
``$UMNN_DATA_ROOT`` or ``datasets/data``; :mod:`umnn_tpu_torch.data.download`
writes them there. The same seed gives the same arrays, bit for bit, as the
JAX package's.

The VAE datasets (`:192-337`): ``VAEImageData``, static binarized MNIST
(``.amat`` files under ``<root>/mnist_static``), Freyfaces
(``freyfaces/freyfaces.pkl``), Omniglot (``omniglot/chardata.mat``) and
Caltech 101 Silhouettes (``caltech/caltech101_silhouettes_28_split1.mat``),
with JAX's rule for their seeded stand-ins: ``synthetic=True`` takes the
stand-in, ``False`` raises where the file is absent, ``None`` takes the
file where it is present and else the stand-in. Omniglot binarizes its
validation and test splits once through ``np.random.seed(777)``, which
resets numpy's global generator as the JAX package's loader does.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "ALPHA",
    "DEFAULT_ROOT",
    "FlowImageData",
    "VAEImageData",
    "VAE_DATASETS",
    "add_uniform_noise_and_logit",
    "load_mnist_flow",
    "load_caltech",
    "load_freyfaces",
    "load_mnist_raw",
    "load_omniglot",
    "load_static_mnist",
    "load_vae_dataset",
    "logit_back",
    "synthetic_mnist_ar1",
]

DEFAULT_ROOT = Path(os.environ.get("UMNN_DATA_ROOT", "datasets/data"))

ALPHA = 1e-6  # logit-transform guard

MNIST_FILES = (
    "train-images-idx3-ubyte",
    "train-labels-idx1-ubyte",
    "t10k-images-idx3-ubyte",
    "t10k-labels-idx1-ubyte",
)


def add_uniform_noise_and_logit(x_uint8: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """uint8 pixels to dequantized logit space: ``logit(ALPHA + (1 - 2
    ALPHA) (x + u) / 256)``, ``u ~ U(0, 1)`` from ``rng``; float32 out."""
    x = (x_uint8.astype(np.float64) + rng.rand(*x_uint8.shape)) / 256.0
    x = ALPHA + (1 - 2 * ALPHA) * x
    return np.log(x / (1.0 - x)).astype(np.float32)


def logit_back(x) -> np.ndarray:
    """Logit space to ``[0, 1]`` pixel space: ``(sigmoid(x) - ALPHA) / (1 -
    2 ALPHA)``, the sigmoid in float64; float32 out. ``x``: an array or a
    tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    s = 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
    return ((s - ALPHA) / (1 - 2 * ALPHA)).astype(np.float32)


def _read_idx(path: Path) -> np.ndarray:
    """An idx file (raw, or gzipped where its name ends in ``.gz``) as a
    uint8 array of the shape its header gives."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        (magic,) = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def load_mnist_raw(root: str | Path = DEFAULT_ROOT) -> tuple:
    """``(train_images [60000, 28, 28], train_labels, test_images,
    test_labels)``, uint8, from ``<root>/mnist`` (each file raw or
    ``.gz``); ``FileNotFoundError`` for the first file missing."""
    d = Path(root) / "mnist"
    out = []
    for name in MNIST_FILES:
        p = d / name
        if not p.exists():
            p = d / (name + ".gz")
        if not p.exists():
            raise FileNotFoundError(p)
        out.append(_read_idx(p))
    return tuple(out)


@dataclasses.dataclass
class FlowImageData:
    """Logit-dequantized splits for the 784-d flow, with their class labels
    (all zero for the AR(1) rows)."""

    trn_x: np.ndarray
    trn_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray
    tst_x: np.ndarray
    tst_y: np.ndarray


def load_mnist_flow(
    root: str | Path = DEFAULT_ROOT, seed: int = 0, synthetic: bool | None = None
) -> FlowImageData:
    """MNIST for density estimation: logit-dequantized, flattened to 784,
    the train files split 5/6 to train (at most 50,000) and the rest to
    valid (`lib/dataloader.py:100-118`).

    ``synthetic``: ``None`` reads the files and takes the stand-in where
    they are absent, ``True`` always takes it, ``False`` raises
    ``FileNotFoundError`` where they are absent. The stand-in: 1,200 train
    and 200 test images of uniform uint8 pixels and uniform labels, from
    ``RandomState(seed)``, which then draws the dequantization noise.
    """
    rng = np.random.RandomState(seed)
    try:
        if synthetic is True:
            raise FileNotFoundError
        tr_x, tr_y, te_x, te_y = load_mnist_raw(root)
    except FileNotFoundError:
        if synthetic is False:
            raise
        tr_x = rng.randint(0, 256, (1200, 28, 28)).astype(np.uint8)
        tr_y = rng.randint(0, 10, 1200)
        te_x = rng.randint(0, 256, (200, 28, 28)).astype(np.uint8)
        te_y = rng.randint(0, 10, 200)
    n_train = min(50000, int(len(tr_x) * 5 / 6))
    trn = add_uniform_noise_and_logit(tr_x[:n_train].reshape(-1, 784), rng)
    val = add_uniform_noise_and_logit(tr_x[n_train:].reshape(-1, 784), rng)
    tst = add_uniform_noise_and_logit(te_x.reshape(-1, 784), rng)
    return FlowImageData(trn, tr_y[:n_train], val, tr_y[n_train:], tst, te_y)


def synthetic_mnist_ar1(
    rho: float = 0.7,
    seed: int = 0,
    n: tuple[int, int, int] = (20000, 2000, 5000),
    d: int = 784,
):
    """Correlated 784-d stand-in for MNIST with an exact bits/pixel floor.

    z_1 ~ N(0,1), z_{i+1} = rho*z_i + sqrt(1-rho^2)*eps, pixels y_i = Phi(z_i):
    uniform marginals (an independence model scores exactly 8.0 bpp) and
    mutual information -((d-1)/2)*ln(1-rho^2) nats for the conditioner to
    learn. Pixels go through the ``alpha + (1-2*alpha)*y`` logit map.
    Returns ``(FlowImageData, floor_bpp)``, where ``floor_bpp`` is the bpp of
    the true density on the test split under the flows' bpp formula.
    """
    rng = np.random.RandomState(seed)
    from scipy.stats import norm

    n_tot = sum(n)
    eps = rng.randn(n_tot, d)
    z = np.empty((n_tot, d))
    z[:, 0] = eps[:, 0]
    c = np.sqrt(1.0 - rho * rho)
    for i in range(1, d):
        z[:, i] = rho * z[:, i - 1] + c * eps[:, i]
    y = norm.cdf(z)
    v = ALPHA + (1 - 2 * ALPHA) * y
    x = np.log(v / (1.0 - v))

    # exact log-density of x: log p_y(y) + sum log |dy/dx|
    # p_y(y) = p_z(z) / prod phi(z_i);  dy/dx = sig(x)(1-sig(x))/(1-2a)
    def true_bpp(xs, zs):
        lp_z = norm.logpdf(zs[:, 0]) + norm.logpdf(
            (zs[:, 1:] - rho * zs[:, :-1]) / c
        ).sum(axis=1) - (d - 1) * np.log(c)
        lp_y = lp_z - norm.logpdf(zs).sum(axis=1)
        sig = 1.0 / (1.0 + np.exp(-xs))
        log_dydx = np.log(sig) + np.log1p(-sig) - np.log(1 - 2 * ALPHA)
        ll = lp_y + log_dydx.sum(axis=1)  # log p_x(x)
        bpp = (
            -ll / (d * np.log(2))
            - np.log2(1 - 2 * ALPHA)
            + 8
            + (np.log2(sig) + np.log2(1 - sig)).sum(axis=1) / d
        )
        return float(bpp.mean())

    n1, n2, _ = n
    splits = np.split(x.astype(np.float32), [n1, n1 + n2])
    zeros = [np.zeros(len(s), dtype=np.int64) for s in splits]
    floor = true_bpp(x[n1 + n2 :], z[n1 + n2 :])
    data = FlowImageData(splits[0], zeros[0], splits[1], zeros[1], splits[2], zeros[2])
    return data, floor


# --- the VAE datasets (`umnn_tpu/data/images.py:192-337`) -----------------------


@dataclasses.dataclass
class VAEImageData:
    trn: np.ndarray  # [N, C*H*W] float32 in [0, 1]
    val: np.ndarray
    tst: np.ndarray
    input_size: tuple[int, ...]
    input_type: str  # "binary" or "multinomial"
    # a bernoulli(data) draw per training batch, Omniglot's
    dynamic_binarization: bool = False


def _synthetic_images(input_size, input_type, seed=0, n=(600, 100, 100), dynamic_binarization=False):
    rng = np.random.RandomState(seed)
    c, h, w = input_size
    outs = []
    for i, count in enumerate(n):
        x = rng.rand(count, c * h * w)
        if input_type == "binary":
            if dynamic_binarization and i == 0:
                # the train split stays real-valued: the training loop draws
                # bernoulli(x) per batch, as for the real Omniglot
                x = x.astype(np.float32)
            else:
                x = (x > 0.5).astype(np.float32)
        else:
            x = (np.floor(x * 256) / 255.0).astype(np.float32)
        outs.append(x)
    return VAEImageData(*outs, tuple(input_size), input_type,
                        dynamic_binarization=dynamic_binarization)


def _pick(path: Path, synthetic) -> bool:
    """Whether to take the stand-in: JAX's three-way rule."""
    if synthetic is True or not path.exists():
        if synthetic is False:
            raise FileNotFoundError(path)
        return True
    return False


def load_static_mnist(root=DEFAULT_ROOT, synthetic=None) -> VAEImageData:
    """Larochelle's static binarized MNIST from ``.amat`` files."""
    d = Path(root) / "mnist_static"
    files = {"trn": "binarized_mnist_train.amat", "val": "binarized_mnist_valid.amat",
             "tst": "binarized_mnist_test.amat"}
    if _pick(d / files["trn"], synthetic):
        return _synthetic_images((1, 28, 28), "binary")
    splits = {k: np.loadtxt(d / v, dtype=np.float32) for k, v in files.items()}
    return VAEImageData(splits["trn"], splits["val"], splits["tst"], (1, 28, 28), "binary")


def load_freyfaces(root=DEFAULT_ROOT, seed=123, synthetic=None) -> VAEImageData:
    """Freyfaces: a seeded shuffle, 1565/200/200 splits, values / 255
    (multinomial)."""
    p = Path(root) / "freyfaces" / "freyfaces.pkl"
    if _pick(p, synthetic):
        return _synthetic_images((1, 28, 20), "multinomial")
    import pickle

    with open(p, "rb") as f:
        data = pickle.load(f, encoding="latin1")[0]
    data = (data / 255.0).astype(np.float32)
    np.random.RandomState(seed).shuffle(data)
    return VAEImageData(data[:1565], data[1565:1765], data[1765:1965], (1, 28, 20),
                        "multinomial")


def _fortran_reshape(data: np.ndarray) -> np.ndarray:
    """The column-major unflatten of the Omniglot and Caltech files."""
    return data.reshape((-1, 28, 28)).reshape((-1, 28 * 28), order="F")


def load_omniglot(root=DEFAULT_ROOT, seed=0, synthetic=None) -> VAEImageData:
    """Omniglot: Fortran-order images, a shuffled 1345-row validation split;
    the train split stays real-valued (binarized per batch in training),
    validation and test are binarized once under numpy's global seed 777."""
    p = Path(root) / "omniglot" / "chardata.mat"
    if _pick(p, synthetic):
        return _synthetic_images((1, 28, 28), "binary", dynamic_binarization=True)
    from scipy.io import loadmat

    raw = loadmat(p)
    trn = _fortran_reshape(raw["data"].T.astype(np.float32))
    tst = _fortran_reshape(raw["testdata"].T.astype(np.float32))
    idx = np.random.RandomState(seed).permutation(len(trn))
    n_val = 1345
    x_trn, x_val = trn[idx[:-n_val]], trn[idx[-n_val:]]
    np.random.seed(777)  # the reference's fixed evaluation draw
    x_val = np.random.binomial(1, x_val).astype(np.float32)
    tst = np.random.binomial(1, tst).astype(np.float32)
    return VAEImageData(x_trn, x_val, tst, (1, 28, 28), "binary", dynamic_binarization=True)


def load_caltech(root=DEFAULT_ROOT, synthetic=None) -> VAEImageData:
    """Caltech 101 Silhouettes, polarity inverted, Fortran-order images."""
    p = Path(root) / "caltech" / "caltech101_silhouettes_28_split1.mat"
    if _pick(p, synthetic):
        return _synthetic_images((1, 28, 28), "binary")
    from scipy.io import loadmat

    raw = loadmat(p)
    return VAEImageData(
        1.0 - _fortran_reshape(raw["train_data"].astype(np.float32)),
        1.0 - _fortran_reshape(raw["val_data"].astype(np.float32)),
        1.0 - _fortran_reshape(raw["test_data"].astype(np.float32)),
        (1, 28, 28),
        "binary",
    )


VAE_DATASETS = {
    "mnist": load_static_mnist,
    "freyfaces": load_freyfaces,
    "omniglot": load_omniglot,
    "caltech": load_caltech,
}


def load_vae_dataset(name: str, root=DEFAULT_ROOT, synthetic=None) -> VAEImageData:
    """One of ``VAE_DATASETS`` by name."""
    if name not in VAE_DATASETS:
        raise ValueError(f"unknown dataset {name}; choose from {sorted(VAE_DATASETS)}")
    return VAE_DATASETS[name](root=root, synthetic=synthetic)
