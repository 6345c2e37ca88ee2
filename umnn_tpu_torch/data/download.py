"""Fetches the datasets the loaders read, into the layout they read.

A copy of `umnn_tpu/data/download.py` (the reference's
`download_datasets.py:232-282`): the MAF tarball of the tabular sets
(POWER, GAS, HEPMASS, MINIBOONE, BSDS300), MNIST's idx files, the static
binarized MNIST, Freyfaces, Omniglot and Caltech101 Silhouettes. The
destinations are the paths :mod:`umnn_tpu_torch.data.uci` and
:mod:`umnn_tpu_torch.data.images` read: ``<root>/power/data.npy``,
``<root>/mnist/train-images-idx3-ubyte`` (and its ``.gz``), and so on, under
``$UMNN_DATA_ROOT`` or ``datasets/data``. Nothing else in the package calls
it: every loader has a seeded stand-in for the files it cannot find.

Usage:
    python -m umnn_tpu_torch.data.download [power gas mnist ... | all]
"""

from __future__ import annotations

import gzip
import shutil
import sys
import tarfile
from pathlib import Path

from umnn_tpu_torch.data.uci import DEFAULT_ROOT

__all__ = ["MAF_DATA_URL", "TABULAR", "URLS", "download", "main"]

MAF_DATA_URL = "https://zenodo.org/record/1161203/files/data.tar.gz"

# name -> [(url, destination under the data root)]
URLS: dict[str, list[tuple[str, str]]] = {
    "mnist": [
        (f"https://ossci-datasets.s3.amazonaws.com/mnist/{n}.gz", f"mnist/{n}.gz")
        for n in (
            "train-images-idx3-ubyte",
            "train-labels-idx1-ubyte",
            "t10k-images-idx3-ubyte",
            "t10k-labels-idx1-ubyte",
        )
    ],
    "mnist_static": [
        (
            "http://www.cs.toronto.edu/~larocheh/public/datasets/"
            f"binarized_mnist/binarized_mnist_{split}.amat",
            f"mnist_static/binarized_mnist_{split}.amat",
        )
        for split in ("train", "valid", "test")
    ],
    "freyfaces": [
        (
            "https://raw.githubusercontent.com/y0ast/Variational-Autoencoder/"
            "master/freyfaces.pkl",
            "freyfaces/freyfaces.pkl",
        )
    ],
    "omniglot": [
        (
            "https://github.com/yburda/iwae/raw/master/datasets/OMNIGLOT/chardata.mat",
            "omniglot/chardata.mat",
        )
    ],
    "caltech": [
        (
            "https://people.cs.umass.edu/~marlin/data/caltech101_silhouettes_28_split1.mat",
            "caltech/caltech101_silhouettes_28_split1.mat",
        )
    ],
}

TABULAR = ("power", "gas", "hepmass", "miniboone", "bsds300")


def _fetch(url: str, dest: Path) -> Path:
    """``url`` to ``dest`` through a ``.part`` file, unless ``dest`` exists."""
    import urllib.request

    dest.parent.mkdir(parents=True, exist_ok=True)
    if dest.exists():
        return dest
    tmp = dest.with_suffix(dest.suffix + ".part")
    urllib.request.urlretrieve(url, tmp)  # noqa: S310
    tmp.rename(dest)
    return dest


def _gunzip(path: Path) -> None:
    """``x.gz`` to ``x`` beside it, unless ``x`` exists."""
    out = path.with_suffix("")
    if not out.exists():
        with gzip.open(path, "rb") as src, open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)


def download(name: str, root: str | Path = DEFAULT_ROOT) -> None:
    """One dataset (or ``"all"``) into the data root.

    The tabular names all resolve to the one MAF tarball, whose top-level
    ``data/`` directory is hoisted so that the sets land at
    ``<root>/power/...`` whatever ``root`` is called.
    """
    root = Path(root)
    name = name.lower()
    if name == "all":
        for n in ("maf_tabular", "mnist", "mnist_static", "freyfaces", "omniglot", "caltech"):
            download(n, root)
        return
    if name in TABULAR:
        name = "maf_tabular"
    if name == "maf_tabular":
        tar_path = _fetch(MAF_DATA_URL, root / "data.tar.gz")
        with tarfile.open(tar_path) as tf:
            tf.extractall(root, filter="data")
        inner = root / "data"
        if inner.is_dir():
            for child in inner.iterdir():
                target = root / child.name
                if not target.exists():
                    shutil.move(str(child), str(target))
            if not any(inner.iterdir()):
                inner.rmdir()
        return
    if name not in URLS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(URLS) + list(TABULAR)}")
    for url, rel in URLS[name]:
        dest = _fetch(url, root / rel)
        if dest.suffix == ".gz":
            _gunzip(dest)


def main(argv: list[str]) -> int:
    for t in argv or ["all"]:
        try:
            download(t)
        except (OSError, KeyError, tarfile.TarError) as e:
            print(
                f"could not download {t}: {e}\n"
                "  (the loaders fall back to seeded stand-ins of the same shapes)",
                file=sys.stderr,
            )
            return 1
        print(f"downloaded {t}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
