"""Built-in dataset fetchers — the port of ``deeplearning4j_tpu/datasets/fetchers.py``:
MNIST / Iris / CIFAR-10 / LFW / curves
(ref: datasets/fetchers/MnistDataFetcher.java, datasets/mnist/MnistManager.java
IDX parsing, iterator/impl/{Mnist,Cifar,Iris}DataSetIterator.java).

Nothing is downloaded.  Real data is read when the cache directory
(``DL4J_TPU_CACHE``, default ``~/.deeplearning4j_tpu/``, the JAX package's)
holds the standard files; otherwise a DETERMINISTIC procedurally-generated
stand-in with the same shapes and label structure is used, the JAX
package's stand-in array for array.  IDX files are parsed with numpy (the
JAX package's native reader waits for the port of ``native/``).
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator

CACHE_DIR = Path(os.environ.get("DL4J_TPU_CACHE", str(Path.home() / ".deeplearning4j_tpu")))

MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}


_IDX_TYPES = {0x08: np.dtype(">u1"), 0x0D: np.dtype(">f4")}


def _read_idx(path: Path) -> np.ndarray:
    """Parse an IDX (ubyte) file, gzip or raw, into uint8 (ref:
    MnistManager.java): the magic's third byte is the element type, its
    fourth the number of dimensions, then one big-endian uint32 per
    dimension and the data."""
    path = Path(path)
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as f:
            raw = f.read()
    else:
        raw = path.read_bytes()
    code, ndim = raw[2], raw[3]
    dims = [struct.unpack(">I", raw[4 + 4 * i:8 + 4 * i])[0]
            for i in range(ndim)]
    data = np.frombuffer(raw, dtype=_IDX_TYPES[code],
                         count=int(np.prod(dims)), offset=4 + 4 * ndim)
    return data.reshape(dims).astype(np.uint8)


def _synthetic_images(n: int, n_classes: int, hw: Tuple[int, int], channels: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable images: each class is a distinct
    frequency/orientation pattern plus noise — learnable by conv nets,
    making loss-decrease and accuracy tests meaningful offline."""
    rng = np.random.default_rng(seed)
    h, w = hw
    ys = rng.integers(0, n_classes, n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.empty((n, channels, h, w), np.float32)
    for c in range(n_classes):
        theta = np.pi * c / n_classes
        freq = 2.0 + (c % 5)
        base = np.sin(freq * (np.cos(theta) * xx + np.sin(theta) * yy) / w * 2 * np.pi)
        sel = ys == c
        k = int(sel.sum())
        if k == 0:
            continue
        noise = rng.normal(0, 0.35, (k, channels, h, w)).astype(np.float32)
        imgs[sel] = base[None, None] + noise
    imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min() + 1e-9)
    labels = np.eye(n_classes, dtype=np.float32)[ys]
    return imgs.astype(np.float32), labels


def load_mnist(train: bool = True, flatten: bool = False,
               num_examples: Optional[int] = None) -> DataSet:
    """MNIST as a DataSet: features [N,1,28,28] (or [N,784]), one-hot labels."""
    sub = "train" if train else "test"
    img_path = CACHE_DIR / "mnist" / MNIST_FILES[f"{sub}_images"]
    lab_path = CACHE_DIR / "mnist" / MNIST_FILES[f"{sub}_labels"]
    if img_path.exists() and lab_path.exists():
        images = _read_idx(img_path).astype(np.float32) / 255.0
        labels_idx = _read_idx(lab_path)
        images = images[:, None, :, :]
        labels = np.eye(10, dtype=np.float32)[labels_idx]
    else:
        n = num_examples or (60000 if train else 10000)
        n = min(n, 8192)  # synthetic fallback kept small
        images, labels = _synthetic_images(n, 10, (28, 28), 1,
                                           seed=1 if train else 2)
    if num_examples:
        images, labels = images[:num_examples], labels[:num_examples]
    if flatten:
        images = images.reshape(images.shape[0], -1)
    return DataSet(images, labels)


def load_cifar10(train: bool = True, num_examples: Optional[int] = None) -> DataSet:
    """CIFAR-10: features [N,3,32,32], one-hot labels (ref: CifarDataSetIterator)."""
    base = CACHE_DIR / "cifar-10-batches-bin"
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    paths = [base / f for f in files]
    if all(p.exists() for p in paths):
        xs, ys = [], []
        for p in paths:
            raw = np.frombuffer(p.read_bytes(), dtype=np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0])
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32))
        images = np.concatenate(xs).astype(np.float32) / 255.0
        labels = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
    else:
        n = num_examples or (50000 if train else 10000)
        n = min(n, 8192)
        images, labels = _synthetic_images(n, 10, (32, 32), 3,
                                           seed=3 if train else 4)
    if num_examples:
        images, labels = images[:num_examples], labels[:num_examples]
    return DataSet(images, labels)


def load_lfw(num_examples: int = 1000, n_labels: int = 40,
             image_hw: Tuple[int, int] = (64, 64), train: bool = True
             ) -> DataSet:
    """LFW faces: features [N,3,H,W], one-hot person labels
    (ref: datasets/fetchers/LFWDataFetcher + LFWDataSetIterator).  With
    no cached copy (zero egress), deterministic class-separable
    synthetic faces stand in, like the MNIST/CIFAR fallbacks."""
    base = CACHE_DIR / "lfw"
    if base.exists():
        files = sorted(p for p in base.rglob("*")
                       if p.suffix.lower() in _IMAGE_EXTS)
        if files:  # empty/garbage cache dir → synthetic fallback below
            names = sorted({p.parent.name for p in files})
            # deterministic 80/20 train/test split by position
            split = max(1, int(0.8 * len(files)))
            chosen = files[:split] if train else files[split:]
            xs, ys = [], []
            for path in chosen[:num_examples]:
                xs.append(_load_image(path, image_hw))
                ys.append(names.index(path.parent.name))
            labels = np.eye(max(len(names), 1),
                            dtype=np.float32)[np.asarray(ys)]
            return DataSet(np.stack(xs) / 255.0, labels)
    n = min(num_examples, 4096)
    images, labels = _synthetic_images(n, n_labels, image_hw, 3,
                                       seed=5 if train else 6)
    return DataSet(images, labels)


_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm",
               ".npy"}


def _load_image(path: Path, hw: Tuple[int, int]) -> np.ndarray:
    """One RGB image as [3, H, W] float32, as the JAX package's
    ``ImageRecordReader(H, W, 3)`` reads it: resized by PIL (a ``.npy``
    array as it is), channels and pixels beyond [3, H, W] cut, missing
    ones zero."""
    h, w = hw
    if path.suffix.lower() == ".npy":
        arr = np.load(path)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
    else:
        from PIL import Image
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB").resize((w, h)), np.float32)
        arr = arr.transpose(2, 0, 1)
    arr = arr[:3]
    if arr.shape != (3, h, w):
        out = np.zeros((3, h, w), np.float32)
        c, hh, ww = (min(a, b) for a, b in zip(arr.shape, (3, h, w)))
        out[:c, :hh, :ww] = arr[:c, :hh, :ww]
        arr = out
    return arr.astype(np.float32)


def load_curves(num_examples: int = 10000) -> DataSet:
    """The "curves" dataset (28×28 grayscale parametric curves used by
    the original deep-autoencoder work; ref:
    datasets/fetchers/CurvesDataFetcher.java:37-51 — S3 download there,
    deterministic synthesis here: features double as labels, it is an
    autoencoder dataset)."""
    n = min(num_examples, 8192)
    rng = np.random.default_rng(12)
    t = np.linspace(0.0, 1.0, 28, dtype=np.float32)
    images = np.zeros((n, 1, 28, 28), np.float32)
    for i in range(n):
        # random cubic Bézier curve rasterized onto the 28x28 grid
        pts = rng.uniform(2, 26, size=(4, 2)).astype(np.float32)
        b = ((1 - t)[:, None] ** 3 * pts[0]
             + 3 * ((1 - t) ** 2 * t)[:, None] * pts[1]
             + 3 * ((1 - t) * t ** 2)[:, None] * pts[2]
             + (t ** 3)[:, None] * pts[3])
        xi = np.clip(b[:, 0].astype(int), 0, 27)
        yi = np.clip(b[:, 1].astype(int), 0, 27)
        images[i, 0, yi, xi] = 1.0
    flat = images.reshape(n, -1)
    return DataSet(flat, flat)  # autoencoder: labels == features


class LFWDataSetIterator(ListDataSetIterator):
    """(ref: datasets/iterator/impl/LFWDataSetIterator.java)"""

    def __init__(self, batch_size: int, num_examples: int = 1000,
                 n_labels: int = 40, image_hw: Tuple[int, int] = (64, 64),
                 train: bool = True):
        ds = load_lfw(num_examples, n_labels, image_hw, train)
        super().__init__(ds.batch_by(batch_size))


class CurvesDataSetIterator(ListDataSetIterator):
    """(ref: CurvesDataFetcher consumed via BaseDatasetIterator)"""

    def __init__(self, batch_size: int, num_examples: int = 10000):
        ds = load_curves(num_examples)
        super().__init__(ds.batch_by(batch_size))


def load_iris() -> DataSet:
    """The Iris dataset, bundled inline (150 examples — the reference bundles
    it as a resource; ref: IrisDataSetIterator)."""
    data = _IRIS.reshape(150, 5)
    features = data[:, :4].astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[data[:, 4].astype(int)]
    return DataSet(features, labels)


class MnistDataSetIterator(ListDataSetIterator):
    """(ref: datasets/iterator/impl/MnistDataSetIterator.java)"""

    def __init__(self, batch: int, num_examples: Optional[int] = None,
                 train: bool = True, shuffle: bool = True, seed: int = 123,
                 flatten: bool = False):
        ds = load_mnist(train=train, flatten=flatten, num_examples=num_examples)
        if shuffle:
            ds = ds.shuffle(seed)
        super().__init__(ds, batch)


class IrisDataSetIterator(ListDataSetIterator):
    """(ref: datasets/iterator/impl/IrisDataSetIterator.java)"""

    def __init__(self, batch: int = 150, num_examples: int = 150):
        ds = load_iris()
        super().__init__(DataSet(ds.features[:num_examples],
                                 ds.labels[:num_examples]), batch)


class CifarDataSetIterator(ListDataSetIterator):
    """(ref: datasets/iterator/impl/CifarDataSetIterator.java)"""

    def __init__(self, batch: int, num_examples: Optional[int] = None,
                 train: bool = True, shuffle: bool = True, seed: int = 123):
        ds = load_cifar10(train=train, num_examples=num_examples)
        if shuffle:
            ds = ds.shuffle(seed)
        super().__init__(ds, batch)


# Fisher's Iris data: 4 features + class index, 150 rows (public domain).
_IRIS = np.array([
    5.1,3.5,1.4,0.2,0, 4.9,3.0,1.4,0.2,0, 4.7,3.2,1.3,0.2,0, 4.6,3.1,1.5,0.2,0,
    5.0,3.6,1.4,0.2,0, 5.4,3.9,1.7,0.4,0, 4.6,3.4,1.4,0.3,0, 5.0,3.4,1.5,0.2,0,
    4.4,2.9,1.4,0.2,0, 4.9,3.1,1.5,0.1,0, 5.4,3.7,1.5,0.2,0, 4.8,3.4,1.6,0.2,0,
    4.8,3.0,1.4,0.1,0, 4.3,3.0,1.1,0.1,0, 5.8,4.0,1.2,0.2,0, 5.7,4.4,1.5,0.4,0,
    5.4,3.9,1.3,0.4,0, 5.1,3.5,1.4,0.3,0, 5.7,3.8,1.7,0.3,0, 5.1,3.8,1.5,0.3,0,
    5.4,3.4,1.7,0.2,0, 5.1,3.7,1.5,0.4,0, 4.6,3.6,1.0,0.2,0, 5.1,3.3,1.7,0.5,0,
    4.8,3.4,1.9,0.2,0, 5.0,3.0,1.6,0.2,0, 5.0,3.4,1.6,0.4,0, 5.2,3.5,1.5,0.2,0,
    5.2,3.4,1.4,0.2,0, 4.7,3.2,1.6,0.2,0, 4.8,3.1,1.6,0.2,0, 5.4,3.4,1.5,0.4,0,
    5.2,4.1,1.5,0.1,0, 5.5,4.2,1.4,0.2,0, 4.9,3.1,1.5,0.1,0, 5.0,3.2,1.2,0.2,0,
    5.5,3.5,1.3,0.2,0, 4.9,3.1,1.5,0.1,0, 4.4,3.0,1.3,0.2,0, 5.1,3.4,1.5,0.2,0,
    5.0,3.5,1.3,0.3,0, 4.5,2.3,1.3,0.3,0, 4.4,3.2,1.3,0.2,0, 5.0,3.5,1.6,0.6,0,
    5.1,3.8,1.9,0.4,0, 4.8,3.0,1.4,0.3,0, 5.1,3.8,1.6,0.2,0, 4.6,3.2,1.4,0.2,0,
    5.3,3.7,1.5,0.2,0, 5.0,3.3,1.4,0.2,0, 7.0,3.2,4.7,1.4,1, 6.4,3.2,4.5,1.5,1,
    6.9,3.1,4.9,1.5,1, 5.5,2.3,4.0,1.3,1, 6.5,2.8,4.6,1.5,1, 5.7,2.8,4.5,1.3,1,
    6.3,3.3,4.7,1.6,1, 4.9,2.4,3.3,1.0,1, 6.6,2.9,4.6,1.3,1, 5.2,2.7,3.9,1.4,1,
    5.0,2.0,3.5,1.0,1, 5.9,3.0,4.2,1.5,1, 6.0,2.2,4.0,1.0,1, 6.1,2.9,4.7,1.4,1,
    5.6,2.9,3.6,1.3,1, 6.7,3.1,4.4,1.4,1, 5.6,3.0,4.5,1.5,1, 5.8,2.7,4.1,1.0,1,
    6.2,2.2,4.5,1.5,1, 5.6,2.5,3.9,1.1,1, 5.9,3.2,4.8,1.8,1, 6.1,2.8,4.0,1.3,1,
    6.3,2.5,4.9,1.5,1, 6.1,2.8,4.7,1.2,1, 6.4,2.9,4.3,1.3,1, 6.6,3.0,4.4,1.4,1,
    6.8,2.8,4.8,1.4,1, 6.7,3.0,5.0,1.7,1, 6.0,2.9,4.5,1.5,1, 5.7,2.6,3.5,1.0,1,
    5.5,2.4,3.8,1.1,1, 5.5,2.4,3.7,1.0,1, 5.8,2.7,3.9,1.2,1, 6.0,2.7,5.1,1.6,1,
    5.4,3.0,4.5,1.5,1, 6.0,3.4,4.5,1.6,1, 6.7,3.1,4.7,1.5,1, 6.3,2.3,4.4,1.3,1,
    5.6,3.0,4.1,1.3,1, 5.5,2.5,4.0,1.3,1, 5.5,2.6,4.4,1.2,1, 6.1,3.0,4.6,1.4,1,
    5.8,2.6,4.0,1.2,1, 5.0,2.3,3.3,1.0,1, 5.6,2.7,4.2,1.3,1, 5.7,3.0,4.2,1.2,1,
    5.7,2.9,4.2,1.3,1, 6.2,2.9,4.3,1.3,1, 5.1,2.5,3.0,1.1,1, 5.7,2.8,4.1,1.3,1,
    6.3,3.3,6.0,2.5,2, 5.8,2.7,5.1,1.9,2, 7.1,3.0,5.9,2.1,2, 6.3,2.9,5.6,1.8,2,
    6.5,3.0,5.8,2.2,2, 7.6,3.0,6.6,2.1,2, 4.9,2.5,4.5,1.7,2, 7.3,2.9,6.3,1.8,2,
    6.7,2.5,5.8,1.8,2, 7.2,3.6,6.1,2.5,2, 6.5,3.2,5.1,2.0,2, 6.4,2.7,5.3,1.9,2,
    6.8,3.0,5.5,2.1,2, 5.7,2.5,5.0,2.0,2, 5.8,2.8,5.1,2.4,2, 6.4,3.2,5.3,2.3,2,
    6.5,3.0,5.5,1.8,2, 7.7,3.8,6.7,2.2,2, 7.7,2.6,6.9,2.3,2, 6.0,2.2,5.0,1.5,2,
    6.9,3.2,5.7,2.3,2, 5.6,2.8,4.9,2.0,2, 7.7,2.8,6.7,2.0,2, 6.3,2.7,4.9,1.8,2,
    6.7,3.3,5.7,2.1,2, 7.2,3.2,6.0,1.8,2, 6.2,2.8,4.8,1.8,2, 6.1,3.0,4.9,1.8,2,
    6.4,2.8,5.6,2.1,2, 7.2,3.0,5.8,1.6,2, 7.4,2.8,6.1,1.9,2, 7.9,3.8,6.4,2.0,2,
    6.4,2.8,5.6,2.2,2, 6.3,2.8,5.1,1.5,2, 6.1,2.6,5.6,1.4,2, 7.7,3.0,6.1,2.3,2,
    6.3,3.4,5.6,2.4,2, 6.4,3.1,5.5,1.8,2, 6.0,3.0,4.8,1.8,2, 6.9,3.1,5.4,2.1,2,
    6.7,3.1,5.6,2.4,2, 6.9,3.1,5.1,2.3,2, 5.8,2.7,5.1,1.9,2, 6.8,3.2,5.9,2.3,2,
    6.7,3.3,5.7,2.5,2, 6.7,3.0,5.2,2.3,2, 6.3,2.5,5.0,1.9,2, 6.5,3.0,5.2,2.0,2,
    6.2,3.4,5.4,2.3,2, 5.9,3.0,5.1,1.8,2,
], dtype=np.float32)
