"""Dataset sources (a copy of the JAX package's ``data/sources.py``,
numpy only, kept here so the port imports nothing from the JAX package).

The reference downloads CIFAR-10 via torchvision
(``Balanced All-Reduce/dataloader.py:10,29-30``).  This environment has no
network egress and no torchvision, so each dataset has two backends:

- **real**: CIFAR-10 python binaries under ``data_dir/cifar-10-batches-py``
  (the standard pickle format) if present on disk;
- **synthetic**: a deterministic, seeded generator producing data with real
  class structure (class-dependent spatial/color patterns + noise) so that
  training genuinely learns and loss/accuracy curves behave like the real
  thing.  Used by tests and by default when the binaries are absent.

Arrays are NHWC float32 in [0,1]; normalization uses dataset-wide per-channel
mean/std computed from the raw train data, exactly as the reference computes
them (``dataloader.py:12-13``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    """In-memory dataset (host-side numpy; sharded onto devices later)."""

    images: np.ndarray  # [N, H, W, C] float32, normalized
    labels: np.ndarray  # [N] int32
    num_classes: int
    mean: np.ndarray    # per-channel mean of raw [0,1] data
    std: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)


def _cifar10_real(data_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        return None
    def load(names):
        xs, ys = [], []
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.extend(d[b"labels"])
        return (np.concatenate(xs).astype(np.float32) / 255.0,
                np.asarray(ys, np.int32))
    xtr, ytr = load([f"data_batch_{i}" for i in range(1, 6)])
    xte, yte = load(["test_batch"])
    return xtr, ytr, xte, yte


def _cifar10_synthetic(n_train: int, n_test: int, seed: int):
    """Learnable 10-class 32x32x3 data.

    Each class has a distinct low-frequency spatial template plus a color
    bias; samples are template + per-sample noise, giving a task a CNN can
    take from 10% to >90% accuracy within a few epochs — so integration tests
    can assert learning, and curves are shaped like real training.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    templates = []
    for c in range(10):
        fx, fy = 1 + (c % 3), 1 + (c // 3)
        phase = c * 0.7
        pattern = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
        color = np.array([np.sin(c * 1.3), np.cos(c * 0.9), np.sin(c * 2.1 + 1)],
                         np.float32) * 0.3
        img = 0.5 + 0.25 * pattern[..., None] + color
        templates.append(img.astype(np.float32))
    templates = np.stack(templates)  # [10, 32, 32, 3]

    def sample(n, rng):
        y = rng.integers(0, 10, size=n).astype(np.int32)
        x = templates[y]
        x = x + rng.normal(0, 0.25, size=x.shape).astype(np.float32)
        # random per-sample brightness/contrast so the task isn't trivial
        gain = rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
        bias = rng.uniform(-0.15, 0.15, size=(n, 1, 1, 1)).astype(np.float32)
        return np.clip(x * gain + bias, 0.0, 1.0), y

    xtr, ytr = sample(n_train, rng)
    xte, yte = sample(n_test, rng)
    return xtr, ytr, xte, yte


def _mnist_real(data_dir: str):
    """MNIST from the standard IDX files (``train-images-idx3-ubyte`` etc.,
    optionally gzipped) under ``data_dir/MNIST/raw`` or ``data_dir`` —
    the torchvision on-disk layout, read without torchvision."""
    import gzip
    names = {
        "xtr": "train-images-idx3-ubyte", "ytr": "train-labels-idx1-ubyte",
        "xte": "t10k-images-idx3-ubyte", "yte": "t10k-labels-idx1-ubyte",
    }

    def find(name):
        for base in (os.path.join(data_dir, "MNIST", "raw"), data_dir):
            for suffix in ("", ".gz"):
                p = os.path.join(base, name + suffix)
                if os.path.isfile(p):
                    return p
        return None

    paths = {k: find(n) for k, n in names.items()}
    if any(p is None for p in paths.values()):
        return None

    def read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            raw = f.read()
        if len(raw) < 4:
            raise ValueError(f"truncated IDX header in {path}")
        magic = raw[2]  # dtype code (0x08 = u8)
        ndim = raw[3]
        if magic != 0x08:
            raise ValueError(f"unsupported IDX dtype 0x{magic:02x} in {path}")
        if len(raw) < 4 + 4 * ndim:
            raise ValueError(f"truncated IDX dimension table in {path}")
        dims = [int.from_bytes(raw[4 + 4 * i:8 + 4 * i], "big")
                for i in range(ndim)]
        expect = 4 + 4 * ndim + int(np.prod(dims))
        if len(raw) != expect:
            raise ValueError(f"IDX payload size mismatch in {path}: "
                             f"{len(raw)} bytes, expected {expect}")
        return np.frombuffer(raw, np.uint8,
                             offset=4 + 4 * ndim).reshape(dims)

    xtr = read_idx(paths["xtr"]).astype(np.float32)[..., None] / 255.0
    xte = read_idx(paths["xte"]).astype(np.float32)[..., None] / 255.0
    ytr = read_idx(paths["ytr"]).astype(np.int32)
    yte = read_idx(paths["yte"]).astype(np.int32)
    return xtr, ytr, xte, yte


def _mnist_synthetic(n_train: int, n_test: int, seed: int):
    """Learnable 10-class 28x28x1 data (digit-like stroke templates)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 27.0
    templates = []
    for c in range(10):
        cx, cy = 0.3 + 0.05 * (c % 4), 0.3 + 0.05 * (c // 4)
        r = 0.15 + 0.02 * c
        ring = np.exp(-((np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) - r) ** 2)
                      / 0.004)
        bar = np.exp(-((xx - (0.2 + 0.07 * c)) ** 2) / 0.01) * (c % 2)
        templates.append(np.clip(ring + bar, 0, 1)[..., None].astype(np.float32))
    templates = np.stack(templates)

    def sample(n, rng):
        y = rng.integers(0, 10, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0, 0.2, size=(n, 28, 28, 1)).astype(np.float32)
        return np.clip(x, 0, 1), y

    xtr, ytr = sample(n_train, rng)
    xte, yte = sample(n_test, rng)
    return xtr, ytr, xte, yte


MASK_TOKEN = 1  # token id 0 is reserved as pad, 1 as [MASK]


def _mlm_synthetic(n_train: int, n_test: int, seed: int, seq_len: int = 128,
                   vocab: int = 1000, mask_rate: float = 0.15):
    """Learnable masked-LM data: each sequence is an arithmetic token
    progression ``tok[i] = (base + step*i) % (vocab-2) + 2`` so masked
    positions are inferable from context; 15% of positions are replaced by
    [MASK] with the original token as label, all other labels are -1
    (ignore-index)."""
    rng = np.random.default_rng(seed)

    def sample(n, rng):
        base = rng.integers(0, vocab - 2, (n, 1))
        step = rng.integers(1, 8, (n, 1))
        pos = np.arange(seq_len)[None, :]
        toks = ((base + step * pos) % (vocab - 2) + 2).astype(np.int32)
        masked = rng.random((n, seq_len)) < mask_rate
        labels = np.where(masked, toks, -1).astype(np.int32)
        inputs = np.where(masked, MASK_TOKEN, toks).astype(np.int32)
        return inputs, labels

    xtr, ytr = sample(n_train, rng)
    xte, yte = sample(n_test, rng)
    return xtr, ytr, xte, yte, vocab


def _lm_synthetic(n_train: int, n_test: int, seed: int, seq_len: int = 128,
                  vocab: int = 1000):
    """Learnable causal-LM data: arithmetic token progressions (the next
    token is a deterministic function of any two previous ones), labels
    shifted one left with the final position -1 (ignore-index) — the
    standard next-token-prediction layout."""
    rng = np.random.default_rng(seed)

    def sample(n, rng):
        base = rng.integers(0, vocab - 2, (n, 1))
        step = rng.integers(1, 8, (n, 1))
        pos = np.arange(seq_len)[None, :]
        toks = ((base + step * pos) % (vocab - 2) + 2).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((n, 1), -1, np.int32)], axis=1)
        return toks, labels

    xtr, ytr = sample(n_train, rng)
    xte, yte = sample(n_test, rng)
    return xtr, ytr, xte, yte, vocab


def load_dataset(name: str, data_dir: str = "data", seed: int = 0,
                 limit_train: int = 0, limit_test: int = 0
                 ) -> tuple[Dataset, Dataset]:
    """Return (train, test) Datasets, normalized with train-set stats
    (dataset-wide mean/std from raw data — ref dataloader.py:12-13)."""
    name = name.lower()
    if name == "cifar10":
        real = _cifar10_real(data_dir)
        if real is not None:
            xtr, ytr, xte, yte = real
        else:
            xtr, ytr, xte, yte = _cifar10_synthetic(
                min(limit_train or 50_000, 50_000),
                min(limit_test or 10_000, 10_000), seed)
        ncls = 10
    elif name == "mnist":
        real = _mnist_real(data_dir)
        if real is not None:
            xtr, ytr, xte, yte = real
        else:
            xtr, ytr, xte, yte = _mnist_synthetic(
                min(limit_train or 60_000, 60_000),
                min(limit_test or 10_000, 10_000), seed)
        ncls = 10
    elif name == "imagenet":
        # synthetic ImageNet-shaped data (224x224x3, 1000 classes), sized for
        # throughput benchmarking rather than accuracy
        rng = np.random.default_rng(seed)
        ntr = limit_train or 8192
        nte = limit_test or 1024
        xtr = rng.random((ntr, 224, 224, 3), dtype=np.float32)
        ytr = rng.integers(0, 1000, ntr).astype(np.int32)
        xte = rng.random((nte, 224, 224, 3), dtype=np.float32)
        yte = rng.integers(0, 1000, nte).astype(np.int32)
        ncls = 1000
    elif name == "synthetic_mlm":
        xtr, ytr, xte, yte, ncls = _mlm_synthetic(
            limit_train or 8192, limit_test or 1024, seed)
    elif name == "synthetic_lm":
        xtr, ytr, xte, yte, ncls = _lm_synthetic(
            limit_train or 8192, limit_test or 1024, seed)
    else:
        raise ValueError(f"unknown dataset {name!r}")

    if limit_train:
        xtr, ytr = xtr[:limit_train], ytr[:limit_train]
    if limit_test:
        xte, yte = xte[:limit_test], yte[:limit_test]

    if np.issubdtype(xtr.dtype, np.integer):
        # token data: no normalization
        zero, one = np.zeros(1, np.float32), np.ones(1, np.float32)
        return (Dataset(xtr, ytr, ncls, zero, one),
                Dataset(xte, yte, ncls, zero, one))
    mean = xtr.mean(axis=(0, 1, 2))
    std = xtr.std(axis=(0, 1, 2)) + 1e-7
    norm = lambda x: (x - mean) / std
    train = Dataset(norm(xtr).astype(np.float32), ytr, ncls, mean, std)
    test = Dataset(norm(xte).astype(np.float32), yte, ncls, mean, std)
    return train, test


def train_val_split(ds: Dataset, val_fraction: float = 0.2, seed: int = 0
                    ) -> tuple[Dataset, Dataset]:
    """80/20 random split (ref dataloader.py:33-35 random_split)."""
    n = len(ds)
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int((1.0 - val_fraction) * n)
    tr, va = perm[:n_train], perm[n_train:]
    mk = lambda idx: Dataset(ds.images[idx], ds.labels[idx], ds.num_classes,
                             ds.mean, ds.std)
    return mk(tr), mk(va)
