"""Vision datasets (`incubator_mxnet_tpu/gluon/data/vision/datasets.py`):
MNIST / FashionMNIST idx files and CIFAR-10 / CIFAR-100 binary batches
read from `root` (nothing is downloaded: a missing file raises), and
`SyntheticImageDataset`, generated from a seed. Items are CPU NDArrays
(HWC uint8 images for the file readers) and integer labels.
`ImageFolderDataset` / `ImageRecordDataset` need image decoding, which
waits for the data layer (ROADMAP Queue A 6d)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

from ....ndarray.ndarray import NDArray
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "SyntheticImageDataset"]


def _host(a):
    """A CPU NDArray over a copy of numpy `a`."""
    return NDArray._from_data(torch.from_numpy(np.array(a)))


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(_host(self._data[idx]), self._label[idx])
        return _host(self._data[idx]), self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from the idx files (gzipped or not) in `root`."""

    _train_files = ("train-images-idx3-ubyte.gz",
                    "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = f.read()
        ndim = struct.unpack(">i", data[:4])[0] % 256
        dims = struct.unpack(">" + "i" * ndim, data[4:4 + 4 * ndim])
        return np.frombuffer(data[4 + 4 * ndim:], dtype=np.uint8).reshape(
            dims)

    def _get_data(self):
        imgs, lbls = self._train_files if self._train else self._test_files
        paths = []
        for name in (imgs, lbls):
            p = os.path.join(self._root, name)
            if not os.path.exists(p) and not os.path.exists(p[:-3]):
                raise FileNotFoundError(
                    f"{p} not found: place the standard MNIST idx files "
                    "under the dataset root (nothing is downloaded), or use "
                    "SyntheticImageDataset")
            paths.append(p if os.path.exists(p) else p[:-3])
        self._data = self._read_idx(paths[0]).reshape(-1, 28, 28, 1)
        self._label = self._read_idx(paths[1]).astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the binary batches in `root`."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if self._train
                 else ["test_batch.bin"])
        data, label = [], []
        for fname in files:
            path = os.path.join(self._root, fname)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} not found: provide the CIFAR binary batches "
                    "(nothing is downloaded) or use SyntheticImageDataset")
            raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
            label.append(raw[:, 0])
            data.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3,
                                                                   1))
        self._data = np.concatenate(data)
        self._label = np.concatenate(label).astype(np.int32)


class CIFAR100(CIFAR10):
    """CIFAR-100 (`train.bin` / `test.bin`), coarse or fine labels."""

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=False, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        path = os.path.join(self._root,
                            "train.bin" if self._train else "test.bin")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found")
        raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3074)
        self._label = raw[:, 1 if self._fine else 0].astype(np.int32)
        self._data = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


class SyntheticImageDataset(Dataset):
    """Seeded image-classification data: item i is uniform [0, 1) float32
    noise of `shape` from RandomState(seed + i) and a label drawn once
    from RandomState(seed)."""

    def __init__(self, num_samples=1000, shape=(3, 224, 224),
                 num_classes=1000, transform=None, seed=0,
                 channels_last=False):
        rng = np.random.RandomState(seed)
        self._labels = rng.randint(0, num_classes,
                                   size=num_samples).astype(np.int32)
        self._shape = tuple(shape)
        self._seed = seed
        self._transform = transform
        self._channels_last = channels_last

    def __getitem__(self, idx):
        img = np.random.RandomState(self._seed + idx).rand(
            *self._shape).astype(np.float32)
        label = self._labels[idx]
        if self._transform is not None:
            return self._transform(_host(img), label)
        return _host(img), label

    def __len__(self):
        return len(self._labels)
