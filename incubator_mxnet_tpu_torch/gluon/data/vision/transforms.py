"""Vision transforms (`incubator_mxnet_tpu/gluon/data/vision/
transforms.py`): blocks over one HWC image (or a batch) on the host.

Their arithmetic is the JAX package's `image` augmenters' (numpy, with
Python's `random` and numpy's global generator drawing as they do).
Resizing, which the JAX package hands to OpenCV, is
`torch.nn.functional.interpolate` here with OpenCV's conventions (half-
pixel centres, no antialiasing): interp 0 nearest, 1 bilinear, 2
bicubic, 3 area. Outputs are CPU NDArrays."""
from __future__ import annotations

import random as pyrandom

import numpy as np
import torch
import torch.nn.functional as tF

from ....ndarray.ndarray import NDArray
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]

_GRAY = np.array([[[0.299, 0.587, 0.114]]])
_MODES = {0: "nearest-exact", 1: "bilinear", 2: "bicubic", 3: "area"}


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def _host(a):
    return NDArray._from_data(torch.from_numpy(np.ascontiguousarray(a)))


def _resize(a, w, h, interp):
    """HWC (or HW) image `a` resized to w x h."""
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.float32)
    t = (t[None, None] if a.ndim == 2 else t.permute(2, 0, 1)[None])
    mode = _MODES.get(interp, "bilinear")
    kw = ({"align_corners": False} if mode in ("bilinear", "bicubic")
          else {})
    out = tF.interpolate(t, size=(h, w), mode=mode, **kw)[0]
    out = out[0] if a.ndim == 2 else out.permute(1, 2, 0)
    out = out.numpy()
    if np.issubdtype(a.dtype, np.integer):
        info = np.iinfo(a.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(a.dtype)


def _scale_down(src_size, size):
    """Shrink a crop (w, h) to fit inside src_size, keeping its aspect."""
    sw, sh = src_size
    w, h = size
    shrink = min(1.0, sw / float(w), sh / float(h))
    return int(w * shrink), int(h * shrink)


def _fixed_crop(a, x0, y0, w, h, size, interp):
    window = a[y0:y0 + h, x0:x0 + w]
    if size is None or tuple(size) == (w, h):
        return window
    return _resize(window, size[0], size[1], interp)


def _center_crop(a, size, interp):
    h, w = a.shape[:2]
    cw, ch = _scale_down((w, h), size)
    return _fixed_crop(a, (w - cw) // 2, (h - ch) // 2, cw, ch, size,
                       interp)


def _random_size_crop(a, size, area, ratio, interp):
    """Inception-style crop: an area fraction and a log-uniform aspect,
    up to 10 draws for a window that fits, else the centre crop."""
    h, w = a.shape[:2]
    lo, hi = (area, 1.0) if isinstance(area, (int, float)) else area
    for _ in range(10):
        pixels = pyrandom.uniform(lo, hi) * (h * w)
        aspect = np.exp(pyrandom.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(pixels * aspect)))
        ch = int(round(np.sqrt(pixels / aspect)))
        if cw > w or ch > h:
            continue
        return _fixed_crop(a, pyrandom.randint(0, w - cw),
                           pyrandom.randint(0, h - ch), cw, ch, size, interp)
    return _center_crop(a, size, interp)


class Compose(Sequential):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        self.add(*transforms)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _host(_np(x).astype(self._dtype))


class ToTensor(Block):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""

    def forward(self, x):
        a = _np(x).astype(np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return _host(a)


class Normalize(Block):
    """(x - mean) / std per channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32)
        self._std = np.asarray(std, dtype=np.float32)

    def forward(self, x):
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return _host((_np(x) - mean) / std)


class Resize(Block):
    """Resize to `size` (w, h), or a square."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size,
                                                                   size)
        self._interpolation = interpolation

    def forward(self, x):
        return _host(_resize(_np(x), self._size[0], self._size[1],
                             self._interpolation))


class CenterCrop(Block):
    """The centred crop of `size` (w, h), scaled down to fit and resized
    back to `size`."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size,
                                                                   size)
        self._interpolation = interpolation

    def forward(self, x):
        return _host(_center_crop(_np(x), self._size, self._interpolation))


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._args = (size if isinstance(size, (tuple, list))
                      else (size, size), scale, ratio, interpolation)

    def forward(self, x):
        size, scale, ratio, interp = self._args
        return _host(_random_size_crop(_np(x), size, scale, ratio, interp))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _host(_np(x)[:, ::-1])
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _host(_np(x)[::-1])
        return x


def _brightness(a, brightness):
    alpha = 1.0 + pyrandom.uniform(-brightness, brightness)
    return a * alpha


def _contrast(a, contrast):
    alpha = 1.0 + pyrandom.uniform(-contrast, contrast)
    a = a.astype(np.float32)
    gray = (a * _GRAY).sum() * (3.0 / a.size)
    return a * alpha + gray * (1 - alpha)


def _saturation(a, saturation):
    alpha = 1.0 + pyrandom.uniform(-saturation, saturation)
    a = a.astype(np.float32)
    gray = (a * _GRAY).sum(axis=2, keepdims=True)
    return a * alpha + gray * (1 - alpha)


_TYIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                  [0.211, -0.523, 0.311]])
_ITYIQ = np.array([[1.0, 0.956, 0.621], [1.0, -0.272, -0.647],
                   [1.0, -1.107, 1.705]])


def _hue(a, hue):
    alpha = pyrandom.uniform(-hue, hue)
    u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
    bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
    t = np.dot(np.dot(_ITYIQ, bt), _TYIQ).T
    return np.dot(a.astype(np.float32), t)


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        return _host(_brightness(_np(x), self._b))


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        return _host(_contrast(_np(x), self._c))


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        return _host(_saturation(_np(x), self._s))


class RandomLighting(Block):
    """PCA lighting noise with ImageNet's eigenvalues and vectors."""

    _EIGVAL = np.array([55.46, 4.794, 1.148])
    _EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.814],
                        [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = np.random.normal(0, self._alpha, size=(3,))
        rgb = np.dot(self._EIGVEC * alpha, self._EIGVAL)
        return _host(_np(x).astype(np.float32) + rgb)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        return _host(_hue(_np(x), self._h))


class RandomColorJitter(Block):
    """Brightness, contrast and saturation jitter in a random order, then
    hue."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._args = (brightness, contrast, saturation)
        self._hue = hue

    def forward(self, x):
        brightness, contrast, saturation = self._args
        ts = []
        if brightness > 0:
            ts.append(lambda a: _brightness(a, brightness))
        if contrast > 0:
            ts.append(lambda a: _contrast(a, contrast))
        if saturation > 0:
            ts.append(lambda a: _saturation(a, saturation))
        pyrandom.shuffle(ts)
        a = _np(x)
        for t in ts:
            a = t(a)
        if self._hue:
            a = _hue(a, self._hue)
        return _host(a)
