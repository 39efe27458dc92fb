"""MobileNet v1/v2 (Howard et al. 1704.04861; Sandler et al.
1801.04381; `incubator_mxnet_tpu/gluon/model_zoo/vision/mobilenet.py`):
each network is a flat spec table -- v1 rows (out_channels, stride) of
depthwise-separable units, v2 rows (expansion, out_channels, stride,
repeats) of inverted-residual groups -- read with the width multiplier
applied, and `_cba` (conv-BN-activation) is the one conv constructor.
NCHW.
"""
from functools import partial

from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]

# v1: (out_channels, stride) per depthwise-separable unit
V1_SPEC = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1))

# v2: (expansion t, out_channels, stride, repeats) per bottleneck group
V2_SPEC = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 2, 3), (6, 64, 2, 4),
           (6, 96, 1, 3), (6, 160, 2, 3), (6, 320, 1, 1))


class _ReLU6(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.clip(x, a_min=0.0, a_max=6.0)


def _cba(seq, channels, kernel=1, stride=1, pad=0, groups=1, act="relu"):
    """conv -> BN -> activation; act in {'relu', 'relu6', None}."""
    seq.add(nn.Conv2D(channels, kernel, stride, pad, groups=groups,
                      use_bias=False))
    seq.add(nn.BatchNorm(scale=True))
    if act == "relu":
        seq.add(nn.Activation("relu"))
    elif act == "relu6":
        seq.add(_ReLU6())


class InvertedResidual(HybridBlock):
    """v2 unit: 1x1 expand -> 3x3 depthwise -> linear 1x1 project, with an
    identity shortcut when the unit preserves shape."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self._shortcut = stride == 1 and in_channels == channels
        mid = in_channels * t
        with self.name_scope():
            self.body = nn.HybridSequential()
            _cba(self.body, mid, act="relu6")
            _cba(self.body, mid, kernel=3, stride=stride, pad=1, groups=mid,
                 act="relu6")
            _cba(self.body, channels, act=None)

    def hybrid_forward(self, F, x):
        out = self.body(x)
        return out + x if self._shortcut else out


# keep the reference zoo's class name for the v2 unit
LinearBottleneck = InvertedResidual


class MobileNet(HybridBlock):
    """v1: stem + a stack of depthwise-separable units from V1_SPEC."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        scale = lambda c: int(c * multiplier)  # noqa: E731
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            _cba(feats, scale(32), kernel=3, stride=2, pad=1)
            in_c = scale(32)
            for out_c, stride in V1_SPEC:
                # depthwise 3x3 on in_c channels, then pointwise to out_c
                _cba(feats, in_c, kernel=3, stride=stride, pad=1, groups=in_c)
                _cba(feats, scale(out_c))
                in_c = scale(out_c)
            feats.add(nn.GlobalAvgPool2D())
            feats.add(nn.Flatten())
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """v2: stem + inverted-residual groups from V2_SPEC + 1280-wide head
    with a 1x1-conv classifier."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        scale = lambda c: int(c * multiplier)  # noqa: E731
        with self.name_scope():
            feats = nn.HybridSequential(prefix="features_")
            with feats.name_scope():
                _cba(feats, scale(32), kernel=3, stride=2, pad=1, act="relu6")
                in_c = scale(32)
                for t, out_c, stride, repeats in V2_SPEC:
                    for j in range(repeats):
                        feats.add(InvertedResidual(
                            in_c, scale(out_c), t, stride if j == 0 else 1))
                        in_c = scale(out_c)
                head = int(1280 * multiplier) if multiplier > 1.0 else 1280
                _cba(feats, head, act="relu6")
                feats.add(nn.GlobalAvgPool2D())
            self.features = feats
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                          prefix="pred_"),
                                nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _get(cls, multiplier, pretrained=False, ctx=None, root=None, **kwargs):
    net = cls(multiplier, **kwargs)
    if pretrained:
        from ..model_store import get_model_file

        base = "mobilenetv2_" if cls is MobileNetV2 else "mobilenet"
        net.load_parameters(
            get_model_file(f"{base}{multiplier}", root), ctx=ctx)
    return net


for _m, _tag in ((1.0, "1_0"), (0.75, "0_75"), (0.5, "0_5"), (0.25, "0_25")):
    for _cls, _name in ((MobileNet, f"mobilenet{_tag}"),
                        (MobileNetV2, f"mobilenet_v2_{_tag}")):
        _fn = partial(_get, _cls, _m)
        _fn.__name__ = _name
        _fn.__doc__ = f"{_cls.__name__} with width multiplier {_m}."
        globals()[_name] = _fn
