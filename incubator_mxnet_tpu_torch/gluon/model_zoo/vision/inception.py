"""Inception V3 (Szegedy et al. 1512.00567;
`incubator_mxnet_tpu/gluon/model_zoo/vision/inception.py`): every block
is a list of branch specs in a small table language -- ("conv", ch,
kernel, stride, pad), ("avgpool",), ("maxpool",) and ("split", stem, b1,
b2) for the fanned-out 3x3 factorizations -- turned into blocks by one
function. NCHW, 299 x 299 input.
"""
from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _cbr(channels, kernel, stride=1, pad=0):
    """conv(no bias) -> BN(eps 1e-3) -> relu, the basic inception unit."""
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                      padding=pad, use_bias=False))
    seq.add(nn.BatchNorm(epsilon=0.001))
    seq.add(nn.Activation("relu"))
    return seq


def _build_branch(spec):
    seq = nn.HybridSequential(prefix="")
    for step in spec:
        kind = step[0]
        if kind == "conv":
            _, ch, k, s, p = step
            seq.add(_cbr(ch, k, s, p))
        elif kind == "avgpool":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif kind == "maxpool":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        else:
            raise ValueError(step)
    return seq


class _Fanout(HybridBlock):
    """('split', stem, b1, b2): stem -> concat(b1(stem), b2(stem))."""

    def __init__(self, stem, b1, b2, **kwargs):
        super().__init__(**kwargs)
        self.stem = _build_branch(stem)
        self.b1 = _build_branch(b1)
        self.b2 = _build_branch(b2)

    def hybrid_forward(self, F, x):
        h = self.stem(x)
        return F.Concat(self.b1(h), self.b2(h), dim=1)


class _Tower(HybridBlock):
    """Parallel branches concatenated on channels."""

    def __init__(self, branch_specs, **kwargs):
        super().__init__(**kwargs)
        for spec in branch_specs:
            if spec and spec[0][0] == "split":
                self.register_child(_Fanout(*spec[0][1:]))
            else:
                self.register_child(_build_branch(spec))

    def hybrid_forward(self, F, x):
        return F.Concat(*[b(x) for b in self._modules.values()], dim=1)


def _conv(ch, k, s=1, p=0):
    return ("conv", ch, k, s, p)


def _block_a(pool_ch):
    return [
        [_conv(64, 1)],
        [_conv(48, 1), _conv(64, 5, 1, 2)],
        [_conv(64, 1), _conv(96, 3, 1, 1), _conv(96, 3, 1, 1)],
        [("avgpool",), _conv(pool_ch, 1)],
    ]


def _block_c(c7):
    return [
        [_conv(192, 1)],
        [_conv(c7, 1), _conv(c7, (1, 7), 1, (0, 3)),
         _conv(192, (7, 1), 1, (3, 0))],
        [_conv(c7, 1), _conv(c7, (7, 1), 1, (3, 0)),
         _conv(c7, (1, 7), 1, (0, 3)), _conv(c7, (7, 1), 1, (3, 0)),
         _conv(192, (1, 7), 1, (0, 3))],
        [("avgpool",), _conv(192, 1)],
    ]


def _block_e():
    split1 = ("split", [_conv(384, 1)],
              [_conv(384, (1, 3), 1, (0, 1))], [_conv(384, (3, 1), 1, (1, 0))])
    split2 = ("split", [_conv(448, 1), _conv(384, 3, 1, 1)],
              [_conv(384, (1, 3), 1, (0, 1))], [_conv(384, (3, 1), 1, (1, 0))])
    return [
        [_conv(320, 1)],
        [split1],
        [split2],
        [("avgpool",), _conv(192, 1)],
    ]


_REDUCE_B = [
    [_conv(384, 3, 2)],
    [_conv(64, 1), _conv(96, 3, 1, 1), _conv(96, 3, 2)],
    [("maxpool",)],
]

_REDUCE_D = [
    [_conv(192, 1), _conv(320, 3, 2)],
    [_conv(192, 1), _conv(192, (1, 7), 1, (0, 3)),
     _conv(192, (7, 1), 1, (3, 0)), _conv(192, 3, 2)],
    [("maxpool",)],
]


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        towers = ([_block_a(32), _block_a(64), _block_a(64), _REDUCE_B]
                  + [_block_c(c) for c in (128, 160, 160, 192)]
                  + [_REDUCE_D, _block_e(), _block_e()])
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            feats.add(_cbr(32, 3, 2))
            feats.add(_cbr(32, 3))
            feats.add(_cbr(64, 3, 1, 1))
            feats.add(nn.MaxPool2D(pool_size=3, strides=2))
            feats.add(_cbr(80, 1))
            feats.add(_cbr(192, 3))
            feats.add(nn.MaxPool2D(pool_size=3, strides=2))
            for i, specs in enumerate(towers):
                feats.add(_Tower(specs, prefix=f"tower{i}_"))
            feats.add(nn.AvgPool2D(pool_size=8))
            feats.add(nn.Dropout(0.5))
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import get_model_file

        net.load_parameters(get_model_file("inceptionv3", root), ctx=ctx)
    return net
