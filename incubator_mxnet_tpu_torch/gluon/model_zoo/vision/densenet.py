"""DenseNet 121/161/169/201 (Huang et al. 1608.06993;
`incubator_mxnet_tpu/gluon/model_zoo/vision/densenet.py`): three
repetitions of one BN -> relu -> conv motif (the bottleneck pair inside
a dense layer, the 1x1 of a transition, the head) plus the channel
arithmetic. NCHW.
"""
from functools import partial

from ...block import HybridBlock
from ... import nn

__all__ = ["DenseNet", "densenet_spec", "densenet121", "densenet161",
           "densenet169", "densenet201"]

# depth -> (stem channels, growth rate, layers per dense block)
densenet_spec = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
}


def _bn_relu_conv(seq, channels, kernel, padding=0):
    """The DenseNet motif: pre-activation conv appended to `seq`."""
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu"))
    seq.add(nn.Conv2D(channels, kernel_size=kernel, padding=padding,
                      use_bias=False))


class _DenseLayer(HybridBlock):
    """Bottleneck (1x1 to bn_size*k, then 3x3 to k) whose output is
    concatenated onto its input along channels."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        _bn_relu_conv(self.body, bn_size * growth_rate, kernel=1)
        _bn_relu_conv(self.body, growth_rate, kernel=3, padding=1)
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.Concat(x, self.body(x), dim=1)


class DenseNet(HybridBlock):
    """Stem -> [dense block -> halving transition]* -> head."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            feats.add(nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                                padding=3, use_bias=False))
            feats.add(nn.BatchNorm())
            feats.add(nn.Activation("relu"))
            feats.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            channels = num_init_features
            for i, n_layers in enumerate(block_config):
                block = nn.HybridSequential(prefix=f"stage{i + 1}_")
                with block.name_scope():
                    for _ in range(n_layers):
                        block.add(_DenseLayer(growth_rate, bn_size, dropout))
                feats.add(block)
                channels += n_layers * growth_rate
                if i + 1 < len(block_config):
                    channels //= 2  # transition halves the channel count
                    _bn_relu_conv(feats, channels, kernel=1)
                    feats.add(nn.AvgPool2D(pool_size=2, strides=2))
            feats.add(nn.BatchNorm())
            feats.add(nn.Activation("relu"))
            feats.add(nn.AvgPool2D(pool_size=7))
            feats.add(nn.Flatten())
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _get_densenet(depth, pretrained=False, ctx=None, root=None, **kwargs):
    stem, growth, blocks = densenet_spec[depth]
    net = DenseNet(stem, growth, blocks, **kwargs)
    if pretrained:
        from ..model_store import get_model_file

        net.load_parameters(get_model_file(f"densenet{depth}", root), ctx=ctx)
    return net


for _d in densenet_spec:
    _fn = partial(_get_densenet, _d)
    _fn.__name__ = f"densenet{_d}"
    _fn.__doc__ = f"DenseNet-{_d} (see densenet_spec)."
    globals()[f"densenet{_d}"] = _fn
