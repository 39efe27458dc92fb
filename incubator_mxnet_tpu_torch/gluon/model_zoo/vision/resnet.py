"""ResNet v1/v2 (`incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py`),
depths 18-152, NCHW or NHWC.

He et al. (1512.03385, post-activation v1; 1603.05027, pre-activation
v2). One residual unit driven by a declarative conv plan, one ResNet
class for both orderings; the same parameter names as the JAX package.

The BN -> ReLU pairs and the v1 residual join go through
`ops.epilogue.bn_act`, which runs them unfused unless
`MXTPU_FUSED_EPILOGUE` is on and the net is channels-last. In a
downsampling v1 unit the join folds the projection's BN and takes the
main branch's BN output as the residual, as the JAX rewrite does (its
`note_add` checks the add's operands in the order `skip + h`).
Pretrained weights are not ported.
"""
from __future__ import annotations

from functools import partial

from ....ops import epilogue
from ... import nn
from ...block import HybridBlock

__all__ = ["ResNet", "ResidualUnit", "get_resnet", "resnet_spec",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


# depth -> (bottleneck?, units per stage, channels per stage)
resnet_spec = {
    18: (False, (2, 2, 2, 2), (64, 64, 128, 256, 512)),
    34: (False, (3, 4, 6, 3), (64, 64, 128, 256, 512)),
    50: (True, (3, 4, 6, 3), (64, 256, 512, 1024, 2048)),
    101: (True, (3, 4, 23, 3), (64, 256, 512, 1024, 2048)),
    152: (True, (3, 8, 36, 3), (64, 256, 512, 1024, 2048)),
}


def _conv_plan(channels, stride, bottleneck, version):
    """(out_channels, kernel, stride, padding, use_bias) per conv of one
    unit: v1 bottlenecks stride on the first 1x1 and put a bias on both
    1x1 convs, v2 bottlenecks stride on the 3x3."""
    if not bottleneck:
        return ((channels, 3, stride, 1, False),
                (channels, 3, 1, 1, False))
    mid = channels // 4
    if version == 1:
        return ((mid, 1, stride, 0, True),
                (mid, 3, 1, 1, False),
                (channels, 1, 1, 0, True))
    return ((mid, 1, 1, 0, False),
            (mid, 3, stride, 1, False),
            (channels, 1, 1, 0, False))


class ResidualUnit(HybridBlock):
    """One residual unit, v1 or v2 ordering.

    v1 (post-activation):  out = relu(x + bn(conv(...relu(bn(conv(x))))))
                           identity branch: 1x1-conv + BN when downsampling
    v2 (pre-activation):   h = relu(bn(x)); out = x' + conv(...relu(bn(conv(h))))
                           identity branch: 1x1-conv of h, no BN
    """

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 version=1, bottleneck=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._version = version
        bn_axis = -1 if layout == "NHWC" else 1
        plan = _conv_plan(channels, stride, bottleneck, version)
        # v1: norms[i] FOLLOWS convs[i]; v2: norms[i] PRECEDES convs[i]
        self.convs = nn.HybridSequential(prefix="")
        self.norms = nn.HybridSequential(prefix="")
        for c, k, s, p, bias in plan:
            self.convs.add(nn.Conv2D(c, kernel_size=k, strides=s, padding=p,
                                     use_bias=bias, layout=layout))
            self.norms.add(nn.BatchNorm(axis=bn_axis))
        if not downsample:
            self.proj = None
            self.proj_norm = None
        else:
            self.proj = nn.Conv2D(channels, kernel_size=1, strides=stride,
                                  use_bias=False, in_channels=in_channels,
                                  layout=layout)
            self.proj_norm = (nn.BatchNorm(axis=bn_axis) if version == 1
                              else None)

    def hybrid_forward(self, F, x):
        convs, norms = list(self.convs), list(self.norms)
        if self._version == 1:
            h = x
            for conv, norm in zip(convs[:-1], norms[:-1]):
                h = epilogue.bn_act(norm, conv(h))
            if self.proj is None:
                return epilogue.bn_act(norms[-1], convs[-1](h), residual=x)
            h = norms[-1](convs[-1](h))
            return epilogue.bn_act(self.proj_norm, self.proj(x), residual=h)
        # v2: BN + relu precede each conv; the first pre-activation also
        # feeds the projection shortcut
        h = x
        skip = x
        for i, conv in enumerate(convs):
            h = epilogue.bn_act(norms[i], h)
            if i == 0 and self.proj is not None:
                skip = self.proj(h)
            h = conv(h)
        return skip + h


class ResNet(HybridBlock):
    """Stage-configured ResNet for both orderings. `thumbnail=True` swaps
    the 7x7 / max-pool ImageNet stem for one 3x3 (the CIFAR stem)."""

    def __init__(self, version, layers, channels, bottleneck, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert version in (1, 2)
        assert layout in ("NCHW", "NHWC")
        bn_axis = -1 if layout == "NHWC" else 1
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            if version == 2:
                feats.add(nn.BatchNorm(scale=False, center=False,
                                       axis=bn_axis))
            if thumbnail:
                feats.add(nn.Conv2D(channels[0], kernel_size=3, strides=1,
                                    padding=1, use_bias=False, layout=layout))
            else:
                feats.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                    layout=layout))
                feats.add(nn.BatchNorm(axis=bn_axis))
                feats.add(nn.Activation("relu"))
                feats.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            in_c = channels[0]
            for i, n_units in enumerate(layers):
                stage = nn.HybridSequential(prefix=f"stage{i + 1}_")
                with stage.name_scope():
                    for j in range(n_units):
                        stride = 2 if (j == 0 and i > 0) else 1
                        stage.add(ResidualUnit(
                            channels[i + 1], stride,
                            downsample=(j == 0 and channels[i + 1] != in_c),
                            in_channels=in_c, version=version,
                            bottleneck=bottleneck, layout=layout, prefix=""))
                        in_c = channels[i + 1]
                feats.add(stage)
            if version == 2:
                feats.add(nn.BatchNorm(axis=bn_axis))
                feats.add(nn.Activation("relu"))
            feats.add(nn.GlobalAvgPool2D(layout=layout))
            feats.add(nn.Flatten())
            self.features = feats
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet of `version` (1 or 2) and depth `num_layers`."""
    if num_layers not in resnet_spec:
        raise ValueError(
            f"unsupported depth {num_layers}; pick from {sorted(resnet_spec)}")
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported")
    bottleneck, layers, channels = resnet_spec[num_layers]
    return ResNet(version, layers, channels, bottleneck, **kwargs)


def _register_factories():
    for depth in resnet_spec:
        for version in (1, 2):
            name = f"resnet{depth}_v{version}"
            fn = partial(get_resnet, version, depth)
            fn.__name__ = name
            fn.__doc__ = f"ResNet-{depth} v{version} (see get_resnet)."
            globals()[name] = fn


_register_factories()
