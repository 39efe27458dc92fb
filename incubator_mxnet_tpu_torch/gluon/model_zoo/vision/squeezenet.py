"""SqueezeNet 1.0/1.1 (Iandola et al. 1602.07360;
`incubator_mxnet_tpu/gluon/model_zoo/vision/squeezenet.py`): each
version is a flat plan of fire-module squeeze widths and pool markers;
the fire module is one block (squeeze 1x1 -> parallel 1x1 / 3x3
expands, concatenated). NCHW.
"""
from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]

# plans: "P" = 3x3/2 ceil maxpool; int s = fire module with squeeze width s
# (expands are always 4s + 4s, per the paper's table)
_PLANS = {
    "1.0": (96, 7, 2, ["P", 16, 16, 32, "P", 32, 48, 48, 64, "P", 64]),
    "1.1": (64, 3, 2, ["P", 16, 16, "P", 32, 32, "P", 48, 48, 64, 64]),
}


class Fire(HybridBlock):
    """squeeze 1x1 -> concat(expand 1x1, expand 3x3), all relu."""

    def __init__(self, squeeze, **kwargs):
        super().__init__(**kwargs)
        expand = 4 * squeeze
        with self.name_scope():
            self.squeeze = nn.Conv2D(squeeze, 1, activation="relu")
            self.left = nn.Conv2D(expand, 1)
            self.right = nn.Conv2D(expand, 3, padding=1)

    def hybrid_forward(self, F, x):
        s = self.squeeze(x)
        return F.Concat(F.Activation(self.left(s), act_type="relu"),
                        F.Activation(self.right(s), act_type="relu"), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _PLANS:
            raise ValueError(f"version must be one of {sorted(_PLANS)}")
        stem_ch, stem_k, stem_s, plan = _PLANS[version]
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            feats.add(nn.Conv2D(stem_ch, kernel_size=stem_k, strides=stem_s,
                                activation="relu"))
            for item in plan:
                if item == "P":
                    feats.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
                else:
                    feats.add(Fire(item))
            feats.add(nn.Dropout(0.5))
            self.features = feats
            head = nn.HybridSequential(prefix="")
            head.add(nn.Conv2D(classes, kernel_size=1))
            head.add(nn.Activation("relu"))
            head.add(nn.GlobalAvgPool2D())
            head.add(nn.Flatten())
            self.output = head

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _get(version, pretrained=False, ctx=None, root=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        from ..model_store import get_model_file

        net.load_parameters(get_model_file(f"squeezenet{version}", root),
                            ctx=ctx)
    return net


def squeezenet1_0(**kwargs):
    return _get("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return _get("1.1", **kwargs)
