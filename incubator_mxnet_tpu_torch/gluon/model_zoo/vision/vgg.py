"""VGG 11/13/16/19 with optional BatchNorm (Simonyan & Zisserman
1409.1556; `incubator_mxnet_tpu/gluon/model_zoo/vision/vgg.py`): each
depth is a tuple of per-stage conv repeats over the fixed 64 -> 512
channel ladder, and the `_bn` variants come from the same table. NCHW.
"""
from functools import partial

from ...block import HybridBlock
from ... import nn

__all__ = ["VGG", "vgg_spec", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

_CHANNELS = (64, 128, 256, 512, 512)
# depth -> conv repeats per stage (stages always end in a stride-2 maxpool)
vgg_spec = {11: (1, 1, 2, 2, 2),
            13: (2, 2, 2, 2, 2),
            16: (2, 2, 3, 3, 3),
            19: (2, 2, 4, 4, 4)}


class VGG(HybridBlock):
    def __init__(self, layers, filters=_CHANNELS, classes=1000,
                 batch_norm=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("per-stage repeats and channels must align")
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            for repeats, ch in zip(layers, filters):
                for _ in range(repeats):
                    feats.add(nn.Conv2D(ch, kernel_size=3, padding=1))
                    if batch_norm:
                        feats.add(nn.BatchNorm())
                    feats.add(nn.Activation("relu"))
                feats.add(nn.MaxPool2D(strides=2))
            for _ in range(2):
                feats.add(nn.Dense(4096, activation="relu"))
                feats.add(nn.Dropout(rate=0.5))
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    net = VGG(vgg_spec[num_layers], **kwargs)
    if pretrained:
        from ..model_store import get_model_file

        bn = "_bn" if kwargs.get("batch_norm") else ""
        net.load_parameters(get_model_file(f"vgg{num_layers}{bn}", root),
                            ctx=ctx)
    return net


for _d in vgg_spec:
    for _bn in (False, True):
        _name = f"vgg{_d}_bn" if _bn else f"vgg{_d}"
        _fn = (partial(get_vgg, _d, batch_norm=True) if _bn
               else partial(get_vgg, _d))
        _fn.__name__ = _name
        _fn.__doc__ = f"VGG-{_d}{' with BatchNorm' if _bn else ''}."
        globals()[_name] = _fn
