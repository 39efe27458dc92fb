"""AlexNet (Krizhevsky et al. 2012;
`incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py`): a flat layer
table, NCHW."""
from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]

# (channels, kernel, stride, padding, pool-after?)
_CONV_PLAN = ((64, 11, 4, 2, True),
              (192, 5, 1, 2, True),
              (384, 3, 1, 1, False),
              (256, 3, 1, 1, False),
              (256, 3, 1, 1, True))


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            for ch, k, s, p, pool in _CONV_PLAN:
                feats.add(nn.Conv2D(ch, kernel_size=k, strides=s, padding=p,
                                    activation="relu"))
                if pool:
                    feats.add(nn.MaxPool2D(pool_size=3, strides=2))
            feats.add(nn.Flatten())
            for _ in range(2):  # the two 4096-wide dropout-regularized FCs
                feats.add(nn.Dense(4096, activation="relu"))
                feats.add(nn.Dropout(0.5))
            self.features = feats
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import get_model_file

        net.load_parameters(get_model_file("alexnet", root), ctx=ctx)
    return net
