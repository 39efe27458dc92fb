"""Gluon convolution and pooling layers
(`incubator_mxnet_tpu/gluon/nn/conv_layers.py`): the 2-D ones ResNet
needs. Weights are (O, I/groups, kh, kw) in both layouts."""
from __future__ import annotations

from ... import initializer as init_mod
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class Conv2D(HybridBlock):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._kernel = _tup(kernel_size, 2)
        self._strides = _tup(strides, 2)
        self._padding = _tup(padding, 2)
        self._dilation = _tup(dilation, 2)
        self._groups = groups
        self._act_type = activation
        self._layout = layout
        self._channels_last = layout == "NHWC"
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"layout {layout!r} is not NCHW or NHWC")
        with self.name_scope():
            wshape = ((channels, in_channels // groups if in_channels else 0)
                      + self._kernel)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=init_mod.Zero())
            else:
                self.bias = None

    def _pre_forward(self, x, *args):
        if not self.weight._shape_known():
            in_c = x.shape[-1] if self._channels_last else x.shape[1]
            self.weight.shape = ((self._channels, in_c // self._groups)
                                 + self._kernel)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(
            x, weight, bias, kernel=self._kernel, stride=self._strides,
            dilate=self._dilation, pad=self._padding,
            num_filter=self._channels, num_group=self._groups,
            no_bias=bias is None,
            layout=self._layout if self._channels_last else None)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return f"Conv2D({self._channels}, kernel_size={self._kernel})"


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "count_include_pad": count_include_pad,
        }
        if layout and layout.endswith("C"):
            self._kwargs["layout"] = layout

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(size={self._kwargs['kernel']})"


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2), strides, _tup(padding, 2),
                         ceil_mode, False, "max", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", layout,
                         **kwargs)
