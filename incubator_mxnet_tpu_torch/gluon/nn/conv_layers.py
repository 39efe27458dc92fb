"""Gluon convolution and pooling layers
(`incubator_mxnet_tpu/gluon/nn/conv_layers.py`): 1-, 2- and 3-D
convolutions and transposed convolutions, and max / average / global
pooling. Weights are (O, I/groups, *kernel) in every layout, and
(I, O/groups, *kernel) for the transposed convolutions, which take the
NC* layouts only."""
from __future__ import annotations

from ... import initializer as init_mod
from ..block import HybridBlock

__all__ = [
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
    "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
    "GlobalAvgPool3D",
]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", ndim=2,
                 transpose=False, output_padding=0, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _tup(kernel_size, ndim)
        self._strides = _tup(strides, ndim)
        self._padding = _tup(padding, ndim)
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self._act_type = activation
        self._use_bias = use_bias
        self._ndim = ndim
        self._transpose = transpose
        self._output_padding = _tup(output_padding, ndim)
        self._layout = layout
        self._channels_last = bool(layout) and layout.endswith("C")
        if self._channels_last and transpose:
            raise ValueError(
                "channels-last layouts are not supported for transposed "
                "convolutions yet; use the default NC* layout")
        with self.name_scope():
            if transpose:
                wshape = (in_channels, channels // groups) + self._kernel
            else:
                wshape = ((channels, in_channels // groups if in_channels
                           else 0) + self._kernel)
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
            if self._transpose:
                self.weight.shape = ((in_c, self._channels // self._groups)
                                     + self._kernel)
            else:
                self.weight.shape = ((self._channels, in_c // self._groups)
                                     + self._kernel)

    def hybrid_forward(self, F, x, weight, bias=None):
        if self._transpose:
            out = F.Deconvolution(
                x, weight, bias, kernel=self._kernel, stride=self._strides,
                pad=self._padding, adj=self._output_padding,
                num_filter=self._channels, num_group=self._groups,
                no_bias=bias is None)
        else:
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
        return (f"{type(self).__name__}({self._channels}, "
                f"kernel_size={self._kernel})")


def _conv(name, ndim, transpose, layout):
    one, zero = (1,) * ndim, (0,) * ndim

    def __init__(self, channels, kernel_size, strides=one, padding=zero,
                 *args, output_padding=zero, dilation=one, groups=1,
                 layout=layout, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if args:  # the reference's positional order after padding
            names = (("output_padding",) if transpose else ()) + (
                "dilation", "groups", "layout", "activation", "use_bias")
            vals = dict(zip(names, args))
            output_padding = vals.get("output_padding", output_padding)
            dilation = vals.get("dilation", dilation)
            groups = vals.get("groups", groups)
            layout = vals.get("layout", layout)
            activation = vals.get("activation", activation)
            use_bias = vals.get("use_bias", use_bias)
        _Conv.__init__(self, channels, kernel_size, strides, padding,
                       dilation, groups, layout, in_channels, activation,
                       use_bias, weight_initializer, bias_initializer,
                       ndim=ndim, transpose=transpose,
                       output_padding=output_padding, **kwargs)

    return type(name, (_Conv,), {"__init__": __init__})


Conv1D = _conv("Conv1D", 1, False, "NCW")
Conv2D = _conv("Conv2D", 2, False, "NCHW")
Conv3D = _conv("Conv3D", 3, False, "NCDHW")
Conv1DTranspose = _conv("Conv1DTranspose", 1, True, "NCW")
Conv2DTranspose = _conv("Conv2DTranspose", 2, True, "NCHW")
Conv3DTranspose = _conv("Conv3DTranspose", 3, True, "NCDHW")


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


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _pool(name, ndim, pool_type, global_pool):
    layout0 = _LAYOUTS[ndim]
    if global_pool:
        def __init__(self, layout=layout0, **kwargs):
            _Pooling.__init__(self, (1,) * ndim, None, (0,) * ndim, False,
                              True, pool_type, layout, **kwargs)
    elif pool_type == "max":
        def __init__(self, pool_size=(2,) * ndim, strides=None, padding=0,
                     layout=layout0, ceil_mode=False, **kwargs):
            _Pooling.__init__(self, _tup(pool_size, ndim), strides,
                              _tup(padding, ndim), ceil_mode, False, "max",
                              layout, **kwargs)
    else:
        def __init__(self, pool_size=(2,) * ndim, strides=None, padding=0,
                     layout=layout0, ceil_mode=False, count_include_pad=True,
                     **kwargs):
            _Pooling.__init__(self, _tup(pool_size, ndim), strides,
                              _tup(padding, ndim), ceil_mode, False, "avg",
                              layout, count_include_pad, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__})


for _n in (1, 2, 3):
    for _kind, _type, _global in (("MaxPool", "max", False),
                                  ("AvgPool", "avg", False),
                                  ("GlobalMaxPool", "max", True),
                                  ("GlobalAvgPool", "avg", True)):
        globals()[f"{_kind}{_n}D"] = _pool(f"{_kind}{_n}D", _n, _type,
                                           _global)
del _n, _kind, _type, _global
