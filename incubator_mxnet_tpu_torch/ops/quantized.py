"""INT8 quantized operators (`incubator_mxnet_tpu/ops/quantized.py`; ref:
src/operator/quantization/ - quantized_conv.cu,
quantized_fully_connected.cc, quantized_pooling.cc).

Symmetric per-tensor scales with no zero-points, the reference's int8
scheme; the ops are inference-only (no gradients).

The int8 products accumulate in int32 and are exact: bit-equal on the
card, on the CPU and in the JAX package. A convolution is an im2col of
the int8 input (a strided view of the zero-padded input, copied
contiguous: `unfold` refuses int8) times the (O, C * k) int8 weights:
on a CUDA tensor through `torch._int_mm` (cuBLASLt's int8 GEMM with
int32 out; k and n padded with zeros to multiples of 8 and the rows to
more than 16, which adds nothing to the sums), on a CPU tensor through
an int32 `torch.matmul`. No float type carries the sums (float32 is
exact only while 127^2 * K < 2^24, K <= 1040, and ResNet-50 reaches
K 4608). A grouped convolution runs one product per group; a depthwise
one (one input channel per group) is a sum of k x k shifted int32
products. `INT_MM_CALLS` counts the `_int_mm` calls.

Pooling works on strided window views: max pools pad with int8-min
(the 'full' convention's extra high padding included), avg pools sum in
int32 and divide by the window size as a 0-dim tensor (a CUDA tensor
divided by a Python number is multiplied by its reciprocal, which can
move a .5 tie) before rounding half to even. Every other division by a
number goes through a tensor for the same reason.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as tF

from .nn import _tup
from .registry import register
from .vision import _div

__all__ = ["quantized_conv", "quantized_fully_connected",
           "quantized_pooling", "INT_MM_CALLS"]

# torch._int_mm calls made (the card's int8 GEMMs), for chip_smoke
INT_MM_CALLS = 0


def _rdiv(a, b):
    """a / b for a Python number a and a tensor b (`a / b` would be
    b's reciprocal times a)."""
    return torch.full_like(b, a) / b


def _ceil8(n):
    return -(-n // 8) * 8


def int_matmul(a, w):
    """a (M, K) int8 times w (N, K) int8 transposed -> (M, N) int32,
    exact."""
    M, K = a.shape
    N = w.shape[0]
    if a.is_cuda:
        global INT_MM_CALLS
        kp, np_, mp = _ceil8(K), _ceil8(N), max(M, 17)
        a = tF.pad(a, (0, kp - K, 0, mp - M)) if (kp, mp) != (K, M) else a
        w = tF.pad(w, (0, kp - K, 0, np_ - N)) if (kp, np_) != (K, N) \
            else w
        out = torch._int_mm(a.contiguous(), w.contiguous().t())
        INT_MM_CALLS += 1
        return out[:M, :N]
    if a.device.type != "cpu":
        raise ValueError(f"int_matmul: no int8 product for device "
                         f"{a.device}")
    return torch.matmul(a.to(torch.int32), w.to(torch.int32).t())


def _pad_widths(pads):
    """tF.pad's widths (last dim first) of per-spatial-dim (lo, hi)."""
    widths = []
    for lo, hi in reversed(pads):
        widths += [lo, hi]
    return widths


def _windows(x, k, s, d=None):
    """(N, C, *out, *k) windows of an (N, C, *spatial) tensor, a view."""
    nd = len(k)
    d = d or (1,) * nd
    for i in range(nd):
        x = x.unfold(2 + i, (k[i] - 1) * d[i] + 1, s[i])
    if any(di > 1 for di in d):
        x = x[(Ellipsis,) + tuple(slice(None, None, di) for di in d)]
    return x


def _depthwise(x, w, k, s, d, out_sp):
    """Sum of k-offset shifted int32 products of an (N, C, *sp) padded
    input with (O, 1, *k) weights, O a multiple of C."""
    nd = len(k)
    mult = w.shape[0] // x.shape[1]
    xi = x.to(torch.int32)
    if mult > 1:
        xi = xi.repeat_interleave(mult, 1)
    wi = w.to(torch.int32).reshape(w.shape[0], *k)
    acc = None
    for off in itertools.product(*[range(ki) for ki in k]):
        idx = tuple(slice(o * di, o * di + (n - 1) * si + 1, si)
                    for o, di, n, si in zip(off, d, out_sp, s))
        term = xi[(slice(None), slice(None)) + idx] * \
            wi[(slice(None),) + tuple(off)].reshape((1, -1) + (1,) * nd)
        acc = term if acc is None else acc + term
    return acc


@register("_contrib_quantized_conv", optional=("bias",),
          no_grad_inputs=("data", "weight", "bias"))
def quantized_conv(data, weight, bias=None, *, kernel=None, stride=None,
                   dilate=None, pad=None, num_filter=None, num_group=1,
                   no_bias=True, layout=None):
    """int8 NC* convolution with exact int32 accumulation (ref:
    quantized_conv.cu). `bias`, when given, must already be int32 in the
    product scale (s_data * s_weight)."""
    nd = data.dim() - 2
    k = tuple(weight.shape[2:])
    s, d = _tup(stride, nd), _tup(dilate, nd)
    p = _tup(pad, nd) if pad is not None else (0,) * nd
    x = data.to(torch.int8)
    w = weight.to(torch.int8)
    if any(p):
        x = tF.pad(x, _pad_widths([(pi, pi) for pi in p]))
    N, C = x.shape[:2]
    out_sp = tuple((x.shape[2 + i] - (k[i] - 1) * d[i] - 1) // s[i] + 1
                   for i in range(nd))
    G = int(num_group)
    O = w.shape[0]
    if G > 1 and C == G:
        out = _depthwise(x, w, k, s, d, out_sp)
    else:
        win = _windows(x, k, s, d)  # (N, C, *out, *k)
        cols = win.permute(0, *range(2, 2 + nd), 1,
                           *range(2 + nd, 2 + 2 * nd))
        a = cols.reshape(N * math.prod(out_sp), C * math.prod(k))
        wm = w.reshape(O, -1)
        if G == 1:
            acc = int_matmul(a, wm)
        else:
            kc, og = a.shape[1] // G, O // G
            acc = torch.cat([
                int_matmul(a[:, g * kc:(g + 1) * kc].contiguous(),
                           wm[g * og:(g + 1) * og]) for g in range(G)], 1)
        out = acc.reshape(N, *out_sp, O).permute(0, nd + 1,
                                                 *range(1, nd + 1))
    if bias is not None and not no_bias:
        out = out + bias.to(torch.int32).reshape((1, -1) + (1,) * nd)
    return out


@register("_contrib_quantized_fully_connected", optional=("bias",),
          no_grad_inputs=("data", "weight", "bias"))
def quantized_fully_connected(data, weight, bias=None, *, num_hidden=None,
                              no_bias=True, flatten=True):
    """int8 y = x W^T (+ b) with exact int32 accumulation (ref:
    quantized_fully_connected.cc)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    lead = x.shape[:-1]
    y = int_matmul(x.reshape(-1, x.shape[-1]).to(torch.int8),
                   weight.to(torch.int8)).reshape(*lead, weight.shape[0])
    if bias is not None and not no_bias:
        y = y + bias.to(torch.int32)
    return y


@register("_contrib_quantized_pooling", no_grad_inputs=("data",))
def quantized_pooling(data, *, kernel=None, stride=None, pad=None,
                      pool_type="max", global_pool=False,
                      pooling_convention="valid"):
    """Pooling on int8 activations (ref: quantized_pooling.cc). Max pools
    stay int8 (the pad is int8-min, the 'full' convention's too, so the
    max is exact); avg pools accumulate in int32 and round back to int8
    (half to even, clipped to -128..127)."""
    nd = data.dim() - 2
    if global_pool:
        k = tuple(data.shape[2:])
        strides = (1,) * nd
        p = (0,) * nd
    else:
        k = _tup(kernel, nd)
        strides = _tup(stride, nd) if stride is not None else k
        p = _tup(pad, nd) if pad is not None else (0,) * nd
    pads = [(pi, pi) for pi in p]
    if pooling_convention == "full" and not global_pool:
        # ceil-mode (the same high-side padding rule as ops.nn.pooling)
        for i in range(nd):
            in_sz = data.shape[2 + i] + 2 * p[i]
            rem = (in_sz - k[i]) % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem != 0 else 0
            pads[i] = (p[i], p[i] + extra)
    widths = _pad_widths(pads)
    dims = tuple(range(-nd, 0))
    if pool_type == "max":
        x = tF.pad(data, widths, value=-128) if any(widths) else data
        return _windows(x, k, strides).amax(dim=dims)
    x = data.to(torch.int32)
    if any(widths):
        x = tF.pad(x, widths)
    acc = _windows(x, k, strides).sum(dim=dims, dtype=torch.int32)
    return torch.clamp(torch.round(_div(acc.float(), math.prod(k))),
                       -128, 127).to(torch.int8)


# -- quantize / dequantize wire ops (ref: quantization/quantize.cc,
# quantize_v2.cc, dequantize.cc, requantize.cc, quantized_concat.cc,
# quantized_flatten.cc) -----------------------------------------------------

def _amax(lo, hi):
    return torch.maximum(torch.abs(lo), torch.abs(hi))


def _q_range(min_r, max_r):
    """Symmetric scale for int8 from a calibration range."""
    amax = _amax(min_r, max_r)
    return torch.where(amax > 0, _rdiv(127.0, amax), torch.ones_like(amax))


def _to_int8(v):
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def _int8_target(op, out_type):
    if out_type not in ("int8", "auto"):
        raise NotImplementedError(
            f"{op} out_type='{out_type}': int8 is the implemented target "
            f"(uint8 is not)")


def _calib(data, lo, hi):
    """The range (lo, hi) from calibration attrs, else from `data`."""
    if lo is not None and hi is not None:
        return (torch.tensor(lo, dtype=torch.float32, device=data.device),
                torch.tensor(hi, dtype=torch.float32, device=data.device))
    return data.min(), data.max()


@register("_contrib_quantize", num_outputs=3,
          no_grad_inputs=("data", "min_range", "max_range"))
def _contrib_quantize(data, min_range, max_range, *, out_type="int8"):
    """float32 -> int8 with explicit calibration range tensors; returns
    (q, min, max) like the reference."""
    _int8_target("quantize", out_type)
    q = _to_int8(data * _q_range(min_range, max_range))
    amax = _amax(min_range, max_range)
    return q, -amax, amax


@register("_contrib_quantize_v2", num_outputs=3, no_grad_inputs=("data",))
def _contrib_quantize_v2(data, *, out_type="int8", min_calib_range=None,
                         max_calib_range=None):
    """The range from the attrs when calibrated, else from the data (ref:
    quantize_v2.cc)."""
    _int8_target("quantize_v2", out_type)
    lo, hi = _calib(data, min_calib_range, max_calib_range)
    q = _to_int8(data * _q_range(lo, hi))
    amax = _amax(lo, hi)
    return q, -amax, amax


@register("_contrib_dequantize",
          no_grad_inputs=("data", "min_range", "max_range"))
def _contrib_dequantize(data, min_range, max_range, *, out_type="float32"):
    """int8 values back to float32 by the recorded (min, max) range."""
    if out_type != "float32":
        raise NotImplementedError(
            f"dequantize out_type='{out_type}': only float32 reconstruction "
            f"is implemented")
    return data.to(torch.float32) / _q_range(min_range, max_range)


@register("_contrib_requantize", num_outputs=3,
          no_grad_inputs=("data", "min_range", "max_range"))
def _contrib_requantize(data, min_range, max_range, *, min_calib_range=None,
                        max_calib_range=None, out_type="int8"):
    """int32 accumulator -> int8 (ref: requantize.cc). The int32 range
    tensors are the real values of the accumulator's int32 extremes, so
    the reconstruction scale is amax / (2^31 - 1)."""
    _int8_target("requantize", out_type)
    real = data.to(torch.float32) * _div(_amax(min_range, max_range),
                                         2147483647.0)
    lo, hi = _calib(real, min_calib_range, max_calib_range)
    q = _to_int8(real * _q_range(lo, hi))
    amax = _amax(lo, hi)
    return q, -amax, amax


@register("_contrib_quantized_flatten", num_outputs=3,
          no_grad_inputs=("data", "min_range", "max_range"))
def _contrib_quantized_flatten(data, min_range, max_range):
    """Flatten quantized data; its (min, max) range passes unchanged."""
    return data.reshape(data.shape[0], -1), min_range, max_range


@register("_contrib_quantized_concat", num_outputs=3)
def _contrib_quantized_concat(*args, num_args=None, dim=1):
    """Concat n int8 tensors whose ranges may differ: requantize each onto
    the merged range, then concat (ref: quantized_concat.cc). Inputs are
    (data_0..n-1, min_0..n-1, max_0..n-1)."""
    n = int(num_args) if num_args else len(args) // 3
    datas, mins, maxs = args[:n], args[n:2 * n], args[2 * n:3 * n]
    amaxs = [_amax(lo, hi) for lo, hi in zip(mins, maxs)]
    merged = amaxs[0]
    for a in amaxs[1:]:
        merged = torch.maximum(merged, a)
    scaled = [_to_int8(d.to(torch.float32) * (a / merged))
              for d, a in zip(datas, amaxs)]
    return torch.cat(scaled, dim=int(dim)), -merged, merged
