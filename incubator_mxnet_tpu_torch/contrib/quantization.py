"""INT8 quantization (`incubator_mxnet_tpu/contrib/quantization.py`; ref:
src/operator/quantization/ and python/mxnet/contrib/quantization.py:422
quantize_model).

`quantize` / `dequantize` / `requantize` are the NDArray-level wire
functions, `calib_minmax` and `calib_entropy` (KL-divergence thresholds,
host numpy) calibrate one output, `quantize_model` quantizes a params
dict. `quantize_net` turns a float32 gluon chain into a `QuantizedNet`:
BatchNorm folded into the convolutions, activation ranges calibrated
(minmax, or an entropy sweep over histograms), weights quantized per
output channel on the host in numpy, and an int8 program whose
convolutions and dense layers run `ops.quantized`'s exact int32
products. The program runs eagerly on the net's device (the JAX
package jits it).

The calibrated ranges are kept on the program (`QuantizedNet.ranges`):
`quantize_net_from_ranges` emits the same program for another copy of
the chain (another device) from them, with the same int8 weights and
scales bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..ops import nn as nnops
from ..ops import quantized as qops

__all__ = ["quantize", "dequantize", "requantize", "calib_minmax",
           "calib_entropy", "quantize_model", "quantize_net",
           "quantize_net_from_ranges", "QuantizedNet", "as_chain"]


def _tensor(x):
    """The tensor of an NDArray or tensor; an array-like lands on the
    default context's device."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x),
                           device=current_context().torch_device())


def _scalar(v, like):
    return NDArray._from_data(torch.tensor(v, dtype=torch.float32,
                                           device=like.device))


def _to_int8(v):
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quantize(data, min_range=None, max_range=None, out_type="int8"):
    """(ref: quantize op) symmetric int8 quantization -> (q, min, max)."""
    d = _tensor(data)
    if min_range is None:
        min_range = float(d.min())
    if max_range is None:
        max_range = float(d.max())
    amax = max(abs(min_range), abs(max_range), 1e-8)
    q = _to_int8(d * (127.0 / amax))
    return NDArray._from_data(q), _scalar(-amax, d), _scalar(amax, d)


def dequantize(qdata, min_range, max_range, out_type="float32"):
    q = _tensor(qdata)
    amax = _tensor(max_range).to(q.device)
    return NDArray._from_data(q.to(torch.float32) * qops._div(amax, 127.0))


def requantize(qdata, min32, max32, min_calib=None, max_calib=None):
    """int32 accumulators -> int8 with a calibrated range (ref: requantize
    op)."""
    q = _tensor(qdata)
    in_amax = float(max32.asscalar() if isinstance(max32, NDArray)
                    else max32)
    out_amax = max_calib if max_calib is not None else in_amax
    scale = (in_amax / (2 ** 31 - 1)) * (127.0 / out_amax)
    out = _to_int8(q.to(torch.float32) * scale)
    return NDArray._from_data(out), _scalar(-out_amax, q), \
        _scalar(out_amax, q)


def _batch_data(batch):
    return batch.data[0] if hasattr(batch, "data") else batch[0]


def _host(out):
    return out.asnumpy() if isinstance(out, NDArray) else \
        (out.detach().cpu().numpy() if isinstance(out, torch.Tensor)
         else np.asarray(out))


def calib_minmax(net_or_fn, calib_iter, num_batches=10):
    """Per-output min / max over calibration batches (ref:
    quantization.py _collect_layer_statistics, minmax mode)."""
    mins, maxs = [], []
    for i, batch in enumerate(calib_iter):
        if i >= num_batches:
            break
        o = _host(net_or_fn(_batch_data(batch)))
        mins.append(float(o.min()))
        maxs.append(float(o.max()))
    return min(mins), max(maxs)


def quantize_model(sym=None, arg_params=None, aux_params=None, net=None,
                   calib_data=None, num_calib_batches=10,
                   quantized_dtype="int8", **kwargs):
    """Quantize a model's weights to int8 with per-tensor scales (ref:
    contrib/quantization.py:422). Returns (quantized params dict, scales
    dict); activations are quantized at op dispatch."""
    params = arg_params or {}
    qparams, scales = {}, {}
    for name, w in params.items():
        if name.endswith(("weight",)):
            q, mn, mx = quantize(w)
            qparams[name] = q
            scales[name] = (float(mn.asscalar()), float(mx.asscalar()))
        else:
            qparams[name] = w
    return qparams, scales


# -- entropy calibration: host numpy, as the JAX package's ------------------

def _kl_divergence(p, q):
    p = p / max(p.sum(), 1e-12)
    q = q / max(q.sum(), 1e-12)
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask]
                                         / np.maximum(q[mask], 1e-12))))


def calib_entropy(net_or_fn, calib_iter, num_batches=10, num_bins=2048,
                  num_quantized_bins=255):
    """KL-divergence (entropy) calibration: the clipping threshold whose
    quantized distribution best matches the float32 one (ref:
    quantization.py _get_optimal_threshold / _LayerHistogramCollector).
    Returns (-threshold, threshold)."""
    if num_bins <= num_quantized_bins // 2:
        raise ValueError(
            f"num_bins ({num_bins}) must exceed num_quantized_bins//2 "
            f"({num_quantized_bins // 2}) for the threshold sweep")
    num_bins += num_bins % 2  # the range-doubling rebin needs even bins
    # a streaming histogram of |activations| whose range doubles (2:1
    # rebinning) when a batch exceeds it: one pass over the iterator
    hist = np.zeros(num_bins, np.float64)
    hi_range = None
    n_seen = 0
    for i, batch in enumerate(calib_iter):
        if i >= num_batches:
            break
        o = np.abs(_host(net_or_fn(_batch_data(batch)))).reshape(-1)
        n_seen += o.size
        bmax = float(o.max()) if o.size else 0.0
        if hi_range is None:
            if bmax == 0.0:
                # an all-zero batch does not seed the range: a later batch
                # would double it ~40 times into bin 0
                continue
            hi_range = bmax
        while bmax > hi_range:
            hist = hist.reshape(num_bins // 2, 2).sum(axis=1)
            hist = np.concatenate([hist, np.zeros(num_bins - num_bins // 2)])
            hi_range *= 2
        hist += np.histogram(o, bins=num_bins, range=(0, hi_range))[0]
    if n_seen == 0:
        raise ValueError("calib_entropy: no calibration data "
                         "(empty iterator or num_batches <= 0)")
    if hi_range is None:
        raise ValueError("calib_entropy: every calibration activation was "
                         "exactly zero — no threshold can be calibrated for "
                         "this layer (check the calibration data)")
    best_t = _kl_sweep(hist, hi_range, num_quantized_bins)
    return -best_t, best_t


def _smooth_distribution(d, eps=1e-4):
    """Move a little mass onto zero bins so KL is finite (ref:
    quantization.py _smooth_distribution)."""
    is_zero = d == 0
    n_zero = int(is_zero.sum())
    n_nonzero = d.size - n_zero
    if n_nonzero == 0:
        return None
    eps1 = eps * n_zero / n_nonzero
    out = d.astype(np.float64).copy()
    out[~is_zero] -= eps1
    out[is_zero] = eps
    if (out < 0).any():
        return None
    return out


def _kl_sweep(hist, amax, num_quantized_bins=255):
    """The clipping threshold minimizing KL(p || quantized p) over an
    |activation| histogram covering [0, amax] (the sweep half of the
    reference's _get_optimal_threshold). The sweep starts at
    num_quantized_bins: a narrower slice quantizes losslessly (KL 0) and
    would always win with a degenerate threshold."""
    num_bins = len(hist)
    edges = np.linspace(0, amax, num_bins + 1)
    best_kl, best_t = None, amax
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, num_bins // 128)):
        t = edges[i] if i < len(edges) else amax
        sliced = hist[:i].astype(np.float64)
        outliers = hist[i:].sum()
        if len(sliced) == 0 or sliced.sum() + outliers == 0:
            continue
        p = sliced.copy()
        p[-1] += outliers  # the clipped mass lands in p's edge bin ...
        # ... but q quantizes the histogram without it: the p / q
        # mismatch is the cost of clipping at t (ref:
        # _get_optimal_threshold builds q from sliced_nd_hist)
        factor = len(sliced) / num_quantized_bins
        q = np.zeros_like(sliced)
        for j in range(num_quantized_bins):
            lo = int(j * factor)
            hi = max(int((j + 1) * factor), lo + 1)
            chunk = sliced[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
        q[p == 0] = 0
        ps = _smooth_distribution(p)
        qs = _smooth_distribution(q)
        if ps is None or qs is None:
            continue
        kl = _kl_divergence(ps, qs)
        if best_kl is None or kl < best_kl:
            best_kl, best_t = kl, float(t)
    return best_t


# ---------------------------------------------------------------------------
# Model-level int8 quantization: a float32 gluon chain -> an int8 program
# (ref: quantize_graph_pass.cc + python quantize_model:422, where the graph
# pass splices quantize / quantized_op / requantize nodes; here the chain
# becomes a program whose conv / FC run int8 x int8 -> int32 through
# _contrib_quantized_conv / _contrib_quantized_fully_connected)
# ---------------------------------------------------------------------------

def _iter_chain(net):
    """Flatten (Hybrid)Sequential containers into a layer list. Only
    Sequential containers are flattened: a composite block with its own
    forward (residual blocks, branches) stays whole and runs as a float32
    island, since flattening it would drop its skip or branch logic."""
    if type(net).__name__ in ("Sequential", "HybridSequential"):
        out = []
        for k in net._modules.values():
            out.extend(_iter_chain(k))
        return out
    return [net]


def _np(param):
    return param.data().asnumpy()


def _fold_conv_bn(w, b, bn):
    """Fold one BatchNorm's affine into the preceding conv / dense (w, b)."""
    gamma, beta = _np(bn.gamma), _np(bn.beta)
    mean, var = _np(bn.running_mean), _np(bn.running_var)
    if not bn._scale:
        gamma = np.ones_like(gamma)
    f = gamma / np.sqrt(var + bn._epsilon)
    w = w * f.reshape((-1,) + (1,) * (w.ndim - 1))
    b = (b if b is not None else 0.0) * f + beta - mean * f
    return w.astype(np.float32), b.astype(np.float32)


def _bn_affine(bn):
    """Inference-mode BatchNorm as a per-channel affine y = a * x + b."""
    gamma, beta = _np(bn.gamma), _np(bn.beta)
    mean, var = _np(bn.running_mean), _np(bn.running_var)
    if not bn._scale:
        gamma = np.ones_like(gamma)
    a = gamma / np.sqrt(var + bn._epsilon)
    b = beta - mean * a
    return a.astype(np.float32), b.astype(np.float32)


def _conv_attrs(lyr):
    return dict(kernel=lyr._kernel, stride=lyr._strides,
                dilate=lyr._dilation, pad=lyr._padding,
                num_filter=lyr._channels, num_group=lyr._groups)


def _wb(conv):
    """A conv / dense layer's (weight, bias or None) in numpy."""
    return _np(conv.weight), (_np(conv.bias) if conv.bias is not None
                              else None)


def _fold_resunit(u):
    """Fold a v1 ResidualUnit's conv + BN pairs (body) and its projection
    shortcut. Returns (body, proj): body = [{lyr, w, b, inner}] where
    `inner` convs are followed by relu and int8 requantization and the
    last conv's int32 accumulator flows into the skip add; proj = {lyr, w,
    b} or None (identity shortcut)."""
    body = []
    n = len(u.convs)
    for i in range(n):
        conv = u.convs[i]
        w, b = _fold_conv_bn(*_wb(conv), u.norms[i])
        body.append(dict(lyr=conv, w=w, b=b, inner=i < n - 1))
    proj = None
    if u.proj is not None:
        w, b = _np(u.proj.weight), None
        if u.proj_norm is not None:
            w, b = _fold_conv_bn(w, b, u.proj_norm)
        proj = dict(lyr=u.proj, w=w.astype(np.float32), b=b)
    return body, proj


def _fire_convs(u):
    """The three convs of a squeezenet Fire module."""
    return (u.squeeze, u.left, u.right)


def _fold_tower(u):
    """Folded branches of an inception _Tower (parallel branches
    concatenated on channels): a plain branch is a folded chain, a
    _Fanout branch is {"fanout": {stem, b1, b2}} (stem -> concat(b1, b2)).

    A densenet _DenseLayer is the two-branch case concat(x, body(x)): an
    identity branch (empty chain) and the bn-relu-conv body chain (a
    standalone BN emits as an int8 per-channel affine)."""
    if type(u).__name__ == "_DenseLayer":
        return [{"recs": []},
                {"recs": _fold_batchnorm(_iter_chain(u.body))}]
    branches = []
    for child in u._modules.values():
        if type(child).__name__ == "_Fanout":
            branches.append({"fanout": {
                k: _fold_batchnorm(_iter_chain(getattr(child, k)))
                for k in ("stem", "b1", "b2")}})
        else:
            branches.append({"recs": _fold_batchnorm(_iter_chain(child))})
    return branches


def _chain_quantizable(recs):
    """A branch chain is int8-eligible when every record is a plain conv
    (no fused non-relu activation), a standalone channel-axis-1 BN, relu,
    a valid pool, flatten or dropout."""
    from ..gluon import nn as gnn

    for kind, lyr, _w, _b in recs:
        if kind == "conv":
            if getattr(lyr, "_channels_last", False):
                return False
            continue
        if kind == "bn_alone":
            if getattr(lyr, "_axis", 1) != 1:
                return False
            continue
        if isinstance(lyr, (gnn.MaxPool2D, gnn.AvgPool2D)):
            kw = lyr._kwargs
            if kw.get("pooling_convention", "valid") != "valid" \
                    and kw["pool_type"] != "max":
                return False
            if (kw["pool_type"] == "avg"
                    and not kw.get("count_include_pad", True)
                    and any(_p for _p in np.atleast_1d(kw.get("pad", 0)))):
                return False
            continue
        if isinstance(lyr, gnn.Activation) and lyr._act_type == "relu":
            continue
        if isinstance(lyr, (gnn.Flatten, gnn.Dropout)):
            continue
        return False
    return True


def _tower_quantizable(branches):
    for br in branches:
        if "fanout" in br:
            f = br["fanout"]
            if not all(_chain_quantizable(f[k]) for k in ("stem", "b1",
                                                          "b2")):
                return False
        elif not _chain_quantizable(br["recs"]):
            return False
    return True


def _fold_resunit_v2(u):
    """Record chains of a v2 (pre-activation) ResidualUnit: (pre, mid,
    last, proj). pre = [bn0, relu], the shared pre-activation that also
    feeds the projection; mid = [conv0, bn1, relu, conv1, ...] up to but
    not including the last conv; last = the last conv's record (its int32
    accumulator flows into the skip add, no relu after the add in v2);
    proj = the 1x1 projection's record or None."""
    from ..gluon import nn as gnn

    n = len(u.convs)
    relu = gnn.Activation("relu")

    def conv_rec(c):
        w, b = _wb(c)
        return ("conv", c, w.astype(np.float32),
                None if b is None else b.astype(np.float32))

    pre = [("bn_alone", u.norms[0], None, None), ("relu", relu, None, None)]
    mid = []
    for i in range(n):
        if i > 0:
            mid.append(("bn_alone", u.norms[i], None, None))
            mid.append(("relu", relu, None, None))
        if i < n - 1:
            mid.append(conv_rec(u.convs[i]))
    last = conv_rec(u.convs[n - 1])
    proj = conv_rec(u.proj) if u.proj is not None else None
    return pre, mid, last, proj


def _nc_conv_unit(layer, convs):
    return not any(getattr(c, "_channels_last", False) for c in convs)


def _fold_batchnorm(layers):
    """Fold BatchNorm into the preceding conv / dense weights (ref: the
    quantize pass fuses conv + bn before quantizing). Returns a list of
    (kind, layer, w, b) records in float32."""
    from ..gluon import nn as gnn

    records = []
    for layer in layers:
        name = type(layer).__name__
        if name in ("_Tower", "_DenseLayer"):
            # parallel conv-chain branches concatenated on channels: each
            # branch quantizes as a sub-chain rescaled to one tower scale
            # (demoted to a float32 island later if a branch cannot)
            records.append(("tower", layer, None, None))
            continue
        if name == "Fire" and _nc_conv_unit(layer, _fire_convs(layer)):
            # squeeze conv -> two expand convs -> channel concat, all
            # relu: both branches requantize to one output scale, so the
            # concat is an int8 op
            records.append(("fire", layer, None, None))
            continue
        if name == "ResidualUnit" and _nc_conv_unit(layer, layer.convs):
            version = getattr(layer, "_version", None)
            if version == 2:
                # pre-activation: standalone BNs emit as int8 affines;
                # skip add on dequantized accumulators, no relu after it
                records.append(("resunit2", layer, None, None))
                continue
            if version == 1:
                # int8 conv body + int8 shortcut, float32
                # dequant-add-requant at the junction (the reference's
                # flagship int8 model is ResNet)
                records.append(("resunit", layer, None, None))
                continue
        if isinstance(layer, gnn.BatchNorm):
            # fold only into a plain conv / dense: BN(act(conv)) is not
            # act(f * conv + shift)
            if (not records or records[-1][0] not in ("conv", "dense")
                    or records[-1][1]._act_type is not None):
                records.append(("bn_alone", layer, None, None))
                continue
            kind, lyr, w, b = records[-1]
            records[-1] = (kind, lyr) + _fold_conv_bn(w, b, layer)
        elif (hasattr(layer, "weight")
              and getattr(layer, "_transpose", False) is False
              and name.startswith("Conv")
              and layer._act_type in (None, "relu")):
            records.append(("conv", layer) + _wb(layer))
        elif name == "Dense" and layer._act_type in (None, "relu"):
            records.append(("dense", layer) + _wb(layer))
        else:
            # composite blocks, transposed convs and conv / dense with a
            # fused non-relu activation run whole as float32 islands
            records.append((name, layer, None, None))
    return records


def as_chain(net, probe=None):
    """Flatten the standard zoo composition `output(features(x))` into a
    HybridSequential sharing the same Parameters, so that `quantize_net`
    sees the whole layer stack instead of one float32 island.

    Pass a `probe` batch to check the flattening numerically (raises on
    a mismatch): a composite forward (residual adds, branches) fails the
    probe instead of being mis-flattened."""
    from .. import autograd as _ag
    from ..gluon import nn as gnn

    if not (hasattr(net, "features") and hasattr(net, "output")):
        raise ValueError(
            "as_chain: net has no features/output children (zoo chain "
            "pattern); pass a (Hybrid)Sequential directly instead")
    chain = gnn.HybridSequential(prefix="")
    chain.add(net.features)
    chain.add(net.output)
    if probe is not None:
        prev = _ag.set_training(False)
        try:
            a = net(probe).asnumpy()
            b = chain(probe).asnumpy()
        finally:
            _ag.set_training(prev)
        if not np.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise ValueError(
                "as_chain: output(features(x)) does not reproduce the "
                "net's forward — composite model, cannot flatten")
    return chain


class QuantizedNet:
    """The int8 inference program `quantize_net` makes, run eagerly on
    the device its tensors live on.

    Dataflow of a quantized layer (symmetric per-tensor scales s =
    127 / amax):
      q_in int8  --int8 conv / fc, int32 accumulation-->  acc
      acc + round(bias * s_in * s_w)  --* (s_out / (s_in * s_w)), round,
      clip-->  q_out int8  (ReLU = max(q_out, 0): the zero-point is 0)
    The last layer dequantizes to float32 logits. `ranges` holds the
    calibrated ranges the program was emitted from.
    """

    def __init__(self, steps, s_in, device, ranges=None):
        self._steps = steps
        self._s_in = float(s_in)
        self.device = torch.device(device)
        self.ranges = ranges

    @torch.no_grad()
    def apply(self, x, codes=None):
        """The forward over a float32 tensor on the program's device.
        With a list `codes`, every int8 activation the chain makes is
        appended to it (in order)."""
        note = codes.append if codes is not None else (lambda q: None)
        s = self._s_in
        q = _to_int8(x * s)
        note(q)
        for step in self._steps:
            kind = step["kind"]
            if kind in ("conv", "dense"):
                acc = _qlinear(kind, q, step)
                if step["last"]:
                    if step["relu"]:
                        acc = torch.relu(acc)  # zero-point 0: relu on acc
                    return acc.to(torch.float32) * step["deq_scale"]
                out = acc.to(torch.float32) * step["requant_scale"]
                if step["relu"]:
                    out = torch.relu(out)
                q = _to_int8(out)
                s = step["s_out"]
            elif kind == "resunit":
                # every convolution int8; the skip add in float32 on the
                # dequantized int32 accumulators
                q_in = h = q
                body32 = None
                for sub in step["body"]:
                    acc = _qconv(h, sub)
                    if sub["inner"]:
                        h = _to_int8(torch.relu(
                            acc.to(torch.float32) * sub["requant_scale"]))
                        note(h)
                    else:
                        body32 = acc.to(torch.float32) * sub["deq_scale"]
                skip32 = self._skip(step, q_in, q_in)
                q = _to_int8(torch.relu(body32 + skip32) * step["s_out"])
                s = step["s_out"]
            elif kind == "resunit2":
                # v2: the shared pre-activation feeds the body and the
                # projection; skip add on dequantized accumulators, no
                # relu after the add, then requantize
                q_in = q
                qp = self._exec_branch(step["pre"], q, note)
                skip32 = self._skip(step, qp, q_in)
                qm = self._exec_branch(step["mid"], qp, note)
                body32 = (_qconv(qm, step["last"]).to(torch.float32)
                          * step["last"]["deq_scale"])
                q = _to_int8((body32 + skip32) * step["s_out"])
                s = step["s_out"]
            elif kind == "tower":
                parts = []
                for br in step["branches"]:
                    if "fanout" in br:
                        f = br["fanout"]
                        qs2 = self._exec_branch(f["stem"], q, note)
                        for part in f["parts"]:
                            parts.append(self._rescaled(
                                part["steps"], part["rescale"], qs2, note))
                    else:
                        parts.append(self._rescaled(
                            br["steps"], br["rescale"], q, note))
                q = torch.cat(parts, 1)
                s = step["s_out"]
            elif kind == "fire":
                def _branch(qx, sub):
                    out = (_qconv(qx, sub).to(torch.float32)
                           * sub["requant_scale"])
                    return _to_int8(torch.relu(out))

                qs = _branch(q, step["squeeze"])
                note(qs)
                # both branches share s_out: the concat stays int8
                q = torch.cat([_branch(qs, step["left"]),
                               _branch(qs, step["right"])], 1)
                s = step["s_out"]
            elif kind == "affine":
                q = _to_int8(q.to(torch.float32) * step["mul"] + step["add"])
                s = step["s_out"]
            elif kind in ("maxpool", "avgpool"):
                q = qops.quantized_pooling(q, pool_type=kind[:3],
                                           **step["attrs"])
            elif kind == "relu":
                q = torch.relu(q)
            elif kind == "flatten":
                q = q.reshape(q.shape[0], -1)
            elif kind == "fp32":
                # dequantize, run the float32 layer, requantize
                x32 = step["fn"](qops._div(q.to(torch.float32), s))
                s = step["s_out"]
                q = _to_int8(x32 * s)
            else:  # identity (Dropout at inference)
                continue
            note(q)
        return qops._div(q.to(torch.float32), s)

    @staticmethod
    def _skip(step, q_proj_in, q_in):
        """The shortcut in float32: the projection's dequantized
        accumulator, or the dequantized input."""
        if step["proj"] is not None:
            return (_qconv(q_proj_in, step["proj"]).to(torch.float32)
                    * step["proj"]["deq_scale"])
        return q_in.to(torch.float32) * step["skip_deq"]

    @staticmethod
    def _exec_branch(bsteps, qx, note):
        """Run an int8 sub-chain (a tower branch, a unit segment)."""
        for st in bsteps:
            if st["kind"] == "conv":
                out = _qconv(qx, st).to(torch.float32) * st["requant_scale"]
                if st["relu"]:
                    out = torch.relu(out)
                qx = _to_int8(out)
            elif st["kind"] in ("maxpool", "avgpool"):
                qx = qops.quantized_pooling(qx, pool_type=st["kind"][:3],
                                            **st["attrs"])
            elif st["kind"] == "affine":
                qx = _to_int8(qx.to(torch.float32) * st["mul"] + st["add"])
            elif st["kind"] == "relu":
                qx = torch.relu(qx)
            elif st["kind"] == "flatten":
                qx = qx.reshape(qx.shape[0], -1)
            else:
                continue
            note(qx)
        return qx

    def _rescaled(self, bsteps, rescale, qx, note):
        qb = self._exec_branch(bsteps, qx, note)
        return _to_int8(qb.to(torch.float32) * rescale)

    @property
    def num_fp32_islands(self):
        """Layers that fell back to float32 between dequantize / quantize
        pairs; 0 means the whole program runs on the int8 path."""
        return sum(1 for s in self._steps if s["kind"] == "fp32")

    def __call__(self, x):
        xd = _tensor(x).to(self.device)
        return NDArray._from_data(self.apply(xd))


def _qconv(q, st):
    return qops.quantized_conv(q, st["qw"], st["qb"],
                               no_bias=st["qb"] is None, **st["attrs"])


def _qlinear(kind, q, st):
    if kind == "conv":
        return _qconv(q, st)
    return qops.quantized_fully_connected(q, st["qw"], st["qb"],
                                          no_bias=st["qb"] is None,
                                          **st["attrs"])


def _net_device(net):
    """The device of the net's parameters (the default context's when
    none is materialized)."""
    for p in net.collect_params().values():
        if p._data is not None:
            return p._data.device
    return current_context().torch_device()


def _fold(net):
    """(records, folded units) of a chain: the layer records and, by
    record index, the folded v1 / v2 residual units and the tower branch
    trees (a tower that cannot quantize is demoted to an island)."""
    records = _fold_batchnorm(_iter_chain(net))
    units = {"resunit": {}, "resunit2": {}, "tower": {}}
    for i, (kind, lyr, _w, _b) in enumerate(records):
        if kind == "resunit":
            units[kind][i] = _fold_resunit(lyr)
        elif kind == "resunit2":
            units[kind][i] = _fold_resunit_v2(lyr)
        elif kind == "tower":
            branches = _fold_tower(lyr)
            if _tower_quantizable(branches):
                units[kind][i] = branches
            else:
                records[i] = (type(lyr).__name__, lyr, None, None)
    return records, units


def _empty_window(lyr, x):
    """Whether a ceil-mode ('full') pool has a window wholly in padding
    at this input's shapes (ops.nn.pooling's rule)."""
    kw = lyr._kwargs
    kk = np.atleast_1d(kw["kernel"])
    ss = np.atleast_1d(kw["stride"])
    pp = np.atleast_1d(kw.get("pad", 0))
    empty = False
    for ax in range(len(kk)):
        dim = x.shape[2 + ax]
        pad = int(pp[ax % len(pp)])
        in_sz = dim + 2 * pad
        kx = int(kk[ax % len(kk)])
        sx = int(ss[ax % len(ss)])
        rem = (in_sz - kx) % sx
        extra = (sx - rem) % sx if rem != 0 else 0
        n_out = 1 + (in_sz - kx + extra) // sx
        if (n_out - 1) * sx >= pad + dim:
            empty = True
    return empty


def _amax_of(x):
    return float(x.abs().max())


def _calibrate(records, units, calib_data, num_calib_batches, calib_mode,
               device):
    """The activation ranges of every quantization point: a float32 pass
    of the folded chain per calibration batch (maxima of |x|), then, for
    calib_mode "entropy", a second pass of histograms and a KL sweep per
    conv / dense output."""
    from ..gluon import nn as gnn

    def dev(a):
        return None if a is None else torch.from_numpy(a).to(device)

    rng = {
        "amax_in": 1e-8,
        "amax_out": [1e-8] * len(records),
        "res": {i: [1e-8] * (len(body) - 1)
                for i, (body, _p) in units["resunit"].items()},
        "fire": {i: 1e-8 for i, r in enumerate(records) if r[0] == "fire"},
        "v2": {i: {"pre": [1e-8] * len(pre), "mid": [1e-8] * len(mid)}
               for i, (pre, mid, _l, _p) in units["resunit2"].items()},
        "tower": {},
        "empty_window": {},
    }
    for i, branches in units["tower"].items():
        am = []
        for br in branches:
            if "fanout" in br:
                am.append({k: [1e-8] * len(br["fanout"][k])
                           for k in ("stem", "b1", "b2")})
            else:
                am.append({"recs": [1e-8] * len(br["recs"])})
        rng["tower"][i] = am

    def conv(x, lyr, w, b):
        return nnops.convolution(x, dev(w), dev(b), no_bias=b is None,
                                 **_conv_attrs(lyr))

    def sim_chain(recs, x, amaxes):
        """Float32 run of a folded branch chain, recording the ranges at
        the (relu-fused) conv outputs and standalone BNs."""
        for j, (kind, lyr, w, b) in enumerate(recs):
            if kind == "conv":
                x = conv(x, lyr, w, b)
                if lyr._act_type == "relu":
                    x = torch.relu(x)
                amaxes[j] = max(amaxes[j], _amax_of(x))
            elif kind == "bn_alone":
                a, bb = _bn_affine(lyr)
                x = x * dev(a).reshape(1, -1, 1, 1) + \
                    dev(bb).reshape(1, -1, 1, 1)
                amaxes[j] = max(amaxes[j], _amax_of(x))
            elif isinstance(lyr, (gnn.MaxPool2D, gnn.AvgPool2D)):
                x = nnops.pooling(x, **lyr._kwargs)
            elif isinstance(lyr, gnn.Activation):
                x = torch.relu(x)
            elif isinstance(lyr, gnn.Flatten):
                x = x.reshape(x.shape[0], -1)
            # Dropout: identity at inference
        return x

    def sim_steps(x):
        """Run the folded float32 chain, yielding (record index,
        output)."""
        for i, (kind, lyr, w, b) in enumerate(records):
            if kind == "conv":
                x = conv(x, lyr, w, b)
                if lyr._act_type == "relu":
                    x = torch.relu(x)
            elif kind == "dense":
                x = nnops.fully_connected(x, dev(w), dev(b),
                                          num_hidden=lyr._units,
                                          no_bias=b is None,
                                          flatten=lyr._flatten)
                if lyr._act_type == "relu":
                    x = torch.relu(x)
            elif kind == "resunit":
                body, proj = units[kind][i]
                h = x
                for j, rec in enumerate(body):
                    h = conv(h, rec["lyr"], rec["w"], rec["b"])
                    if rec["inner"]:
                        h = torch.relu(h)
                        rng["res"][i][j] = max(rng["res"][i][j],
                                               _amax_of(h))
                skip = x if proj is None else conv(x, proj["lyr"],
                                                   proj["w"], proj["b"])
                x = torch.relu(skip + h)
            elif kind == "resunit2":
                pre, mid, last, proj = units[kind][i]
                h = sim_chain(pre, x, rng["v2"][i]["pre"])
                skip = x if proj is None else conv(h, *proj[1:])
                h = sim_chain(mid, h, rng["v2"][i]["mid"])
                x = skip + conv(h, *last[1:])
            elif kind == "tower":
                parts = []
                for br, am in zip(units[kind][i], rng["tower"][i]):
                    if "fanout" in br:
                        f = br["fanout"]
                        h = sim_chain(f["stem"], x, am["stem"])
                        parts.append(sim_chain(f["b1"], h, am["b1"]))
                        parts.append(sim_chain(f["b2"], h, am["b2"]))
                    else:
                        parts.append(sim_chain(br["recs"], x, am["recs"]))
                x = torch.cat(parts, 1)
            elif kind == "fire":
                sq, left, right = _fire_convs(lyr)
                s = torch.relu(conv(x, sq, *_wb(sq)))
                rng["fire"][i] = max(rng["fire"][i], float(s.max()))
                x = torch.cat([torch.relu(conv(s, c, *_wb(c)))
                               for c in (left, right)], 1)
            elif isinstance(lyr, (gnn.MaxPool2D, gnn.AvgPool2D,
                                  gnn.GlobalMaxPool2D, gnn.GlobalAvgPool2D)):
                if lyr._kwargs.get("pooling_convention") == "full":
                    # gates int8 eligibility at these shapes
                    rng["empty_window"][i] = _empty_window(lyr, x)
                x = nnops.pooling(x, **lyr._kwargs)
            elif isinstance(lyr, gnn.Flatten):
                x = x.reshape(x.shape[0], -1)
            elif isinstance(lyr, gnn.Dropout):
                pass
            elif kind == "bn_alone":
                x = nnops.batch_norm(
                    x, lyr.gamma.tensor(), lyr.beta.tensor(),
                    lyr.running_mean.tensor(), lyr.running_var.tensor(),
                    eps=lyr._epsilon, fix_gamma=not lyr._scale,
                    use_global_stats=True)
            else:
                x = lyr(x)
            yield i, x

    def batches():
        n = 0
        for batch in calib_data:
            if n >= num_calib_batches:
                break
            yield _tensor(_batch_data(batch)).to(device)
            n += 1

    n_done = 0
    for x in batches():
        rng["amax_in"] = max(rng["amax_in"], _amax_of(x))
        for i, out in sim_steps(x):
            rng["amax_out"][i] = max(rng["amax_out"][i], _amax_of(out))
        n_done += 1
    if n_done == 0:
        raise ValueError("quantize_net: empty calibration iterator")

    if calib_mode == "entropy":
        # a second pass (calib_data must be re-iterable): |activation|
        # histograms inside the minmax range, then a KL sweep picks each
        # conv / dense output's clipping threshold (ref:
        # _get_optimal_threshold, entropy mode). Only those outputs' are
        # kept, the only ones the sweep reads.
        nbins = 1024
        swept = [i for i, r in enumerate(records)
                 if r[0] in ("conv", "dense")]
        hists = {i: np.zeros(nbins) for i in swept}
        n2 = 0
        for x in batches():
            for i, out in sim_steps(x):
                if i in hists:
                    o = np.abs(out.cpu().numpy()).ravel()
                    hists[i] += np.histogram(
                        o, bins=nbins, range=(0, rng["amax_out"][i]))[0]
            n2 += 1
        if n2 == 0:
            raise ValueError("calib_mode='entropy' needs a re-iterable "
                             "calib_data (the first pass consumed it)")
        for i in swept:
            if hists[i].sum() > 0:
                rng["amax_out"][i] = _kl_sweep(hists[i],
                                               rng["amax_out"][i])
    elif calib_mode != "minmax":
        raise ValueError(f"unsupported calib_mode {calib_mode!r} "
                         "(use 'minmax' or 'entropy')")
    return rng


def _emit(records, units, rng, device):
    """The int8 program's steps from the folded chain and the ranges."""
    from ..gluon import nn as gnn

    def f32(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(device)

    def qweight(w):
        """Per-output-channel symmetric int8 weights (the reference's
        channel-wise option; the output channel is axis 0 of conv (O, I,
        kh, kw) and dense (U, in) weights) -> (qw, s_w (C,), s_w as a
        float32 column to broadcast over the accumulator)."""
        amax_w = np.abs(w).reshape(w.shape[0], -1).max(axis=1)
        s_w = 127.0 / np.maximum(amax_w, 1e-8)
        qw = np.clip(np.round(w * s_w.reshape((-1,) + (1,) * (w.ndim - 1))),
                     -127, 127).astype(np.int8)
        return torch.from_numpy(qw).to(device), s_w, s_w.astype(np.float32)

    def qbias(b, s_in, s_w):
        return None if b is None else \
            torch.from_numpy(np.round(b * s_in * s_w).astype(np.int32)) \
            .to(device)

    def conv_step(lyr, w, b, s_in):
        """(step with qw / qb / attrs, s_w broadcast) of one conv."""
        qw, s_w, s_w_b = qweight(w)
        return (dict(qw=qw, qb=qbias(b, s_in, s_w),
                     attrs=_conv_attrs(lyr)), s_w_b.reshape(1, -1, 1, 1))

    def emit_chain(recs, s_in_c, amaxes):
        """Steps of a folded branch chain (each conv requantizes to its
        own range) and its final scale."""
        out = []
        s_cur = s_in_c
        for j, (kind, lyr, w, b) in enumerate(recs):
            if kind == "conv":
                st, s_w_b = conv_step(lyr, w, b, s_cur)
                s_j = 127.0 / amaxes[j]
                st.update(kind="conv", relu=lyr._act_type == "relu",
                          last=False,
                          requant_scale=f32(s_j / (s_cur * s_w_b)),
                          deq_scale=f32(1.0 / (s_cur * s_w_b)), s_out=s_j)
                out.append(st)
                s_cur = s_j
            elif kind == "bn_alone":
                a, bb = _bn_affine(lyr)
                s_j = 127.0 / amaxes[j]
                out.append(dict(
                    kind="affine",
                    mul=f32((a * (s_j / s_cur)).reshape(1, -1, 1, 1)),
                    add=f32((bb * s_j).reshape(1, -1, 1, 1)), s_out=s_j))
                s_cur = s_j
            elif isinstance(lyr, (gnn.MaxPool2D, gnn.AvgPool2D)):
                kw = lyr._kwargs
                out.append(dict(
                    kind="maxpool" if kw["pool_type"] == "max"
                    else "avgpool",
                    attrs=dict(kernel=kw["kernel"], stride=kw["stride"],
                               pad=kw["pad"],
                               pooling_convention=kw.get(
                                   "pooling_convention", "valid"))))
            elif isinstance(lyr, gnn.Activation):
                out.append(dict(kind="relu"))
            elif isinstance(lyr, gnn.Flatten):
                out.append(dict(kind="flatten"))
            else:  # Dropout
                out.append(dict(kind="identity"))
        return out, s_cur

    def pool_quantizable(i, lyr):
        """int8 pooling: valid-convention pools, and ceil-mode max pools
        whose windows each hold an input (the int8-min pad keeps the max
        exact); avg without count_include_pad over padding stays
        float32."""
        kw = lyr._kwargs
        convention = kw.get("pooling_convention", "valid")
        if convention == "full":
            return kw["pool_type"] == "max" and \
                not rng["empty_window"].get(i, False)
        if convention != "valid":
            return False
        return not (kw["pool_type"] == "avg"
                    and not kw.get("count_include_pad", True)
                    and any(_p for _p in np.atleast_1d(kw.get("pad", 0))))

    amax_out = rng["amax_out"]
    s_in0 = 127.0 / rng["amax_in"]
    steps = []
    s_prev = s_in0
    last_q = max((i for i, r in enumerate(records)
                  if r[0] in ("conv", "dense")), default=-1)
    if last_q != len(records) - 1:
        last_q = -1  # trailing non-compute layers: dequantize at the end
    for i, (kind, lyr, w, b) in enumerate(records):
        s_out = 127.0 / amax_out[i]
        if kind in ("conv", "dense"):
            if kind == "conv":
                st, s_w_b = conv_step(lyr, w, b, s_prev)
            else:
                qw, s_w, s_w_b = qweight(w)
                s_w_b = s_w_b.reshape(1, -1)
                st = dict(qw=qw, qb=qbias(b, s_prev, s_w),
                          attrs=dict(num_hidden=lyr._units,
                                     flatten=lyr._flatten))
            st.update(kind=kind, relu=lyr._act_type == "relu",
                      last=i == last_q,
                      requant_scale=f32(s_out / (s_prev * s_w_b)),
                      deq_scale=f32(1.0 / (s_prev * s_w_b)), s_out=s_out)
            steps.append(st)
            s_prev = s_out
        elif kind == "resunit":
            # int8 conv body + int8 shortcut conv, the dequantized float32
            # add at the junction, relu, requantize to the unit's range
            body, proj = units[kind][i]
            s_cur = s_prev
            subs = []
            for j, rec in enumerate(body):
                sub, s_w_b = conv_step(rec["lyr"], rec["w"], rec["b"],
                                       s_cur)
                sub["inner"] = rec["inner"]
                if rec["inner"]:
                    s_j = 127.0 / rng["res"][i][j]
                    sub["requant_scale"] = f32(s_j / (s_cur * s_w_b))
                    s_cur = s_j
                else:
                    sub["deq_scale"] = f32(1.0 / (s_cur * s_w_b))
                subs.append(sub)
            pstep = None
            if proj is not None:
                pstep, s_w_b = conv_step(proj["lyr"], proj["w"], proj["b"],
                                         s_prev)
                pstep["deq_scale"] = f32(1.0 / (s_prev * s_w_b))
            steps.append(dict(kind="resunit", body=subs, proj=pstep,
                              skip_deq=1.0 / s_prev, s_out=s_out))
            s_prev = s_out
        elif kind == "resunit2":
            pre, mid, last, proj = units[kind][i]
            pre_steps, s_pre = emit_chain(pre, s_prev, rng["v2"][i]["pre"])
            pstep = None
            if proj is not None:
                pstep, s_w_b = conv_step(*proj[1:], s_pre)
                pstep["deq_scale"] = f32(1.0 / (s_pre * s_w_b))
            mid_steps, s_mid = emit_chain(mid, s_pre, rng["v2"][i]["mid"])
            lstep, s_w_b = conv_step(*last[1:], s_mid)
            lstep["deq_scale"] = f32(1.0 / (s_mid * s_w_b))
            steps.append(dict(kind="resunit2", pre=pre_steps,
                              mid=mid_steps, last=lstep, proj=pstep,
                              skip_deq=1.0 / s_prev, s_out=s_out))
            s_prev = s_out
        elif kind == "tower":
            # each branch emits as an int8 sub-chain and rescales its
            # int8 output to the shared tower scale, so the concat stays
            # int8; a fanout's two sub-branches rescale to the tower scale
            # directly (concat(concat(a, b), c) == concat(a, b, c))
            ebranches = []
            for br, am in zip(units[kind][i], rng["tower"][i]):
                if "fanout" in br:
                    f = br["fanout"]
                    stem_steps, s_stem = emit_chain(f["stem"], s_prev,
                                                    am["stem"])
                    parts = []
                    for key in ("b1", "b2"):
                        bsteps, s_b = emit_chain(f[key], s_stem, am[key])
                        parts.append(dict(steps=bsteps,
                                          rescale=s_out / s_b))
                    ebranches.append(dict(fanout=dict(stem=stem_steps,
                                                      parts=parts)))
                else:
                    bsteps, s_b = emit_chain(br["recs"], s_prev,
                                             am["recs"])
                    ebranches.append(dict(steps=bsteps,
                                          rescale=s_out / s_b))
            steps.append(dict(kind="tower", branches=ebranches,
                              s_out=s_out))
            s_prev = s_out
        elif kind == "fire":
            # both expand branches requantize to the same output scale:
            # the channel concat is an int8 op
            sq, left, right = _fire_convs(lyr)
            s_sq = 127.0 / rng["fire"][i]
            fire = dict(kind="fire", s_out=s_out)
            for key, c, s_a, s_b in (("squeeze", sq, s_prev, s_sq),
                                     ("left", left, s_sq, s_out),
                                     ("right", right, s_sq, s_out)):
                sub, s_w_b = conv_step(c, *_wb(c), s_a)
                sub["requant_scale"] = f32(s_b / (s_a * s_w_b))
                fire[key] = sub
            steps.append(fire)
            s_prev = s_out
        elif (isinstance(lyr, (gnn.MaxPool2D, gnn.AvgPool2D))
              and pool_quantizable(i, lyr)):
            kw = lyr._kwargs
            steps.append(dict(
                kind="maxpool" if kw["pool_type"] == "max" else "avgpool",
                attrs=dict(kernel=kw["kernel"], stride=kw["stride"],
                           pad=kw["pad"],
                           pooling_convention=kw.get("pooling_convention",
                                                     "valid"))))
            # pooling keeps the input scale (max exactly, avg to rounding)
        elif isinstance(lyr, (gnn.GlobalMaxPool2D, gnn.GlobalAvgPool2D)):
            kw = lyr._kwargs
            steps.append(dict(
                kind="maxpool" if kw["pool_type"] == "max" else "avgpool",
                attrs=dict(kernel=kw["kernel"], stride=kw["stride"],
                           pad=kw["pad"], global_pool=True)))
        elif kind == "bn_alone" and getattr(lyr, "_axis", 1) == 1:
            # a standalone inference BN is a per-channel affine, exact in
            # the int8 requantization: q' = round(q * (a * s_out / s_in)
            # + b * s_out)
            a, bb = _bn_affine(lyr)
            steps.append(dict(
                kind="affine",
                mul=f32((a * (s_out / s_prev)).reshape(1, -1, 1, 1)),
                add=f32((bb * s_out).reshape(1, -1, 1, 1)), s_out=s_out))
            s_prev = s_out
        elif isinstance(lyr, gnn.Activation) and lyr._act_type == "relu":
            steps.append(dict(kind="relu"))
        elif isinstance(lyr, gnn.Flatten):
            steps.append(dict(kind="flatten"))
        elif isinstance(lyr, gnn.Dropout):
            steps.append(dict(kind="identity"))
        else:
            steps.append(dict(kind="fp32", fn=lyr, s_out=s_out))
            s_prev = s_out
    return QuantizedNet(steps, s_in0, device, rng)


def quantize_net(net, calib_data, num_calib_batches=10, calib_mode="minmax",
                 quantized_dtype="int8"):
    """Float32 gluon chain -> `QuantizedNet` with calibrated activation
    scales (ref: python quantize_model flow: collect statistics, set the
    ranges, emit the quantized graph), on the net's device. Covers
    Conv2D / Dense (folded BatchNorm, fused relu), max / avg / global
    pooling (ceil-mode int8 max included), Flatten, Activation('relu'),
    Dropout, and the composite units: v1 residual units (int8 body and
    shortcut, float32 dequant-add-requant at the junction), v2 units,
    squeezenet Fire modules, inception towers and densenet layers;
    anything else runs as a float32 island between dequantize / quantize
    pairs."""
    if quantized_dtype != "int8":
        raise ValueError("only int8 is supported")
    device = _net_device(net)
    records, units = _fold(net)
    with torch.no_grad():
        rng = _calibrate(records, units, calib_data, num_calib_batches,
                         calib_mode, device)
    return _emit(records, units, rng, device)


def quantize_net_from_ranges(net, ranges):
    """The `QuantizedNet` of a chain from the calibrated ranges of another
    program (`QuantizedNet.ranges`) of the same chain, on this net's
    device: the same int8 weights, biases and scales."""
    device = _net_device(net)
    records, units = _fold(net)
    return _emit(records, units, ranges, device)
