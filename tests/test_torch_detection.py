"""The port's detection path against the JAX package's (CPU): NMS's keep
set and order on tied scores and on a planted chain of overlaps (the
port's fixed point takes chain + 1 passes where JAX walks every box),
the three sort orders of `Proposal` on tied scores, ROIPooling's windows
on bins wider than the map, and the two-stage detector of
`examples/rcnn_proposal.py` at a small size (a 64 x 96 image, ResNet-18
v1 C4, 9 anchors, pre-NMS 200 / post-NMS 16, ROIPooling 14 x 14 at 1/16,
stage 4 as the head, 21 classes) through both packages from the same
weights: rois equal and the head's logits at rtol 1e-4 (the model-logits
tolerance). NMS is held at 1e-5 (`tests/test_vision.py`)."""
import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params
from incubator_mxnet_tpu_torch.ops import vision as tv

NMS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: on a loaded machine (the suite's other workers), torch's
    intra-op thread pool makes them many times slower than one thread
    does, and takes cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_nms_one(rows, thresh, **kw):
    import jax

    from incubator_mxnet_tpu.ops import vision as jv

    args = dict(valid_thresh=0.0, topk=-1, coord_start=2, score_index=1,
                id_index=-1, force_suppress=False, in_format="corner",
                out_format="corner")
    args.update(kw)
    return np.asarray(jax.jit(lambda d: jv._nms_one(
        d, thresh, args["valid_thresh"], args["topk"], args["coord_start"],
        args["score_index"], args["id_index"], args["force_suppress"],
        args["in_format"], args["out_format"]))(rows))


def _port_nms_one(rows, thresh, **kw):
    args = dict(valid_thresh=0.0, topk=-1, coord_start=2, score_index=1,
                id_index=-1, force_suppress=False, in_format="corner",
                out_format="corner")
    args.update(kw)
    tv.NMS_PASSES.clear()
    out = tv._nms_one(torch.from_numpy(rows), thresh, *args.values())
    return out.numpy(), tv.NMS_PASSES[-1]


def _chain(n, step=1.0, width=4.0):
    """n boxes along x, each overlapping the next at IoU 0.6 (above 0.5)
    and the one after it below, with falling scores: greedy NMS keeps
    every other box, and the suppression chain is n - 1 long."""
    x = np.arange(n, dtype=np.float32) * step
    rows = np.stack([np.zeros(n), np.linspace(0.9, 0.1, n), x,
                     np.zeros(n), x + width, np.full(n, 2.0)], 1)
    return rows.astype(np.float32)


def test_nms_planted_chain_matches_jax():
    """A chain of 40 boxes: every other one kept, in 40 passes (JAX's
    loop, and the greedy definition: keep 0, 2, 4, ...)."""
    rows = _chain(40, step=1.0, width=4.0)   # IoU(i, i+1) 0.6, (i, i+2) 1/3
    got, passes = _port_nms_one(rows, 0.5)
    want = _jax_nms_one(rows, 0.5)
    np.testing.assert_allclose(got, want, **NMS_TOL)
    assert (got[:, 1] >= 0).sum() == 20
    assert passes == 40


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_ties_match_jax(seed):
    """Scores drawn from 3 values over 48 overlapping boxes: among equal
    scores the higher index goes first (JAX's reversed stable argsort),
    so the keep set and the order agree; also per id and with topk."""
    rng = np.random.RandomState(seed)
    n = 48
    xy = rng.uniform(0, 6, (n, 2))
    rows = np.concatenate([
        rng.randint(0, 2, (n, 1)), rng.randint(1, 4, (n, 1)) / 4.0,
        xy, xy + rng.uniform(2, 5, (n, 2))], 1).astype(np.float32)
    for kw in ({}, {"id_index": 0}, {"topk": 12, "id_index": 0}):
        got, _ = _port_nms_one(rows, 0.4, **kw)
        np.testing.assert_allclose(got, _jax_nms_one(rows, 0.4, **kw),
                                   err_msg=str(kw), **NMS_TOL)


def test_proposal_tie_orders_match_jax():
    """Foreground scores from 3 values (exact ties at the pre-NMS top-k
    boundary, inside NMS and in the survivors' sort) and a pre top that
    cuts through a tie: rois and scores equal JAX's."""
    import jax

    from incubator_mxnet_tpu.ops import vision as jv

    rng = np.random.RandomState(3)
    a, h, w = 6, 5, 5
    prob = (rng.randint(1, 4, (1, 2 * a, h, w)) / 4.0).astype(np.float32)
    deltas = (0.2 * rng.randn(1, 4 * a, h, w)).astype(np.float32)
    info = np.array([[40.0, 40.0, 1.0]], np.float32)
    attrs = dict(scales=(2, 4), ratios=(0.5, 1, 2), feature_stride=8,
                 rpn_pre_nms_top_n=37, rpn_post_nms_top_n=20,
                 threshold=0.6, rpn_min_size=2, output_score=True)
    want = jax.jit(lambda p, d, i: jv.proposal(p, d, i, **attrs))(
        prob, deltas, info)
    got = tv.proposal(*map(torch.from_numpy, (prob, deltas, info)), **attrs)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **NMS_TOL)


def test_roi_pooling_wide_windows_match_jax():
    """ROIs larger than the map and bins several rows high, on integer
    data (tied maxima): values exact and the gradient split evenly among
    the ties, as JAX's."""
    import jax

    from incubator_mxnet_tpu.ops import vision as jv

    rng = np.random.RandomState(5)
    data = np.round(rng.randn(1, 2, 9, 11) * 1.5).astype(np.float32)
    rois = np.array([[0, -8, -5, 30, 25], [0, 2, 3, 21, 17],
                     [0, 10, 10, 11, 11]], np.float32)
    head = rng.randn(3, 2, 2, 3).astype(np.float32)
    attrs = dict(pooled_size=(2, 3), spatial_scale=0.5)
    want, vjp = jax.vjp(lambda d: jv.roi_pooling(d, rois, **attrs), data)
    want_g = vjp(head)[0]
    x = torch.from_numpy(data).requires_grad_()
    got = tv.roi_pooling(x, torch.from_numpy(rois), **attrs)
    got.backward(torch.from_numpy(head))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)


# -- the two-stage detector at a small size ---------------------------------

DET = dict(image=(64, 96), stride=16, scales=(8, 16, 32),
           ratios=(0.5, 1, 2), pre=200, post=16, nms=0.7, min_size=16,
           pooled=14, classes=21)


def _parts(mx):
    """The detector's blocks in package `mx`, with fixed prefixes."""
    nn = mx.gluon.nn
    base = mx.gluon.model_zoo.vision.resnet18_v1(prefix="det_")
    rpn = nn.Conv2D(512, 3, padding=1, activation="relu", prefix="rpn_")
    rpn_cls = nn.Conv2D(18, 1, prefix="rpncls_")
    rpn_reg = nn.Conv2D(36, 1, prefix="rpnreg_")
    cls = nn.Dense(DET["classes"], prefix="cls_")
    reg = nn.Dense(4 * DET["classes"], prefix="reg_")
    return dict(base=base, rpn=rpn, rpn_cls=rpn_cls, rpn_reg=rpn_reg,
                cls=cls, reg=reg)


def _forward(parts, F, x, pool):
    """rois and head logits of the detector over `F`'s ops (the
    package's tensor-level namespace)."""
    feats = parts["base"].features
    c4 = feats[:7](x)
    r = parts["rpn"](c4)
    scores, deltas = parts["rpn_cls"](r), parts["rpn_reg"](r)
    fh, fw = c4.shape[2], c4.shape[3]
    prob = F.softmax(F.reshape(scores, shape=(1, 2, 9, fh, fw)), axis=1)
    prob = F.reshape(prob, shape=(1, 18, fh, fw))
    h, w = DET["image"]
    rois = F._contrib_Proposal(
        prob, deltas, pool.info, scales=DET["scales"], ratios=DET["ratios"],
        feature_stride=DET["stride"], rpn_pre_nms_top_n=DET["pre"],
        rpn_post_nms_top_n=DET["post"], threshold=DET["nms"],
        rpn_min_size=DET["min_size"])
    p = DET["pooled"]
    pooled = F.ROIPooling(c4, rois, pooled_size=(p, p),
                          spatial_scale=1.0 / DET["stride"])
    head = F.mean(feats[7](pooled), axis=(2, 3))
    return rois, parts["cls"](head), parts["reg"](head)


def _weights(shapes, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(("gamma", "running_var")):
            v = 1.0 + 0.1 * np.abs(rng.randn(*shape))
        elif name.endswith(("beta", "bias", "running_mean")):
            v = 0.1 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) * math.sqrt(2.0 / math.prod(shape[1:]))
        out[name] = v.astype(np.float32)
    return out


def test_detection_pass_matches_jax():
    import jax

    from incubator_mxnet_tpu.gluon.block import _ParamSubst
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray as JND
    from incubator_mxnet_tpu_torch.ndarray.register import F as TF

    h, w = DET["image"]
    x = np.random.RandomState(0).rand(1, 3, h, w).astype(np.float32)
    info = np.array([[h, w, 1.0]], np.float32)

    # the port resolves the shapes, then both packages take the weights
    tparts = _parts(tmx)
    for p in tparts.values():
        p.initialize(device="cpu")

    class Info:
        pass

    tpool = Info()
    tpool.info = torch.from_numpy(info)
    with torch.no_grad():
        _forward(tparts, TF, torch.from_numpy(x), tpool)
    shapes = {n: tuple(p.shape) for blk in tparts.values()
              for n, p in blk.collect_params().items()}
    weights = _weights(shapes)
    for blk in tparts.values():
        load_numpy_params(blk, {n: weights[n] for n in
                                blk.collect_params()}, prefix=blk.prefix)
    with torch.no_grad():
        rois, logits, box = _forward(tparts, TF, torch.from_numpy(x), tpool)

    jparts = _parts(jmx)
    names = []
    for blk in jparts.values():
        blk.initialize()
        for n, p in blk.collect_params().items():
            p.set_data(jmx.nd.array(weights[n]))
            names.append((n, p))

    def f(ws, xd, inf):
        mapping = {n: JND._from_data(wt) for (n, _), wt in zip(names, ws)}
        jpool = Info()
        jpool.info = JND._from_data(inf)
        prev = jmx.autograd.set_training(False)
        try:
            with _ParamSubst(mapping):
                return tuple(o._data for o in _forward(
                    jparts, jmx.nd, JND._from_data(xd), jpool))
        finally:
            jmx.autograd.set_training(prev)

    want = jax.jit(f)([weights[n] for n, _ in names], x, info)
    np.testing.assert_allclose(rois.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    assert rois.shape == (DET["post"], 5)
    for got, wv in zip((logits, box), want[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(wv), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(wv).max()))
