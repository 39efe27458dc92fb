"""Seeded inputs for every operator of the port's registry, shared by
`tests/test_torch_ndarray.py` (the port against the JAX package on the
CPU) and `chip_smoke.py` (the port on the card against its own CPU
result). JAX-free: numpy, torch and the port only.

`CASES` maps an op to case(rng) -> (inputs, attrs); an input that is a
numpy array becomes an NDArray. `NAME_CASES` gives an alias a case of
its own, `EXTRA` adds cases for an op's other modes, and
`RANDOM_CASES` the samplers' parameters with the mean and standard
deviation of each row's distribution.
"""
import numpy as np
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.ops.nn import rnn_param_size
from incubator_mxnet_tpu_torch.ops.registry import OP_REGISTRY

CPU = tmx.cpu()


def A(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def U(rng, lo, hi, *shape):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def P(rng, *shape):
    return U(rng, 0.5, 2.0, *shape)


def R(rng, *shape):
    """Small integers as float32 (ties for the comparisons)."""
    return np.round(rng.randn(*shape) * 1.5).astype(np.float32)


def I(vals):
    return np.asarray(vals, np.float32)


def Q8(rng, *shape):
    """int8 codes of the quantized ops, -127..127."""
    return rng.randint(-127, 128, shape).astype(np.int8)


def Q32(rng, *shape, hi=10000):
    """int32 biases or accumulators of the quantized ops."""
    return rng.randint(-hi, hi, shape).astype(np.int32)


def SPD(rng, n):
    a = A(rng, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def LOW(rng, n):
    return np.linalg.cholesky(SPD(rng, n)).astype(np.float32)


def _binary(lhs, rhs=None):
    return lambda r: ([lhs(r), (rhs or lhs)(r)], {})


def _scalar(data, scalar):
    return lambda r: ([data(r)], {"scalar": scalar})


def _unary(data):
    return lambda r: ([data(r)], {})


def _a(*shape):
    return lambda r: A(r, *shape)


def _p(*shape):
    return lambda r: P(r, *shape)


def _u(lo, hi, *shape):
    return lambda r: U(r, lo, hi, *shape)


def _rd(*shape):
    return lambda r: R(r, *shape)


# canonical op name -> case(rng) -> (inputs, attrs); an input that is a
# numpy array becomes an NDArray, anything else is passed as it is
CASES = {}
for _n in ("broadcast_add", "broadcast_sub", "broadcast_mul",
           "broadcast_maximum", "broadcast_minimum", "broadcast_hypot"):
    CASES[_n] = _binary(_a(2, 3, 4), _a(1, 3, 1))
CASES["broadcast_div"] = _binary(_a(2, 3, 4), _p(1, 3, 1))
CASES["broadcast_mod"] = _binary(_u(-3, 3, 2, 3), _p(2, 3))
CASES["broadcast_power"] = _binary(_p(2, 3), _a(2, 3))
for _n in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "broadcast_logical_and",
           "broadcast_logical_or", "broadcast_logical_xor"):
    CASES[_n] = _binary(_rd(3, 4), _rd(3, 4))
for _n, _s in (("_plus_scalar", 1.5), ("_minus_scalar", 0.5),
               ("_rminus_scalar", 2.0), ("_mul_scalar", -1.5),
               ("_div_scalar", 3.0), ("_maximum_scalar", 0.2),
               ("_minimum_scalar", -0.2), ("_hypot_scalar", 0.7)):
    CASES[_n] = _scalar(_a(3, 4), _s)
CASES["_rdiv_scalar"] = _scalar(_p(3, 4), 2.0)
CASES["_mod_scalar"] = _scalar(_u(-3, 3, 3, 4), 0.7)
CASES["_rmod_scalar"] = _scalar(_p(3, 4), 2.5)
CASES["_power_scalar"] = _scalar(_p(3, 4), 1.7)
CASES["_rpower_scalar"] = _scalar(_a(3, 4), 1.3)
for _n in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
           "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
           "_logical_and_scalar", "_logical_or_scalar",
           "_logical_xor_scalar"):
    CASES[_n] = _scalar(_rd(3, 4), 1.0)
for _n in ("abs", "sign", "square", "exp", "expm1", "sin", "cos", "arctan",
           "sinh", "cosh", "tanh", "arcsinh", "degrees", "radians",
           "sigmoid", "softsign", "relu", "erf", "negative", "identity",
           "BlockGrad", "make_loss", "cbrt", "hard_sigmoid"):
    CASES[_n] = _unary(_a(3, 4))
for _n in ("rint", "round", "ceil", "floor", "trunc", "fix"):
    CASES[_n] = _unary(lambda r: A(r, 3, 4) * 3)
for _n in ("sqrt", "rsqrt", "rcbrt", "log", "log10", "log2", "log1p",
           "gamma", "gammaln", "reciprocal", "digamma"):
    CASES[_n] = _unary(_p(3, 4))
CASES["tan"] = _unary(_u(-1, 1, 3, 4))
for _n in ("arcsin", "arccos", "arctanh", "erfinv"):
    CASES[_n] = _unary(_u(-0.9, 0.9, 3, 4))
CASES["arccosh"] = _unary(_u(1.5, 3, 3, 4))
CASES["logical_not"] = _unary(_rd(3, 4))
CASES["polygamma"] = lambda r: ([P(r, 3, 4)], {"n": 1})
CASES["smooth_l1"] = lambda r: ([A(r, 3, 4)], {"scalar": 1.5})
CASES["clip"] = lambda r: ([A(r, 3, 4)], {"a_min": -0.5, "a_max": 0.5})
CASES["Cast"] = lambda r: ([A(r, 3, 4)], {"dtype": "float16"})
CASES["amp_cast"] = CASES["Cast"]
CASES["sum"] = lambda r: ([A(r, 2, 3, 4)], {"axis": 1})
CASES["mean"] = lambda r: ([A(r, 2, 3, 4)], {"axis": (0, 2),
                                             "keepdims": True})
CASES["prod"] = lambda r: ([P(r, 2, 3)], {"axis": 1})
CASES["max"] = lambda r: ([A(r, 2, 3, 4)], {"axis": 1})
CASES["min"] = lambda r: ([A(r, 2, 3, 4)], {"axis": 0, "exclude": True})


def _with_nan(r, data):
    data = data.copy()
    data[0, 1] = np.nan
    return data


CASES["nansum"] = lambda r: ([_with_nan(r, A(r, 3, 4))], {"axis": 1})
CASES["nanprod"] = lambda r: ([_with_nan(r, P(r, 3, 4))], {"axis": 1})
CASES["norm"] = lambda r: ([A(r, 3, 4)], {"axis": 1})
CASES["argmax"] = lambda r: ([A(r, 3, 4)], {"axis": 1})
CASES["argmin"] = lambda r: ([A(r, 3, 4)], {"axis": 0, "keepdims": True})
CASES["argmax_channel"] = _unary(_a(2, 3, 4))
CASES["dot"] = lambda r: ([A(r, 3, 4), A(r, 5, 4)], {"transpose_b": True})
CASES["batch_dot"] = lambda r: ([A(r, 2, 3, 4), A(r, 2, 4, 5)], {})
CASES["_linalg_gemm2"] = lambda r: ([A(r, 2, 4, 3), A(r, 2, 4, 5)],
                                    {"transpose_a": True, "alpha": 0.5})
CASES["_linalg_gemm"] = lambda r: ([A(r, 3, 4), A(r, 4, 5), A(r, 3, 5)],
                                   {"beta": 0.3})
CASES["_linalg_potrf"] = lambda r: ([SPD(r, 3)], {})
CASES["_linalg_potri"] = lambda r: ([LOW(r, 3)], {})
CASES["_linalg_trsm"] = lambda r: ([LOW(r, 3), A(r, 3, 4)], {"alpha": 2.0})
CASES["_linalg_trmm"] = lambda r: ([LOW(r, 3), A(r, 4, 3)],
                                   {"rightside": True})
CASES["_linalg_syrk"] = lambda r: ([A(r, 3, 4)], {"alpha": 0.5})
CASES["_linalg_sumlogdiag"] = lambda r: ([LOW(r, 3)], {})
CASES["_linalg_extractdiag"] = lambda r: ([A(r, 3, 3)], {"offset": 1})
CASES["_linalg_makediag"] = lambda r: ([A(r, 2, 3)], {"offset": 1})
CASES["_linalg_gelqf"] = lambda r: ([A(r, 3, 5)], {})
CASES["_linalg_syevd"] = lambda r: ([SPD(r, 4)], {})
CASES["Reshape"] = lambda r: ([A(r, 2, 3, 4)], {"shape": (0, -3)})
CASES["reshape_like"] = lambda r: ([A(r, 2, 3, 4), A(r, 6, 4)], {})
CASES["Flatten"] = _unary(_a(2, 3, 4))
CASES["transpose"] = lambda r: ([A(r, 2, 3, 4)], {"axes": (1, 0, 2)})
CASES["SwapAxis"] = lambda r: ([A(r, 2, 3, 4)], {"dim1": 0, "dim2": 2})
CASES["expand_dims"] = lambda r: ([A(r, 2, 3)], {"axis": 1})
CASES["squeeze"] = lambda r: ([A(r, 2, 1, 3)], {"axis": 1})
CASES["broadcast_to"] = lambda r: ([A(r, 1, 3)], {"shape": (2, 3)})
CASES["broadcast_like"] = lambda r: ([A(r, 1, 3), A(r, 4, 3)], {})
CASES["broadcast_axis"] = lambda r: ([A(r, 2, 1, 3)], {"axis": 1,
                                                       "size": 4})
CASES["zeros_like"] = _unary(_a(2, 3))
CASES["ones_like"] = _unary(_a(2, 3))
CASES["shape_array"] = _unary(_a(2, 3))
CASES["size_array"] = _unary(_a(2, 3))
CASES["slice"] = lambda r: ([A(r, 4, 5)], {"begin": (1, 0), "end": (3, 5),
                                           "step": (1, 2)})
CASES["slice_axis"] = lambda r: ([A(r, 4, 5)], {"axis": 1, "begin": 1,
                                                "end": 4})
CASES["slice_like"] = lambda r: ([A(r, 4, 5), A(r, 2, 3)], {})
CASES["Concat"] = lambda r: ([A(r, 2, 3), A(r, 2, 2)], {"dim": 1})
CASES["stack"] = lambda r: ([A(r, 2, 3), A(r, 2, 3)], {"axis": 1})
CASES["add_n"] = lambda r: ([A(r, 2, 3), A(r, 2, 3), A(r, 2, 3)], {})
CASES["SliceChannel"] = lambda r: ([A(r, 2, 6)], {"num_outputs": 3,
                                                  "axis": 1})
CASES["tile"] = lambda r: ([A(r, 2, 3)], {"reps": (2, 1)})
CASES["repeat"] = lambda r: ([A(r, 2, 3)], {"repeats": 2, "axis": 1})
CASES["reverse"] = lambda r: ([A(r, 2, 3)], {"axis": 1})
CASES["Pad"] = lambda r: ([A(r, 1, 2, 3, 4)],
                          {"mode": "reflect",
                           "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)})
CASES["diag"] = lambda r: ([A(r, 3, 4)], {"k": 1})
CASES["depth_to_space"] = lambda r: ([A(r, 1, 8, 2, 3)], {"block_size": 2})
CASES["space_to_depth"] = lambda r: ([A(r, 1, 2, 4, 6)], {"block_size": 2})
CASES["take"] = lambda r: ([A(r, 5, 3), I([0, 4, 2, 7])], {"axis": 0})
CASES["batch_take"] = lambda r: ([A(r, 4, 3), I([0, 2, 1, 2])], {})
CASES["pick"] = lambda r: ([A(r, 4, 5), I([0, 4, 2, 1])], {"axis": 1})
CASES["Embedding"] = lambda r: ([I([[0, 5, 2], [3, 3, 1]]), A(r, 6, 4)],
                                {"input_dim": 6, "output_dim": 4})
CASES["gather_nd"] = lambda r: ([A(r, 3, 4), I([[0, 2], [1, 3]])], {})
CASES["scatter_nd"] = lambda r: ([A(r, 2), I([[0, 2], [1, 3]])],
                                 {"shape": (3, 4)})
CASES["one_hot"] = lambda r: ([I([0, 2, 4, 1])], {"depth": 5,
                                                  "on_value": 2.0})
CASES["where"] = lambda r: ([I([[1, 0, 1], [0, 0, 1]]), A(r, 2, 3),
                             A(r, 2, 3)], {})
CASES["boolean_mask"] = lambda r: ([A(r, 4, 3), I([1, 0, 1, 1])], {})
CASES["sort"] = lambda r: ([A(r, 3, 4)], {"axis": 1, "is_ascend": False})
CASES["argsort"] = lambda r: ([R(r, 3, 5)], {"axis": 1, "is_ascend": False})
CASES["topk"] = lambda r: ([A(r, 3, 5)], {"k": 2, "ret_typ": "both"})
CASES["SequenceMask"] = lambda r: ([A(r, 4, 3, 2), I([2, 4, 1])],
                                   {"use_sequence_length": True,
                                    "value": -1.0})
CASES["SequenceLast"] = lambda r: ([A(r, 4, 3, 2), I([2, 4, 1])],
                                   {"use_sequence_length": True})
CASES["SequenceReverse"] = lambda r: ([A(r, 4, 3, 2), I([2, 4, 1])],
                                      {"use_sequence_length": True})
CASES["_arange_like"] = lambda r: ([A(r, 3, 4)], {"axis": 1, "start": 2.0})
CASES["histogram"] = lambda r: ([A(r, 40)], {"bin_cnt": 5,
                                             "range": (-2.0, 2.0)})
CASES["khatri_rao"] = lambda r: ([A(r, 2, 3), A(r, 4, 3)], {})
CASES["_ravel_multi_index"] = lambda r: ([I([[0, 1, 2], [1, 0, 3]])],
                                         {"shape": (3, 4)})
CASES["_unravel_index"] = lambda r: ([I([0, 5, 11])], {"shape": (3, 4)})
CASES["_square_sum"] = lambda r: ([A(r, 3, 4)], {"axis": 1})
CASES["_split_v2"] = lambda r: ([A(r, 6, 2)],
                                {"indices_or_sections": (2, 5)})
CASES["_arange"] = lambda r: ([], {"start": 1.0, "stop": 7.0, "step": 1.5,
                                   "repeat": 2})
CASES["_eye"] = lambda r: ([], {"N": 3, "M": 4, "k": 1})
CASES["_full"] = lambda r: ([], {"shape": (2, 3), "value": 0.5})
CASES["_zeros"] = lambda r: ([], {"shape": (2, 2)})
CASES["_ones"] = lambda r: ([], {"shape": (2, 3)})
CASES["_slice_assign"] = lambda r: ([A(r, 4, 5), A(r, 2, 2)],
                                    {"begin": (1, 1), "end": (3, 3)})
CASES["_slice_assign_scalar"] = lambda r: ([A(r, 4, 5)],
                                           {"scalar": 2.0, "begin": (0, 1),
                                            "end": (2, 4)})
CASES["_scatter_set_nd"] = lambda r: ([A(r, 3, 4), A(r, 2),
                                       I([[0, 2], [1, 3]])], {})
CASES["_identity_with_attr_like_rhs"] = _binary(_a(2, 3))
CASES["_contrib_bipartite_matching"] = lambda r: (
    [A(r, 2, 3, 4)], {"threshold": -0.5})
# nn
CASES["FullyConnected"] = lambda r: ([A(r, 4, 2, 3), A(r, 5, 6), A(r, 5)],
                                     {"num_hidden": 5})
CASES["Convolution"] = lambda r: ([A(r, 2, 3, 6, 6), A(r, 4, 3, 3, 3),
                                   A(r, 4)],
                                  {"kernel": (3, 3), "num_filter": 4,
                                   "pad": (1, 1), "stride": (2, 1)})
CASES["Deconvolution"] = lambda r: ([A(r, 2, 4, 5, 5), A(r, 4, 1, 3, 3)],
                                    {"kernel": (3, 3), "stride": (2, 2),
                                     "num_filter": 2, "pad": (1, 1),
                                     "adj": (1, 1), "num_group": 2})
CASES["Pooling"] = lambda r: ([A(r, 2, 3, 7, 7)],
                              {"kernel": (3, 3), "stride": (2, 2),
                               "pool_type": "avg", "pad": (1, 1),
                               "pooling_convention": "full",
                               "count_include_pad": False})
CASES["BatchNorm"] = lambda r: ([A(r, 4, 3, 2), P(r, 3), A(r, 3), A(r, 3),
                                 P(r, 3)], {"fix_gamma": False,
                                            "eps": 1e-5})
CASES["LayerNorm"] = lambda r: ([A(r, 3, 4), P(r, 4), A(r, 4)], {})
CASES["InstanceNorm"] = lambda r: ([A(r, 2, 3, 4), P(r, 3), A(r, 3)], {})
CASES["GroupNorm"] = lambda r: ([A(r, 2, 4, 3), P(r, 4), A(r, 4)],
                                {"num_groups": 2})
CASES["L2Normalization"] = _unary(_a(2, 3, 4))
CASES["LRN"] = lambda r: ([A(r, 2, 5, 3, 3)], {"nsize": 3})
CASES["Activation"] = lambda r: ([A(r, 3, 4)], {"act_type": "softrelu"})
CASES["LeakyReLU"] = lambda r: ([A(r, 2, 3, 4), P(r, 3)],
                                {"act_type": "prelu"})
CASES["softmax"] = lambda r: ([A(r, 3, 4)], {"temperature": 2.0})
CASES["log_softmax"] = lambda r: ([A(r, 3, 4)], {"axis": 0})
CASES["softmin"] = _unary(_a(3, 4))
CASES["SoftmaxActivation"] = lambda r: ([A(r, 2, 3, 4)], {"mode": "channel"})
CASES["softmax_cross_entropy"] = lambda r: ([A(r, 4, 5), I([0, 4, 2, 1])],
                                            {})
CASES["SoftmaxOutput"] = lambda r: ([A(r, 4, 5), I([0, 4, 2, 1])],
                                    {"grad_scale": 2.0,
                                     "normalization": "batch"})
for _n in ("LinearRegressionOutput", "LogisticRegressionOutput",
           "MAERegressionOutput"):
    CASES[_n] = lambda r: ([A(r, 4, 3), A(r, 4, 3)], {"grad_scale": 0.5})
CASES["UpSampling"] = lambda r: ([A(r, 1, 2, 3, 3)],
                                 {"scale": 2, "sample_type": "nearest"})
CASES["im2col"] = lambda r: ([A(r, 1, 2, 5, 5)],
                             {"kernel": (3, 3), "stride": (2, 2),
                              "pad": (1, 1)})
CASES["col2im"] = lambda r: ([A(r, 1, 18, 9)],
                             {"output_size": (5, 5), "kernel": (3, 3),
                              "stride": (2, 2), "pad": (1, 1)})
CASES["SVMOutput"] = lambda r: ([A(r, 4, 5), I([0, 4, 2, 1])],
                                {"margin": 0.5})


def _rnn_case(mode, layers, bidirectional, state_batch, **attrs):
    """The fused RNN op over T 4, B 2, I 3, H 4: data, packed parameters
    (scaled 0.3), the initial state (and cell), with `attrs`."""
    def case(r):
        d = 2 if bidirectional else 1
        n = rnn_param_size(layers, 3, 4, bidirectional, mode)
        states = [A(r, layers * d, state_batch, 4)
                  for _ in range(2 if mode == "lstm" else 1)]
        return ([A(r, 4, 2, 3), 0.3 * A(r, n)] + states,
                dict(state_size=4, num_layers=layers, mode=mode,
                     bidirectional=bidirectional, **attrs))
    return case


CASES["RNN"] = _rnn_case("lstm", 2, True, 2, state_outputs=True)
CASES["CTCLoss"] = lambda r: ([2 * A(r, 6, 3, 5),
                               I([[1, 2, 0], [3, 3, 1], [4, 0, 0]])], {})

# the optimizer updates (ops/optimizer.py): weight, gradient and states of
# (3, 4); positive second moments; rescale, clip and weight decay on
_OPT = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}


def _opt_case(*inputs, **attrs):
    """An update's case: `inputs` drawn in order; `attrs` over _OPT, an
    attribute given as None left out (the multi-tensor ops take lrs and
    wds)."""
    merged = {k: v for k, v in {**_OPT, **attrs}.items() if v is not None}
    return lambda r: ([f(r) for f in inputs], dict(merged))


_W, _PW = _a(3, 4), _p(3, 4)
CASES["sgd_update"] = _opt_case(_W, _W, clip_gradient=0.4)
CASES["sgd_mom_update"] = _opt_case(_W, _W, _W, momentum=0.9,
                                    clip_gradient=0.4)
CASES["nag_mom_update"] = _opt_case(_W, _W, _W, momentum=0.9)
CASES["adam_update"] = _opt_case(_W, _W, _W, _PW, clip_gradient=0.4)
CASES["rmsprop_update"] = _opt_case(_W, _W, _PW, gamma1=0.9,
                                    clip_weights=0.8)
CASES["rmspropalex_update"] = _opt_case(
    _W, _W, _p(3, 4), lambda r: 0.1 * A(r, 3, 4), _W, gamma1=0.9,
    gamma2=0.8)
CASES["ftrl_update"] = _opt_case(_W, _W, _W, _PW, lamda1=0.05, beta=1.5)
CASES["signsgd_update"] = _opt_case(_W, _W)
CASES["signum_update"] = _opt_case(_W, _W, _W, momentum=0.9, wd_lh=0.01)
CASES["ftml_update"] = _opt_case(_W, _W, _PW, _PW, _W, t=2,
                                 clip_grad=0.4)
CASES["adamw_update"] = _opt_case(_W, _W, _W, _PW, eta=0.7)
CASES["multi_sgd_update"] = _opt_case(
    _W, _W, _a(5), _a(5), lrs=(0.1, 0.05), wds=(0.01, 0.0), num_weights=2,
    lr=None, wd=None)
CASES["multi_sgd_mom_update"] = _opt_case(
    _W, _W, _W, _a(5), _a(5), _a(5), lrs=(0.1, 0.05), wds=(0.01, 0.0),
    num_weights=2, momentum=0.9, lr=None, wd=None)
CASES["multi_mp_sgd_update"] = _opt_case(
    _W, _W, _W, _a(5), _a(5), _a(5), lrs=(0.1, 0.05), wds=(0.01, 0.0),
    num_weights=2, lr=None, wd=None)
CASES["multi_mp_sgd_mom_update"] = _opt_case(
    _W, _W, _W, _W, _a(5), _a(5), _a(5), _a(5), lrs=(0.1, 0.05),
    wds=(0.01, 0.0), num_weights=2, momentum=0.9, lr=None, wd=None)
CASES["mp_sgd_update"] = _opt_case(_W, _W, _W, clip_gradient=0.4)
CASES["mp_sgd_mom_update"] = _opt_case(_W, _W, _W, _W, momentum=0.9)
CASES["_adamw_update"] = lambda r: (
    [A(r, 3, 4), A(r, 3, 4), A(r, 3, 4), P(r, 3, 4), I([0.5])],
    {"lr": 0.1, "wd": 0.01, "eta": 0.7, "clip_gradient": 0.4})
CASES["_mp_adamw_update"] = lambda r: (
    [A(r, 3, 4), A(r, 3, 4), A(r, 3, 4), P(r, 3, 4), A(r, 3, 4), I([0.5])],
    {"lr": 0.1, "wd": 0.01})
CASES["_contrib_group_adagrad_update"] = lambda r: (
    [A(r, 3, 4), A(r, 3, 4), P(r, 3, 1)], {"lr": 0.1, "rescale_grad": 0.5})



# -- ops/vision.py and ops/contrib_ops.py -----------------------------------


def BOX(rng, *lead, lo=0.0, hi=10.0, size=(1.0, 5.0)):
    """Corner boxes (..., 4): x1, y1 in [lo, hi), sides in `size`."""
    xy = rng.uniform(lo, hi, lead + (2,))
    wh = rng.uniform(size[0], size[1], lead + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def DETS(rng, n, ids=3, ties=False):
    """(1, n, 6) detection rows [id, score, x1, y1, x2, y2] over a small
    area (many overlaps); `ties` draws the scores from 4 values."""
    ident = rng.randint(0, ids, (1, n, 1)).astype(np.float32)
    score = (rng.randint(0, 4, (1, n, 1)) * 0.25 + 0.1 if ties
             else rng.uniform(0, 1, (1, n, 1)))
    return np.concatenate([ident, score.astype(np.float32),
                           BOX(rng, 1, n, hi=6.0, size=(2.0, 5.0))], -1)


def ROIS(rng, r, batch, extent):
    """(r, 5) rows [batch index, x1, y1, x2, y2] inside `extent` (h, w)."""
    b = rng.randint(0, batch, (r, 1)).astype(np.float32)
    h, w = extent
    x1 = rng.uniform(-1, w * 0.6, (r, 1))
    y1 = rng.uniform(-1, h * 0.6, (r, 1))
    x2 = x1 + rng.uniform(1, w * 0.5, (r, 1))
    y2 = y1 + rng.uniform(1, h * 0.5, (r, 1))
    return np.concatenate([b, x1, y1, x2, y2], 1).astype(np.float32)


def PRIOR_ANCHORS(rng, n):
    """(1, n, 4) normalized corner anchors."""
    return BOX(rng, 1, n, lo=0.0, hi=0.7, size=(0.1, 0.3))


def GT_LABELS(rng, b, m):
    """(b, m, 5) rows [cls, x1, y1, x2, y2], the last row padding."""
    cls = rng.randint(0, 3, (b, m, 1)).astype(np.float32)
    lab = np.concatenate([cls, BOX(rng, b, m, lo=0.0, hi=0.7,
                                   size=(0.1, 0.3))], -1)
    lab[:, -1] = -1.0
    return lab


def RPN(rng, a, h, w):
    """Proposal inputs: cls_prob (1, 2a, h, w) of foreground scores in
    the second half, deltas (1, 4a, h, w), im_info [[8h, 8w, 1]]."""
    prob = U(rng, 0, 1, 1, 2 * a, h, w)
    return [prob, 0.3 * A(rng, 1, 4 * a, h, w),
            I([[8.0 * h, 8.0 * w, 1.0]])]


def _proposal_case(**attrs):
    base = dict(scales=(2, 4), ratios=(0.5, 1, 2), feature_stride=8,
                rpn_pre_nms_top_n=50, rpn_post_nms_top_n=10,
                threshold=0.7, rpn_min_size=4)
    base.update(attrs)
    return lambda r: (RPN(r, 6, 4, 4), base)


CASES["_contrib_box_iou"] = lambda r: ([BOX(r, 2, 3), BOX(r, 5)], {})
CASES["_contrib_box_nms"] = lambda r: ([DETS(r, 20)],
                                       {"overlap_thresh": 0.5})
CASES["_contrib_box_encode"] = lambda r: (
    [I(np.where(r.rand(2, 6) > 0.4, 1.0, -1.0)),
     I(r.randint(0, 3, (2, 6))), BOX(r, 2, 6), BOX(r, 2, 3)], {})
CASES["_contrib_box_decode"] = lambda r: ([0.5 * A(r, 2, 6, 4),
                                           BOX(r, 1, 6)], {})
CASES["_contrib_MultiBoxPrior"] = lambda r: (
    [A(r, 1, 3, 4, 5)], {"sizes": (0.5, 0.25), "ratios": (1.0, 2.0, 0.5)})
CASES["_contrib_MultiBoxTarget"] = lambda r: (
    [PRIOR_ANCHORS(r, 12), GT_LABELS(r, 2, 3), A(r, 2, 4, 12)], {})
CASES["_contrib_MultiBoxDetection"] = lambda r: (
    [U(r, 0, 1, 2, 4, 12), 0.3 * A(r, 2, 48), PRIOR_ANCHORS(r, 12)],
    {"nms_threshold": 0.4})
CASES["ROIPooling"] = lambda r: ([R(r, 2, 3, 8, 10), ROIS(r, 5, 2, (16, 20))],
                                 {"pooled_size": (3, 2),
                                  "spatial_scale": 0.5})
CASES["Crop"] = lambda r: ([A(r, 2, 3, 6, 7)], {"h_w": (3, 4),
                                                "offset": (1, 2)})
CASES["_contrib_PSROIPooling"] = lambda r: (
    [A(r, 2, 8, 6, 6), ROIS(r, 3, 2, (12, 12))],
    {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 2})
CASES["_contrib_DeformablePSROIPooling"] = lambda r: (
    [A(r, 2, 8, 6, 6), ROIS(r, 3, 2, (12, 12)), A(r, 3, 2, 2, 2)],
    {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 2,
     "part_size": 2, "sample_per_part": 2, "trans_std": 0.1})
CASES["_contrib_ROIAlign"] = lambda r: (
    [A(r, 2, 3, 8, 10), ROIS(r, 5, 2, (16, 20))],
    {"pooled_size": (3, 3), "spatial_scale": 0.5, "sample_ratio": 2})
CASES["BilinearSampler"] = lambda r: ([A(r, 2, 3, 5, 6),
                                       U(r, -1.1, 1.1, 2, 2, 4, 4)], {})
CASES["GridGenerator"] = lambda r: ([A(r, 2, 6)], {"target_shape": (3, 4)})
CASES["SpatialTransformer"] = lambda r: (
    [A(r, 2, 3, 5, 6), I([[1, 0, 0, 0, 1, 0]]) + 0.2 * A(r, 2, 6)],
    {"target_shape": (4, 4)})
CASES["Correlation"] = lambda r: ([A(r, 1, 3, 6, 6), A(r, 1, 3, 6, 6)],
                                  {"max_displacement": 1})
CASES["_contrib_BilinearResize2D"] = lambda r: (
    [A(r, 1, 2, 4, 5)], {"height": 7, "width": 3})
CASES["_contrib_AdaptiveAvgPooling2D"] = lambda r: (
    [A(r, 1, 2, 5, 7)], {"output_size": (2, 3)})
CASES["_contrib_DeformableConvolution"] = lambda r: (
    [A(r, 1, 4, 5, 5), 0.7 * A(r, 1, 36, 5, 5), 0.3 * A(r, 4, 2, 3, 3),
     A(r, 4)],
    {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1), "num_group": 2,
     "num_deformable_group": 2})
CASES["_contrib_Proposal"] = _proposal_case()
CASES["_image_to_tensor"] = lambda r: ([U(r, 0, 255, 4, 5, 3)], {})
CASES["_image_normalize"] = lambda r: ([A(r, 3, 4, 5)],
                                       {"mean": (0.1, 0.2, 0.3),
                                        "std": (1.0, 2.0, 0.5)})
CASES["_image_resize"] = lambda r: ([A(r, 6, 8, 3)], {"size": (4, 3)})
CASES["_contrib_fft"] = _unary(_a(3, 8))
CASES["_contrib_ifft"] = _unary(_a(3, 16))
CASES["_contrib_count_sketch"] = lambda r: (
    [A(r, 4, 6), I(r.randint(0, 5, 6)), I(np.where(r.rand(6) > 0.5, 1, -1))],
    {"out_dim": 5})
CASES["_contrib_quadratic"] = lambda r: ([A(r, 3, 4)],
                                         {"a": 0.5, "b": -1.0, "c": 2.0})
CASES["_contrib_hawkesll"] = lambda r: (
    [P(r, 2, 3), U(r, 0.1, 0.5, 3), P(r, 3), 0.1 * P(r, 2, 3), P(r, 2, 5),
     I(r.randint(0, 3, (2, 5))), I([5, 3])], {})
CASES["_contrib_SyncBatchNorm"] = lambda r: (
    [A(r, 4, 3, 2), P(r, 3), A(r, 3), A(r, 3), P(r, 3)],
    {"fix_gamma": False, "eps": 1e-5})
CASES["_contrib_div_sqrt_dim"] = _unary(_a(3, 4))
CASES["_contrib_gradientmultiplier"] = lambda r: ([A(r, 3, 4)],
                                                  {"scalar": -0.5})
CASES["_contrib_index_copy"] = lambda r: ([A(r, 5, 3), I([3, 0]),
                                           A(r, 2, 3)], {})
CASES["_contrib_getnnz"] = _unary(_rd(3, 4))
CASES["IdentityAttachKLSparseReg"] = lambda r: (
    [A(r, 4, 3)], {"sparseness_target": 0.2, "penalty": 0.01})

# the quantized family (ops/quantized.py): int8 codes, int32 biases and
# accumulators, float32 ranges of shape (1,) as the reference passes them
CASES["_contrib_quantized_conv"] = lambda r: (
    [Q8(r, 2, 3, 7, 7), Q8(r, 4, 3, 3, 3), Q32(r, 4)],
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 4,
     "no_bias": False})
CASES["_contrib_quantized_fully_connected"] = lambda r: (
    [Q8(r, 3, 2, 5), Q8(r, 4, 10), Q32(r, 4)],
    {"num_hidden": 4, "no_bias": False})
CASES["_contrib_quantized_pooling"] = lambda r: (
    [Q8(r, 2, 3, 7, 7)], {"kernel": (3, 3), "stride": (2, 2),
                          "pad": (1, 1), "pool_type": "max"})
CASES["_contrib_quantize"] = lambda r: ([A(r, 3, 4), I([-1.5]), I([2.0])],
                                        {})
CASES["_contrib_quantize_v2"] = _unary(_a(3, 4))
CASES["_contrib_dequantize"] = lambda r: ([Q8(r, 3, 4), I([-1.5]),
                                           I([2.0])], {})
CASES["_contrib_requantize"] = lambda r: (
    [Q32(r, 3, 4, hi=2 ** 30), I([-3.0]), I([4.0])], {})
CASES["_contrib_quantized_flatten"] = lambda r: (
    [Q8(r, 2, 3, 2, 2), I([-1.0]), I([1.0])], {})
CASES["_contrib_quantized_concat"] = lambda r: (
    [Q8(r, 2, 3), Q8(r, 2, 2), I([-1.0]), I([-2.0]), I([1.5]), I([0.5])],
    {"num_args": 2, "dim": 1})

# the modes of the vision, contrib and quantized ops beside their one
# case each
FAMILY_EXTRA = [
    ("_contrib_box_iou", lambda r: ([BOX(r, 4), BOX(r, 3)],
                                    {"format": "center"})),
    ("_contrib_box_nms", lambda r: ([DETS(r, 24)],
                                    {"overlap_thresh": 0.3, "id_index": 0,
                                     "topk": 10, "valid_thresh": 0.2})),
    ("_contrib_box_nms", lambda r: ([DETS(r, 24)],
                                    {"id_index": 0, "background_id": 1,
                                     "out_format": "center"})),
    ("_contrib_box_nms", lambda r: ([DETS(r, 32, ties=True)],
                                    {"overlap_thresh": 0.4, "id_index": 0,
                                     "force_suppress": True})),
    ("_contrib_box_decode", lambda r: ([0.5 * A(r, 2, 6, 4), BOX(r, 1, 6)],
                                       {"clip": 5.0, "format": "center"})),
    ("_contrib_MultiBoxPrior", lambda r: (
        [A(r, 1, 3, 3, 4)], {"sizes": (0.6,), "ratios": (1.0, 3.0),
                             "clip": True, "steps": (0.3, 0.25),
                             "offsets": (0.2, 0.7)})),
    ("_contrib_MultiBoxTarget", lambda r: (
        [PRIOR_ANCHORS(r, 12), GT_LABELS(r, 2, 3), A(r, 2, 4, 12)],
        {"negative_mining_ratio": 2.0, "negative_mining_thresh": 0.3,
         "overlap_threshold": 0.3, "minimum_negative_samples": 1})),
    ("_contrib_MultiBoxDetection", lambda r: (
        [U(r, 0, 1, 2, 4, 12), 0.3 * A(r, 2, 48), PRIOR_ANCHORS(r, 12)],
        {"force_suppress": True, "nms_topk": 5, "clip": False,
         "threshold": 0.3})),
    ("ROIPooling", lambda r: ([A(r, 2, 3, 8, 10), ROIS(r, 5, 2, (16, 20))],
                              {"pooled_size": 3, "spatial_scale": 0.5})),
    ("Crop", lambda r: ([A(r, 2, 3, 6, 7), A(r, 1, 1, 4, 3)],
                        {"num_args": 2, "center_crop": True})),
    ("_contrib_DeformablePSROIPooling", lambda r: (
        [A(r, 2, 8, 6, 6), ROIS(r, 3, 2, (12, 12))],
        {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 2,
         "sample_per_part": 3, "no_trans": True})),
    ("_contrib_ROIAlign", lambda r: (
        [A(r, 2, 3, 8, 10), ROIS(r, 5, 2, (16, 20))],
        {"pooled_size": (2, 3), "spatial_scale": 0.5, "aligned": True})),
    ("_contrib_ROIAlign", lambda r: (
        [A(r, 2, 8, 8, 10), ROIS(r, 4, 2, (16, 20))],
        {"pooled_size": 2, "spatial_scale": 0.5, "sample_ratio": 3,
         "position_sensitive": True})),
    ("GridGenerator", lambda r: ([A(r, 2, 2, 3, 4)],
                                 {"transform_type": "warp"})),
    ("Correlation", lambda r: ([A(r, 1, 3, 6, 6), A(r, 1, 3, 6, 6)],
                               {"kernel_size": 3, "max_displacement": 2,
                                "stride2": 2, "pad_size": 2,
                                "is_multiply": False})),
    ("_contrib_Proposal", _proposal_case(output_score=True,
                                         rpn_pre_nms_top_n=-1,
                                         rpn_post_nms_top_n=30)),
    ("_contrib_Proposal", _proposal_case(rpn_pre_nms_top_n=8,
                                         rpn_post_nms_top_n=12,
                                         threshold=0.3)),
    ("_image_to_tensor", lambda r: ([U(r, 0, 255, 2, 4, 5, 3)], {})),
    ("_image_resize", lambda r: ([A(r, 2, 4, 6, 3)],
                                 {"size": 9, "keep_ratio": True})),
    ("_image_resize", lambda r: ([A(r, 6, 8, 3)], {"size": (5, 9),
                                                   "interp": 0})),
    ("_contrib_getnnz", lambda r: ([R(r, 3, 4)], {"axis": 1})),
    ("_contrib_SyncBatchNorm", lambda r: (
        [A(r, 4, 3, 2), P(r, 3), A(r, 3), A(r, 3), P(r, 3)],
        {"use_global_stats": True})),
    # grouped with dilation, depthwise with a channel multiplier, 1-D
    ("_contrib_quantized_conv", lambda r: (
        [Q8(r, 2, 4, 7, 7), Q8(r, 6, 2, 3, 3)],
        {"kernel": (3, 3), "dilate": (2, 2), "num_filter": 6,
         "num_group": 2})),
    ("_contrib_quantized_conv", lambda r: (
        [Q8(r, 2, 4, 6, 6), Q8(r, 8, 1, 3, 3), Q32(r, 8)],
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 8,
         "num_group": 4, "no_bias": False})),
    ("_contrib_quantized_conv", lambda r: (
        [Q8(r, 2, 3, 9), Q8(r, 5, 3, 3)],
        {"kernel": (3,), "stride": (2,), "num_filter": 5})),
    ("_contrib_quantized_fully_connected", lambda r: (
        [Q8(r, 2, 3, 5), Q8(r, 4, 5)], {"num_hidden": 4, "flatten": False})),
    # avg windows of 6 (even, not a power of two: .5 ties), 'full'
    # convention, global
    ("_contrib_quantized_pooling", lambda r: (
        [Q8(r, 2, 3, 6, 9)], {"kernel": (2, 3), "stride": (2, 3),
                              "pool_type": "avg"})),
    ("_contrib_quantized_pooling", lambda r: (
        [Q8(r, 2, 3, 8, 8)], {"kernel": (3, 3), "stride": (2, 2),
                              "pool_type": "avg",
                              "pooling_convention": "full"})),
    ("_contrib_quantized_pooling", lambda r: (
        [Q8(r, 2, 3, 7, 7)], {"kernel": (3, 3), "stride": (2, 2),
                              "pool_type": "max",
                              "pooling_convention": "full"})),
    ("_contrib_quantized_pooling", lambda r: (
        [Q8(r, 2, 3, 5, 5)], {"global_pool": True, "pool_type": "avg"})),
    ("_contrib_quantize_v2", lambda r: (
        [A(r, 3, 4)], {"min_calib_range": -0.5, "max_calib_range": 1.0})),
    ("_contrib_requantize", lambda r: (
        [Q32(r, 3, 4, hi=2 ** 30), I([-3.0]), I([4.0])],
        {"min_calib_range": -2.0, "max_calib_range": 2.0})),
]

# an alias whose case differs from its op's (a second path of the op)
NAME_CASES = {
    "pad": lambda r: ([A(r, 1, 2, 3, 4)],
                      {"mode": "constant", "constant_value": 0.5,
                       "pad_width": (0, 0, 1, 0, 1, 1, 0, 2)}),
    "flip": lambda r: ([A(r, 2, 3, 4)], {"axis": (0, 2)}),
    "crop": lambda r: ([A(r, 4, 5)], {"begin": (3, None), "end": (0, None),
                                      "step": (-1, None)}),
    "Pooling_v1": lambda r: ([A(r, 2, 3, 7, 7)],
                             {"kernel": (3, 3), "stride": (2, 2),
                              "pool_type": "max",
                              "pooling_convention": "full"}),
    "Softmax": lambda r: ([A(r, 2, 3, 4), I([[0, 1, 2, 3], [3, 2, 1, 0]])],
                          {"multi_output": True, "use_ignore": True,
                           "ignore_label": 3, "normalization": "valid"}),
    "flatten": lambda r: ([A(r, 2, 3, 4, 1)], {}),
    "split": lambda r: ([A(r, 2, 6)], {"num_outputs": 2, "axis": 1,
                                       "squeeze_axis": False}),
    "eye": lambda r: ([], {"N": 3}),
    "arange": lambda r: ([], {"start": 5.0}),
    "ctc_loss": lambda r: ([2 * A(r, 6, 3, 5),
                            I([[0, 1, -1], [2, 2, 0], [3, -1, -1]]),
                            I([6, 4, 5]), I([2, 3, 1])],
                           {"use_data_lengths": True,
                            "use_label_lengths": True,
                            "blank_label": "last"}),
}
# extra cases of ops with several modes, beside the one per name
EXTRA = [
    ("LeakyReLU", lambda r: ([A(r, 3, 4)], {"act_type": "leaky",
                                            "slope": 0.1})),
    ("LeakyReLU", lambda r: ([A(r, 3, 4)], {"act_type": "elu"})),
    ("LeakyReLU", lambda r: ([A(r, 3, 4)], {"act_type": "selu"})),
    ("LeakyReLU", lambda r: ([A(r, 3, 4)], {"act_type": "gelu"})),
    ("UpSampling", lambda r: ([A(r, 1, 2, 3, 3)],
                              {"scale": 2, "sample_type": "bilinear"})),
    ("Pooling", lambda r: ([A(r, 2, 3, 6, 6)], {"kernel": (2, 2),
                                                "stride": (2, 2),
                                                "pool_type": "sum"})),
    ("Pooling", lambda r: ([A(r, 2, 3, 6, 6)], {"kernel": (2, 2),
                                                "stride": (2, 2),
                                                "pool_type": "lp",
                                                "p_value": 2})),
    ("Pooling", lambda r: ([A(r, 1, 4, 4, 2)], {"kernel": (2, 2),
                                                "pool_type": "max",
                                                "layout": "NHWC",
                                                "global_pool": True})),
    ("softmax", lambda r: ([A(r, 3, 4), I([2, 4, 0])], {"use_length": True})),
    ("Convolution", lambda r: ([A(r, 2, 5, 5, 4), A(r, 6, 2, 3, 3)],
                               {"kernel": (3, 3), "num_filter": 6,
                                "num_group": 2, "no_bias": True,
                                "layout": "NHWC"})),
    ("LayerNorm", lambda r: ([A(r, 3, 4), P(r, 4), A(r, 4)],
                             {"output_mean_var": True})),
    ("SequenceReverse", lambda r: ([A(r, 4, 3)], {})),
    ("RNN", _rnn_case("gru", 1, False, 2)),
    ("RNN", _rnn_case("rnn_tanh", 2, False, 1, state_outputs=True)),
    ("RNN", _rnn_case("rnn_relu", 1, True, 2, state_outputs=True)),
    ("RNN", _rnn_case("lstm", 1, False, 2, state_outputs=True,
                      lstm_state_clip_min=-0.3, lstm_state_clip_max=0.4)),
    ("CTCLoss", lambda r: ([2 * A(r, 6, 3, 5),
                            I([[1, 2, 0], [3, 3, 1], [4, 4, 4]]),
                            I([6, 3, 5])], {"use_data_lengths": True})),
    ("topk", lambda r: ([A(r, 3, 6)], {"k": 3, "is_ascend": True})),
]

EXTRA += FAMILY_EXTRA

# ops whose gradient is not compared: the sign of each eigenvector is a
# convention of the LAPACK call (the values are compared up to it)
NO_GRAD = {"_linalg_syevd"}


def _random_name(name):
    """An op that draws (LeakyReLU draws in one mode and RNN only with
    dropout: their cases are deterministic)."""
    op = OP_REGISTRY[name]
    return op.needs_rng and op.name not in ("LeakyReLU", "RNN")


ALL_NAMES = sorted(OP_REGISTRY)
# the registry's families by the port's module: `vision`, `contrib` and
# `quantized` (ops/vision.py, ops/contrib_ops.py, ops/quantized.py) have
# test files of their own
FAMILY = {n: {"vision": "vision", "contrib_ops": "contrib",
              "quantized": "quantized"}.get(
    OP_REGISTRY[n].fn.__module__.rsplit(".", 1)[1], "core")
    for n in ALL_NAMES}
DETERMINISTIC = [n for n in ALL_NAMES if not _random_name(n)]
RANDOM = [n for n in ALL_NAMES if _random_name(n)]


def _case_of(name):
    if name in NAME_CASES:
        return NAME_CASES[name]
    return CASES.get(OP_REGISTRY[name].name)


def _key(name):
    """The JAX result a name is held to: an alias without a case of its
    own shares its op's (the same function on the same inputs)."""
    return f"name:{name if name in NAME_CASES else OP_REGISTRY[name].name}"


# key -> (name, case, seed): one per op (and per alias with a case of its
# own), then the extra modes
_ALL_CASES = {_key(n): (n if n in NAME_CASES else OP_REGISTRY[n].name,
                        _case_of(n), 0)
              for n in DETERMINISTIC if _case_of(n) is not None}
_ALL_CASES.update({f"extra:{k}": (name, fn, 10 + k)
                   for k, (name, fn) in enumerate(EXTRA)})
# names that nd's creation functions shadow, as in the JAX package
_SHADOWED = {"full", "arange", "eye"}


def _heads(shapes, seed):
    hr = np.random.RandomState(seed)
    return [np.asarray(hr.randn(*shape), dtype) for shape, dtype in shapes]


def _diff(name, inputs):
    """Positions of the float inputs that are differentiated: all but
    integer-like ones (`no_grad_inputs`: indices, masks, labels)."""
    op = OP_REGISTRY[name]
    skip = ({op.inputs.index(n) for n in op.no_grad_inputs}
            if not op.variadic else set())
    return [i for i, a in enumerate(inputs)
            if a.dtype == np.float32 and i not in skip]


def _port(name, inputs, attrs, seed, grad, ctx=CPU):
    """(values, gradients, inputs after the call) of the port's
    nd.<name> over `inputs` on `ctx`, in training mode under record()."""
    arrays = [tnd.array(a, ctx=ctx) for a in inputs]
    diff = [arrays[i] for i in _diff(name, inputs)]
    for a in diff:
        a.attach_grad()
    kw = dict(attrs)
    if not inputs:
        kw["ctx"] = ctx
    with tag.record():
        if name in _SHADOWED:
            out = tnd.register.invoke_by_name(name, arrays, kw)
        else:
            out = getattr(tnd, name)(*arrays, **kw)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [o.asnumpy() for o in outs]
    grads = None
    if grad and diff and all(o.dtype in (np.float32, np.float16)
                             for o in outs):
        heads = _heads([(o.shape, o.dtype) for o in outs], seed)
        tag.backward(outs, [tnd.array(h, ctx=ctx) for h in heads])
        grads = [a.grad.asnumpy() for a in diff]
    return values, grads, [a.asnumpy() for a in arrays]



def _rows_signed(u):
    """Eigenvector rows with their largest-magnitude entry positive (the
    sign of each is the LAPACK call's convention)."""
    u = np.array(u)
    pick = np.take_along_axis(u, np.abs(u).argmax(-1)[..., None], -1)
    return u * np.sign(pick)



def _zipf(range_max, n=1_000_000):
    u = np.random.RandomState(0).uniform(size=n)
    cls = np.floor(np.exp(u * np.log(range_max + 1.0)) - 1.0)
    return np.clip(cls, 0, range_max - 1)


def _multinomial(p):
    k = np.arange(len(p))
    mean = float((k * p).sum())
    return mean, float(np.sqrt(((k - mean) ** 2 * p).sum()))


# sampler -> (inputs, attrs, [(mean, std) of each row's distribution])
RANDOM_CASES = {
    "_random_uniform": ([], {"low": -1.0, "high": 3.0},
                        [(1.0, 4 / np.sqrt(12))]),
    "_random_normal": ([], {"loc": 1.0, "scale": 2.0}, [(1.0, 2.0)]),
    "_random_gamma": ([], {"alpha": 2.0, "beta": 1.5},
                      [(3.0, np.sqrt(2) * 1.5)]),
    "_random_exponential": ([], {"lam": 2.0}, [(0.5, 0.5)]),
    "_random_poisson": ([], {"lam": 3.0}, [(3.0, np.sqrt(3))]),
    "_random_negative_binomial": ([], {"k": 3, "p": 0.4},
                                  [(4.5, np.sqrt(11.25))]),
    "_random_generalized_negative_binomial": ([], {"mu": 2.0, "alpha": 0.5},
                                              [(2.0, 2.0)]),
    "_random_randint": ([], {"low": -3, "high": 7},
                        [(1.5, np.sqrt(99 / 12))]),
    "_random_bernoulli": ([], {"p": 0.3}, [(0.3, np.sqrt(0.21))]),
    "_sample_unique_zipfian": ([], {"range_max": 50},
                               [(_zipf(50).mean(), _zipf(50).std())]),
    "_sample_uniform": ([I([0.0, 2.0]), I([1.0, 5.0])], {},
                        [(0.5, 1 / np.sqrt(12)), (3.5, 3 / np.sqrt(12))]),
    "_sample_normal": ([I([0.0, 3.0]), I([1.0, 0.5])], {},
                       [(0.0, 1.0), (3.0, 0.5)]),
    "_sample_gamma": ([I([1.0, 3.0]), I([2.0, 0.5])], {},
                      [(2.0, 2.0), (1.5, np.sqrt(3) * 0.5)]),
    "_sample_exponential": ([I([1.0, 4.0])], {}, [(1.0, 1.0), (0.25, 0.25)]),
    "_sample_poisson": ([I([1.0, 6.0])], {}, [(1.0, 1.0), (6.0, np.sqrt(6))]),
    "_sample_negative_binomial": ([I([2.0, 5.0]), I([0.3, 0.6])], {},
                                  [(2 * 0.7 / 0.3, np.sqrt(2 * 0.7) / 0.3),
                                   (5 * 0.4 / 0.6, np.sqrt(5 * 0.4) / 0.6)]),
    "_sample_generalized_negative_binomial": (
        [I([2.0, 4.0]), I([0.5, 0.2])], {},
        [(2.0, np.sqrt(2 + 0.5 * 4)), (4.0, np.sqrt(4 + 0.2 * 16))]),
    "_sample_multinomial": ([I([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]])], {},
                            [_multinomial(np.array([0.1, 0.2, 0.7])),
                             _multinomial(np.array([0.5, 0.25, 0.25]))]),
}
N_DRAWS = 4000


def sample_moments(name, ctx=CPU):
    """Draw with sampler `name` on `ctx` and check its moments (see
    `test_sampling_op_moments_match_the_distribution`); returns the
    largest |mean - want| in standard errors."""
    op = OP_REGISTRY[name].name
    if op == "_shuffle":
        x = np.arange(50, dtype=np.float32)
        got = getattr(tnd, name)(tnd.array(x, ctx=ctx)).asnumpy()
        assert sorted(got) == list(x) and not np.array_equal(got, x), name
        return 0.0
    if op == "Dropout":
        with tag.record():
            out = getattr(tnd, name)(tnd.ones((N_DRAWS,), ctx=ctx), p=0.3)
        o = out.asnumpy()
        assert set(np.unique(o)) <= {0.0, np.float32(1 / 0.7)}, name
        se = np.sqrt(0.21 / N_DRAWS)
        z = abs((o == 0).mean() - 0.3) / se
        assert z < 6, (name, z)
        return float(z)
    inputs, attrs, want = RANDOM_CASES[op]
    got = getattr(tnd, name)(*[tnd.array(a, ctx=ctx) for a in inputs],
                             shape=(N_DRAWS,), **attrs,
                             **({} if inputs else {"ctx": ctx})).asnumpy()
    rows = got.reshape(len(want), N_DRAWS).astype(np.float64)
    worst = 0.0
    for row, (mean, std) in zip(rows, want):
        z = abs(row.mean() - mean) / (std / np.sqrt(N_DRAWS))
        assert z <= 6, (name, row.mean(), mean)
        assert abs(row.std() - std) <= 0.1 * std, (name, row.std(), std)
        worst = max(worst, float(z))
    return worst
