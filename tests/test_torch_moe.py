"""Mixture-of-experts FFN of the PyTorch port against the JAX package
(CPU).

`moe_dispatch` and `moe_ffn` against the JAX functions, dropped tokens
included (capacity_factor 0.5): dispatch tensors equal, combine, outputs
and the balance loss at 1e-5, gradients at rtol 1e-4 / atol 1e-5. Then
the transformer with `n_experts`: `init_params` bit-identical, `apply`
logits and aux at 1e-4, and every decoding path (`decode_step`,
`prefill`, `decode_step_paged`, `prefill_paged`,
`decode_step_paged_wide`) at 1e-4, the tolerance of
`tests/test_torch_transformer.py`.

Top-1 routing is discontinuous: a token whose two best experts are all
but level may route differently on either side. A routing disagreement
fails with that token's top-2 probability gap in the message, so such a
tie is named as the cause.
"""
import numpy as np

import jax
import jax.numpy as jnp
import pytest
import torch

from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu.parallel import moe as jmoe
from incubator_mxnet_tpu_torch.models import transformer as ttfm
from incubator_mxnet_tpu_torch.parallel import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64, n_experts=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _cfgs(**kw):
    base = dict(SMALL, **kw)
    return jtfm.TransformerConfig(**base), ttfm.TransformerConfig(**base)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    return (jcfg, tcfg, jtfm.init_params(jcfg, seed=3),
            ttfm.init_params(tcfg, seed=3, device="cpu"))


def _moe_case(seed, T=24, d=16, f=32, E=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, d).astype(np.float32),
            (rng.randn(d, E) * 0.5).astype(np.float32),
            (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
            (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32))


def _assert_same_routing(tdisp, jdisp, tokens, router):
    got = _np(tdisp).reshape(tdisp.shape[0], -1).argmax(-1)
    want = np.asarray(jdisp).reshape(got.shape[0], -1).argmax(-1)
    bad = np.nonzero(got != want)[0]
    if len(bad):
        probs = np.sort(np.asarray(jax.nn.softmax(tokens @ router)), -1)
        gaps = probs[bad, -1] - probs[bad, -2]
        raise AssertionError(f"tokens {bad.tolist()} route differently; "
                             f"top-2 probability gaps {gaps.tolist()}")


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["room", "drops"])
def test_moe_dispatch_and_ffn_match_jax(cf):
    tokens, router, w1, w2 = _moe_case(0)
    T, E = tokens.shape[0], w1.shape[0]
    C = max(1, int(cf * T / E))
    jdisp, jcomb, jaux = jmoe.moe_dispatch(jnp.asarray(tokens),
                                           jnp.asarray(router), E, C)
    tdisp, tcomb, taux = tmoe.moe_dispatch(_t(tokens), _t(router), E, C)
    _assert_same_routing(tdisp, jdisp, tokens, router)
    np.testing.assert_array_equal(_np(tdisp), np.asarray(jdisp))
    np.testing.assert_allclose(_np(tcomb), np.asarray(jcomb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-5)
    dropped = int((_np(tdisp).sum((1, 2)) == 0).sum())
    assert (dropped > 0) == (cf < 1.0), dropped  # 0.5 must drop tokens

    jout, jaux2 = jmoe.moe_ffn(*map(jnp.asarray, (tokens, router, w1, w2)),
                               capacity_factor=cf)
    tout, taux2 = tmoe.moe_ffn(*map(_t, (tokens, router, w1, w2)),
                               capacity_factor=cf)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux2), float(jaux2), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["room", "drops"])
def test_moe_ffn_gradients_match_jax(cf):
    """Gradients of sum(out * w) + aux for the tokens, the router and both
    expert weights: they reach the router only through the gate and the
    balance loss, as in JAX."""
    args = _moe_case(1)
    w = np.random.RandomState(2).randn(*args[0].shape).astype(np.float32)

    def jloss(*a):
        out, aux = jmoe.moe_ffn(*a, capacity_factor=cf)
        return jnp.sum(out * w) + aux

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    ts = [_t(a).requires_grad_(True) for a in args]
    out, aux = tmoe.moe_ffn(*ts, capacity_factor=cf)
    got = torch.autograd.grad((out * _t(w)).sum() + aux, ts)
    for name, g, j in zip(("tokens", "router", "w1", "w2"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_with_experts_bit_identical(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp = jtfm.init_params(jcfg, seed=5)
    tp = ttfm.init_params(tcfg, seed=5, device="cpu")
    assert list(jp) == list(tp)
    assert tuple(tp["router"].shape) == (2, 32, 2)
    assert tuple(tp["w1"].shape) == (2, 2, 32, 64)
    for k in jp:
        want = np.asarray(jp[k])
        assert tp[k].dtype == getattr(torch, want.dtype.name), k
        np.testing.assert_array_equal(_np(tp[k]), want.astype(np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("n_experts", [2, 4])
def test_apply_logits_and_aux_match_jax(n_experts):
    jcfg, tcfg = _cfgs(n_experts=n_experts)
    jp = jtfm.init_params(jcfg, seed=3)
    tp = ttfm.init_params(tcfg, seed=3, device="cpu")
    tok = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.int32)
    want, jaux = jtfm.apply(jp, jnp.asarray(tok), jcfg)
    got, aux = ttfm.apply(tp, _t(tok), tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_prefill_and_decode_step_with_experts_match_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 64, (2, 9)).astype(np.int32)
    nxt = rng.randint(1, 64, (2,)).astype(np.int32)
    jc = jtfm.init_kv_cache(jcfg, 2, 32)
    jc, jl0 = jtfm.prefill(jp, jc, jnp.asarray(prompt), jcfg)
    jl1, jc = jtfm.decode_step(jp, jc, jnp.asarray(nxt), jcfg)
    tc = ttfm.init_kv_cache(tcfg, 2, 32, device="cpu")
    tc, tl0 = ttfm.prefill(tp, tc, _t(prompt), tcfg)
    tl1, tc = ttfm.decode_step(tp, tc, _t(nxt), tcfg)
    np.testing.assert_allclose(_np(tl0), np.asarray(jl0), **TOL)
    np.testing.assert_allclose(_np(tl1), np.asarray(jl1), **TOL)
    np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), **TOL)


def test_paged_programs_with_experts_match_jax(model):
    """prefill_paged (padded rows route too) then decode_step_paged over
    ragged slots and a dead slot."""
    jcfg, tcfg, jp, tp = model
    ps, P, W = 8, 16, 8
    rng = np.random.RandomState(2)
    true_lens = np.array([5, 16, 0], np.int32)
    prompts = np.zeros((3, 16), np.int32)
    for s, n in enumerate(true_lens):
        prompts[s, :n] = rng.randint(1, 64, n)
    table = np.zeros((3, W), np.int32)
    table[0, :1], table[1, :3] = [4], [7, 2, 9]
    jpaged = jtfm.init_paged_kv_cache(jcfg, P, ps)
    jpaged, jl0 = jtfm.prefill_paged(jp, jpaged, jnp.asarray(prompts),
                                     jnp.asarray(true_lens),
                                     jnp.asarray(table), jcfg)
    tpaged = ttfm.init_paged_kv_cache(tcfg, P, ps, device="cpu")
    tpaged, tl0 = ttfm.prefill_paged(tp, tpaged, _t(prompts), _t(true_lens),
                                     _t(table), tcfg)
    live = true_lens > 0
    np.testing.assert_allclose(_np(tl0)[live], np.asarray(jl0)[live], **TOL)
    toks = np.array([11, 12, 0], np.int32)
    jl1, jpaged = jtfm.decode_step_paged(jp, jpaged, jnp.asarray(toks),
                                         jnp.asarray(true_lens),
                                         jnp.asarray(table), jcfg)
    tl1, tpaged = ttfm.decode_step_paged(tp, tpaged, _t(toks), _t(true_lens),
                                         _t(table), tcfg)
    np.testing.assert_allclose(_np(tl1)[live], np.asarray(jl1)[live], **TOL)
    owned = [4, 7, 2, 9]
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tpaged[key])[:, owned],
                                   np.asarray(jpaged[key])[:, owned], **TOL)


def test_decode_step_paged_wide_with_experts_matches_jax(model):
    """Four slots of five rows: a full chunk, a padded chunk, rows past
    cap and a dead slot, all routed (S·Q = 20 tokens)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(4)
    ps, P, W, Q = 8, 16, 8, 5
    shape = (2, P, ps, 2, 16)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    tokens = rng.randint(1, 64, (4, Q)).astype(np.int32)
    start = np.array([6, 13, 62, 0], np.int32)
    n_real = np.array([5, 2, 5, 0], np.int32)
    table = np.zeros((4, W), np.int32)
    table[0, :2] = [3, 5]
    table[1, :3] = [7, 2, 9]
    table[2] = [1, 4, 6, 8, 10, 11, 12, 13]
    jl, _ = jtfm.decode_step_paged_wide(
        jp, {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(n_real),
        jnp.asarray(table), jcfg)
    tl, _ = ttfm.decode_step_paged_wide(
        tp, {"k": _t(kp), "v": _t(vp)}, _t(tokens), _t(start), _t(n_real),
        _t(table), tcfg)
    live = n_real > 0  # the dead slot reads the null page, left undefined
    np.testing.assert_allclose(_np(tl)[live], np.asarray(jl)[live], **TOL)
