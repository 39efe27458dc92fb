"""Transformer parity of the PyTorch port with the JAX package (CPU).

Weights must be bit-identical; logits agree at rtol = atol = 1e-4
(float32 sums in another order, XLA on the CPU against ATen, over two
layers); greedy tokens and beam sequences must be identical.
"""
import numpy as np

import jax.numpy as jnp
import pytest
import torch

from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu_torch.models import transformer as ttfm

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64)


def _cfgs(**kw):
    base = dict(SMALL, **kw)
    return jtfm.TransformerConfig(**base), ttfm.TransformerConfig(**base)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    return (jcfg, tcfg, jtfm.init_params(jcfg, seed=3),
            ttfm.init_params(tcfg, seed=3, device="cpu"))


def _np(t):
    return t.detach().float().numpy()


def _assert_same_params(jp, tp):
    assert list(jp) == list(tp)
    for k in jp:
        want = np.asarray(jp[k])
        assert tp[k].dtype == getattr(torch, want.dtype.name), k
        assert tuple(tp[k].shape) == want.shape, k
        # bfloat16 -> float32 is exact, so equal float32 values are equal bits
        np.testing.assert_array_equal(_np(tp[k]), want.astype(np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bit_identical(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp = jtfm.init_params(jcfg, seed=5)
    _assert_same_params(jp, ttfm.init_params(tcfg, seed=5, device="cpu"))
    # carried across from the JAX package's numpy arrays, dtypes kept
    carried = ttfm.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                     device="cpu")
    _assert_same_params(jp, carried)


def test_apply_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    tok = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.int32)
    want, _ = jtfm.apply(jp, jnp.asarray(tok), jcfg)
    got, aux = ttfm.apply(tp, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_step_match_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 64, (2, 9)).astype(np.int32)
    nxt = rng.randint(1, 64, (2,)).astype(np.int32)
    jc = jtfm.init_kv_cache(jcfg, 2, 32)
    jc, jl0 = jtfm.prefill(jp, jc, jnp.asarray(prompt), jcfg)
    jl1, jc = jtfm.decode_step(jp, jc, jnp.asarray(nxt), jcfg)
    tc = ttfm.init_kv_cache(tcfg, 2, 32, device="cpu")
    tc, tl0 = ttfm.prefill(tp, tc, torch.from_numpy(prompt), tcfg)
    tl1, tc = ttfm.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
    np.testing.assert_allclose(_np(tl0), np.asarray(jl0), **TOL)
    np.testing.assert_allclose(_np(tl1), np.asarray(jl1), **TOL)
    assert tc["pos"] == int(jc["pos"]) == 10
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **TOL)


def test_kv_cache_padded_to_decode_block():
    _, tcfg = _cfgs(max_len=512)
    for T_req, T in ((200, 256), (16, 16), (128, 128)):
        cache = ttfm.init_kv_cache(tcfg, 1, T_req, device="cpu")
        assert cache["k"].shape[2] == T


def test_paged_programs_match_jax(model):
    """prefill_paged then decode_step_paged over ragged slots and a dead
    slot: logits of the live slots and their pages agree with JAX."""
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
    tpaged, tl0 = ttfm.prefill_paged(tp, tpaged, torch.from_numpy(prompts),
                                     torch.from_numpy(true_lens),
                                     torch.from_numpy(table), tcfg)
    live = true_lens > 0
    np.testing.assert_allclose(_np(tl0)[live], np.asarray(jl0)[live], **TOL)
    toks = np.array([11, 12, 0], np.int32)
    jl1, jpaged = jtfm.decode_step_paged(jp, jpaged, jnp.asarray(toks),
                                         jnp.asarray(true_lens),
                                         jnp.asarray(table), jcfg)
    tl1, tpaged = ttfm.decode_step_paged(tp, tpaged, torch.from_numpy(toks),
                                         torch.from_numpy(true_lens),
                                         torch.from_numpy(table), tcfg)
    np.testing.assert_allclose(_np(tl1)[live], np.asarray(jl1)[live], **TOL)
    owned = [4, 7, 2, 9]  # every real page (the null page holds garbage)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tpaged[key])[:, owned],
                                   np.asarray(jpaged[key])[:, owned], **TOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_generate_greedy_tokens_identical(use_flash):
    jcfg, tcfg = _cfgs(use_flash=use_flash)
    jp = jtfm.init_params(jcfg, seed=3)
    tp = ttfm.init_params(tcfg, seed=3, device="cpu")
    prompt = np.random.RandomState(4).randint(1, 64, (2, 7)).astype(np.int32)
    want = np.asarray(jtfm.generate(jp, jnp.asarray(prompt), 9, jcfg))
    got = ttfm.generate(tp, prompt, 9, tcfg, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # sampling restricted to the top-1 token is greedy decoding again
    gen = torch.Generator().manual_seed(7)
    top1 = ttfm.generate(tp, prompt, 9, tcfg, generator=gen, temperature=0.7,
                         top_k=1, device="cpu").numpy()
    np.testing.assert_array_equal(top1, want)


def test_beam_search_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    prompt = np.random.RandomState(5).randint(1, 64, (2, 5)).astype(np.int32)
    jseq, jsc = jtfm.beam_search(jp, jnp.asarray(prompt), 5, jcfg,
                                 beam_size=3)
    tseq, tsc = ttfm.beam_search(tp, prompt, 5, tcfg, beam_size=3,
                                 device="cpu")
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(_np(tsc), np.asarray(jsc), **TOL)


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.9), (7, 0.5),
                                         (100, 0.0)])
def test_filter_logits_masks_identical(top_k, top_p):
    logits = (np.random.RandomState(6).randn(4, 64) * 3).astype(np.float32)
    want = np.asarray(jtfm._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = ttfm._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


def test_sampling_is_reproducible_from_a_generator(model):
    _, tcfg, _, tp = model
    prompt = np.ones((1, 4), np.int32)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return ttfm.generate(tp, prompt, 12, tcfg, generator=gen,
                             temperature=1.0, top_p=0.9, device="cpu")

    assert torch.equal(draw(11), draw(11))


def test_unported_options_raise():
    _, moe = _cfgs(n_experts=2)
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        ttfm.init_params(moe, device="cpu")
    with pytest.raises(NotImplementedError, match="softmax-xent"):
        ttfm._xent(torch.zeros(2, 8), torch.zeros(2), fused=True)
