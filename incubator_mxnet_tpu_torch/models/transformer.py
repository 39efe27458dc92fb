"""Transformer LM: the PyTorch counterpart of the JAX package's
`models/transformer.py`, serving and single-device training.

Plain functions over a dict of tensors, with the JAX package's stacked
layout (every per-layer tensor has a leading `n_layers` axis), so the
same numpy weights go through both and compare like with like. The
layer stack is a Python loop where the JAX code scans.

- `init_params` draws the same `np.random.RandomState(seed)` numbers as
  the JAX `init_params` and gives bit-identical values;
  `params_from_numpy` carries the JAX package's parameters across.
- `apply` is the full forward pass (with `cfg.use_flash`, attention is
  the trainable flash-attention kernels, forward and backward);
  `loss_fn` is its mean cross-entropy plus `aux_weight` times the MoE
  balance loss, and `make_train_step` the single-device SGD step over
  it, the counterpart of `make_gspmd_train_step` on a one-device mesh;
- `prefill` / `decode_step` / `generate` / `beam_search` decode over a
  dense KV cache (with `cfg.use_flash`, decode attention is the
  `flash_decode` kernel).
- `init_paged_kv_cache` / `decode_step_paged` / `prefill_paged` /
  `decode_step_paged_wide` are the paged programs the serving engine
  drives; decode attention is the `paged_decode_attention` kernel, and
  the wide step's (Q rows per slot, behind the serving levers) the
  `paged_decode_attention_wide` kernel.

KV caches are updated in place (`index_copy_` into the page pool, slice
assignment into the dense cache) where the JAX functions return a new
cache: a step never holds two copies of the pool. At full width in
float32 one copy of the paged pool is about 100 MB
(2 x 6 layers x 257 pages x 16 rows x 512 x 4 bytes).

The train step updates the parameters in place, where the JAX step
donates them and returns new ones.

Not ported yet: the mixture-of-experts FFN (`n_experts > 0`), the fused
softmax-xent loss (`use_fused_xent`) and the multi-device train steps.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.kernels.decode import (DECODE_BLOCK, dense_decode_attention,
                                  flash_decode, paged_decode_attention,
                                  paged_decode_attention_wide)
from ..ops.kernels.flash import flash_attention

__all__ = [
    "TransformerConfig",
    "init_params",
    "params_from_numpy",
    "apply",
    "loss_fn",
    "make_train_step",
    "init_kv_cache",
    "decode_step",
    "prefill",
    "generate",
    "beam_search",
    "init_paged_kv_cache",
    "decode_step_paged",
    "prefill_paged",
    "decode_step_paged_wide",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NEG_INF = -1e30


@dataclasses.dataclass
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128
    max_len: int = 128
    n_experts: int = 0  # 0 = dense FFN
    dtype: str = "float32"
    # flash-attention kernels in apply (forward and backward) and
    # flash_decode in decoding
    use_flash: bool = False
    use_fused_xent: bool = False  # fused softmax-xent loss (not ported)


def _check_cfg(cfg):
    if cfg.n_experts:
        raise NotImplementedError(
            "the mixture-of-experts FFN (n_experts > 0) is not ported yet; "
            "it comes with the fused-xent slice")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def _check_device(params, dev):
    have = params["embed"].device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"params are on {have}, the call asks for {dev}")


def _to_bf16_values(a):
    """float32 array holding `a` rounded to bfloat16 (round to nearest
    even), as numpy's `astype("bfloat16")` gives where ml_dtypes is
    loaded; done in torch, since numpy alone has no bfloat16."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def init_params(cfg: TransformerConfig, seed: int = 0, device=None):
    """Stacked-layer parameter dict, bit-identical to the JAX
    `init_params(cfg, seed)`.

    The JAX code computes `rng.randn(...).astype(dtype) * scale` in numpy
    and casts the product to float32 (`jnp.asarray`). A float64 scale
    (`1/np.sqrt(fan_in)`) makes that product float64, rounded to float32
    once; the python-float scale 0.02 keeps it float32. So the matrices
    are float32 for both dtypes, holding bfloat16-rounded draws when
    `cfg.dtype` is "bfloat16", while the LayerNorm parameters take
    `cfg.dtype`. This mirrors the JAX result, draw for draw."""
    dt = _check_cfg(cfg)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab

    def W(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
        a = rng.randn(*shape)
        a = (_to_bf16_values(a) if cfg.dtype == "bfloat16"
             else a.astype(np.float32))
        a = np.asarray(a * scale, dtype=np.float32)
        return torch.from_numpy(a).to(dev)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=dt, device=dev)

    p = {
        "embed": W(V, d, scale=0.02),
        "pos": W(cfg.max_len, d, scale=0.02),
        "ln_f_g": const(1.0, d),
        "ln_f_b": const(0.0, d),
        "wq": W(L, d, d),
        "wk": W(L, d, d),
        "wv": W(L, d, d),
        "wo": W(L, d, d),
        "ln1_g": const(1.0, L, d),
        "ln1_b": const(0.0, L, d),
        "ln2_g": const(1.0, L, d),
        "ln2_b": const(0.0, L, d),
    }
    p["w1"] = W(L, d, f)
    p["w2"] = W(L, f, d, scale=1.0 / np.sqrt(f))
    return p


def params_from_numpy(np_params, device=None):
    """The JAX package's parameters, as numpy arrays (`np.asarray` of
    each), as the port's tensors on `device`, each keeping its dtype
    (bfloat16 arrays of ml_dtypes included)."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_params.items():
        a = np.array(v, order="C")  # a writable copy the tensor may own
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[k] = t.to(dev)
    return out


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)  # population, as jnp.var
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _split_heads(x, n_heads):
    B, T, d = x.shape
    return x.reshape(B, T, n_heads, d // n_heads)


def _layer_params(params, l):
    return {k: params[k][l] for k in ("wq", "wk", "wv", "wo", "w1", "w2",
                                      "ln1_g", "ln1_b", "ln2_g", "ln2_b")}


def _ffn(x, lp):
    h = _ln(x, lp["ln2_g"], lp["ln2_b"])
    return x + F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]


def _dense_attention(q, k, v, causal=True):
    # q, k, v: (B, T, H, Dh); plain matmul + softmax, as the JAX einsum
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T = q.shape[1]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_attention_fn(q, k, v, causal=True):
    """Adapter onto the flash-attention kernels (`ops/kernels/flash.py`):
    model layout (B, T, H, Dh) <-> kernel layout (B, H, T, Dh), both as
    transposed views, since the kernels read and write through strides.
    Any T runs the kernels, so unlike the JAX adapter there is no padding
    of causal remainders, no dense fallback for non-causal ones and no
    fallback counter."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def _logits(params, x):
    return _ln(x, params["ln_f_g"], params["ln_f_b"]) @ params["embed"].T


def apply(params, tokens, cfg: TransformerConfig, attn_fn=None):
    """Forward pass: tokens (B, T) integer -> (logits (B, T, V), aux).
    `aux` is the MoE balance loss of the JAX version, 0 for the dense
    FFN. Attention is `attn_fn(q, k, v)` over (B, T, H, Dh); by default
    the flash-attention kernels with `cfg.use_flash`, else the dense
    softmax, as in the JAX `apply`."""
    _check_cfg(cfg)
    if attn_fn is None:
        attn_fn = _flash_attention_fn if cfg.use_flash else _dense_attention
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    B, T = tokens.shape
    x = params["embed"][tokens] + params["pos"][:T][None]
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = _split_heads(h @ lp["wq"], cfg.n_heads)
        k = _split_heads(h @ lp["wk"], cfg.n_heads)
        v = _split_heads(h @ lp["wv"], cfg.n_heads)
        a = attn_fn(q, k, v)
        x = _ffn(x + a.reshape(B, T, cfg.d_model) @ lp["wo"], lp)
    aux = torch.zeros((), dtype=x.dtype, device=x.device)
    return _logits(params, x), aux / max(cfg.n_layers, 1)


def _xent(logits, targets, fused=False):
    if fused:
        raise NotImplementedError(
            "the fused softmax-xent kernel is not ported yet "
            "(fused-xent slice)")
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def loss_fn(params, tokens, targets, cfg: TransformerConfig,
            aux_weight=0.01):
    """Mean next-token cross-entropy of `apply` plus `aux_weight` times its
    aux loss: the loss of the JAX `make_gspmd_train_step`. tokens and
    targets (B, T) integers; returns a 0-d tensor."""
    logits, aux = apply(params, tokens, cfg)
    targets = torch.as_tensor(targets, device=logits.device)
    losses = _xent(logits, targets, fused=cfg.use_fused_xent)
    return losses.mean() + aux_weight * aux


def make_train_step(cfg: TransformerConfig, lr=0.1, aux_weight=0.01,
                    seed=0, device=None):
    """Single-device SGD train step, the counterpart of the JAX
    `make_gspmd_train_step` on a one-device mesh. Returns (step, params),
    params = `init_params(cfg, seed)` on `device` (None: CUDA).

    step(params, tokens, targets) -> (0-d loss, params): the gradient of
    `loss_fn` for every parameter, then w <- w - lr * g IN PLACE under
    `torch.no_grad()` (the JAX step donates its params and returns new
    ones). Nothing in the step waits for the device; tokens and targets
    already on the device keep it so (host arrays are copied over, which
    waits)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, device=dev)

    def step(p, tokens, targets):
        weights = list(p.values())
        for w in weights:
            w.requires_grad_(True)
        loss = loss_fn(p, tokens, targets, cfg, aux_weight)
        grads = torch.autograd.grad(loss, weights)
        with torch.no_grad():
            for w, g in zip(weights, grads):
                w.sub_(lr * g)
        return loss.detach(), p

    return step, params


# ---------------------------------------------------------------------------
# Incremental decoding over a dense KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int,
                  max_len: int | None = None, device=None):
    """Per-layer key/value cache (L, B, T_max, H, Dh) + the write
    position (a python int). T_max is rounded up to a DECODE_BLOCK
    multiple when larger than one block, as in the JAX package, so cache
    shapes agree; extra positions are masked by n_valid."""
    dt = _check_cfg(cfg)
    dev = resolve_device(device)
    T = int(max_len or cfg.max_len)
    if T > DECODE_BLOCK and T % DECODE_BLOCK:
        T += DECODE_BLOCK - T % DECODE_BLOCK
    H = cfg.n_heads
    shape = (cfg.n_layers, batch, T, H, cfg.d_model // H)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": 0}


def decode_step(params, cache, tokens, cfg: TransformerConfig):
    """One token through the stack with cached attention state.

    tokens: (B,) integer, the tokens at position cache["pos"]. Writes
    their keys and values into the cache IN PLACE and returns
    (logits (B, V), cache advanced by one position)."""
    B = tokens.shape[0]
    pos = int(cache["pos"])
    T_max = cache["k"].shape[2]
    if pos >= T_max:
        raise ValueError(f"decode position {pos} is past the cache "
                         f"capacity ({T_max})")
    tokens = tokens.long()
    x = params["embed"][tokens] + params["pos"][pos]  # (B, d)
    attend = flash_decode if cfg.use_flash else dense_decode_attention
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(B, cfg.n_heads, -1)
        k = (h @ lp["wk"]).reshape(B, cfg.n_heads, -1)
        v = (h @ lp["wv"]).reshape(B, cfg.n_heads, -1)
        k_cache, v_cache = cache["k"][l], cache["v"][l]  # (B, T, H, Dh)
        k_cache[:, pos] = k.to(k_cache.dtype)
        v_cache[:, pos] = v.to(v_cache.dtype)
        a = attend(q, k_cache, v_cache, pos + 1)
        x = _ffn(x + a.reshape(B, cfg.d_model) @ lp["wo"], lp)
    return _logits(params, x), {"k": cache["k"], "v": cache["v"],
                                "pos": pos + 1}


def prefill(params, cache, prompt, cfg: TransformerConfig):
    """Fill the cache with the whole prompt in one batched pass (dense
    causal attention). Returns (cache, last-token logits (B, V))."""
    prompt = prompt.long()
    B, T_p = prompt.shape
    x = params["embed"][prompt] + params["pos"][:T_p][None]
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = _split_heads(h @ lp["wq"], cfg.n_heads)
        k = _split_heads(h @ lp["wk"], cfg.n_heads)
        v = _split_heads(h @ lp["wv"], cfg.n_heads)
        cache["k"][l, :, :T_p] = k.to(cache["k"].dtype)
        cache["v"][l, :, :T_p] = v.to(cache["v"].dtype)
        a = _dense_attention(q, k, v, causal=True)
        x = _ffn(x + a.reshape(B, T_p, cfg.d_model) @ lp["wo"], lp)
    logits = _logits(params, x[:, -1])
    return {"k": cache["k"], "v": cache["v"], "pos": T_p}, logits


def _filter_logits(logits, top_k=0, top_p=0.0):
    """Top-k and nucleus (top-p) filters: everything outside goes to
    -inf. The caller passes temperature-scaled logits, so the nucleus is
    taken on the distribution actually sampled. Both filters read the
    sort of the unfiltered logits, as the JAX version does."""
    need_sorted = (top_p and top_p > 0.0) or (top_k and top_k > 0)
    if not need_sorted:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])  # clamp to vocab
        kth = sorted_logits[..., k - 1:k]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p and top_p > 0.0:
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose PRECEDING mass is < p (always keeps the top-1)
        preceding = torch.cat([torch.zeros_like(cum[..., :1]),
                               cum[..., :-1]], dim=-1)
        cutoff = torch.where(preceding < top_p, sorted_logits,
                             math.inf).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return logits


def _check_capacity(T_p, n_steps, T_max, n_pos):
    if T_p + n_steps > T_max:
        raise ValueError(f"prompt ({T_p}) + n_steps ({n_steps}) exceeds the "
                         f"cache capacity ({T_max}); raise max_len")
    if T_p + n_steps > n_pos:
        raise ValueError(f"prompt ({T_p}) + n_steps ({n_steps}) exceeds "
                         f"max_len ({n_pos}) positional embeddings")


def generate(params, prompt, n_steps, cfg: TransformerConfig, generator=None,
             temperature=0.0, max_len=None, top_k=0, top_p=0.0, device=None):
    """Autoregressive generation: prefill the cache with the prompt, then
    n_steps continuation tokens. prompt: (B, T_p) integers. Returns
    (B, n_steps) int64. temperature 0 = greedy (token-identical to the
    JAX version); otherwise categorical sampling from `generator` (a
    `torch.Generator` on `device`; default: one seeded with 0), after the
    top_k / nucleus top_p filters. The final token needs no decode step,
    so n_steps - 1 are run."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    _check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, T_p = prompt.shape
    cache = init_kv_cache(cfg, B, max_len, device=dev)
    _check_capacity(T_p, n_steps, cache["k"].shape[2],
                    params["pos"].shape[0])
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def sample(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = _filter_logits(logits / temperature, top_k=top_k,
                                top_p=top_p)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    cache, logits = prefill(params, cache, prompt, cfg)
    toks = []
    for i in range(n_steps):
        tok = sample(logits)
        toks.append(tok)
        if i + 1 < n_steps:
            logits, cache = decode_step(params, cache, tok, cfg)
    return torch.stack(toks, dim=1)


def beam_search(params, prompt, n_steps, cfg: TransformerConfig,
                beam_size=4, max_len=None, device=None):
    """Beam-search decoding. prompt (B, T_p) integers -> (sequences
    (B, beam, n_steps) int64, scores (B, beam) summed log-probs), beams
    sorted best-first. Sequences are rebuilt at the end by backtracking
    the per-step parent pointers, as the JAX version does."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    _check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, T_p = prompt.shape
    K, V = int(beam_size), cfg.vocab
    cache = init_kv_cache(cfg, B, max_len, device=dev)
    # the first token comes from the prefill logits: n_steps - 1 decodes
    _check_capacity(T_p, n_steps - 1, cache["k"].shape[2],
                    params["pos"].shape[0])

    cache, logits = prefill(params, cache, prompt, cfg)
    logp = torch.log_softmax(logits, dim=-1)  # (B, V)
    scores, first = torch.topk(logp, K, dim=-1)  # (B, K)
    cache = {"k": cache["k"].repeat_interleave(K, dim=1),
             "v": cache["v"].repeat_interleave(K, dim=1),
             "pos": cache["pos"]}
    rows = torch.arange(B, device=dev)[:, None] * K
    tokens, toks, parents = first, [], []
    for _ in range(n_steps - 1):
        logits, cache = decode_step(params, cache, tokens.reshape(B * K),
                                    cfg)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        total = scores[..., None] + logp  # (B, K, V)
        scores, flat = torch.topk(total.reshape(B, K * V), K, dim=-1)
        par = flat // V  # which beam each came from
        tokens = flat % V
        # reorder every beam-replicated cache row to follow its parent
        gather = (rows + par).reshape(B * K)
        cache = {"k": cache["k"][:, gather], "v": cache["v"][:, gather],
                 "pos": cache["pos"]}
        toks.append(tokens)
        parents.append(par)
    beam_idx = torch.arange(K, device=dev)[None].expand(B, K)
    rev = []
    for tok_t, par_t in zip(reversed(toks), reversed(parents)):
        rev.append(torch.gather(tok_t, 1, beam_idx))
        beam_idx = torch.gather(par_t, 1, beam_idx)
    first_tok = torch.gather(first, 1, beam_idx)
    seqs = torch.stack([first_tok] + rev[::-1], dim=-1)  # (B, K, n_steps)
    return seqs, scores


# ---------------------------------------------------------------------------
# Paged decoding: K/V in a global page pool shared by every decode slot
# (serving/engine.py drives these four functions)
# ---------------------------------------------------------------------------


def init_paged_kv_cache(cfg: TransformerConfig, num_pages: int,
                        page_size: int, device=None):
    """Per-layer paged K/V pool: (L, num_pages, page_size, H, Dh). Page 0
    is the null page (serving.pages.PageAllocator never hands it out):
    dead slots and padded prefill rows write there."""
    dt = _check_cfg(cfg)
    dev = resolve_device(device)
    H = cfg.n_heads
    shape = (cfg.n_layers, num_pages, page_size, H, cfg.d_model // H)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _page_write_index(page_table, positions, page_size):
    """Flat pool row (page * page_size + offset) where each slot's next
    token lands. positions: (S,) tokens already cached per slot."""
    page = torch.gather(page_table, 1, (positions // page_size)[:, None])
    return page[:, 0] * page_size + positions % page_size


def _write_rows(pool, rows, values):
    """Scatter `values` (N, H, Dh) into pool rows `rows` (N,) of one
    layer's (P, page_size, H, Dh) pool, in place."""
    flat = pool.view((-1,) + tuple(pool.shape[2:]))
    flat.index_copy_(0, rows, values.to(pool.dtype))


def decode_step_paged(params, paged, tokens, positions, page_table,
                      cfg: TransformerConfig):
    """One token for every decode slot, each at its own depth.

    paged: init_paged_kv_cache dict, updated IN PLACE; tokens (S,)
    integers; positions (S,) tokens already cached per slot (the new
    token is written there, then attention covers positions + 1);
    page_table (S, P_max) page ids per slot. Dead slots (all-zero table
    row, position 0) write to the null page and give logits the caller
    discards. Returns (logits (S, V), paged)."""
    S = tokens.shape[0]
    page_size = paged["k"].shape[2]
    tokens, positions = tokens.long(), positions.long()
    page_table = page_table.long()
    x = params["embed"][tokens] + params["pos"][positions]  # (S, d)
    write_idx = _page_write_index(page_table, positions, page_size)
    # the kernel's index types, converted once for every layer
    table32 = page_table.to(torch.int32)
    n_valid = (positions + 1).to(torch.int32)
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(S, cfg.n_heads, -1)
        k = (h @ lp["wk"]).reshape(S, cfg.n_heads, -1)
        v = (h @ lp["wv"]).reshape(S, cfg.n_heads, -1)
        k_pool, v_pool = paged["k"][l], paged["v"][l]
        _write_rows(k_pool, write_idx, k)
        _write_rows(v_pool, write_idx, v)
        a = paged_decode_attention(q, k_pool, v_pool, table32, n_valid)
        x = _ffn(x + a.reshape(S, cfg.d_model) @ lp["wo"], lp)
    return _logits(params, x), paged


def prefill_paged(params, paged, prompts, true_lens, page_table,
                  cfg: TransformerConfig):
    """Prefill a bucket of prompts straight into their pages in one pass.

    prompts: (S, T_b) integers padded to the bucket length; true_lens
    (S,) real prompt length per row; page_table (S, P_max). Causal
    attention makes every position < true_len exact whatever the padding;
    padded positions write to the null page. Updates `paged` IN PLACE and
    returns (paged, logits (S, V) at each row's last real token)."""
    prompts, true_lens = prompts.long(), true_lens.long()
    page_table = page_table.long()
    S, T_b = prompts.shape
    page_size = paged["k"].shape[2]
    dev = prompts.device
    x = params["embed"][prompts] + params["pos"][:T_b][None]
    t = torch.arange(T_b, device=dev)
    valid = t[None, :] < true_lens[:, None]  # (S, T_b)
    page = torch.gather(page_table, 1, (t // page_size)[None].expand(S, T_b))
    write_idx = torch.where(valid, page * page_size + t[None] % page_size,
                            0).reshape(S * T_b)
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = _split_heads(h @ lp["wq"], cfg.n_heads)
        k = _split_heads(h @ lp["wk"], cfg.n_heads)
        v = _split_heads(h @ lp["wv"], cfg.n_heads)
        _write_rows(paged["k"][l], write_idx, k.reshape((S * T_b,)
                                                        + k.shape[2:]))
        _write_rows(paged["v"][l], write_idx, v.reshape((S * T_b,)
                                                        + v.shape[2:]))
        a = _dense_attention(q, k, v, causal=True)
        x = _ffn(x + a.reshape(S, T_b, cfg.d_model) @ lp["wo"], lp)
    last = (true_lens - 1).clamp(min=0)
    x_last = x[torch.arange(S, device=dev), last]  # (S, d)
    return paged, _logits(params, x_last)


def decode_step_paged_wide(params, paged, tokens, start, n_real, page_table,
                           cfg: TransformerConfig):
    """Q consecutive tokens per decode slot in one pass: the wide step
    behind the serving levers (chunked prefill with Q = the chunk, the
    prefix cache's tail prefill starting at the cached length, and n-gram
    speculative verification with Q = lookahead + 1).

    tokens: (S, Q) integers, token j of slot s at position start[s] + j;
    start: (S,) tokens already cached per slot; n_real: (S,) rows whose
    K/V are written (j < n_real; the rest, chunk padding and dead slots,
    go to row 0 of the null page); page_table (S, P_max). A position at or
    past cap = min(P_max * page_size, positional-table rows) is not
    written either, and its embedding and page lookup use position 0:
    speculative rows may run past a slot's last owned page, and the
    caller discards their outputs. Query j attends positions
    < start + j + 1 through the `paged_decode_attention_wide` kernel.
    Updates `paged` IN PLACE; returns (logits (S, Q, V), paged). Dense FFN
    only, as everywhere in the port."""
    S, Q = tokens.shape
    page_size = paged["k"].shape[2]
    dev = tokens.device
    tokens, start, n_real = tokens.long(), start.long(), n_real.long()
    page_table = page_table.long()
    j = torch.arange(Q, device=dev)
    pos = start[:, None] + j[None]  # (S, Q) global positions
    cap = min(page_table.shape[1] * page_size, params["pos"].shape[0])
    writable = (j[None] < n_real[:, None]) & (pos < cap)
    safe_pos = torch.where(pos < cap, pos, 0)
    x = params["embed"][tokens] + params["pos"][safe_pos]  # (S, Q, d)
    page = torch.gather(page_table, 1, safe_pos // page_size)
    write_idx = torch.where(writable, page * page_size + safe_pos % page_size,
                            0).reshape(S * Q)
    table32 = page_table.to(torch.int32)
    start32 = start.to(torch.int32)
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = _split_heads(h @ lp["wq"], cfg.n_heads)  # (S, Q, H, Dh)
        k = _split_heads(h @ lp["wk"], cfg.n_heads)
        v = _split_heads(h @ lp["wv"], cfg.n_heads)
        k_pool, v_pool = paged["k"][l], paged["v"][l]
        _write_rows(k_pool, write_idx, k.reshape((S * Q,) + k.shape[2:]))
        _write_rows(v_pool, write_idx, v.reshape((S * Q,) + v.shape[2:]))
        a = paged_decode_attention_wide(q, k_pool, v_pool, table32, start32)
        x = _ffn(x + a.reshape(S, Q, cfg.d_model) @ lp["wo"], lp)
    return _logits(params, x), paged
