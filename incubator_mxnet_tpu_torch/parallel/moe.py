"""Mixture-of-experts FFN with capacity-based top-1 dispatch, on one
device: the counterpart of `moe_dispatch` and `moe_ffn` in the JAX
package's `parallel/moe.py`.

Routing is dense products against a (tokens, experts, capacity) dispatch
tensor, as in the JAX package: top-1 routing (softmax, argmax, gate = the
top probability), each token's place in its expert's queue from a float
cumulative sum of the one-hot, a fixed capacity per expert (tokens past it
are dropped: the caller's residual carries them unchanged), and the
Switch-Transformer load-balance loss. Gradients flow where the JAX
version's do: into the router through the gate and the balance loss's
mean probabilities; the one-hot, the queue positions and the keep mask
carry none. The einsums are plain PyTorch products: the JAX package
leaves them to XLA, outside any kernel.

Not ported here: `moe_ffn_shardmap`, the expert-parallel variant over
several devices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["moe_dispatch", "moe_ffn"]


def moe_dispatch(tokens, router_w, n_experts, capacity):
    """Top-1 dispatch and combine tensors and the load-balance loss.

    tokens (T, d); router_w (d, E). Returns (dispatch (T, E, C) 0/1,
    combine (T, E, C) weighted by the gate, aux 0-d)."""
    probs = torch.softmax(tokens @ router_w, dim=-1)  # (T, E)
    expert = torch.argmax(probs, dim=-1)  # first of equal maxima, as JAX
    gate = probs.amax(dim=-1)
    onehot = F.one_hot(expert, n_experts).to(tokens.dtype)
    # each token's place in its expert's queue; -1 where not routed
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    pos_tok = pos.amax(dim=-1)
    keep = (pos_tok >= 0) & (pos_tok < capacity)
    slot = F.one_hot(pos_tok.clamp(0, capacity - 1).long(), capacity)
    disp = (onehot[:, :, None] * slot.to(tokens.dtype)[:, None, :]
            * keep.to(tokens.dtype)[:, None, None])
    combine = disp * gate[:, None, None]
    # E * sum_e (share of tokens routed to e) * (mean probability of e)
    aux = n_experts * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    return disp, combine, aux


def moe_ffn(tokens, router_w, w1, w2, *, capacity_factor=2.0):
    """MoE FFN on one device. tokens (T, d); router_w (d, E); w1
    (E, d, f); w2 (E, f, d). Capacity is max(1, int(capacity_factor * T /
    E)), computed in Python as in the JAX version. Returns (out (T, d),
    aux 0-d)."""
    E = w1.shape[0]
    T = tokens.shape[0]
    capacity = max(1, int(capacity_factor * T / E))
    disp, combine, aux = moe_dispatch(tokens, router_w, E, capacity)
    xs = torch.einsum("td,tec->ecd", tokens, disp)  # (E, C, d)
    h = F.gelu(torch.einsum("ecd,edf->ecf", xs, w1), approximate="tanh")
    ys = torch.einsum("ecf,efd->ecd", h, w2)  # (E, C, d)
    return torch.einsum("ecd,tec->td", ys, combine), aux
