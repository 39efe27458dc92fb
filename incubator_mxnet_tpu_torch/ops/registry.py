"""The operator registry (`incubator_mxnet_tpu/ops/registry.py`).

Each op is a function over torch tensors plus static attributes; from
this one registry come the eager `nd.*` functions (over `NDArray`s,
`ndarray/register.py`) and the tensor-level `F` namespace that
`HybridBlock.hybrid_forward` receives. Gradients come from
`torch.autograd` (a few output ops define their own backward with a
`torch.autograd.Function`, as the JAX ops use `jax.custom_vjp`).

fn signature convention: positional params are tensor inputs; keyword-only
params are static attrs. A ``*args`` param means variadic tensor inputs.
With ``needs_rng`` / ``needs_training`` the caller passes ``_rng`` (a
`torch.Generator` seeded from the global random state) / ``_training``
(bool). Ops with ``aux`` inputs (BatchNorm's moving stats) return
(out, new_aux...) in training mode and the caller writes the new values.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

__all__ = ["OpDef", "register", "get_op", "list_ops", "OP_REGISTRY", "alias"]

OP_REGISTRY: dict[str, "OpDef"] = {}


@dataclass
class OpDef:
    """One registered operator."""

    name: str
    fn: Callable
    inputs: Sequence[str] = ()
    variadic: bool = False
    num_outputs: object = 1
    aux: Sequence[str] = ()
    needs_rng: bool = False
    needs_training: bool = False
    optional: Sequence[str] = ()
    attrs: dict = field(default_factory=dict)
    aliases: Sequence[str] = ()
    no_grad_inputs: Sequence[str] = ()

    @property
    def attr_names(self):
        return tuple(self.attrs.keys())


def register(name, *, num_outputs=1, aux=(), needs_rng=False,
             needs_training=False, optional=(), aliases=(),
             no_grad_inputs=()):
    """Decorator registering a function over tensors as an operator."""

    def deco(fn):
        sig = inspect.signature(fn)
        inputs, attrs, variadic = [], {}, False
        for pname, p in sig.parameters.items():
            if pname in ("_rng", "_training"):
                continue
            if p.kind == inspect.Parameter.VAR_POSITIONAL:
                variadic = True
            elif p.kind == inspect.Parameter.KEYWORD_ONLY:
                attrs[pname] = (None if p.default is inspect.Parameter.empty
                                else p.default)
            elif p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                            inspect.Parameter.POSITIONAL_OR_KEYWORD):
                inputs.append(pname)
        opdef = OpDef(name=name, fn=fn, inputs=tuple(inputs),
                      variadic=variadic, num_outputs=num_outputs,
                      aux=tuple(aux), needs_rng=needs_rng,
                      needs_training=needs_training,
                      optional=tuple(optional), attrs=attrs,
                      aliases=tuple(aliases),
                      no_grad_inputs=tuple(no_grad_inputs))
        OP_REGISTRY[name] = opdef
        for a in aliases:
            OP_REGISTRY[a] = opdef
        fn.__opdef__ = opdef
        return fn

    return deco


def alias(existing, *names):
    op = OP_REGISTRY[existing]
    for n in names:
        OP_REGISTRY[n] = op


def get_op(name) -> Optional[OpDef]:
    return OP_REGISTRY.get(name)


def list_ops():
    return sorted(set(o.name for o in OP_REGISTRY.values()))
