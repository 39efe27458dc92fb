"""Runtime knobs read by the PyTorch port, with the JAX package's names,
defaults and environment semantics.

Only the knobs the ported serving path reads are registered here,
including the serving levers' (`MXTPU_PREFIX_CACHE`,
`MXTPU_PREFILL_CHUNK`, `MXTPU_SPEC_NGRAM`, `MXTPU_SPEC_LOOKAHEAD`); an
engine's constructor argument wins over its knob.
"""
from __future__ import annotations

import dataclasses
import os

import torch

__all__ = ["Knob", "KNOBS", "get", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: object
    type: type
    doc: str


KNOBS: dict[str, Knob] = {}


def _register(name, default, type_, doc):
    KNOBS[name] = Knob(name, default, type_, doc)


def get(name, default=None):
    """Read a registered knob from the environment with its typed default
    (read live, as the JAX package's `config.get` does)."""
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"unregistered config knob {name!r}; add it to "
                       "incubator_mxnet_tpu_torch/config.py")
    raw = os.environ.get(name)
    if raw is None:
        return default if default is not None else knob.default
    if knob.type is bool:
        return raw.lower() not in ("0", "false", "off", "")
    return knob.type(raw)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. `None` means CUDA, and raises
    when CUDA is absent: the port never falls back to the CPU on its own.
    Pass `device="cpu"` to run the plain PyTorch versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_register("MXNET_TELEMETRY", False, bool,
          "Turn the metrics registry on (off: every inc/set_gauge/observe "
          "returns before touching it).")
_register("MXTPU_PAGE_SIZE", 16, int,
          "Tokens per KV-cache page in the paged decode pool.")
_register("MXTPU_DECODE_SLOTS", 8, int,
          "Fixed number of decode slots in the continuous-batching engine: "
          "the batch dimension of every paged decode step.")
_register("MXTPU_SERVING_PAGES", 0, int,
          "Total pages in the serving KV pool (page 0 is the reserved null "
          "page). 0 auto-sizes to slots x ceil(max_len / page_size) + 1.")
_register("MXTPU_PREFILL_BUCKETS", "", str,
          "Comma-separated prompt-length buckets for serving prefill. Empty "
          "uses powers of two from 16 up to the model's max_len.")
_register("MXTPU_PREFIX_CACHE", 0, int,
          "Prefix-cached copy-on-write KV pages in the serving engine: "
          "prompts sharing a page-aligned token prefix map the cached pages "
          "read-only instead of prefilling them again. 0 (default) "
          "disables; 1 enables with a cache bounded only by pool pressure; "
          "N > 1 caps the cache at N pages.")
_register("MXTPU_PREFILL_CHUNK", 0, int,
          "Chunked prefill: prompts stream through the wide step this many "
          "tokens per engine step, interleaved with the batched decode. 0 "
          "(default) prefills each prompt in one bucketed call at "
          "admission.")
_register("MXTPU_SPEC_NGRAM", 0, int,
          "N-gram length of draft-free prompt-lookup speculation: the "
          "trailing n-gram of a request's own history proposes the "
          "continuation of its latest earlier match. 0 (default) "
          "disables speculation.")
_register("MXTPU_SPEC_LOOKAHEAD", 4, int,
          "Tokens proposed per speculative step (the wide verification "
          "step runs lookahead + 1 query rows per slot). Read only when "
          "MXTPU_SPEC_NGRAM > 0.")
