"""Device contexts (`incubator_mxnet_tpu/context.py`), each naming one
`torch.device`.

`gpu(i)` is the card `cuda:i` and `cpu()` the host. The default context
is `gpu(0)`, as every entry point of the port defaults to CUDA: without
CUDA, resolving it raises (pass `cpu()` or `device="cpu"` to run on the
host). `with ctx:` makes `ctx` the calling thread's default. `tpu()` is
kept as a name and raises, naming `gpu()`; `num_tpus()` is 0.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus", "num_tpus"]


class Context:
    """A device context: (device_type, device_id), resolving to a
    `torch.device` through `torch_device()`."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "tpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "tpu": 5}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_type = device_type.device_type
            self.device_id = device_type.device_id
        elif isinstance(device_type, torch.device):
            self.device_type = "gpu" if device_type.type == "cuda" else "cpu"
            self.device_id = device_type.index or 0
        else:
            self.device_type = device_type
            self.device_id = device_id
        if self.device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {self.device_type}")
        if self.device_type == "tpu":
            raise ValueError("the PyTorch port has no TPU context; use "
                             "gpu() for the card")

    @property
    def device_typeid(self):
        return self.devstr2type[self.device_type]

    def torch_device(self):
        """The `torch.device` of this context; a gpu context raises when
        CUDA is absent."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; use cpu() (or device='cpu') to run "
                "the plain PyTorch path on the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise ValueError(f"device_id {self.device_id} out of range: "
                             f"{n} CUDA device(s)")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default_ctx.stack.pop()

    @classmethod
    def default_ctx(cls):
        stack = getattr(cls._default_ctx, "stack", None)
        if stack:
            return stack[-1]
        return Context("gpu", 0)


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """The card `cuda:<device_id>`."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Kept for the reference's API; the port has no TPU."""
    raise ValueError("the PyTorch port has no TPU context; use gpu() for "
                     "the card")


def current_context():
    return Context.default_ctx()


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus():
    return 0


def to_device(ctx):
    """A `torch.device` for `ctx` (a Context, a torch.device, a device
    string or None for the current context)."""
    if ctx is None:
        return current_context().torch_device()
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return torch.device(ctx)


def context_of(device):
    """The Context naming `device` (a torch.device)."""
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)
