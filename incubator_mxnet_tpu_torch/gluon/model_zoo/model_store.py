"""The model zoo's parameter files
(`incubator_mxnet_tpu/gluon/model_zoo/model_store.py`): resolved
locally only, under `MXTPU_MODELS_ROOT` (default ~/.mxnet/models).
Nothing is downloaded: `pretrained=True` loads `<root>/<name>.params`
(or a sha1-tagged `<name>-XXXXXXXX.params`, the reference's files load
as they are) and raises with the expected path when it is absent.
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "model_root"]


def model_root(root=None):
    """The weights directory: `root`, else MXTPU_MODELS_ROOT, else
    ~/.mxnet/models."""
    if root:
        return os.path.expanduser(root)
    from ... import config as _config

    env = _config.get("MXTPU_MODELS_ROOT")
    if env:
        return os.path.expanduser(env)
    return os.path.expanduser(os.path.join("~", ".mxnet", "models"))


def get_model_file(name, root=None):
    """Path to `<root>/<name>.params` (also accepts the reference's
    sha1-tagged `<name>-XXXXXXXX.params` spelling). Raises with the
    expected location when absent: nothing is downloaded."""
    root = model_root(root)
    exact = os.path.join(root, f"{name}.params")
    if os.path.exists(exact):
        return exact
    if os.path.isdir(root):
        tagged = sorted(f for f in os.listdir(root)
                        if f.startswith(f"{name}-") and
                        f.endswith(".params"))
        if tagged:
            return os.path.join(root, tagged[-1])
    raise FileNotFoundError(
        f"pretrained weights for {name!r} not found; the model zoo "
        f"downloads nothing: place the file at {exact} (reference-format "
        f".params files load directly)")
