"""Carry weights and state across from the JAX package: its parameter tree
(nested dicts of arrays, e.g. ``split_params(init_model(...))[0]``
converted with ``np.asarray``) becomes the port's flat parameter dict, so
both packages compute the same function; its adaptive ``ControlState``
becomes one worker's (``control_from_jax``)."""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(x, device="cpu") -> torch.Tensor:
    """One array (anything ``np.asarray`` takes) as a tensor; bfloat16
    arrays (numpy's ml_dtypes extension) keep their bits."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_numpy(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``{"a/b/c": tensor}``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
            return
        out[prefix] = tensor_from_numpy(node, device)

    walk(tree, "")
    return out


def _flatten(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in JAX's flatten
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def control_from_jax(ctl, worker: int = 0, device="cpu"):
    """A JAX ``ControlState`` (trees of arrays, the workers stacked on the
    leading axis of ``last_sent`` and ``bound``, ``last_avg`` params-shaped,
    a scalar ``step``) -> worker ``worker``'s port ``ControlState``: lists in
    the JAX flatten order, ``bound`` 0-d float32 tensors, ``step`` an int."""
    from repro_torch.optim.optimizers import ControlState
    return ControlState(
        last_sent=[tensor_from_numpy(np.asarray(x)[worker], device)
                   for x in _flatten(ctl.last_sent)],
        last_avg=[tensor_from_numpy(x, device)
                  for x in _flatten(ctl.last_avg)],
        bound=[tensor_from_numpy(np.asarray(x)[worker], device).to(
            torch.float32).reshape(()) for x in _flatten(ctl.bound)],
        step=int(np.asarray(ctl.step)))


def cnn_params_from_jax(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The JAX package's section-5.2 CNN parameters (``init_cnn``'s nested
    dict, as numpy arrays) -> the port's ``{"conv1/w": tensor}`` dict in
    the JAX flatten order (sorted names). The port keeps the JAX layout
    (HWIO kernels, ``fc`` rows in NHWC flatten order; ``experiments.cnn``
    convolves a permuted view), so no array is transposed."""
    return dict(sorted(params_from_numpy(tree, device).items()))
