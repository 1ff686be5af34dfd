"""Carry weights across from the JAX package: its parameter tree (nested
dicts of arrays, e.g. ``split_params(init_model(...))[0]`` converted with
``np.asarray``) becomes the port's flat parameter dict, so both packages
compute the same function."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``{"a/b/c": tensor}``. bfloat16
    arrays (numpy's ml_dtypes extension) keep their bits."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
            return
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        out[prefix] = t.to(device)

    walk(tree, "")
    return out


def cnn_params_from_jax(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The JAX package's section-5.2 CNN parameters (``init_cnn``'s nested
    dict, as numpy arrays) -> the port's ``{"conv1/w": tensor}`` dict in
    the JAX flatten order (sorted names). The port keeps the JAX layout
    (HWIO kernels, ``fc`` rows in NHWC flatten order; ``experiments.cnn``
    convolves a permuted view), so no array is transposed."""
    return dict(sorted(params_from_numpy(tree, device).items()))
