"""Parameter naming and initialization (port of ``repro.models.common``).

The JAX package keeps parameters as a nested dict of arrays; the port keeps
them flat, keyed by the same path joined with "/" (``"blocks/b0_attn_full/
attn/wq"``). ``leaf_order`` sorts paths component by component, which is the
order ``jax.tree_util.tree_flatten`` visits a nested dict in — so the
compression plan sees the leaves in the same order on both sides.
"""
from __future__ import annotations

import torch


def leaf_order(names) -> list[str]:
    """Parameter paths in the JAX flatten order of the nested dict."""
    return sorted(names, key=lambda n: tuple(n.split("/")))


class Initializer:
    """Draws parameters from an explicit ``torch.Generator`` with the JAX
    package's distributions (its streams differ: JAX threefry vs Philox)."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape, stddev: float = 0.02) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return x.mul_(stddev).to(self.dtype)

    def fan_in(self, shape, in_dim_idx: int = 0,
               layers: int | None = None) -> torch.Tensor:
        """Normal scaled by 1/sqrt(fan-in); ``layers`` stacks that many
        independent copies on a leading axis."""
        scale = 1.0 / max(1, shape[in_dim_idx]) ** 0.5
        full = shape if layers is None else (layers,) + tuple(shape)
        return self.normal(full, stddev=scale)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def constant(self, value: float, shape) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)
