"""Coding-length model and realized wire accounting (port of the parts of
``repro.core.coding`` the COO gather wire uses).

The coding model charges a sampled message the paper's section-3.3 hybrid
code: sure coordinates (p = 1) cost ``b + log2 d`` bits each, sampled ones
``log2 d`` each or a dense ternary map of 2d bits, whichever is shorter,
plus ``b`` once. The realized wire side counts what the COO layout puts on
the collective: ``k_cap`` value slots plus ``k_cap`` int32 coordinates.
"""
from __future__ import annotations

import torch

INDEX_BITS = 32


def hybrid_branch_bits(n, d: int, per_item_bits, map_bits: float):
    """Section 3.3's two-branch minimum: ``n`` items at ``per_item_bits``
    each, or a dense map of ``map_bits`` per coordinate."""
    return torch.minimum(n * per_item_bits,
                         torch.as_tensor(float(d) * map_bits,
                                         dtype=torch.float32))


def dense_coding_bits(d: int, b: int = 32) -> float:
    """Uncompressed message: d floats."""
    return float(d) * b


def realized_wire_bits(layout: str, k_cap: int, d: int,
                       value_bits: float) -> float:
    """Bits one layer of a leaf puts on the collective under ``layout``."""
    if layout == "coo":
        return float(k_cap) * (value_bits + INDEX_BITS)
    if layout in ("bitmap", "dense", "rice"):
        raise NotImplementedError(
            f"wire layout {layout!r} is not ported yet (ROADMAP.md queue A "
            "item 8)")
    raise ValueError(f"unknown wire layout {layout!r}")
