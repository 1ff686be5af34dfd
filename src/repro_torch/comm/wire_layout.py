"""Wire layouts for the bucketed sparse collectives (port of
``repro.comm.wire_layout``, COO only).

A leaf's buffers travel under a statically chosen layout. This slice ships
``coo``: ``k_cap`` codec-encoded values plus ``k_cap`` int32 coordinates
per row. The bitmap, dense and Golomb-Rice layouts, and ``auto`` (the
argmin over them, which picks RICE at the main path's density), are
ROADMAP.md queue A item 8.
"""
from __future__ import annotations

import dataclasses

import torch


def value_bits_of(dtype: torch.dtype) -> float:
    """Wire width of one value slot in bits."""
    return float(torch.empty((), dtype=dtype).element_size() * 8)


def choose(k_cap: int, d: int, value_bits: float,
           override: str = "coo") -> str:
    if override != "coo":
        raise NotImplementedError(
            f"wire layout {override!r} is not ported yet (ROADMAP.md queue A "
            "item 8: bitmap, dense, rice and the auto chooser)")
    return override


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Static wire description of one group's segments inside a bucket."""
    layout: str
    layers: int              # rows of the group
    d: int                   # coordinates per row
    k_cap: int
    val_len: int             # value slots per row on the wire
    idx_len: int             # int32 index words per row on the wire

    @property
    def block(self) -> int:
        """Coordinates this group spans in the bucket's flat space."""
        return self.layers * self.d


def plan(sg) -> LeafPlan:
    if sg.layout != "coo":
        choose(sg.k_cap, sg.d, 0.0, sg.layout)
    return LeafPlan(layout="coo", layers=sg.rows, d=sg.d, k_cap=sg.k_cap,
                    val_len=sg.k_cap, idx_len=sg.k_cap)


def pack(sg, lp: LeafPlan) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """``(values [rows, val_len], index words [rows, idx_len], used word
    counts [rows])``: for COO the compact pair itself (row-local
    coordinates; the bucket adds its offsets) and zero counts."""
    return sg.values, sg.idx, torch.zeros(lp.layers, dtype=torch.int32,
                                          device=sg.idx.device)


def unpack_gathered(lp: LeafPlan, decoded: torch.Tensor,
                    widx: torch.Tensor | None,
                    coord_off: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One group's gathered, decoded segment -> scatter-ready ``(updates
    [m, X], coords [m, X])`` in the bucket's flat space; COO words arrive
    already offset."""
    return decoded, widx
