"""Fixed-capacity compaction helpers (port of the compact/scatter half of
``repro.comm.compaction`` that the COO gather wire uses).

Collectives move static shapes, so a sparse message is a fixed-capacity
``(values[k_cap], idx[k_cap])`` pair with

    k_cap = ceil(capacity_slack * rho * d)   (rounded up to a multiple of 128)

The bitmap and Golomb-Rice index codecs are ROADMAP.md queue A item 8.
"""
from __future__ import annotations

import torch

# One bucket's concatenated coordinate space is addressed with int32.
INT32_COORD_LIMIT = 2**31 - 1


def check_bucket_coords(total_coords: int, n_leaves: int) -> None:
    """Guard the int32 coordinate space of one bucketed collective."""
    if total_coords > INT32_COORD_LIMIT:
        raise ValueError(
            f"sparse-wire bucket would span {total_coords} coordinates "
            f"across {n_leaves} leaves, past the int32 index limit "
            f"({INT32_COORD_LIMIT}); oversized buckets are chunked by "
            "grouping.chunk_spans, so a caller bypassed the chunker")


def capacity_for(d: int, rho: float, slack: float = 1.25) -> int:
    """Static message capacity for a leaf of size d at target density rho."""
    k = (int(slack * rho * d) + 127) // 128 * 128
    return min(d, max(128, k))


def scatter(vals: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    """Dense reconstruction ``zeros(d)[idx] += vals`` (float32). Padding
    slots add exact zeros; live coordinates are unique per message."""
    out = torch.zeros(d, dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.reshape(-1).long(),
                          vals.reshape(-1).to(torch.float32))
