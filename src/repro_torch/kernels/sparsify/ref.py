"""Plain PyTorch versions of the sparsify kernels.

Each function computes what its CUDA kernel in ``kernel.py`` computes, on
the same ``[rows, d]`` group layout and with the same per-row scalars: the
wrappers take them for CPU tensors, the CPU tests hold them against the JAX
package's Pallas kernels, and ``chip_smoke.py`` holds each kernel against
them on the card. They repeat the kernels' arithmetic and are no yardstick
of speed. They walk a group row by row, which bounds their scratch memory
on the full-width rows of the main path (one embedding row is 5.2e8
coordinates).

Sums accumulate in float64 and round to float32 once, like the kernels;
counts are exact integers. Per-element arithmetic is float32 in the order
the TPU kernels use, so every count, kept coordinate and emitted value is
bit-equal to the kernels' on the same inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.comm import compaction

F32 = torch.float32
F64 = torch.float64


def ntiles(d: int, tile: int) -> int:
    return -(-d // tile)


def stats_l1max_ref(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum|g|, max|g|) per row of ``g [rows, d]``, both float32."""
    l1 = torch.empty(g.shape[0], dtype=F32, device=g.device)
    mx = torch.empty_like(l1)
    for r in range(g.shape[0]):
        a = g[r].to(F32).abs()
        l1[r] = a.sum(dtype=F64)
        mx[r] = a.max() if a.numel() else 0.0
    return l1, mx


def tail_stats_ref(g: torch.Tensor, thresh: torch.Tensor,
                   gate: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(count, sum|g|) per row over the coordinates with ``|g| < thresh[row]``
    — the active, non-saturated set of Algorithm 3. Rows whose ``gate`` is
    False report (0, 0): nothing saturates there and the solver keeps its
    first lambda. Counts are int64."""
    cnt = torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
    l1 = torch.zeros(g.shape[0], dtype=F32, device=g.device)
    for r in range(g.shape[0]):
        a = g[r].to(F32).abs()
        below = a < thresh[r]
        c = below.sum()
        s = torch.where(below, a, 0.0).sum(dtype=F64)
        cnt[r] = torch.where(gate[r], c, 0)
        l1[r] = torch.where(gate[r], s, 0.0)
    return cnt, l1


def _sample(g_row: torch.Tensor, u_row: torch.Tensor, lam: torch.Tensor):
    """The gspar selector on one row: ``p = min(lam |g|, 1)``, ``z = u < p``,
    ``v = z ? g / p : 0`` in float32."""
    x = g_row.to(F32)
    a = x.abs()
    p = torch.clamp_max(lam * a, 1.0)
    z = u_row < p
    v = torch.where(z, x / torch.where(p > 0, p, 1.0), 0.0)
    return x, a, p, z, v


class SelectStats(NamedTuple):
    """Pass-1 reductions per row, plus the per-tile base ranks pass 2 uses."""
    nnz: torch.Tensor          # int32: survivors before the capacity cut
    nonzeros: torch.Tensor     # int32: |{i : g_i != 0}|
    p_sum: torch.Tensor        # float32: sum of keep probabilities
    den: torch.Tensor          # float32: sum g^2
    sum_sq: torch.Tensor       # float32: sum v^2 over the first k_cap survivors
    max_abs: torch.Tensor      # float32: max |v| over the first k_cap survivors
    base: torch.Tensor         # int32 [rows, tiles]: survivors before each tile


def select_stats_ref(g: torch.Tensor, u: torch.Tensor, lam: torch.Tensor,
                     k_cap: int, tile: int) -> SelectStats:
    rows, d = g.shape
    dev = g.device
    nt = ntiles(d, tile)
    nnz = torch.empty(rows, dtype=torch.int32, device=dev)
    nzc = torch.empty_like(nnz)
    psum = torch.empty(rows, dtype=F32, device=dev)
    den = torch.empty_like(psum)
    vsq = torch.empty_like(psum)
    vmx = torch.empty_like(psum)
    base = torch.empty((rows, nt), dtype=torch.int32, device=dev)
    for r in range(rows):
        _, a, p, z, v = _sample(g[r], u[r], lam[r])
        zi = z.to(torch.int32)
        rank = torch.cumsum(zi, 0, dtype=torch.int32) - zi
        keep = z & (rank < k_cap)
        vk = torch.where(keep, v, 0.0)
        per_tile = torch.zeros(nt * tile, dtype=torch.int32, device=dev)
        per_tile[:d] = zi
        counts = per_tile.view(nt, tile).sum(1, dtype=torch.int32)
        base[r] = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        nnz[r] = zi.sum()
        nzc[r] = (a > 0).sum()
        psum[r] = p.sum(dtype=F64)
        den[r] = (a * a).sum(dtype=F64)
        vsq[r] = (vk * vk).sum(dtype=F64)
        vmx[r] = vk.abs().max() if d else 0.0
    return SelectStats(nnz, nzc, psum, den, vsq, vmx, base)


def compact_emit_ref(g: torch.Tensor, u: torch.Tensor, lam: torch.Tensor,
                     k_cap: int, wire_dtype: torch.dtype, ef: bool,
                     round_residual: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor | None]:
    """Pass 2: the first ``k_cap`` survivors of each row in coordinate order
    as ``values [rows, k_cap]`` (rounded to ``wire_dtype``) and ``idx [rows,
    k_cap]`` (int32); unused slots hold idx 0 and value 0. With ``ef`` also
    the residual ``g - encoded value`` in g's dtype, where every survivor is
    subtracted, those dropped past ``k_cap`` included; the encoded value is
    rounded to ``wire_dtype`` only with ``round_residual`` (a rounding
    codec)."""
    rows, d = g.shape
    vals = torch.zeros((rows, k_cap), dtype=wire_dtype, device=g.device)
    idx = torch.zeros((rows, k_cap), dtype=torch.int32, device=g.device)
    res = torch.empty_like(g) if ef else None
    for r in range(rows):
        x, _, _, z, v = _sample(g[r], u[r], lam[r])
        ev = v.to(wire_dtype)
        kept = torch.nonzero(z).reshape(-1)[:k_cap]
        n = kept.numel()
        vals[r, :n] = ev[kept]
        idx[r, :n] = kept.to(torch.int32)
        if ef:
            enc = ev.to(F32) if round_residual else v
            res[r] = (x - torch.where(z, enc, 0.0)).to(g.dtype)
    return vals, idx, res


def rice_pack_ref(idx: torch.Tensor, nnz: torch.Tensor, d: int,
                  r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Golomb-Rice packing of each row's compact stream ``idx [rows, k_cap]``
    (ascending over its first ``min(nnz, k_cap)`` slots): the port's
    encoder, ``compaction.rice_encode``'s sorted path, row by row. Returns
    ``(words [rows, rice_cap_words], used [rows])``, int32."""
    rows, k_cap = idx.shape
    cap = compaction.rice_cap_words(k_cap, d, r)
    words = torch.empty((rows, cap), dtype=torch.int32, device=idx.device)
    used = torch.empty(rows, dtype=torch.int32, device=idx.device)
    for row in range(rows):
        _, sidx = compaction.coordinate_order(idx[row], idx[row], d,
                                              nnz=nnz[row])
        words[row], used[row] = compaction._rice_pack_gaps(
            compaction._rice_gaps(sidx, d), r, cap)
    return words, used
