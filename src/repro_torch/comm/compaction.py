"""Fixed-capacity compaction and the index codecs of the wire layouts (port
of ``repro.comm.compaction``: capacity, scatter, the bitmap codec and the
static-parameter Golomb-Rice codec).

Collectives move static shapes, so a sparse message is a fixed-capacity
``(values[k_cap], idx[k_cap])`` pair with

    k_cap = ceil(capacity_slack * rho * d)   (rounded up to a multiple of 128)

Every function here is plain PyTorch over a trailing message axis, with any
leading batch dims (rows of a group, gathered workers). Words are int32 bit
patterns, LSB-first, bit for bit the JAX package's. Bits are packed and
unpacked through little-endian ``uint8`` views of the words (the byte order
of x86 hosts and of CUDA devices), because torch has no uint32 shifts on
every backend.

Golomb-Rice stream layout per row (what makes a parallel fixed-shape decode
possible)::

    [ k_cap fixed r-bit remainders | unary quotients | zero padding ]

The remainder field has a static size; in the unary field every code is
``q`` one-bits and a zero terminator, so the i-th zero bit ends code i.
"""
from __future__ import annotations

import torch

# One bucket's concatenated coordinate space is addressed with int32.
INT32_COORD_LIMIT = 2**31 - 1

WORD_BITS = 32
# Rice shifts stay inside int32 coordinate arithmetic.
RICE_MAX_R = 30

I32 = torch.int32
U8 = torch.uint8


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


def slot_tiles(rows: int, k: int, units: int):
    """``(a, b, j0, j1)`` tiles of a ``[rows, k]`` buffer of at most
    ``units`` slots each, row batches first (a row longer than ``units``
    goes in column chunks): the unit of work of the row-batched passes
    over compact buffers, which bounds their temporaries."""
    cols = max(1, min(k, units))
    step = max(1, units // max(1, k))
    for a in range(0, rows, step):
        for j0 in range(0, k, cols):
            yield a, min(rows, a + step), j0, min(k, j0 + cols)


def bitmap_words(d: int) -> int:
    """int32 words of a d-bit occupancy map."""
    return -(-d // WORD_BITS)


def _arange(n: int, like: torch.Tensor, dtype=I32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def coordinate_order(vals: torch.Tensor, idx: torch.Tensor, d: int,
                     nnz: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, idx) [..., k]`` -> ``(svals, sidx)`` with live slots
    ascending by coordinate and dead slots keyed to the sentinel ``d`` at
    the tail (the liveness rule of the bitmap and RICE codecs).

    Generic path (``nnz`` None): a slot is live iff its value is nonzero;
    the keys sort alone and each value finds its slot by rank. Sorted path
    (``nnz [...]`` given): the valid prefix ``min(nnz, k)`` is already
    ascending (the port's counting compaction), values stay put and only
    the dead tail is re-keyed."""
    k = vals.shape[-1]
    if nnz is None:
        key = torch.where(vals != 0, idx, d)
        sidx = torch.sort(key, dim=-1).values
        pos = torch.searchsorted(sidx, key.contiguous(), side="left")
        pos = torch.where(key < d, pos, k)              # dead slots: dropped
        svals = torch.zeros(vals.shape[:-1] + (k + 1,), dtype=vals.dtype,
                            device=vals.device)
        return svals.scatter_(-1, pos, vals)[..., :k], sidx
    valid = _arange(k, idx) < torch.clamp_max(nnz, k)[..., None]
    return vals, torch.where(valid, idx, d).to(I32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 array ``[..., n * 32]`` (LSB-first per word) -> int32 words
    ``[..., n]``."""
    b = bits.to(U8).reshape(bits.shape[:-1] + (-1, 8))
    byte = (b << _arange(8, b, U8)).sum(-1, dtype=U8)
    return byte.view(I32)


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words ``[..., W]`` -> uint8 0/1 array ``[..., W * 32]``,
    LSB-first."""
    byte = words.contiguous().view(U8)
    bits = (byte[..., None] >> _arange(8, byte, U8)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))


def bitmap_pack(vals: torch.Tensor, idx: torch.Tensor, d: int,
                nnz: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, idx)`` -> ``(coordinate-ordered values, occupancy words
    [..., bitmap_words(d)])``; dead slots carry no bit."""
    svals, sidx = coordinate_order(vals, idx, d, nnz=nnz)
    nbits = bitmap_words(d) * WORD_BITS
    occ = torch.zeros(sidx.shape[:-1] + (nbits + 1,), dtype=U8,
                      device=sidx.device)
    occ.scatter_(-1, torch.where(sidx < d, sidx, nbits).long(), 1)
    return svals, _pack_bits(occ[..., :nbits])


def bitmap_select(words: torch.Tensor, vals: torch.Tensor,
                  d: int) -> torch.Tensor:
    """Dense reconstruction of a bitmap-coded message: ``words [..., W]`` and
    coordinate-ordered ``vals [..., k]`` -> ``[..., d]``; each set bit
    gathers the value of its rank, unset coordinates are exact zeros."""
    mask = _unpack_bits(words)[..., :d]
    rank = torch.cumsum(mask, -1, dtype=I32) - 1
    sel = torch.gather(vals, -1,
                       torch.clamp(rank, 0, vals.shape[-1] - 1).long())
    return torch.where(mask != 0, sel, torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device))


def rice_cap_words(k_cap: int, d: int, r: int) -> int:
    """int32 words that bound any Rice-coded index stream of one row: k_cap
    codes of (r + 1) fixed bits plus a unary quotient mass of at most
    ``(d - 1) >> r``. The payload shape on the collective."""
    return -(-(k_cap * (r + 1) + ((max(d, 1) - 1) >> r)) // WORD_BITS)


def rice_encode(vals: torch.Tensor, idx: torch.Tensor, d: int, r: int,
                nnz: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(values, idx) [..., k]`` -> ``(coordinate-ordered values, code
    words [..., rice_cap_words], used word counts [...])``. Exactly k gaps
    are coded: live slots their delta, dead slots a zero quotient."""
    svals, sidx = coordinate_order(vals, idx, d, nnz=nnz)
    words, used = _rice_pack_gaps(_rice_gaps(sidx, d), r,
                                  rice_cap_words(svals.shape[-1], d, r))
    return svals, words, used


def _rice_gaps(sidx: torch.Tensor, d: int) -> torch.Tensor:
    """Coordinate-ordered stream -> the gap-1 codes: live slots their
    sorted-coordinate delta minus one, dead slots (sentinel ``d``) 0."""
    first = torch.full(sidx.shape[:-1] + (1,), -1, dtype=I32,
                       device=sidx.device)
    prev = torch.cat([first, sidx[..., :-1]], -1)
    return torch.where(sidx < d, sidx - prev - 1, 0).to(I32)


def _rice_pack_gaps(x: torch.Tensor, r: int, cap_words: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack gap-1 codes ``x [..., k]`` at parameter ``r`` into ``cap_words``
    int32 words. Returns ``(words [..., cap_words], used [...] int32)``."""
    batch, k = x.shape[:-1], x.shape[-1]
    q = (x >> r).long()
    u_cap = cap_words * WORD_BITS - k * r
    # remainder field: k * r bits at offset 0, LSB-first per code
    rbits = ((x[..., None] >> _arange(r, x)) & 1).reshape(batch + (k * r,))
    # unary field: q_i one-bits then a 0 terminator; terminator i lands at
    # (inclusive cumsum q)_i + i, inside u_cap by the capacity bound
    tpos = torch.cumsum(q, -1) + _arange(k, x, torch.long)
    total_unary = q.sum(-1) + k
    tmark = torch.zeros(batch + (u_cap + 1,), dtype=U8, device=x.device)
    tmark.scatter_(-1, torch.clamp_max(tpos, u_cap), 1)
    ubits = ((_arange(u_cap, x, torch.long) < total_unary[..., None])
             & (tmark[..., :u_cap] == 0))
    words = _pack_bits(torch.cat([rbits.to(U8), ubits.to(U8)], -1))
    used = (k * r + total_unary + WORD_BITS - 1) // WORD_BITS
    return words, used.to(I32)


def _cumsum_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inclusive cumsum along the last dim, taken as one scan over the
    flattened tensor and rebased per row: on CUDA torch scans a flat
    tensor an order of magnitude faster than a few long rows."""
    flat = torch.cumsum(x.reshape(-1), 0, dtype=dtype).reshape(x.shape)
    return flat - (flat[..., :1] - x[..., :1].to(dtype))


def rice_decode(words: torch.Tensor, k_cap: int, d: int,
                r: int) -> torch.Tensor:
    """Coordinates of a Rice-coded message: ``words [..., W]`` -> ``idx
    [..., k_cap]`` (int32, ascending). Slots past the live count decode to
    what the tail's zero-quotient codes add up to (below ``d + k_cap``); the
    receiver masks them by their zero value."""
    batch = words.shape[:-1]
    bits = _unpack_bits(words)
    if r > 0:
        rb = bits[..., :k_cap * r].reshape(batch + (k_cap, r)).to(I32)
        rem = (rb << _arange(r, rb)).sum(-1, dtype=I32)
    else:
        rem = torch.zeros(batch + (k_cap,), dtype=I32, device=words.device)
    # the flat scans run over all rows at once: int32 while their totals
    # stay below 2^31 (a row has 32 W bits, and its gaps add up to less
    # than d + k_cap)
    count_dtype = I32 if words.numel() * WORD_BITS < 2**31 else torch.int64
    # every zero bit of the unary field ends a code: code i's terminator is
    # the first position where the running count of zeros reaches i + 1
    zeros = _cumsum_rows(bits[..., k_cap * r:] == 0, count_dtype)
    del bits
    tgt = _arange(k_cap, words, count_dtype).add_(1).expand(
        batch + (k_cap,)).contiguous()
    zpos = torch.searchsorted(zeros, tgt, side="left", out_int32=True)
    del zeros, tgt
    first = torch.full(batch + (1,), -1, dtype=I32, device=words.device)
    q = zpos - torch.cat([first, zpos[..., :-1]], -1) - 1
    gaps = ((q << r) | rem) + 1
    rows = gaps.numel() // max(1, k_cap)
    wide = rows * (d + k_cap) >= 2**31
    return (_cumsum_rows(gaps, torch.int64 if wide else I32) - 1).to(I32)
