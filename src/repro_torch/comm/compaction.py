"""Fixed-capacity compaction and the index codecs of the wire layouts (port
of ``repro.comm.compaction``: capacity, scatter, the bitmap codec, the
static-parameter Golomb-Rice codec and its data-fitted twin, wire-format
v4).

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

Wire-format v4 fits r per row over a static window of candidates
(``coding.rice_fit_window``) and ships the choice in the high bits of the
row's phase-one counts word: ``(r << RICE_HDR_SHIFT) | used``. The payload
capacity is the window's largest (``rice_fit_cap_words``), and the receiver
decodes each row once, at the r its header names (``rice_decode_rows``). A
zero header (the adaptive loop's skip sentinel) names r = 0 over zero
words; every slot of such a row carries a zero value, so the receiver's
zero-value masking drops it whole.
"""
from __future__ import annotations

import functools

import torch

# One bucket's concatenated coordinate space is addressed with int32.
INT32_COORD_LIMIT = 2**31 - 1

WORD_BITS = 32
# Rice shifts stay inside int32 coordinate arithmetic.
RICE_MAX_R = 30
# The fitted header: r (at most RICE_MAX_R, 5 bits) above a 26-bit used
# count, so the sign bit stays clear. Static counts have no high bits, and
# masking with RICE_HDR_USED_MASK is the identity on them.
RICE_HDR_SHIFT = 26
RICE_HDR_USED_MASK = (1 << RICE_HDR_SHIFT) - 1

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


def compact(q: torch.Tensor, k_cap: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the nonzeros of q into ``(values[k_cap], idx[k_cap], nnz)``:
    the ``k_cap`` largest magnitudes, ties at the k_cap-th by lowest
    coordinate (``lax.top_k``'s order), never a zero; ``nnz`` is the
    nonzero count *before* the capacity cut (overflow is ``max(nnz - k_cap,
    0)``). ``q`` is one vector or a ``[rows, d]`` group (then per row).
    Unused slots hold idx 0 and value 0, so a scatter-add reconstructs q
    less the overflow. The JAX package orders the buffer by descending
    magnitude; here it ascends by coordinate (the counting compaction of
    ``kernels.sparsify.ops.magnitude_compact``: on the card its hand
    kernels, no sort), which its wire codecs sort into anyway (ROADMAP.md
    C)."""
    from repro_torch.kernels.sparsify import ops     # ops imports this
    row = q.dim() == 1
    c = ops.magnitude_compact(q.reshape(1, -1) if row else q.contiguous(),
                              k_cap=k_cap)
    if row:
        return c.values[0], c.idx[0], c.nnz[0]
    return c.values, c.idx, c.nnz


def live_prefix(vals: torch.Tensor, idx: torch.Tensor, n_valid: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The nonzero-valued slots of each row's ascending prefix ``[0,
    min(n_valid, k))`` moved to the front, in order: ``(values, idx,
    live)`` with the other slots idx 0 and value 0 and ``live`` their
    count (int32). This is ``coordinate_order``'s generic liveness rule
    (a zero value is no slot) on a coordinate-sorted buffer, by one scan
    and a scatter instead of a sort."""
    k = vals.shape[-1]
    keep = (_arange(k, idx) < torch.clamp_max(n_valid, k)[..., None]) \
        & (vals != 0)
    pos = torch.cumsum(keep, -1) - 1
    pos = torch.where(keep, pos, k)                 # dropped: a scratch slot
    shape = vals.shape[:-1] + (k + 1,)
    out_v = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    out_i = torch.zeros(shape, dtype=idx.dtype, device=idx.device)
    out_v.scatter_(-1, pos, torch.where(keep, vals, 0))
    out_i.scatter_(-1, pos, torch.where(keep, idx, 0))
    return (out_v[..., :k].contiguous(), out_i[..., :k].contiguous(),
            keep.sum(-1, dtype=I32))


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


@functools.lru_cache(maxsize=1024)
def rice_fit_cap_words(k_cap: int, d: int, window: tuple[int, ...]) -> int:
    """Word capacity of a fitted stream: the largest over the window (the
    payload must hold whichever candidate the data picks). Raises where a
    row's used count could reach the header's 2^26, rather than truncate.
    Cached: the kernels' wrappers ask for it on every call."""
    cap = max(rice_cap_words(k_cap, d, r) for r in window)
    if cap > RICE_HDR_USED_MASK:
        raise ValueError(f"a fitted Golomb-Rice row of k_cap={k_cap}, d={d} "
                         f"can use {cap} words, past the counts header's "
                         f"{RICE_HDR_USED_MASK}")
    return cap


def rice_fit_used(x: torch.Tensor, window: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of gap-1 codes ``x [..., k]``: the fitted ``(r, header)``,
    int32. Each candidate's used words are ``ceil((k r + sum(x >> r) + k)
    / 32)``; the first minimum over the ascending window wins."""
    k = x.shape[-1]
    x64 = x.long()
    best_u = best_r = None
    for r in window:
        u = (k * r + (x64 >> r).sum(-1) + k + WORD_BITS - 1) // WORD_BITS
        if best_u is None:
            best_u, best_r = u, torch.full_like(u, r)
        else:
            better = u < best_u
            best_u = torch.where(better, u, best_u)
            best_r = torch.where(better, r, best_r)
    return (best_r.to(I32),
            ((best_r << RICE_HDR_SHIFT) | best_u).to(I32))


def rice_encode_fitted(vals: torch.Tensor, idx: torch.Tensor, d: int,
                       window: tuple[int, ...],
                       nnz: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The data-fitted twin of ``rice_encode``: ``(coordinate-ordered
    values, words [..., rice_fit_cap_words], header [...])``, each row
    packed at the window's first minimum of used words, ``header = (r <<
    RICE_HDR_SHIFT) | used``. Plain: it packs every candidate and keeps
    each row's own, as the JAX package's encoder does."""
    svals, sidx = coordinate_order(vals, idx, d, nnz=nnz)
    x = _rice_gaps(sidx, d)
    cap = rice_fit_cap_words(svals.shape[-1], d, window)
    r_rows, header = rice_fit_used(x, window)
    words = torch.zeros(x.shape[:-1] + (cap,), dtype=I32, device=x.device)
    for r in window:
        w, _ = _rice_pack_gaps(x, r, cap)
        words = torch.where((r_rows == r)[..., None], w, words)
    return svals, words, header


def rice_decode_fitted(words: torch.Tensor, k_cap: int, d: int,
                       window: tuple[int, ...],
                       header: torch.Tensor) -> torch.Tensor:
    """Coordinates of fitted streams: each row decoded once, at the r its
    ``header`` names (``rice_decode_rows``); a zero header (r = 0 over
    zero words, a dead row) decodes at ``window[0]``."""
    r_rows = (header >> RICE_HDR_SHIFT) & 0x1F
    return rice_decode_rows(words, k_cap, d, r_rows, r_min=window[0])


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


def rice_decode_rows(words: torch.Tensor, k_cap: int, d: int,
                     r_rows: torch.Tensor, r_min: int) -> torch.Tensor:
    """``rice_decode`` with a parameter per row: ``words [..., W]`` and
    ``r_rows [...]`` (on the device: no host sync) -> ``idx [..., k_cap]``.
    A row's r is taken at least ``r_min`` (the window's smallest: a zero
    header, the skip sentinel, decodes there, as the JAX package decodes
    it). Each row's remainders are read from its words at bit ``i r`` (the
    two words they span joined in int64, shifted and masked); its unary
    field starts at bit ``k_cap r``. One cumsum counts the zero bits from
    bit ``k_cap r_min`` on, the zeros of the row's own remainder field
    before its unary field are subtracted, and code i ends where the count
    reaches i + 1 past them."""
    batch = words.shape[:-1]
    dev = words.device
    r = torch.clamp_min(r_rows.to(I32), r_min).reshape(batch + (1,))
    wide = k_cap * RICE_MAX_R >= 2**31
    slot = _arange(k_cap, words, torch.int64 if wide else I32)
    pos = slot * r                                    # each remainder's bit
    wi = (pos >> 5).long()
    w64 = torch.cat([words.to(torch.int64) & 0xFFFFFFFF,
                     torch.zeros(batch + (1,), dtype=torch.int64,
                                 device=dev)], -1)
    pair = (torch.gather(w64, -1, wi)
            | (torch.gather(w64, -1, wi + 1) << 32))
    del w64, wi
    rem = ((pair >> (pos & 31)) & ((1 << r) - 1)).to(I32)
    del pair, pos
    bits = _unpack_bits(words)[..., k_cap * r_min:]
    count_dtype = I32 if bits.numel() < 2**31 else torch.int64
    zeros = _cumsum_rows(bits == 0, count_dtype)
    del bits
    start = (k_cap * (r - r_min)).to(count_dtype)     # the unary field
    before = torch.where(
        start > 0, torch.gather(zeros, -1, torch.clamp_min(start - 1, 0)),
        0)
    tgt = (_arange(k_cap, words, count_dtype) + 1 + before).contiguous()
    zpos = torch.searchsorted(zeros, tgt, side="left", out_int32=True)
    del zeros, tgt
    prev = torch.cat([start.to(I32) - 1, zpos[..., :-1]], -1)
    q = zpos - prev - 1
    del zpos, prev
    gaps = ((q << r) | rem) + 1
    del q, rem
    rows = gaps.numel() // max(1, k_cap)
    wide = rows * (d + k_cap) >= 2**31
    return (_cumsum_rows(gaps, torch.int64 if wide else I32) - 1).to(I32)
