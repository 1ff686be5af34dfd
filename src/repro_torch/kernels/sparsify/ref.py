"""Plain PyTorch versions of the sparsify kernels.

Each function computes what its CUDA kernel in ``kernel.py`` computes, on
the same ``[rows, d]`` group layout and with the same per-row scalars: the
wrappers take them for CPU tensors, the CPU tests hold them against the JAX
package's Pallas kernels, and ``chip_smoke.py`` holds each kernel against
them on the card. They repeat the kernels' arithmetic and are no yardstick
of speed. They walk a group row by row, which bounds their scratch memory
on the full-width rows of the main path (one embedding row is 5.2e8
coordinates).

Sums accumulate in float64 and round to float32 once, like the kernels
(the dense emit's kernel first sums a thread's eight squares in float32:
within rtol 1e-6 of these); counts are exact integers. Per-element
arithmetic is float32 in the order the TPU kernels use, so every count,
kept coordinate and emitted value is bit-equal to the kernels' on the same
inputs.
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


def stats_ref(g: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum|g|, sum g^2, max|g|) per row of ``g [rows, d]``, float32: sum|g|
    and max|g| formed exactly as ``stats_l1max_ref`` forms them, and sum
    g^2 over the float32 squares the same way (one float64 row sum rounded
    once)."""
    l1 = torch.empty(g.shape[0], dtype=F32, device=g.device)
    l2 = torch.empty_like(l1)
    mx = torch.empty_like(l1)
    for r in range(g.shape[0]):
        a = g[r].to(F32).abs()
        l1[r] = a.sum(dtype=F64)
        l2[r] = (a * a).sum(dtype=F64)
        mx[r] = a.max() if a.numel() else 0.0
    return l1, l2, mx


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


def magnitude_keys(g_row: torch.Tensor) -> torch.Tensor:
    """The bit pattern of ``|g|`` as a non-negative int32 key, monotone in
    |g| for finite values: ``bits & 0x7fff`` for bfloat16 and ``bits &
    0x7fffffff`` for float32."""
    if g_row.dtype == torch.bfloat16:
        return g_row.view(torch.int16).to(torch.int32) & 0x7FFF
    if g_row.dtype == F32:
        return g_row.view(torch.int32) & 0x7FFFFFFF
    raise ValueError(f"no magnitude key for {g_row.dtype}")


def topk_threshold_ref(g: torch.Tensor, k_target: int,
                       bits: tuple[int, ...]) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Per row of ``g [rows, d]``: ``t``, the ``k_target``-th largest |g|
    (float32), and ``budget = k_target - #{|g| > t}`` (int64), by the
    kernel's radix select on the magnitude keys: each round counts
    ``bits[i]`` bits of the key (from the top, ``torch.bincount``) among
    the coordinates whose higher bits equal the prefix so far, then takes
    the bin that holds the remaining rank, counting the bins above it out
    of ``k_target``. A row with fewer nonzeros than ``k_target`` ends at
    key 0: t = 0, budget = k_target - nnz."""
    rows, d = g.shape
    if not 1 <= k_target <= d:
        raise ValueError(f"k_target {k_target} outside [1, {d}]")
    key_bits = 15 if g.dtype == torch.bfloat16 else 31
    if sum(bits) != key_bits:
        raise ValueError(f"rounds {bits} do not cover {key_bits} key bits")
    t = torch.empty(rows, dtype=F32, device=g.device)
    budget = torch.empty(rows, dtype=torch.int64, device=g.device)
    for r in range(rows):
        keys = magnitude_keys(g[r])
        prefix, left, shift = 0, k_target, key_bits
        for i, b in enumerate(bits):
            shift -= b
            if i:
                keys = keys[(keys >> (shift + b)) == prefix]
            hist = torch.bincount((keys >> shift) & ((1 << b) - 1),
                                  minlength=1 << b)
            from_top = torch.cumsum(hist.flip(0), 0)
            j = int(torch.searchsorted(from_top, left))
            left -= int(from_top[j]) - int(hist[(1 << b) - 1 - j])
            prefix = (prefix << b) | ((1 << b) - 1 - j)
        key = prefix << 16 if g.dtype == torch.bfloat16 else prefix
        t[r] = torch.tensor(key, dtype=torch.int32).view(F32)
        budget[r] = left
    return t, budget


# the bins of a bfloat16 row: the 15 bits of |g|'s pattern, one value each
KEY_BINS = 1 << 15


def magnitude_counts(g: torch.Tensor) -> torch.Tensor:
    """Per row of a bfloat16 ``g [rows, d]``: the count of each magnitude
    key, ``[rows, 2^15]`` int32 (``torch.bincount``)."""
    return torch.stack([torch.bincount(magnitude_keys(row),
                                       minlength=KEY_BINS).to(torch.int32)
                        for row in g])


def _key_values(device) -> torch.Tensor:
    """The float32 value of each bfloat16 magnitude key."""
    return (torch.arange(KEY_BINS, dtype=torch.int32, device=device)
            << 16).view(F32)


class CompactBins(NamedTuple):
    """The row scalars of a bfloat16 group's magnitude compaction at
    ``k_cap``, all from the row's magnitude histogram (``compact_bins``)."""
    t: torch.Tensor            # float32: the k_cap-th largest |g| (0 where
                               # the row has fewer nonzeros)
    budget: torch.Tensor       # int64: ties |g| == t to keep
    nonzeros: torch.Tensor     # int32: |{i : g_i != 0}|
    kept: torch.Tensor         # int32: min(k_cap, nonzeros)
    sum_sq: torch.Tensor       # float32: sum v^2 over the kept values
    max_abs: torch.Tensor      # float32: max |v| over the kept values


def compact_bins_ref(g: torch.Tensor, k_cap: int) -> CompactBins:
    """``compact_bins``: per row of a bfloat16 ``g [rows, d]`` its
    magnitude histogram, then from the counts alone (a bin is one value)
    the threshold and tie budget of ``topk_threshold_ref`` at ``k_target =
    k_cap``, the nonzeros (d less bin 0), the kept count, and sum v^2 (each
    v^2 rounded to float32, as pass 1 squares; one float64 sum rounded
    once) and max|v| over the kept values: the bins above t and ``budget``
    values t."""
    rows, d = g.shape
    if not 1 <= k_cap <= d:
        raise ValueError(f"k_cap {k_cap} outside [1, {d}]")
    cnt = magnitude_counts(g).to(torch.int64)
    from_top = torch.cumsum(cnt.flip(-1), -1)
    want = torch.full((rows, 1), k_cap, dtype=torch.int64, device=g.device)
    j = torch.searchsorted(from_top, want)          # first reaching k_cap
    key = KEY_BINS - 1 - j[:, 0]
    budget = k_cap - (from_top.gather(1, j)[:, 0]
                      - cnt.gather(1, key[:, None])[:, 0])
    val = _key_values(g.device)
    sq = (val * val).to(F64)
    bins = torch.arange(KEY_BINS, device=g.device)
    above = (bins > key[:, None]) & (cnt > 0)
    sum_sq = (torch.where(above, cnt.to(F64) * sq, 0.0).sum(-1)
              + budget.to(F64) * sq[key])
    top = torch.where(cnt > 0, bins, 0).amax(-1)
    nonzeros = (d - cnt[:, 0]).to(torch.int32)
    return CompactBins(val[key], budget, nonzeros,
                       torch.clamp_max(nonzeros, k_cap), sum_sq.to(F32),
                       val[top])


def closed_lambda_bins_ref(counts: torch.Tensor, eps: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2's lambda of each bfloat16 row from its magnitude
    histogram ``counts [rows, 2^15]``: ``(lam [rows] float32, bin [rows]
    int32)``. A bin holds one value, so the condition of
    ``sparsify.closed_form_lambda`` is constant over a bin's run in
    descending order, and k* is the first position of the highest bin b
    where it holds. With v a bin's value, s1 = c v and s2 = c v^2 (float64;
    0 for an empty bin: no inf x 0), T and L the sums of s1 and s2 over the
    bins below and S the row's sum of s2, the condition at a non-empty bin
    is ``v T <= eps S + L``, and ``lambda = (s1 + T) / (eps S + s2 + L)``
    at b, rounded to float32 once. Where no bin qualifies (eps < 0): lambda
    0 and bin -1, as the JAX package's fused path takes lambda = 0."""
    dev = counts.device
    cnt = counts.to(torch.int64)
    v64 = torch.where(cnt > 0, _key_values(dev).to(F64), 0.0)
    s1 = cnt.to(F64) * v64
    s2 = s1 * v64
    total = s2.sum(-1, keepdim=True)
    t_low = torch.cumsum(s1, -1) - s1
    l_low = torch.cumsum(s2, -1) - s2
    c = (cnt > 0) & (v64 * t_low <= eps * total + l_low)
    b = torch.where(c, torch.arange(KEY_BINS, device=dev), -1).amax(-1)
    j = b.clamp_min(0)[:, None]
    num = (s1.gather(1, j) + t_low.gather(1, j))[:, 0]
    den = (eps * total[:, 0] + s2.gather(1, j)[:, 0]
           + l_low.gather(1, j)[:, 0])
    ok = den > 0
    lam = torch.where(ok, num / torch.where(ok, den, 1.0), 0.0).to(F32)
    return torch.where(b >= 0, lam, 0.0), b.to(torch.int32)


# The deterministic rounding's uniform: the float32 just below 0.5, so that
# ``u < frac`` holds exactly where a float32 frac is at least 0.5.
DET_U = float(torch.nextafter(torch.tensor(0.5), torch.tensor(0.0)))

PKINDS = ("lam", "rho", "bern", "topk")
# the dense wire's kinds: passes 1-2's and the identity selector's
DENSE_KINDS = PKINDS + ("one",)


def _select_row(pkind: str, g_row: torch.Tensor, u_row, s1, s2, budget):
    """One row's selector, in float32 and in the TPU kernel's order of
    operations (``_tile_select``, src/repro/kernels/sparsify/kernel.py:302).
    Returns ``(x, a, p, z, v)``: the row as float32, ``|x|``, the keep
    probabilities, the kept mask and the transmitted values.

      lam  -- gspar: p = min(s1 |g|, 1)
      rho  -- unisp: p = s1 on the support, 0 off it
      bern -- bernoulli: p = |g| / s2 (s2 = max|g|)
      topk -- keep |g| > s1 (the k-th magnitude), and the first ``budget``
              coordinates with |g| == s1 > 0 (XLA top_k's lowest-index
              tie break); p = 1 on the kept, v = g

    The sampling selectors keep ``u < p`` and send ``g / p``."""
    x = g_row.to(F32)
    a = x.abs()
    if pkind == "topk":
        tie = (a == s1) & (s1 > 0)
        ti = tie.to(torch.int64)
        tie_rank = torch.cumsum(ti, 0) - ti                # exclusive
        z = (a > s1) | (tie & (tie_rank < budget))
        return x, a, z.to(F32), z, torch.where(z, x, 0.0)
    if pkind == "lam":
        p = torch.clamp_max(s1 * a, 1.0)
    elif pkind == "rho":
        p = torch.where(a > 0, s1, 0.0)
    elif pkind == "bern":
        p = torch.where(s2 > 0, a / torch.where(s2 > 0, s2, 1.0), 0.0)
    else:
        raise ValueError(f"unknown select kind {pkind!r}; have {PKINDS}")
    z = u_row < p
    v = torch.where(z, x / torch.where(p > 0, p, 1.0), 0.0)
    return x, a, p, z, v


def _row(t: torch.Tensor | None, r: int):
    return None if t is None else t[r]


def _tile_sums(flags: torch.Tensor, nt: int, tile: int) -> torch.Tensor:
    """Per-tile counts of a row's 0/1 int32 ``flags`` and their exclusive
    scan: the base offset of each tile."""
    per_tile = torch.zeros(nt * tile, dtype=torch.int32, device=flags.device)
    per_tile[:flags.numel()] = flags
    counts = per_tile.view(nt, tile).sum(1, dtype=torch.int32)
    return torch.cumsum(counts, 0, dtype=torch.int32) - counts


class SelectStats(NamedTuple):
    """Pass-1 reductions per row, plus the per-tile offsets pass 2 uses."""
    nnz: torch.Tensor          # int32: survivors before the capacity cut
    nonzeros: torch.Tensor     # int32: |{i : g_i != 0}|
    p_sum: torch.Tensor        # float32: sum of keep probabilities
    den: torch.Tensor          # float32: sum g^2
    sum_sq: torch.Tensor       # float32: sum v^2 over the first k_cap survivors
    max_abs: torch.Tensor      # float32: max |v| over the first k_cap survivors
    base: torch.Tensor         # int32 [rows, tiles]: survivors before each tile
    tie_base: torch.Tensor | None = None
                               # int32 [rows, tiles], topk only: threshold
                               # ties before each tile


def select_stats_ref(g: torch.Tensor, u: torch.Tensor | None,
                     s1: torch.Tensor, k_cap: int, tile: int, *,
                     pkind: str = "lam", s2: torch.Tensor | None = None,
                     budget: torch.Tensor | None = None,
                     round_v: bool = False) -> SelectStats:
    """Pass 1 (``kernel.select_stats``); with ``round_v`` the codec-scale
    statistics (sum v^2, max|v|) see v rounded to g's dtype."""
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
    tie_base = (torch.empty((rows, nt), dtype=torch.int32, device=dev)
                if pkind == "topk" else None)
    for r in range(rows):
        _, a, p, z, v = _select_row(pkind, g[r], _row(u, r), s1[r],
                                    _row(s2, r), _row(budget, r))
        zi = z.to(torch.int32)
        rank = torch.cumsum(zi, 0, dtype=torch.int32) - zi
        keep = z & (rank < k_cap)
        if round_v:
            v = v.to(g.dtype).to(F32)
        vk = torch.where(keep, v, 0.0)
        base[r] = _tile_sums(zi, nt, tile)
        if tie_base is not None:
            tie_base[r] = _tile_sums(((a == s1[r]) & (s1[r] > 0)).to(
                torch.int32), nt, tile)
        nnz[r] = zi.sum()
        nzc[r] = (a > 0).sum()
        psum[r] = p.sum(dtype=F64)
        den[r] = (a * a).sum(dtype=F64)
        vsq[r] = (vk * vk).sum(dtype=F64)
        vmx[r] = vk.abs().max() if d else 0.0
    return SelectStats(nnz, nzc, psum, den, vsq, vmx, base, tie_base)


def compact_emit_ref(g: torch.Tensor, u: torch.Tensor | None,
                     s1: torch.Tensor, k_cap: int, codec, ef: bool, *,
                     pkind: str = "lam", s2: torch.Tensor | None = None,
                     budget: torch.Tensor | None = None,
                     scale: torch.Tensor | None = None,
                     u_cod: torch.Tensor | None = None,
                     det_round: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor | None]:
    """Pass 2: the first ``k_cap`` survivors of each row in coordinate order
    as ``values [rows, k_cap]`` (codec-encoded in ``codec.wire_dtype``) and
    ``idx [rows, k_cap]`` (int32); unused slots hold idx 0 and value 0.

    A float codec rounds to its wire dtype. An integer codec (qsgd, ternary)
    encodes with the row's ``scale`` and, for survivor j, the uniform
    ``u_cod[row, j]``; with ``det_round`` the uniform ``DET_U`` for every
    survivor (the deterministic rounding: up where the fraction is at least
    0.5). With ``ef`` (float codecs only) also the residual
    ``g - encoded value`` in g's dtype, where every survivor is subtracted,
    those dropped past ``k_cap`` included; the encoded value is rounded to
    the wire dtype only for a rounding codec (bf16)."""
    rows, d = g.shape
    wire_dtype = codec.wire_dtype(g.dtype)
    vals = torch.zeros((rows, k_cap), dtype=wire_dtype, device=g.device)
    idx = torch.zeros((rows, k_cap), dtype=torch.int32, device=g.device)
    res = torch.empty_like(g) if ef else None
    for r in range(rows):
        x, _, _, z, v = _select_row(pkind, g[r], _row(u, r), s1[r],
                                    _row(s2, r), _row(budget, r))
        kept = torch.nonzero(z).reshape(-1)[:k_cap]
        n = kept.numel()
        if codec.integer_coded:
            uc = (torch.full((n,), DET_U, dtype=F32, device=g.device)
                  if det_round else u_cod[r, :n])
            vals[r, :n] = codec.encode(v[kept], scale[r], uc)
        else:
            ev = v.to(wire_dtype)
            vals[r, :n] = ev[kept]
            if ef:
                enc = ev.to(F32) if codec.rounds_values else v
                res[r] = (x - torch.where(z, enc, 0.0)).to(g.dtype)
        idx[r, :n] = kept.to(torch.int32)
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


def rice_fit_ref(idx: torch.Tensor, nnz: torch.Tensor, d: int,
                 window: tuple[int, ...]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The data-fitted Golomb-Rice parameter of each row's compact stream
    (wire-format v4): the first minimum of the used words over the
    ascending ``window``, row by row (``compaction.rice_fit_used``).
    Returns ``(r [rows], header [rows])``, int32, ``header = (r << 26) |
    used``."""
    rows = idx.shape[0]
    r_out = torch.empty(rows, dtype=torch.int32, device=idx.device)
    header = torch.empty_like(r_out)
    for row in range(rows):
        _, sidx = compaction.coordinate_order(idx[row], idx[row], d,
                                              nnz=nnz[row])
        r_out[row], header[row] = compaction.rice_fit_used(
            compaction._rice_gaps(sidx, d), window)
    return r_out, header


def rice_tile_bases_ref(idx: torch.Tensor, nnz: torch.Tensor,
                        r_rows: torch.Tensor, d: int, tile: int
                        ) -> torch.Tensor:
    """The quotient base of each tile of ``tile`` codes of each row's compact
    stream at the row's parameter ``r_rows[row]``: ``[rows, ntiles(k_cap,
    tile) + 1]`` int32, entry t the sum of ``(gap - 1) >> r`` over the codes
    before ``min(t * tile, k_cap)`` (dead codes code 0; the last entry is
    the row's total). Tile t's unary span begins ``k_cap r + base + t *
    tile`` bits into the stream: its first code's terminator follows that
    code's quotient of ones."""
    rows, k_cap = idx.shape
    nb = ntiles(k_cap, tile)
    ends = torch.clamp_max(torch.arange(nb + 1, device=idx.device) * tile,
                           k_cap)
    out = torch.empty((rows, nb + 1), dtype=torch.int32, device=idx.device)
    for row in range(rows):
        _, sidx = compaction.coordinate_order(idx[row], idx[row], d,
                                              nnz=nnz[row])
        q = compaction._rice_gaps(sidx, d).long() >> int(r_rows[row])
        out[row] = torch.cat([q.new_zeros(1), torch.cumsum(q, 0)])[ends].to(
            torch.int32)
    return out


def rice_fit_tiles_ref(idx: torch.Tensor, nnz: torch.Tensor, d: int,
                       window: tuple[int, ...], tile: int,
                       r_rows: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rice_fit_ref``'s ``(r, header)`` with the tile bases at r
    (``rice_tile_bases_ref``); given ``r_rows``, each row at its own r and
    the header ``(r << 26) | used`` of that packing."""
    header = None
    if r_rows is None:
        r_rows, header = rice_fit_ref(idx, nnz, d, window)
    bases = rice_tile_bases_ref(idx, nnz, r_rows, d, tile)
    if header is None:
        k_cap = idx.shape[1]
        used = (k_cap * r_rows.long() + bases[:, -1] + k_cap + 31) // 32
        header = ((r_rows.long() << compaction.RICE_HDR_SHIFT)
                  | used).to(torch.int32)
    return r_rows, header, bases


def rice_pack_fitted_ref(idx: torch.Tensor, nnz: torch.Tensor,
                         r_rows: torch.Tensor, d: int,
                         window: tuple[int, ...]
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rice_pack_ref`` with each row at its own parameter ``r_rows[row]``
    into the fitted capacity ``compaction.rice_fit_cap_words``. Returns
    ``(words [rows, cap], header [rows])``, int32, ``header = (r << 26) |
    used``: with ``rice_fit_ref``'s r, ``compaction.rice_encode_fitted``'s
    words and header bit for bit."""
    rows, k_cap = idx.shape
    cap = compaction.rice_fit_cap_words(k_cap, d, window)
    words = torch.empty((rows, cap), dtype=torch.int32, device=idx.device)
    header = torch.empty(rows, dtype=torch.int32, device=idx.device)
    for row in range(rows):
        r = int(r_rows[row])
        _, sidx = compaction.coordinate_order(idx[row], idx[row], d,
                                              nnz=nnz[row])
        words[row], used = compaction._rice_pack_gaps(
            compaction._rice_gaps(sidx, d), r, cap)
        header[row] = (r << compaction.RICE_HDR_SHIFT) | int(used)
    return words, header


class Sparsified(NamedTuple):
    """Kernels 5, 6 and 8 on one ``[rows, d]`` group: the dense ``q`` in the
    wire dtype, with kernel 6 the EF residual ``g - float32(q)`` in g's
    dtype, and per row the counts and the sums the dense wire's accounting
    reads, all over q as the wire carries it (rounded to its dtype)."""
    q: torch.Tensor              # [rows, d] Q(g) in the wire dtype
    residual: torch.Tensor | None
                                 # [rows, d] g - q, g's dtype (kernel 6)
    nnz: torch.Tensor            # [rows] int64: q != 0
    n_sure: torch.Tensor         # [rows] int64: q != 0 where p = 1
    sum_sq: torch.Tensor         # [rows] float32: sum q^2
    den: torch.Tensor | None = None
                                 # [rows] float32: sum g^2


def _dense_rows(g: torch.Tensor, s1: torch.Tensor | None, out_dtype,
                ef: bool, uniforms, *, pkind: str = "lam",
                s2: torch.Tensor | None = None,
                budget: torch.Tensor | None = None, codec=None,
                scale: torch.Tensor | None = None,
                u_cod: torch.Tensor | None = None,
                den: torch.Tensor | None = None) -> Sparsified:
    """The body of kernels 5, 6 and 8 row by row; ``uniforms(r)`` gives
    row r's float32 uniforms (None for topk and identity). The selector
    kind ``pkind`` (``_select_row``'s, or ``"one"``: identity, v = g) gives
    v, rounded to g's dtype as ``apply_mask`` casts it; a float codec
    rounds it to ``out_dtype``, an integer codec (qsgd, ternary: ``codec``
    with ``scale [rows]`` and ``u_cod`` shaped like g) encodes it and
    writes the decoded level in ``out_dtype`` (g's). ``den`` (sum g^2 per
    row from an earlier pass) is passed through; without it, reduced."""
    rows = g.shape[0]
    dev = g.device
    q = torch.empty(g.shape, dtype=out_dtype, device=dev)
    res = torch.empty_like(g) if ef else None
    nnz = torch.empty(rows, dtype=torch.int64, device=dev)
    n_sure = torch.empty_like(nnz)
    sum_sq = torch.empty(rows, dtype=F32, device=dev)
    reduce_den = den is None
    if reduce_den:
        den = torch.empty(rows, dtype=F32, device=dev)
    integer = codec is not None and codec.integer_coded
    for r in range(rows):
        if pkind == "one":
            x = g[r].to(F32)
            v, sure = x, torch.ones_like(x, dtype=torch.bool)
        else:
            x, _, p, z, v = _select_row(pkind, g[r], uniforms(r), s1[r],
                                        _row(s2, r), _row(budget, r))
            sure = z if pkind == "topk" else p >= 1.0
        v = v.to(g.dtype).to(F32)
        if integer:
            q[r] = codec.decode(codec.encode(v, scale[r], u_cod[r]),
                                scale[r]).to(out_dtype)
        else:
            q[r] = v.to(out_dtype)
        w = q[r].to(F32)
        nz = w != 0
        nnz[r] = nz.sum()
        n_sure[r] = (nz & sure).sum()
        sum_sq[r] = (w * w).sum(dtype=F64)
        if reduce_den:
            den[r] = (x * x).sum(dtype=F64)
        if ef:
            res[r] = (x - w).to(g.dtype)
    return Sparsified(q, res, nnz, n_sure, sum_sq, den)


def sparsify_ref(g: torch.Tensor, u: torch.Tensor | None,
                 s1: torch.Tensor | None, out_dtype=None, **kind
                 ) -> Sparsified:
    """Kernel 5: Q = [u < p] g / p, p = min(s1[row] |g|, 1), in
    ``out_dtype`` (default g's), from the float32 uniforms ``u``; ``kind``
    (``pkind``, ``s2``, ``budget``, ``codec``, ``scale``, ``u_cod``) as in
    ``_dense_rows``."""
    return _dense_rows(g, s1, out_dtype or g.dtype, False,
                       lambda r: None if u is None else u[r], **kind)


def sparsify_ef_ref(g: torch.Tensor, u: torch.Tensor | None,
                    s1: torch.Tensor | None, out_dtype=None, **kind
                    ) -> Sparsified:
    """Kernel 6: kernel 5 plus the residual ``g - float32(Q)`` after the
    wire rounding, in g's dtype."""
    return _dense_rows(g, s1, out_dtype or g.dtype, True,
                       lambda r: None if u is None else u[r], **kind)


PHILOX_M = (0xD2511F53, 0xCD9E8D57)       # Philox4x32 round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)       # Weyl key increments
_MASK32 = 0xFFFFFFFF


def philox4x32_10_ref(ctr: torch.Tensor, key: tuple[int, int]
                      ) -> torch.Tensor:
    """Philox4x32-10 (Salmon et al., SC 2011; Random123) of the counters
    ``ctr [n, 4]`` (int64 holding uint32 words) under the 32-bit key pair
    ``key``: ``[n, 4]`` int64 holding the output words. In int64 with
    32-bit masks: a 32x32 product may wrap int64, but its bits 32-63 still
    come out right after ``>> 32 & 0xFFFFFFFF``."""
    c0, c1, c2, c3 = (ctr[:, j] & _MASK32 for j in range(4))
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        p0 = c0 * PHILOX_M[0]
        p1 = c2 * PHILOX_M[1]
        hi0, lo0 = (p0 >> 32) & _MASK32, p0 & _MASK32
        hi1, lo1 = (p1 >> 32) & _MASK32, p1 & _MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], 1)


# Coordinates per Philox call of ``philox_uniforms``: bounds its int64
# scratch (about ten [n / 4] int64 temporaries) on a 5.2e8-wide row.
PHILOX_UNITS = 1 << 24


def philox_uniforms(row: int, d: int, seed: int,
                    device=None) -> torch.Tensor:
    """Row ``row``'s float32 uniforms of kernel 8: coordinate i takes word
    ``i % 4`` of Philox4x32-10 at counter ``(i // 4, row, 0, 0)`` under key
    ``(seed, 0)``, as ``u = (bits >> 8) * 2^-24``. The stream does not
    depend on the kernel's tiling."""
    u = torch.empty(d, dtype=F32, device=device)
    for a in range(0, d, PHILOX_UNITS):
        b = min(d, a + PHILOX_UNITS)
        blocks = torch.arange(a // 4, -(-b // 4), dtype=torch.int64,
                              device=device)
        ctr = torch.zeros((blocks.numel(), 4), dtype=torch.int64,
                          device=device)
        ctr[:, 0] = blocks
        ctr[:, 1] = row
        bits = philox4x32_10_ref(ctr, (seed, 0)).reshape(-1)
        off = a - (a // 4) * 4
        u[a:b] = (bits[off:off + b - a] >> 8).to(F32) * 2.0 ** -24
    return u


def sparsify_prng_ref(g: torch.Tensor, lam: torch.Tensor,
                      seed: int) -> Sparsified:
    """Kernel 8: kernel 5 with the uniforms of ``philox_uniforms`` in place
    of an input buffer; Q in g's dtype, no sum g^2."""
    return _dense_rows(g, lam, g.dtype, False, lambda r: philox_uniforms(
        r, g.shape[1], seed, g.device))._replace(den=None)
