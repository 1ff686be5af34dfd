"""Coding-length model and realized wire accounting (port of the parts of
``repro.core.coding`` the gather and dense wires use).

The coding model charges a sampled message the paper's section-3.3 hybrid
code: sure coordinates (p = 1) cost ``b + log2 d`` bits each, sampled ones
``log2 d`` each or a dense ternary map of 2d bits, whichever is shorter,
plus ``b`` once; an integer-coded message (qsgd, ternary) costs its levels
plus indices, or a dense level map (``quantized_coding_bits``). The
realized wire side counts what a wire layout
(``repro_torch.comm.wire_layout``) puts on the collective, with int32 index
words; its word geometry comes from the packer (``comm.compaction``).

``rice_parameter`` / ``rice_stream_bits`` are the model of the RICE layout
(Golomb-Rice delta coding of the sorted coordinate gaps,
``compaction.rice_encode``). ``rice_stream_bits`` and ``rice_stream_words``
are numpy off-wire twins of the encoder: tests and ``chip_smoke.py``
recompute realized bytes with them. Wire-format v4 fits the parameter to
the data over a static window (``rice_fit_window``,
``rice_fitted_parameter``, ``rice_fitted_stream_words``: the twins of
``compaction.rice_encode_fitted``).

The off-wire estimators (``expected_coding_bits``, ``theorem4_bound_bits``,
``qsgd_coding_bits``, ``elias_gamma_bits``, ``golomb_bits``,
``delta_coded_index_bits``) measure what no wire ships: the paper's
expected cost, its Theorem 4 bound, QSGD's cost model, and data-fitted
Golomb / Elias-gamma codes of an index set.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.comm.compaction import (RICE_MAX_R, WORD_BITS, bitmap_words,
                                         rice_cap_words)

INDEX_BITS = 32


def hybrid_branch_bits(n, d: int, per_item_bits, map_bits: float):
    """Section 3.3's two-branch minimum: ``n`` items at ``per_item_bits``
    each, or a dense map of ``map_bits`` per coordinate."""
    return torch.minimum(n * per_item_bits,
                         torch.as_tensor(float(d) * map_bits,
                                         dtype=torch.float32))


def realized_coding_bits(n_sure: torch.Tensor, n_sampled: torch.Tensor,
                         d: int, b: float = 32.0) -> torch.Tensor:
    """Bits of one *sampled* message per row (not the expectation), from
    the kept coordinates' counts: ``n_sure`` with p = 1 at ``b + log2 d``
    each, ``n_sampled`` with p < 1 as a ``log2 d`` index list or a dense
    ternary map of 2d bits, whichever is shorter, plus ``b`` once. The JAX
    package's function takes q and p and counts them itself."""
    logd = torch.log2(torch.tensor(float(d), dtype=torch.float32,
                                   device=n_sure.device))
    return (n_sure.to(torch.float32) * (b + logd)
            + hybrid_branch_bits(n_sampled.to(torch.float32), d, logd, 2.0)
            + b)


def expected_coding_bits(p: torch.Tensor, b: int = 32) -> torch.Tensor:
    """Expected message bits of one gradient under the hybrid coding, from
    its keep probabilities ``p`` (section 5.1's cost model)::

        sum_{p_i=1} (b + log2 d) + min(2d, log2 d * sum_{p_i<1} p_i) + b
    """
    p = p.reshape(-1).to(torch.float32)
    d = p.shape[0]
    logd = torch.log2(torch.tensor(float(d), dtype=torch.float32,
                                   device=p.device))
    sure = p >= 1.0
    n_sure = sure.to(torch.float32).sum()
    tail_mass = torch.where(sure, 0.0, p).sum()
    return (n_sure * (b + logd)
            + hybrid_branch_bits(tail_mass, d, logd, 2.0) + b)


def theorem4_bound_bits(s: int, rho: float, d: int, b: int = 32) -> float:
    """The Theorem 4 upper bound: s(b + log2 d) + min(rho*s*log2 d, 2d) + b."""
    logd = math.log2(d)
    return s * (b + logd) + min(rho * s * logd, 2.0 * d) + b


def qsgd_coding_bits(d: int, bits: int) -> float:
    """QSGD's cost model of the paper's figures 5-6: d * bits a message."""
    return float(d) * bits


def dense_coding_bits(d: int, b: int = 32) -> float:
    """Uncompressed message: d floats."""
    return float(d) * b


def quantized_coding_bits(nnz: torch.Tensor, d: int, value_bits: float,
                          dense_map_bits: float,
                          header_bits: float) -> torch.Tensor:
    """Bits of an integer-coded message per row, from ``nnz [rows]``, the
    count of nonzero decoded values (the JAX package's function takes the
    values and counts them itself): each transmitted coordinate costs its
    level plus a log2 d index, or the message ships as a dense level map of
    ``dense_map_bits`` per coordinate, whichever is shorter, plus the
    codec's header (its scale float)."""
    logd = torch.log2(torch.tensor(float(d), dtype=torch.float32,
                                   device=nnz.device))
    return hybrid_branch_bits(nnz, d, value_bits + logd,
                              dense_map_bits) + header_bits


def bitmap_word_bits(d: int) -> float:
    """Bits of a d-coordinate occupancy bitmap packed into whole words."""
    return float(bitmap_words(d) * WORD_BITS)


def rice_parameter(k_cap: int, d: int) -> int:
    """Static Golomb-Rice parameter of one row's index stream:
    ``2^r ~= ln2 * (d / k_cap)``, rounded to the nearest power of two in
    log space (half up), clipped to [0, RICE_MAX_R]. Part of the wire
    format: sender and receiver derive it independently."""
    mu = max(1.0, float(d) / max(1, k_cap))
    m_opt = math.log(2.0) * mu
    if m_opt <= 1.0:
        return 0
    return min(RICE_MAX_R, int(math.floor(math.log2(m_opt) + 0.5)))


def rice_wire_words(k_cap: int, d: int) -> int:
    """Static int32 word capacity of one row's RICE index stream at the
    static parameter: the payload shape on the collective and the chooser's
    cost for the RICE branch. Realized streams use at most this many."""
    return rice_cap_words(k_cap, d, rice_parameter(k_cap, d))


def _index_gaps(idx, d: int) -> np.ndarray:
    """Sorted-coordinate delta sequence, every gap >= 1 (the first index is
    coded against -1)."""
    a = np.unique(np.asarray(idx, dtype=np.int64).reshape(-1))
    if a.size == 0:
        return np.zeros((0,), np.int64)
    if a[0] < 0 or a[-1] >= d:
        raise ValueError(f"index out of range [0, {d}): {a[0]}..{a[-1]}")
    return np.diff(a, prepend=-1)


def rice_stream_bits(idx, k_cap: int, d: int, r: int | None = None) -> int:
    """Exact bit length of one row's realized RICE stream: k_cap codes of
    (r + 1) fixed bits each plus the unary quotient mass of the live
    sorted-coordinate gaps. ``idx`` is the live coordinate set."""
    if r is None:
        r = rice_parameter(k_cap, d)
    gaps = _index_gaps(idx, d)
    if gaps.size > k_cap:
        raise ValueError(f"{gaps.size} live coordinates exceed k_cap={k_cap}")
    return int(k_cap * (r + 1) + np.sum((gaps - 1) >> r))


def rice_stream_words(idx, k_cap: int, d: int, r: int | None = None) -> int:
    """Realized int32 words of one row's RICE stream: the encoder's used
    word count, what phase one of the two-phase exchange reports."""
    return -(-rice_stream_bits(idx, k_cap, d, r) // WORD_BITS)


def rice_fit_window(k_cap: int, d: int) -> tuple[int, ...]:
    """Candidate parameters of the data-fitted Golomb-Rice code (wire-format
    v4): ``{r_s - 1, r_s, r_s + 1, r_s + 2}`` around the static
    ``rice_parameter`` r_s, clipped to [0, RICE_MAX_R], deduplicated,
    ascending. Part of the wire format: both sides derive it from ``(k_cap,
    d)``, and only the choice travels, in the counts word's high bits.
    Holding r_s, the fitted stream never exceeds the static one."""
    r_s = rice_parameter(k_cap, d)
    return tuple(sorted({min(RICE_MAX_R, max(0, r_s + off))
                         for off in (-1, 0, 1, 2)}))


def rice_fitted_parameter(idx, k_cap: int, d: int) -> int:
    """The parameter the fitted encoder picks for one live index set: the
    first minimum of the realized word counts over the window."""
    window = rice_fit_window(k_cap, d)
    words = [rice_stream_words(idx, k_cap, d, r) for r in window]
    return window[words.index(min(words))]


def rice_fitted_stream_words(idx, k_cap: int, d: int) -> int:
    """Realized words of one row's fitted stream: the minimum over the
    window, the used count of the fitted header."""
    window = rice_fit_window(k_cap, d)
    return min(rice_stream_words(idx, k_cap, d, r) for r in window)


def realized_wire_bits(layout: str, k_cap: int, d: int,
                       value_bits: float) -> float:
    """Bits one row of a group puts on the collective under ``layout``;
    ``value_bits`` is the wire width of one value slot.

      coo    -- k_cap value slots + k_cap int32 coordinates
      bitmap -- k_cap value slots + a packed d-bit occupancy map
      dense  -- d value slots, no index stream
      rice   -- k_cap value slots + the static word capacity of the
                Golomb-Rice index stream (its worst case over index draws)
    """
    if layout == "coo":
        return float(k_cap) * (value_bits + INDEX_BITS)
    if layout == "bitmap":
        return float(k_cap) * value_bits + bitmap_word_bits(d)
    if layout == "dense":
        return float(d) * value_bits
    if layout == "rice":
        return (float(k_cap) * value_bits
                + float(rice_wire_words(k_cap, d) * WORD_BITS))
    raise ValueError(f"unknown wire layout {layout!r}; "
                     "have ('coo', 'bitmap', 'dense', 'rice')")


def elias_gamma_bits(gaps) -> float:
    """Total Elias-gamma code length of positive integers: 2 floor(log2 g)
    + 1 bits each."""
    g = np.asarray(gaps, dtype=np.int64).reshape(-1)
    if g.size == 0:
        return 0.0
    if np.any(g < 1):
        raise ValueError("Elias-gamma codes positive integers only")
    return float(np.sum(2 * np.floor(np.log2(g)) + 1))


def golomb_bits(gaps, m: int | None = None) -> float:
    """Total Golomb code length of the gaps (coded as gap - 1 >= 0): a
    unary quotient of q + 1 bits and a truncated-binary remainder. ``m``
    None takes the geometric-optimal m ~= 0.69 mean(gap)."""
    g = np.asarray(gaps, dtype=np.int64).reshape(-1)
    if g.size == 0:
        return 0.0
    if np.any(g < 1):
        raise ValueError("Golomb gaps must be positive")
    if m is None:
        m = max(1, int(round(0.69 * float(np.mean(g)))))
    x = g - 1
    q = x // m
    r = x % m
    b = max(1, math.ceil(math.log2(m))) if m > 1 else 0
    if m == 1:
        r_bits = np.zeros_like(r)
    else:
        cutoff = (1 << b) - m          # remainders below this take b - 1
        r_bits = np.where(r < cutoff, b - 1, b)
    return float(np.sum(q + 1 + r_bits))


def delta_coded_index_bits(idx, d: int, method: str = "golomb") -> float:
    """Entropy-coded size estimate of one message's index stream: its sorted
    gaps under a data-fitted Golomb code or Elias-gamma."""
    gaps = _index_gaps(idx, d)
    if method == "golomb":
        return golomb_bits(gaps)
    if method == "elias":
        return elias_gamma_bits(gaps)
    raise ValueError(f"unknown method {method!r}; have ('golomb', 'elias')")
