"""Wire layouts for the bucketed sparse collectives (port of
``repro.comm.wire_layout``).

Every ``SparseGrad`` group is stamped with a layout chosen from ``(k_cap,
d)`` and the codec's wire width, and ``repro_torch.comm.sync`` packs and
unpacks each bucket accordingly:

  coo    -- k_cap values + k_cap int32 coordinates (the bucket offsets them)
  bitmap -- k_cap values in coordinate order + a packed d-bit occupancy map
  dense  -- d values in coordinate order, no index stream
  rice   -- k_cap values in coordinate order + the sorted index stream
            delta-coded with a static-parameter Golomb-Rice code, padded to
            its static word capacity; the realized length of each row rides
            phase one of a two-phase exchange (a gathered int32 counts
            vector), which also prices the realized bytes

``auto`` is the argmin of ``coding.realized_wire_bits`` over the four, with
RICE at its worst-case capacity, so realized bytes only come in under the
chosen bound. With ``plan(sg, fitted=True)`` a RICE group takes
wire-format v4: each row's Golomb-Rice parameter is fitted to its gaps
over the static window ``coding.rice_fit_window`` and rides the high bits
of its counts word, ``(r << RICE_HDR_SHIFT) | used``; the payload capacity
is the window's largest, and realized words never exceed the static
parameter's (its r is in the window).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import compaction
from repro_torch.core import coding

LAYOUTS = ("coo", "bitmap", "dense", "rice")
# Dead RICE slots add their zero values into a scratch tail of this many
# coordinates past the bucket, spread over it so that the decode's atomic
# adds do not pile onto one address.
DROP_SLOTS = 1 << 16
# tie-break by decode cost: dense (slice-add) < coo (scatter) < bitmap
# (rank-gather) < rice (unary scan + prefix sum). Part of the wire format.
_PREFERENCE = ("dense", "coo", "bitmap", "rice")


def value_bits_of(dtype: torch.dtype) -> float:
    """Wire width of one value slot in bits."""
    return float(torch.empty((), dtype=dtype).element_size() * 8)


def choose(k_cap: int, d: int, value_bits: float,
           override: str = "auto") -> str:
    """The layout of one group (per row): ``override`` when it names a
    layout, else the one whose realized wire bits are least."""
    if override != "auto":
        if override not in LAYOUTS:
            raise ValueError(f"unknown wire layout {override!r}; "
                             f"have {LAYOUTS + ('auto',)}")
        return override
    return min(_PREFERENCE,
               key=lambda l: coding.realized_wire_bits(l, k_cap, d,
                                                       value_bits))


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Static wire description of one group's segments inside a bucket. For
    RICE ``idx_len`` is the word capacity (the static payload shape)."""
    layout: str
    layers: int              # rows of the group
    d: int                   # coordinates per row
    k_cap: int
    val_len: int             # value slots per row on the wire
    idx_len: int             # int32 index words per row on the wire
    rice_r: int = 0          # static Golomb-Rice parameter (rice only)
    fitted: bool = False     # wire-format v4: a fitted parameter per row
    rice_window: tuple = ()  # its candidates (fitted only)

    @property
    def block(self) -> int:
        """Coordinates this group spans in the bucket's flat space."""
        return self.layers * self.d


def plan(sg, fitted: bool = False) -> LeafPlan:
    """The static wire plan of one SparseGrad, from its stamped layout;
    ``fitted`` puts a RICE group on wire-format v4 (the fitted capacity and
    window)."""
    rice_r = 0
    window: tuple = ()
    if sg.layout == "coo":
        val_len, idx_len = sg.k_cap, sg.k_cap
    elif sg.layout == "bitmap":
        val_len, idx_len = sg.k_cap, compaction.bitmap_words(sg.d)
    elif sg.layout == "dense":
        val_len, idx_len = sg.d, 0
    elif sg.layout == "rice":
        rice_r = coding.rice_parameter(sg.k_cap, sg.d)
        val_len = sg.k_cap
        if fitted:
            window = coding.rice_fit_window(sg.k_cap, sg.d)
            idx_len = compaction.rice_fit_cap_words(sg.k_cap, sg.d, window)
        else:
            idx_len = compaction.rice_cap_words(sg.k_cap, sg.d, rice_r)
    else:
        raise ValueError(f"unknown wire layout {sg.layout!r}; have {LAYOUTS}")
    return LeafPlan(layout=sg.layout, layers=sg.rows, d=sg.d, k_cap=sg.k_cap,
                    val_len=val_len, idx_len=idx_len, rice_r=rice_r,
                    fitted=bool(window), rice_window=window)


# Slots per index call of scatter_live: int64 coordinates and the values,
# about 1.5 GB of temporaries.
SCATTER_UNITS = 1 << 27


def scatter_live(vals, idx: torch.Tensor, nnz: torch.Tensor, d: int, *,
                 base: torch.Tensor | None = None,
                 add: bool = False) -> torch.Tensor:
    """``[rows, d]`` from the compact ``idx [rows, k_cap]`` and its values:
    each row's live slots (the first ``min(nnz, k_cap)``, unique ascending
    coordinates) written into zeros, or with ``add`` added into a copy of
    ``base``, in ``base``'s dtype (else the values'). ``vals`` is the values
    tensor ``[rows, k_cap]``, or a function of a tile ``(a, b, j0, j1)``
    that returns ``vals[a:b, j0:j1]`` (formed tile by tile). Dead slots go
    to a scratch tail of ``DROP_SLOTS`` coordinates past the rows, spread
    over it: as one index call over every slot, they would pile onto each
    row's coordinate 0 (a plain ``scatter_add_`` of the padding). Tiles of
    at most ``SCATTER_UNITS`` slots (``compaction.slot_tiles``) bound the
    temporaries."""
    rows, k_cap = idx.shape
    tile_of = vals if callable(vals) else (
        lambda a, b, j0, j1: vals[a:b, j0:j1])
    dtype = base.dtype if base is not None else vals.dtype
    dev = idx.device
    total = rows * d + DROP_SLOTS
    # index_add_ takes int32 coordinates (half the scratch), index_copy_
    # only int64
    cdt = (torch.int32 if add and total <= compaction.INT32_COORD_LIMIT
           else torch.int64)
    flat = torch.empty(total, dtype=dtype, device=dev)
    if base is not None:
        flat[:rows * d].copy_(base.reshape(-1))
    else:
        flat[:rows * d].zero_()
    n_live = torch.clamp_max(nnz.to(cdt), k_cap)
    for a, b, j0, j1 in compaction.slot_tiles(rows, k_cap, SCATTER_UNITS):
        slot = torch.arange(j0, j1, dtype=cdt, device=dev)
        row0 = torch.arange(a, b, dtype=cdt, device=dev)[:, None] * d
        coords = torch.where(slot < n_live[a:b, None],
                             idx[a:b, j0:j1].to(cdt) + row0,
                             (slot & (DROP_SLOTS - 1)) + rows * d).reshape(-1)
        src = tile_of(a, b, j0, j1).reshape(-1).to(dtype)
        if add:
            flat.index_add_(0, coords, src)
        else:
            flat.index_copy_(0, coords, src)
        del coords, src
    return flat[:rows * d].view(rows, d)


def pack(sg, lp: LeafPlan) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One SparseGrad's wire streams: ``(values [rows, val_len], index words
    [rows, idx_len], used word counts [rows])``. COO words are row-local
    coordinates (the bucket offsets them); bitmap and RICE words are opaque
    bits; the counts are the RICE rows' realized lengths (zeros for the
    fixed layouts; under wire-format v4 the fitted headers). RICE ships
    the words the kernel packed (``sg.rice_words``, in the plan's format)
    as they are; bitmap packs sort-free from ``nnz``, since the port's
    counting compaction is coordinate-sorted."""
    if lp.layout == "rice":
        if sg.rice_words is None:
            raise ValueError("a RICE group ships the words its kernel "
                             "packed; this SparseGrad has none")
        if sg.rice_window != lp.rice_window:
            raise ValueError(
                f"the kernel packed this group's words over the Golomb-Rice "
                f"window {sg.rice_window} (() = static), the plan ships "
                f"{lp.rice_window}: compress and sync with one "
                "CompressionConfig.rice_fitted")
        return sg.values, sg.rice_words, sg.rice_used
    zeros = torch.zeros(lp.layers, dtype=torch.int32, device=sg.idx.device)
    if lp.layout == "coo":
        return sg.values, sg.idx, zeros
    if lp.layout == "dense":
        # live coordinates are unique and padding slots hold zeros, so this
        # is the JAX package's scatter-add of the compact pair bit for bit
        return (scatter_live(sg.values, sg.idx, sg.n_valid, lp.d),
                sg.idx.new_zeros((lp.layers, 0)), zeros)
    sv, words = compaction.bitmap_pack(sg.values, sg.idx, lp.d,
                                       nnz=sg.n_valid)
    return sv, words, zeros


def unpack_gathered(lp: LeafPlan, decoded: torch.Tensor,
                    widx: torch.Tensor | None, coord_off: int,
                    wcounts: torch.Tensor | None = None, *,
                    drop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One group's gathered segment -> scatter-ready ``(updates [m, X],
    coords [m, X])`` in the bucket's flat space.

    ``decoded [m, layers * val_len]`` are the gathered values, ``widx [m,
    layers * idx_len]`` the index words (COO words arrive offset; None for
    dense), ``wcounts [m, layers]`` the phase-one counts of a RICE group:
    padding words past each worker's used count (the counts' low
    ``RICE_HDR_SHIFT`` bits) are zeroed before the decode, and a fitted
    plan decodes each row once, at the r its header names.
    Dead RICE slots (zero value) point into ``[drop, drop + DROP_SLOTS)``,
    a scratch tail past the bucket that the caller discards (``index_add_``
    has no drop mode, and a boolean filter would sync with the host)."""
    m = decoded.shape[0]
    if lp.layout == "coo":
        return decoded, widx
    if lp.layout == "rice":
        words = widx.reshape(m, lp.layers, lp.idx_len)
        if wcounts is not None:
            # static counts have no header bits: the mask is the identity
            used = wcounts & compaction.RICE_HDR_USED_MASK
            words = torch.where(
                torch.arange(lp.idx_len, dtype=torch.int32,
                             device=words.device) < used[..., None],
                words, 0)
        if lp.fitted:
            sidx = compaction.rice_decode_fitted(words, lp.k_cap, lp.d,
                                                 lp.rice_window, wcounts)
        else:
            sidx = compaction.rice_decode(words, lp.k_cap, lp.d, lp.rice_r)
        del words
        rows_off = (torch.arange(lp.layers, dtype=torch.int32,
                                 device=sidx.device) * lp.d)[None, :, None]
        coords = (sidx + rows_off + coord_off).reshape(m, -1)
        spread = torch.arange(coords.shape[1], dtype=torch.int32,
                              device=coords.device) & (DROP_SLOTS - 1)
        return decoded, torch.where(decoded != 0, coords, spread + drop)
    iota = torch.arange(lp.block, dtype=torch.int32, device=decoded.device)
    iota = (iota + coord_off).expand(m, lp.block)
    if lp.layout == "dense":
        return decoded, iota
    dense = compaction.bitmap_select(
        widx.reshape(m, lp.layers, lp.idx_len),
        decoded.reshape(m, lp.layers, lp.val_len), lp.d)
    return dense.reshape(m, lp.block), iota
