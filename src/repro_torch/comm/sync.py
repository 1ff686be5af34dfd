"""Gradient synchronization, Algorithm 1 on ``torch.distributed`` (port of
``repro.comm.sync``: ``SyncStats``, ``sync_tree`` with the adaptive control
loop and the pod hierarchy, the dense wire's ``_sync_leaves_dense``, the
sparse wires' sync exchange ``_bucketed_sync`` and overlapped exchange
``_overlapped_sync``, every wire layout with the static and the
data-fitted Golomb-Rice parameter, ``_apply_skip``, the pod stage's
``_compact_items`` and its drops).

The dense wire (``cfg.wire == "dense"``, the default) compresses every
leaf to Q(g) in dense layout (``repro_torch.core.api.compress_tree``) and
averages it over the workers in the leaf's dtype, as the JAX package's
``pmean``; it charges ``numel x itemsize`` of every leaf, has no capacity
to overflow and stamps no layout. Every backend takes one path: an ordered
reduce-scatter, then an all-gather. Each dtype's flat buffer is cut into m
equal shards; one ``all_to_all_single`` sends shard j of every worker to
rank j, which sums its m copies in worker order in float32 (a bfloat16
buffer rounded to bfloat16 once) and divides by m; an all-gather puts the
shards back together, a chunk of ``EXCHANGE_UNITS`` elements at a time,
so its scratch stays about one chunk whatever the model's size. The JAX
package's ``pmean`` on the CPU sums in that order too, and the division by
m is an IEEE quotient on every device, so the two are bit-equal at any
worker count, on gloo and on NCCL alike (an NCCL or gloo all-reduce sums
in its own ring or chunk order, and at three workers moved a fifth of
float32 sums by an ulp). At one worker the exchange issues no collective.

On the sparse wires (``cfg.wire`` "gather", or "packed": gather with bf16
values where the composition names no codec) every worker compresses its
local gradient leaves into fixed-capacity
``SparseGrad`` buffers (``repro_torch.core.api.compress_tree_sparse``),
each group stamped with a wire layout (``repro_torch.comm.wire_layout``);
the groups of one wire dtype share one concatenated coordinate space and
are exchanged with one all-gather for the values and one for the int32
index words (COO coordinates offset into the bucket; bitmap and RICE words
are opaque bits and ride as they are; dense groups ship no index stream,
and the second all-gather is skipped when no group has one). A chunk with
RICE groups first all-gathers their per-row used word counts (phase one of
the two-phase exchange): the RICE payload then travels at its static
capacity shape, padding past each count is zeroed before the decode, and
the counts price the realized bytes. Every worker then decodes and
scatter-adds the gathered buffers and divides by the worker count. Tiny
dense-passthrough leaves share one all-reduce. Buckets past
``cfg.bucket_coord_cap`` coordinates (by default the int32 limit less the
decode's scratch tail) split into row-granular chunks, each its own set of
collectives — a 2.5e9-parameter tree needs two.

Reduction order. The decode adds the gathered workers one after another in
worker order (worker-major), as the JAX package's single scatter-add does;
``index_add_`` on CUDA uses atomics, so one call over all workers would
not keep that order. Within one worker the live coordinates are unique and
padding and dead slots add exact zeros, so each per-worker ``index_add_``
is exact and the sum is bit-identical to a sequential worker-major scatter.
Groups, and row batches of a group, cover disjoint coordinates, so decoding
them one after another keeps that order; it also bounds the decode's
scratch (unpacked RICE bits, bitmap ranks) to one row batch.

The integer codecs (qsgd, ternary) ship integer levels and one float32
scale per row: the scales of a chunk ride one more all-gather, and each
worker's slots decode with that worker's own scale.

Collectives gather raw bytes (a ``uint8`` view of each buffer), so any wire
dtype crosses any backend (gloo takes no bfloat16). ``SyncStats.wire_bytes``
charges what the JAX package charges: value slots at the wire dtype's width,
the fixed layouts' int32 index words, for RICE the counts vector plus the
used words (not the padding), four bytes per row for a codec's scale, and
four bytes per element of the dense passthrough. The RICE term is a device
tensor (no host sync per chunk), and the total is float64 so that it stays
exact past 2^24 bytes.

Wire-format v4 (``cfg.rice_fitted``): the kernels pack each RICE row at its
data-fitted parameter, and its counts word carries ``(r << 26) | used``;
the charge and the padding mask read the used field alone
(``compaction.RICE_HDR_USED_MASK``).

The adaptive control loop (``cfg.adaptive``, with a ``ControlState``):
every leaf sends the difference ``g - delta_beta * last_sent``, and a leaf
whose delta energy is at most ``skip_tau`` times its EMA bound is skipped:
compressed like the others, then its q zeroed (dense wire) or its rows'
values, words and counts zeroed (``_apply_skip``; the wire charges one
sentinel word a row), and its whole target folded into the EF residual.
The receiver closes the delta with ``delta_beta * last_avg``. As in the JAX
package every decision is taken from the same targets on both wires, so
they stay bit-equal. To save memory the port keeps the delta in the
``last_sent`` tensors of the control it is given and writes the new
``last_sent`` there after the exchange; the returned control holds those
tensors, and its ``last_avg`` are the synced leaves.

The overlapped exchange (``cfg.exchange == "overlap"``,
``_overlapped_sync``) walks the groups in reverse and ships buckets of at
most ``cfg.overlap_bucket_bytes``: one fused int32 word stream each
(RICE counts, index words, 4-byte values and codec scales at offsets the
plans fix) beside a companion stream of sub-word values; each bucket's
all-gather is issued (``async_op=True``) as soon as the bucket is packed,
so it travels while the next ones are packed, none is waited on before
the last is issued, and the decode keeps the worker-major order, so it is
bit-equal to the sync exchange and charges the same bytes.

The pod hierarchy (``sync_tree``'s ``pod_group``): the exchange above
runs within a pod (``group``), then a pod stage exchanges between the
pods. The dense wire averages twice; the sparse wires compact each pod
average to its capacity by magnitude (``_compact_items``: the hand
kernels of topk, an integer codec rounded deterministically), whose drops
join the worker residual under error feedback, or with
``cfg.resparsify_pods`` (Algorithm 1's step 7) compress it again on the
pod's generator, with error feedback on the pod's own residual.
``SyncStats.wire_bytes_intra`` charges the first stage,
``wire_bytes_inter`` the pod stage.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.comm import compaction, wire_layout
from repro_torch.core.api import (CompressionConfig, _stack_group,
                                  compress_tree, compress_tree_sparse)
from repro_torch.core.grouping import chunk_spans, plan_tree
from repro_torch.core.sparse import (SparseGrad, _plan_layout,
                                     residual_from_buffers)
from repro_torch.kernels.sparsify import kernel as K
from repro_torch.kernels.sparsify import ops
from repro_torch.optim.optimizers import ControlState, FeedbackState

F32 = torch.float32


@dataclasses.dataclass
class SyncStats:
    """Per-step accounting for one worker's gradient synchronization."""
    bits: torch.Tensor              # message bits this worker sent (model)
    dense_bits: torch.Tensor        # uncompressed message bits
    wire_bytes: torch.Tensor        # bytes the collectives moved per worker
                                    # (float64: exact past 2^24)
    wire_bytes_intra: torch.Tensor  # ... in the data-parallel stage
    wire_bytes_inter: torch.Tensor  # ... in the pod stage (0 without)
    density: torch.Tensor           # realized nnz fraction
    var_ratio: torch.Tensor         # ||Q(g)||^2/||g||^2, the paper's `var`
    overflow: torch.Tensor          # survivors dropped by the fixed capacity
    skipped: torch.Tensor           # leaves skipped (adaptive only)
    layouts: tuple = ()             # (rows, d, k_cap, layout) per sparse
                                    # group, as stamped this step

    FIELDS = ("bits", "dense_bits", "wire_bytes", "wire_bytes_intra",
              "wire_bytes_inter", "density", "var_ratio", "overflow",
              "skipped")


def _issue_gather(x: torch.Tensor, group):
    """Start the all-gather of ``x`` (1-D) over ``group`` as raw bytes
    (gloo takes no bfloat16); returns ``(work, out [m, numel] in x's
    dtype)``, valid once ``work.wait()`` returned."""
    m = dist.get_world_size(group)
    raw = x.contiguous().view(torch.uint8)
    out = torch.empty(m * raw.numel(), dtype=torch.uint8, device=x.device)
    work = dist.all_gather_into_tensor(out, raw, group=group, async_op=True)
    return work, out.view(x.dtype).reshape(m, x.numel())


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[m, *x.shape]``: every worker's ``x``, in rank order."""
    work, out = _issue_gather(x.reshape(-1), group)
    work.wait()
    return out.reshape((-1,) + tuple(x.shape))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _route_span(members, r0: int, n: int, d: int, seg: torch.Tensor,
                pieces: dict, leaves: list) -> None:
    """Slice one chunk span's flat reconstruction back to leaves: ``seg``
    holds group rows ``[r0, r0 + n)``; pieces append in row order, already
    cast to their leaf's dtype (so a bf16 model keeps no float32 chunk
    buffer alive past its chunk)."""
    m0 = 0
    for i, rows in members:
        a = max(m0, r0)
        b = min(m0 + rows, r0 + n)
        if b > a:
            pieces.setdefault(i, []).append(
                seg[(a - r0) * d:(b - r0) * d].to(leaves[i].dtype))
        m0 += rows


def _assemble_pieces(pieces: dict, leaves: list, out: list) -> None:
    for i, ps in pieces.items():
        leaf = leaves[i]
        flat = ps[0] if len(ps) == 1 else torch.cat(ps)
        out[i] = flat.reshape(leaf.shape)


# Scratch bound of one decode call, in units of one unpacked bit, bitmap
# coordinate or COO slot per gathered row: about 1-1.5 GB of temporaries.
DECODE_UNITS = 1 << 27


def decode_into(dense: torch.Tensor, lp: wire_layout.LeafPlan,
                vals: torch.Tensor, words: torch.Tensor | None,
                counts: torch.Tensor | None, coord_off: int,
                drop: int, scales: torch.Tensor | None = None,
                codec=None) -> None:
    """Decode one group's gathered segment and scatter-add it into the
    float32 chunk buffer ``dense`` at ``coord_off``, worker by worker, in
    row batches that bound the decode's scratch. ``vals [m, layers *
    val_len]``, ``words [m, layers * idx_len]`` (None for dense), ``counts
    [m, layers]`` (RICE only); dead slots go to ``wire_layout.DROP_SLOTS``
    scratch coordinates from ``drop`` on. A codec with a scale decodes
    each worker's row with that worker's own scale, ``scales [m,
    layers]``, before the unpack, as the JAX package decodes the gathered
    values."""
    m = vals.shape[0]
    per_row = m * {"coo": lp.k_cap, "dense": lp.d, "bitmap": lp.d,
                   "rice": lp.idx_len * compaction.WORD_BITS}[lp.layout]
    step = max(1, min(lp.layers, DECODE_UNITS // max(1, per_row)))
    for a in range(0, lp.layers, step):
        n = min(step, lp.layers - a)
        v = vals[:, a * lp.val_len:(a + n) * lp.val_len]
        if scales is not None:
            v = codec.decode(v.reshape(m, n, lp.val_len),
                             scales[:, a:a + n, None]).reshape(m, -1)
        upd, crd = wire_layout.unpack_gathered(
            dataclasses.replace(lp, layers=n), v,
            (words[:, a * lp.idx_len:(a + n) * lp.idx_len]
             if words is not None else None),
            coord_off + a * lp.d,
            counts[:, a:a + n] if counts is not None else None, drop=drop)
        for w in range(m):                   # worker-major reduction order
            dense.index_add_(0, crd[w], upd[w].to(F32))
        del upd, crd


def _flat_storage(ts: list) -> torch.Tensor | None:
    """The one flat buffer that the contiguous tensors ``ts`` (of one dtype)
    tile exactly, as a 1-D tensor, or None when they do not tile one."""
    st = ts[0].untyped_storage()
    if not all(t.is_contiguous()
               and t.untyped_storage().data_ptr() == st.data_ptr()
               for t in ts) or sum(
                   t.numel() * t.element_size() for t in ts) != st.nbytes():
        return None
    return torch.empty(0, dtype=ts[0].dtype, device=ts[0].device).set_(
        st, 0, (st.nbytes() // ts[0].element_size(),))


def _div_workers(t: torch.Tensor, m: int) -> torch.Tensor:
    """``t / m`` in place, an IEEE quotient on every device: the divisor is
    a tensor, as PyTorch's CUDA division by a Python number multiplies by
    its rounded reciprocal instead (at m = 3 an ulp off the JAX package's
    quotient)."""
    return t.div_(torch.full((), m, dtype=t.dtype, device=t.device))


# Elements of a dense exchange's buffer that one ordered reduce-scatter and
# all-gather carry at once (rounded down to a multiple of the worker count):
# their scratch beside the buffer is one chunk (the received shards), two
# shards of it, and for a ragged last chunk its padded copy, whatever the
# buffer's size.
EXCHANGE_UNITS = 1 << 26


def _worker_order_mean(flat: torch.Tensor, m: int, group) -> None:
    """``flat`` (1-D) becomes the mean over the ``m`` workers, in place, a
    chunk of ``EXCHANGE_UNITS`` at a time: an ordered reduce-scatter and an
    all-gather. A chunk is cut into m equal shards (the last, ragged chunk
    padded in a copy of its own); ``all_to_all_single`` sends shard j of
    every worker to rank j (as bytes: gloo takes no bfloat16), which sums
    its m copies in worker order in float32, rounds the sum once to the
    buffer's dtype and divides it by m; ``all_gather_into_tensor`` returns
    every shard to every worker, into the chunk."""
    n, dt = flat.numel(), flat.dtype
    step = max(m, EXCHANGE_UNITS // m * m)
    for a in range(0, n, step):
        chunk = flat[a:a + step]
        c = chunk.numel()
        shard = -(-c // m)
        buf = chunk if shard * m == c else torch.cat(
            [chunk, chunk.new_zeros(shard * m - c)])
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv.view(torch.uint8),
                               buf.view(torch.uint8), group=group)
        parts = recv.view(m, shard)
        acc = parts[0].to(torch.promote_types(dt, F32), copy=True)
        for part in parts[1:]:
            acc += part
        mine = _div_workers(acc.to(dt), m)
        del acc, recv
        dist.all_gather_into_tensor(buf.view(torch.uint8),
                                    mine.view(torch.uint8), group=group)
        if buf is not chunk:
            chunk.copy_(buf[:c])


def _sync_leaves_dense(q: list, group) -> tuple[list, float]:
    """pmean of every leaf over ``group``, in the leaf's dtype: one ordered
    reduce-scatter and all-gather per dtype (``_worker_order_mean``; none
    at one worker), in place on the flat buffer that ``compress_tree`` lays
    that dtype's leaves out in (a copy into one when they do not tile one).
    Returns ``(synced leaves, wire bytes)``: ``numel x itemsize`` of every
    leaf, as the JAX package charges."""
    m = dist.get_world_size(group)
    synced: list = [None] * len(q)
    by_dtype: dict = {}
    for i, t in enumerate(q):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dt in sorted(by_dtype, key=_dtype_name):     # the same on every rank
        ids = by_dtype[dt]
        flat = _flat_storage([q[i] for i in ids])
        in_place = flat is not None
        if not in_place:
            flat = torch.cat([q[i].reshape(-1) for i in ids])
        if m > 1:
            _worker_order_mean(flat, m, group)
        off = 0
        for i in ids:
            n = q[i].numel()
            synced[i] = q[i] if in_place else flat[off:off + n].view(
                q[i].shape)
            off += n
    return synced, float(sum(t.numel() * t.element_size() for t in q))


@dataclasses.dataclass
class _Span:
    """Rows ``[r0, r0 + lp.layers)`` of sparse group ``items[e]`` as both
    exchanges ship them (``lp`` is the group's plan cut to those rows): the
    RICE rows' word counts ``[n]`` (under wire-format v4 the fitted
    headers), the index words ``[n * idx_len]`` (COO coordinates offset by
    the rows' layer strides and the span's coordinate offset), the values
    ``[n * val_len]`` in the wire dtype and the codec's float32 scales
    ``[n]``."""
    e: int
    r0: int
    lp: wire_layout.LeafPlan
    counts: torch.Tensor | None
    words: torch.Tensor | None
    vals: torch.Tensor
    scales: torch.Tensor | None

    @classmethod
    def cut(cls, e: int, sg: SparseGrad, packed: tuple, r0: int, n: int,
            has_scale: bool, coord_off: int) -> "_Span":
        """The span of ``wire_layout.pack``'s ``packed = (plan, values,
        index words, counts)`` of ``sg``."""
        lp0, v2d, w2d, nw = packed
        lp = dataclasses.replace(lp0, layers=n)
        words = None
        if lp.idx_len:
            words = w2d[r0:r0 + n]
            if lp.layout == "coo":
                words = words + ((torch.arange(n, dtype=torch.int32,
                                               device=words.device) * lp.d)
                                 [:, None] + coord_off)
            words = words.reshape(-1)
        return cls(e, r0, lp,
                   counts=nw[r0:r0 + n] if lp.layout == "rice" else None,
                   words=words, vals=v2d[r0:r0 + n].reshape(-1),
                   scales=sg.scale[r0:r0 + n].to(F32) if has_scale else None)

    def static_bytes(self) -> int:
        """The charge the shapes fix: RICE counts (4 B a row; the used
        words are ``used_words``) or the fixed layouts' index words, the
        values at the wire dtype's width and 4 B a row for a scale."""
        lp = self.lp
        idx = lp.layers * (1 if lp.layout == "rice" else lp.idx_len)
        return (4 * idx + self.vals.numel() * self.vals.element_size()
                + (4 * lp.layers if self.scales is not None else 0))

    def used_words(self) -> torch.Tensor:
        """The RICE rows' realized words (a fitted header masked off)."""
        return (self.counts & compaction.RICE_HDR_USED_MASK).sum(
            dtype=torch.int64)


def _coord_cap(cfg: CompressionConfig) -> int:
    """Coordinates per chunk or bucket: room for the dead-slot scratch
    tail inside the int32 coordinates."""
    return min(cfg.bucket_coord_cap,
               compaction.INT32_COORD_LIMIT - wire_layout.DROP_SLOTS)


def _sync_dense_items(items: list, dense_ids: list, leaves: list, out: list,
                      group) -> int:
    """The tiny dense-passthrough leaves: one float32 all-reduce, the mean
    written into ``out``; returns the bytes charged."""
    if not dense_ids:
        return 0
    flat = torch.cat([items[e][1].reshape(-1).to(F32) for e in dense_ids])
    dist.all_reduce(flat, group=group)
    synced = _div_workers(flat, dist.get_world_size(group))
    off = 0
    for e in dense_ids:
        for i, n in items[e][2]:
            out[i] = synced[off:off + n].reshape(leaves[i].shape).to(
                leaves[i].dtype)
            off += n
    return flat.numel() * 4


def _bucketed_sync(items: list, leaves: list, group,
                   cfg: CompressionConfig):
    """Exchange all groups with one collective set per (kind, wire dtype)
    chunk; returns ``(synced leaves, wire bytes as an int64 device tensor,
    overflow)``."""
    m = dist.get_world_size(group)
    out: list = [None] * len(leaves)
    dev = leaves[0].device
    used_words = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    dense_ids: list = []
    sparse_groups: dict = {}
    for e, (kind, payload, _members) in enumerate(items):
        if kind == "dense":
            dense_ids.append(e)
        else:
            sparse_groups.setdefault(payload.values.dtype, []).append(e)
    # bytes fixed by the static shapes
    wire = _sync_dense_items(items, dense_ids, leaves, out, group)

    cap = _coord_cap(cfg)
    codec = cfg.scheme().codec
    for wdt, ids in sorted(sparse_groups.items(),
                           key=lambda kv: _dtype_name(kv[0])):
        packed: dict = {}
        for e in ids:
            sg = items[e][1]
            lp = wire_layout.plan(sg, fitted=cfg.rice_fitted)
            packed[e] = (lp,) + wire_layout.pack(sg, lp)
            overflow = overflow + sg.overflow().sum()
        chunks = chunk_spans([(e, packed[e][0].layers, packed[e][0].d)
                              for e in ids], cap)
        pieces: dict = {}
        for chunk in chunks:
            spans: list = []
            coord_off = 0
            for e, r0, n in chunk:
                spans.append(_Span.cut(e, items[e][1], packed[e], r0, n,
                                       codec.has_scale, coord_off))
                coord_off += spans[-1].lp.block
                wire += spans[-1].static_bytes()
            compaction.check_bucket_coords(coord_off, len(chunk))
            rice = [sp for sp in spans if sp.counts is not None]
            gcounts = None
            if rice:                         # phase one: RICE row lengths
                gcounts = _all_gather(torch.cat([sp.counts for sp in rice]),
                                      group)                       # [m, R]
                for sp in rice:
                    used_words = used_words + sp.used_words()
            gvals = _all_gather(torch.cat([sp.vals for sp in spans]),
                                group)                             # [m, V]
            gwidx = None
            if any(sp.words is not None for sp in spans):
                gwidx = _all_gather(torch.cat(             # phase two
                    [sp.words for sp in spans if sp.words is not None]),
                    group)                                         # [m, I]
            gscales = None
            if codec.has_scale:              # one float32 scale per row
                gscales = _all_gather(torch.cat([sp.scales for sp in spans]),
                                      group)                       # [m, S]
            plans = [(sp.e, sp.r0, sp.lp) for sp in spans]
            del spans, rice
            # a scratch tail past the chunk takes the dead RICE slots
            dense = torch.zeros(coord_off + wire_layout.DROP_SLOTS,
                                dtype=F32, device=dev)
            v0 = i0 = c0 = cc0 = s0 = 0
            for _, _, lp in plans:
                n_vals, n_idx = lp.layers * lp.val_len, lp.layers * lp.idx_len
                rice_rows = lp.layers if lp.layout == "rice" else 0
                decode_into(
                    dense, lp, gvals[:, v0:v0 + n_vals],
                    gwidx[:, i0:i0 + n_idx] if lp.idx_len else None,
                    gcounts[:, cc0:cc0 + rice_rows] if rice_rows else None,
                    c0, coord_off,
                    (gscales[:, s0:s0 + lp.layers]
                     if gscales is not None else None), codec)
                v0, i0, cc0, s0 = (v0 + n_vals, i0 + n_idx, cc0 + rice_rows,
                                   s0 + lp.layers)
                c0 += lp.block
            del gvals, gwidx, gcounts, gscales
            dense = _div_workers(dense[:coord_off], m)
            c0 = 0
            for e, r0, lp in plans:
                _route_span(items[e][2], r0, lp.layers, lp.d,
                            dense[c0:c0 + lp.block], pieces, leaves)
                c0 += lp.block
            del dense
        _assemble_pieces(pieces, leaves, out)
    return out, used_words * 4 + wire, overflow


def _word_pack(x: torch.Tensor) -> torch.Tensor:
    """A 4-byte wire buffer as a flat int32 word stream (a bitcast view;
    the overlapped exchange packs only 4-byte dtypes so)."""
    return x.contiguous().reshape(-1).view(torch.int32)


def _word_unpack(words: torch.Tensor, dtype: torch.dtype,
                 n_elems: int) -> torch.Tensor:
    """Inverse of ``_word_pack`` on a gathered ``[m, W]`` segment: ``[m,
    n_elems]`` in ``dtype``."""
    return words.contiguous().view(dtype)[:, :n_elems]


def _overlapped_sync(items: list, leaves: list, group,
                     cfg: CompressionConfig):
    """The overlapped exchange (``repro.comm.sync._overlapped_sync``): the
    same arguments and returns as ``_bucketed_sync``, the same synced
    leaves bit for bit and the same wire bytes, another collective
    structure.

    The sparse groups are walked in reverse (the backward pass ends with
    the first layers, so the last ones are packed first), each cut into
    row spans by the sync exchange's rule (``chunk_spans`` at the
    coordinate cap; a span is atomic, ``_Span``), and the spans go
    greedily into buckets of at most ``cfg.overlap_bucket_bytes`` of
    payload and the coordinate cap. A bucket ships one int32 word stream,
    per span ``[RICE counts | index words (COO offset by its layer strides,
    each span in its own block) | 4-byte values as words | codec scales as
    words]``, and its sub-word values (bfloat16, int8, int16) ride one
    companion stream in their own dtype. A bucket's all-gather is issued
    (``async_op=True``) as soon as the bucket is packed, so it travels
    while the next buckets are packed, and none is waited on before every
    bucket is issued; then the tiny dense leaves' all-reduce runs, then
    the buckets are decoded in the order they were issued: each span's
    segments are sliced out at offsets known from its plan, the counts
    read in band, and ``decode_into`` adds the workers one after another
    (worker-major, as the sync exchange), so the two are bit-equal. The
    charge is the sync exchange's, span by span (``_Span.static_bytes``
    and ``used_words``): the word stream is 4-byte aligned by construction
    and the companion stream carries no padding."""
    m = dist.get_world_size(group)
    codec = cfg.scheme().codec
    out: list = [None] * len(leaves)
    dev = leaves[0].device
    wire = 0
    used_words = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    dense_ids = [e for e, it in enumerate(items) if it[0] == "dense"]
    sparse_ids = [e for e, it in enumerate(items) if it[0] == "sparse"]
    cap = _coord_cap(cfg)
    cap_bytes = max(4, cfg.overlap_bucket_bytes)

    # per issued bucket: (segments, (work, gathered words), the value
    # stream's (work, gathered) or None, the inputs, held until the wait)
    pending: list = []
    cur: dict = {}

    def reset():
        cur.update(parts=[], vparts=[], segs=[], words=0, velems=0,
                   coords=0)

    def flush():
        if cur["segs"]:
            stream = torch.cat(cur["parts"])
            vstream = torch.cat(cur["vparts"]) if cur["vparts"] else None
            pending.append((
                cur["segs"], _issue_gather(stream, group),
                _issue_gather(vstream, group) if vstream is not None
                else None, (stream, vstream)))
        reset()

    reset()
    for e in reversed(sparse_ids):
        sg = items[e][1]
        lp0 = wire_layout.plan(sg, fitted=cfg.rice_fitted)
        packed = (lp0,) + wire_layout.pack(sg, lp0)
        overflow = overflow + sg.overflow().sum()
        itemsize = sg.values.element_size()
        for _, r0, n in (sp for c in chunk_spans([(e, lp0.layers, lp0.d)],
                                                 cap) for sp in c):
            sp = _Span.cut(e, sg, packed, r0, n, codec.has_scale, 0)
            wire += sp.static_bytes()
            if sp.counts is not None:
                used_words = used_words + sp.used_words()
            in_words = itemsize == 4          # one value a word
            parts = [t for t in (sp.counts, sp.words) if t is not None]
            if in_words:
                parts.append(_word_pack(sp.vals))
            if sp.scales is not None:
                parts.append(_word_pack(sp.scales))
            n_words = sum(p.numel() for p in parts)
            n_bytes = n_words * 4 + (0 if in_words else sp.vals.numel()
                                     * itemsize)
            if (cur["words"] or cur["velems"]) and (
                    cur["words"] * 4 + cur["velems"] * itemsize + n_bytes
                    > cap_bytes or cur["coords"] + sp.lp.block > cap):
                flush()
            cur["segs"].append((e, sp.lp, r0, cur["words"], sg.values.dtype,
                                -1 if in_words else cur["velems"]))
            cur["parts"].extend(parts)
            cur["words"] += n_words
            cur["coords"] += sp.lp.block
            if not in_words:
                cur["vparts"].append(sp.vals)
                cur["velems"] += sp.vals.numel()
            del sp, parts
    flush()

    # the tiny leaves, after the buckets are issued
    wire += _sync_dense_items(items, dense_ids, leaves, out, group)

    pieces: dict = {}
    for segs, (work, gs), gv, inputs in pending:   # in issue order
        work.wait()
        if gv is not None:
            gv[0].wait()
            gv = gv[1]
        del inputs
        total = sum(seg[1].block for seg in segs)
        compaction.check_bucket_coords(total, len(segs))
        dense = torch.zeros(total + wire_layout.DROP_SLOTS, dtype=F32,
                            device=dev)
        block_off = 0
        for (e, lp, r0, pos, wdt, v0) in segs:
            counts = words = scales = None
            if lp.layout == "rice":
                counts = gs[:, pos:pos + lp.layers]
                pos += lp.layers
            if lp.idx_len:
                words = gs[:, pos:pos + lp.layers * lp.idx_len]
                if lp.layout == "coo":   # span-local on the wire
                    words = words + block_off
                pos += lp.layers * lp.idx_len
            n_vals = lp.layers * lp.val_len
            if v0 < 0:
                vals = _word_unpack(gs[:, pos:pos + n_vals], wdt, n_vals)
                pos += n_vals
            else:
                vals = gv[:, v0:v0 + n_vals]
            if codec.has_scale:
                scales = _word_unpack(gs[:, pos:pos + lp.layers], F32,
                                      lp.layers)
            decode_into(dense, lp, vals, words, counts, block_off, total,
                        scales, codec)
            block_off += lp.block
        del gs, gv
        dense = _div_workers(dense[:total], m)
        off = 0
        for (e, lp, r0, *_) in segs:
            _route_span(items[e][2], r0, lp.layers, lp.d,
                        dense[off:off + lp.block], pieces, leaves)
            off += lp.block
        del dense
    pending.clear()
    _assemble_pieces(pieces, leaves, out)
    return out, used_words * 4 + wire, overflow


def _exchange_fn(cfg: CompressionConfig):
    return _overlapped_sync if cfg.exchange == "overlap" else _bucketed_sync


def _compact_items(cfg: CompressionConfig, leaves: list, stacked: list):
    """The pod stage's one selection without ``resparsify_pods``
    (``repro.comm.sync._compact_items``): every sparse shape group of the
    already averaged ``leaves`` compacted to its capacity by magnitude
    (``ops.magnitude_compact``, on the card its hand kernels), its
    values encoded in the configured codec's wire dtype, an integer codec
    rounding deterministically. The items are ``compress_tree_sparse``'s,
    under the same plan, with ``p_sum = nnz`` and zero accounting; RICE
    groups carry their words (fitted under ``cfg.rice_fitted``), and an
    integer codec's zero levels are no live slots (``SparseGrad.live``),
    as the JAX package's wire codecs drop zero values."""
    codec = cfg.scheme().codec
    plan = plan_tree(cfg, leaves, stacked)
    items = []
    for grp in plan.groups:
        if grp.kind == "dense":
            items.append(("dense", torch.cat(
                [leaves[i].reshape(-1).to(F32) for i, _ in grp.members]),
                grp.members))
            continue
        stack = _stack_group(grp, leaves, None, False)
        layout, rice_r, window = _plan_layout(cfg, codec, stack.dtype,
                                              grp.k_cap, grp.d)
        c = ops.magnitude_compact(stack, k_cap=grp.k_cap, codec=codec,
                                  rice_r=rice_r, rice_window=window)
        del stack
        zeros = torch.zeros(grp.rows, dtype=F32, device=c.idx.device)
        items.append(("sparse", SparseGrad(
            values=c.values, idx=c.idx, nnz=c.nnz, p_sum=c.nnz.to(F32),
            bits=zeros, var_ratio=zeros, scale=c.scale, d=grp.d,
            codec=codec.name, layout=layout, rice_words=c.rice_words,
            rice_used=c.rice_used, rice_window=window,
            live=c.live if codec.integer_coded else None), grp.members))
    return items


def _add_compaction_drops(items: list, leaves: list, residual: list) -> None:
    """Add to ``residual`` (in place) what the pod stage's fixed-capacity
    messages failed to carry (``repro.comm.sync._compaction_drops``): each
    leaf less the scatter of its decoded buffers, formed in float32 and
    rounded to the leaf's dtype. Nonzero on overflow (the pod union of the
    workers' coordinates can exceed one message's capacity) and where a
    codec rounds the kept values; the dense passthrough drops nothing."""
    for kind, sg, members in items:
        if kind == "dense":
            continue
        # float32 leaf less the decoded buffers: a residual in float32
        drop = residual_from_buffers(torch.cat(
            [leaves[i].reshape(rows, sg.d).to(F32) for i, rows in members]),
            sg)
        r0 = 0
        for i, rows in members:
            residual[i].add_(drop[r0:r0 + rows].reshape(
                residual[i].shape).to(residual[i].dtype))
            r0 += rows
        del drop


def _energy(t: torch.Tensor) -> torch.Tensor:
    """``sum(t^2)`` of one leaf as a float32 0-d tensor: its float32 squares
    summed in float64 and rounded once, by the ``stats`` kernel (kernel 7)
    over the leaf as one row, which reads it once (on the CPU its plain
    version). The JAX package sums in float32 in XLA's order, so the two
    differ by rounding only."""
    return K.stats(t.reshape(1, -1))[1][0]


def _delta_and_skips(cfg: CompressionConfig, grads: list,
                     control: ControlState, energy_sum=None):
    """The adaptive pre-pass: the leaves to send (the delta ``g - beta *
    last_sent``, written into the ``last_sent`` tensors; the gradients
    themselves at ``delta_beta`` 0), each leaf's skip flag (a 0-d bool on
    the device) and its new bound.

    The bound is primed with the delta energy at step 0, else its EMA
    ``decay * b + (1 - decay) * sq``, formed as XLA compiles it (one fused
    multiply-add over the float32 product ``(1 - decay) * sq``; float64
    here, then rounded). A leaf is skipped past step 0 when ``sq <= tau *
    b`` (float32); never at tau 0 or below ``cfg.min_leaf_size``.
    ``energy_sum`` (with a model axis) sums the leaves' float32 delta
    energies over the model workers, as JAX's ``stat_axes`` psum does, so
    that a leaf's skip and bound are the same on each of its shards."""
    beta = cfg.delta_beta
    send = grads
    if beta:
        send = []
        for g, s in zip(grads, control.last_sent):
            if beta != 1.0:   # JAX rounds beta to the leaf dtype first
                s.mul_(torch.full((), beta, dtype=s.dtype, device=s.device))
            send.append(torch.sub(g, s, out=s))
    warm = control.step > 0
    dev = grads[0].device
    decay = torch.tensor(cfg.bound_decay, dtype=F32).item()
    c_sq = torch.full((), 1.0 - cfg.bound_decay, dtype=F32, device=dev)
    tau = torch.full((), cfg.skip_tau, dtype=F32, device=dev)
    flags, bounds = [], []
    sqs = [_energy(t) for t in send]
    if energy_sum is not None:
        sqs = list(energy_sum(torch.stack(sqs)).unbind())
    for t, b, sq in zip(send, control.bound, sqs):
        b32 = b.to(device=dev, dtype=F32).reshape(())
        if warm:
            bounds.append((b32.double() * decay
                           + (c_sq * sq).double()).to(F32))
        else:
            bounds.append(sq)
        if warm and cfg.skip_tau > 0.0 and t.numel() >= cfg.min_leaf_size:
            flags.append(sq <= tau * b32)
        else:
            flags.append(torch.zeros((), dtype=torch.bool, device=dev))
    return send, flags, bounds


def _row_flags(members, flags: list) -> torch.Tensor:
    """Per-leaf flags as one per-row mask of a group's ``[rows, ...]``
    buffers (rows in member order; ``grouping.member_row_flags``)."""
    return torch.cat([flags[i].reshape(1).expand(rows)
                      for i, rows in members])


def _apply_skip(cfg: CompressionConfig, items: list, flags: list):
    """Communication skipping on the compressed buffers, in place: a skipped
    leaf's rows ship zero values (exact zeros in the scatter-add, as the
    dense wire's zeroed q in its mean) and, on RICE, zero words and a zero
    counts word (the skip sentinel). Returns the bytes to refund from the
    exchange's static charge (float64 on the device): a skipped RICE row
    keeps only its counts word, any other row a 4-byte sentinel."""
    scale_b = 4 if cfg.scheme().codec.has_scale else 0
    savings = flags[0].new_zeros((), dtype=torch.float64)
    for kind, sg, members in items:
        if kind == "dense":                # tiny leaves never skip
            continue
        lp = wire_layout.plan(sg, fitted=cfg.rice_fitted)
        mask = _row_flags(members, flags)
        sg.values.masked_fill_(mask[:, None], 0)
        per_row = lp.val_len * sg.values.element_size() + scale_b
        if lp.layout == "rice":
            sg.rice_words.masked_fill_(mask[:, None], 0)
            sg.rice_used.masked_fill_(mask, 0)
        else:
            per_row += lp.idx_len * 4 - 4
        savings += mask.sum(dtype=torch.float64) * per_row
    return savings


def sync_tree(cfg: CompressionConfig, generator: torch.Generator,
              grads: list, *, group=None, pod_group=None,
              pod_generator: torch.Generator | None = None,
              stacked: list | None = None,
              feedback: FeedbackState | list | None = None,
              control: ControlState | None = None, energy_sum=None):
    """Compress this worker's gradient leaves and exchange them with the
    workers of ``group`` (the default process group when None), then, with
    a ``pod_group``, between the pods.

    ``grads`` are the model's leaves in the JAX flatten order; ``stacked``
    flags the layer-stacked ones (compressed per layer). ``generator``
    draws this worker's uniforms: give every worker its own stream. With
    ``cfg.error_feedback`` the caller must pass ``feedback`` (a
    FeedbackState or a residual list); the residual is added before
    compression and the new compression error comes back. With
    ``cfg.adaptive`` the caller must pass ``control`` too (a ControlState,
    ``optimizers.init_control``): the leaves go out as deltas against its
    ``last_sent``, leaves whose delta energy is under ``skip_tau`` times
    their bound are skipped, and the synced leaves are closed with
    ``delta_beta * last_avg``. The control's ``last_sent`` tensors are
    overwritten (module docstring): use the returned control. With a model
    axis ``grads`` are this worker's shards and ``energy_sum`` sums a
    float32 vector of per-leaf delta energies over the model workers (JAX's
    ``stat_axes``; ``train.step.shard_sync``).

    The pod hierarchy (``repro.comm.sync.sync_tree`` with a pod axis):
    ``group`` is then this worker's pod (its data workers) and
    ``pod_group`` the workers of the other pods at its data index, one per
    pod. The dense wire takes the mean over the pod, then over the pods.
    On the sparse wires the pod average goes through the pod stage, one
    selection whose messages cross ``pod_group``: without
    ``cfg.resparsify_pods`` a deterministic compaction to each group's
    capacity (``_compact_items``), whose drops, with error feedback, are
    added to this worker's residual; with it (Algorithm 1's step 7) a
    second compression of the pod average (the dense wire: then the mean
    over the pods), on ``pod_generator``, which must draw the same stream
    on every data worker of a pod and another in each pod and each model
    shard (the port's ``_pod_key``), and with error feedback on the pod's own residual
    ``feedback.pod_residual`` (``init_feedback(params, pod=True)``; every
    data worker of a pod carries the same). ``SyncStats.wire_bytes_intra``
    and ``wire_bytes_inter`` charge the two stages.

    Returns ``(synced, new_feedback, stats)``: the averaged leaves, the new
    FeedbackState (None without error feedback) and SyncStats; with a
    control, ``(synced, new_feedback, new_control, stats)``.
    """
    if isinstance(feedback, FeedbackState):
        residual, pod_residual = feedback.residual, feedback.pod_residual
    else:
        residual, pod_residual = feedback, None
    if cfg.error_feedback and residual is None:
        raise ValueError(
            "sync_tree: error_feedback=True requires the per-worker residual "
            "(feedback=FeedbackState(...)); refusing to silently drop the "
            "compression error.")
    resparsify = cfg.resparsify_pods and pod_group is not None
    if resparsify and cfg.error_feedback and pod_residual is None:
        raise ValueError(
            "sync_tree: error_feedback=True with resparsify_pods=True and a "
            "pod group requires the pod stage's residual too "
            "(feedback=FeedbackState(residual=..., pod_residual=...); build "
            "one with repro_torch.optim.optimizers.init_feedback(params, "
            "pod=True)): the pod stage's re-sparsification error must be "
            "carried, not dropped.")
    if resparsify and pod_generator is None:
        raise ValueError(
            "sync_tree: resparsify_pods with a pod group needs "
            "pod_generator, seeded alike on every data worker of a pod, so "
            "that the pod's workers re-sparsify its average alike.")
    if cfg.adaptive and control is None:
        raise ValueError(
            "sync_tree: adaptive=True requires the control state (pass "
            "control=ControlState(...), built with "
            "repro_torch.optim.optimizers.init_control and carried through "
            "the train step); delta transmission against an untracked "
            "last-sent state would silently drop gradient mass.")
    if control is not None and not cfg.adaptive:
        raise ValueError(
            "sync_tree: control state passed but cfg.adaptive=False: the "
            "control loop would be a silent no-op. Set "
            "CompressionConfig(adaptive=True, error_feedback=True) or drop "
            "the control argument.")
    dev = grads[0].device
    zero = torch.zeros((), dtype=F32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    stk = stacked if stacked is not None else [False] * len(grads)
    send, flags = grads, None
    if cfg.adaptive:
        send, flags, bounds = _delta_and_skips(cfg, grads, control,
                                               energy_sum)
    new_pod_res = pod_residual
    wire_inter = torch.zeros((), **f64)
    overflow, layouts = zero, ()
    if cfg.wire == "dense":
        q, new_res, stats = compress_tree(cfg, generator, send,
                                          stacked=stacked, residual=residual)
        if flags is not None:    # skipped leaves add exact zeros
            for t, f in zip(q, flags):
                t.masked_fill_(f, 0)
        synced, wire = _sync_leaves_dense(q, group)
        del q
        wire_intra = torch.tensor(wire, **f64)
        if flags is not None:
            _fold_skipped(send, residual, new_res, flags)
        if pod_group is not None:
            if resparsify:       # step 7 on the pod average, then the mean
                synced, new_pod_res, _ = compress_tree(
                    cfg, pod_generator, synced, stacked=stacked,
                    residual=pod_residual if cfg.error_feedback else None)
            synced, wire = _sync_leaves_dense(synced, pod_group)
            wire_inter = torch.tensor(wire, **f64)
    else:
        exchange = _exchange_fn(cfg)
        items, new_res, stats = compress_tree_sparse(
            cfg, generator, send, stacked=stacked, residual=residual)
        savings = _apply_skip(cfg, items, flags) if flags is not None \
            else None
        synced, wire, ovf = exchange(items, grads, group, cfg)
        wire_intra = wire.to(torch.float64)
        if savings is not None:
            wire_intra = wire_intra - savings
        layouts = tuple((sg.rows, sg.d, sg.k_cap, sg.layout)
                        for kind, sg, _ in items if kind == "sparse")
        del items
        if flags is not None:    # before the pod stage adds its drops
            _fold_skipped(send, residual, new_res, flags)
        if pod_group is not None:
            if resparsify:
                items, new_pod_res, _ = compress_tree_sparse(
                    cfg, pod_generator, synced, stacked=stacked,
                    residual=pod_residual if cfg.error_feedback else None)
            else:
                items = _compact_items(cfg, synced, stk)
                if cfg.error_feedback:
                    _add_compaction_drops(items, synced, new_res)
            synced, wire, ovf2 = exchange(items, synced, pod_group, cfg)
            del items
            wire_inter = wire.to(torch.float64)
            ovf = ovf + ovf2
        overflow = ovf.to(F32)
    new_control = None
    if cfg.adaptive:
        new_control = _close_control(cfg, grads, residual, new_res, bounds,
                                     synced, control)
    wire_t = wire_intra + wire_inter
    out_stats = SyncStats(
        bits=stats.bits, dense_bits=stats.dense_bits, wire_bytes=wire_t,
        wire_bytes_intra=wire_intra, wire_bytes_inter=wire_inter,
        density=stats.density, var_ratio=stats.var_ratio,
        overflow=overflow,
        skipped=(torch.stack(flags).sum(dtype=F32) if flags is not None
                 else zero),
        layouts=layouts)
    new_feedback = (FeedbackState(residual=new_res, pod_residual=new_pod_res)
                    if cfg.error_feedback else None)
    if control is not None:
        return synced, new_feedback, new_control, out_stats
    return synced, new_feedback, out_stats


def _fold_skipped(send, res_in, new_res, flags) -> None:
    """A skipped leaf's residual becomes its whole target ``send + r_in``
    (its q was zero), in place."""
    for t, r, nr, f in zip(send, res_in, new_res, flags):
        torch.where(f, t + r, nr, out=nr)


def _close_control(cfg, grads, res_in, new_res, bounds, synced,
                   control: ControlState) -> ControlState:
    """After the exchange, a leaf at a time and in place: the synced leaves
    become ``beta * last_avg + synced``, the receiver's closure of the
    delta; ``last_sent`` becomes ``S' = g + r_in - r_out`` (``beta * S +
    Q(target)``, one formula for sent and skipped leaves; ``r_out`` after
    ``_fold_skipped`` and the pod stage's drops)."""
    beta = cfg.delta_beta
    if beta:
        for s, a in zip(synced, control.last_avg):
            s.add_(a if beta == 1.0 else a * torch.full(
                (), beta, dtype=a.dtype, device=a.device))
    for g, r, nr, s in zip(grads, res_in, new_res, control.last_sent):
        torch.add(g, r, out=s).sub_(nr)
    return ControlState(
        last_sent=control.last_sent,
        last_avg=synced if beta else control.last_avg,
        bound=bounds, step=control.step + 1)
