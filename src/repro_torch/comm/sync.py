"""Gradient synchronization, Algorithm 1 on ``torch.distributed`` (port of
``repro.comm.sync``: ``SyncStats``, ``sync_tree`` with the adaptive control
loop, the dense wire's ``_sync_leaves_dense`` and the sync exchange
``_bucketed_sync`` on the gather wire, every wire layout with the static
and the data-fitted Golomb-Rice parameter, ``_apply_skip``).

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

On the gather wire (``cfg.wire == "gather"``) every worker compresses its
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

The overlapped exchange and the pod hierarchy are ROADMAP.md queue A item
9.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.comm import compaction, wire_layout
from repro_torch.core.api import (CompressionConfig, compress_tree,
                                  compress_tree_sparse)
from repro_torch.core.grouping import chunk_spans
from repro_torch.kernels.sparsify import kernel as K
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
    wire_bytes_inter: torch.Tensor  # ... in an inter-pod stage (0 here)
    density: torch.Tensor           # realized nnz fraction
    var_ratio: torch.Tensor         # ||Q(g)||^2/||g||^2, the paper's `var`
    overflow: torch.Tensor          # survivors dropped by the fixed capacity
    skipped: torch.Tensor           # leaves skipped (adaptive only)
    layouts: tuple = ()             # (rows, d, k_cap, layout) per sparse
                                    # group, as stamped this step

    FIELDS = ("bits", "dense_bits", "wire_bytes", "wire_bytes_intra",
              "wire_bytes_inter", "density", "var_ratio", "overflow",
              "skipped")


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[m, *x.shape]``: every worker's ``x``, in rank order."""
    m = dist.get_world_size(group)
    raw = x.contiguous().view(torch.uint8).reshape(-1)
    out = torch.empty(m * raw.numel(), dtype=torch.uint8, device=x.device)
    dist.all_gather_into_tensor(out, raw, group=group)
    return out.view(x.dtype).reshape((m,) + tuple(x.shape))


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


def _bucketed_sync(items: list, leaves: list, group,
                   cfg: CompressionConfig):
    """Exchange all groups with one collective set per (kind, wire dtype)
    chunk; returns ``(synced leaves, wire bytes as an int64 device tensor,
    overflow)``."""
    m = dist.get_world_size(group)
    out: list = [None] * len(leaves)
    dev = leaves[0].device
    wire = 0                        # bytes fixed by the static shapes
    used_words = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    dense_ids: list = []
    sparse_groups: dict = {}
    for e, (kind, payload, _members) in enumerate(items):
        if kind == "dense":
            dense_ids.append(e)
        else:
            sparse_groups.setdefault(payload.values.dtype, []).append(e)

    if dense_ids:
        flat = torch.cat([items[e][1].reshape(-1).to(F32)
                          for e in dense_ids])
        dist.all_reduce(flat, group=group)
        synced = _div_workers(flat, m)
        off = 0
        for e in dense_ids:
            for i, n in items[e][2]:
                leaf = leaves[i]
                out[i] = synced[off:off + n].reshape(leaf.shape).to(
                    leaf.dtype)
                off += n
        wire += flat.numel() * 4

    # room for the dead-slot scratch tail inside the int32 coordinates
    cap = min(cfg.bucket_coord_cap,
              compaction.INT32_COORD_LIMIT - wire_layout.DROP_SLOTS)
    codec = cfg.scheme().codec
    for wdt, ids in sorted(sparse_groups.items(),
                           key=lambda kv: _dtype_name(kv[0])):
        itemsize = torch.empty((), dtype=wdt).element_size()
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
            vals_parts, widx_parts, count_parts, plans = [], [], [], []
            scale_parts = []
            static_idx_words = coord_off = v_off = i_off = c_off = s_off = 0
            for e, r0, n in chunk:
                lp0, v2d, w2d, nw = packed[e]
                lp = dataclasses.replace(lp0, layers=n)
                w2 = w2d[r0:r0 + n]
                if lp.layout == "coo":
                    w2 = w2 + ((torch.arange(n, dtype=torch.int32,
                                             device=dev) * lp.d)[:, None]
                               + coord_off)
                if lp.idx_len:
                    widx_parts.append(w2.reshape(-1))
                if lp.layout == "rice":
                    count_parts.append(nw[r0:r0 + n])
                else:
                    static_idx_words += n * lp.idx_len
                vals_parts.append(v2d[r0:r0 + n].reshape(-1))
                if codec.has_scale:
                    scale_parts.append(items[e][1].scale[r0:r0 + n].to(F32))
                plans.append((e, lp, r0, v_off, i_off, coord_off, c_off,
                              s_off))
                v_off += n * lp.val_len
                i_off += n * lp.idx_len
                coord_off += lp.block
                c_off += n if lp.layout == "rice" else 0
                s_off += n
            compaction.check_bucket_coords(coord_off, len(chunk))
            gcounts = None
            if count_parts:                  # phase one: RICE row lengths
                counts = torch.cat(count_parts)
                gcounts = _all_gather(counts, group)               # [m, R]
                wire += counts.numel() * 4
                # a fitted count carries r above its used words
                used_words = used_words + (
                    counts & compaction.RICE_HDR_USED_MASK).sum(
                        dtype=torch.int64)
            gvals = _all_gather(torch.cat(vals_parts), group)      # [m, V]
            gwidx = None
            if widx_parts:                   # phase two: the index words
                gwidx = _all_gather(torch.cat(widx_parts), group)  # [m, I]
                wire += static_idx_words * 4
            gscales = None
            if scale_parts:                  # one float32 scale per row
                gscales = _all_gather(torch.cat(scale_parts), group)  # [m, S]
                wire += s_off * 4
            del vals_parts, widx_parts, count_parts, scale_parts
            # a scratch tail past the chunk takes the dead RICE slots
            dense = torch.zeros(coord_off + wire_layout.DROP_SLOTS,
                                dtype=F32, device=dev)
            for (e, lp, r0, v0, i0, c0, cc0, s0) in plans:
                decode_into(
                    dense, lp, gvals[:, v0:v0 + lp.layers * lp.val_len],
                    (gwidx[:, i0:i0 + lp.layers * lp.idx_len]
                     if lp.idx_len else None),
                    (gcounts[:, cc0:cc0 + lp.layers]
                     if lp.layout == "rice" else None), c0, coord_off,
                    (gscales[:, s0:s0 + lp.layers]
                     if gscales is not None else None), codec)
            del gvals, gwidx, gcounts, gscales
            dense = _div_workers(dense[:coord_off], m)
            for (e, lp, r0, _, _, c0, _, _) in plans:
                _route_span(items[e][2], r0, lp.layers, lp.d,
                            dense[c0:c0 + lp.block], pieces, leaves)
            wire += v_off * itemsize
            del dense
        _assemble_pieces(pieces, leaves, out)
    return out, used_words * 4 + wire, overflow


def _energy(t: torch.Tensor) -> torch.Tensor:
    """``sum(t^2)`` of one leaf as a float32 0-d tensor: its float32 squares
    summed in float64 and rounded once, by the ``stats`` kernel (kernel 7)
    over the leaf as one row, which reads it once (on the CPU its plain
    version). The JAX package sums in float32 in XLA's order, so the two
    differ by rounding only."""
    return K.stats(t.reshape(1, -1))[1][0]


def _delta_and_skips(cfg: CompressionConfig, grads: list,
                     control: ControlState):
    """The adaptive pre-pass: the leaves to send (the delta ``g - beta *
    last_sent``, written into the ``last_sent`` tensors; the gradients
    themselves at ``delta_beta`` 0), each leaf's skip flag (a 0-d bool on
    the device) and its new bound.

    The bound is primed with the delta energy at step 0, else its EMA
    ``decay * b + (1 - decay) * sq``, formed as XLA compiles it (one fused
    multiply-add over the float32 product ``(1 - decay) * sq``; float64
    here, then rounded). A leaf is skipped past step 0 when ``sq <= tau *
    b`` (float32); never at tau 0 or below ``cfg.min_leaf_size``."""
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
    for t, b in zip(send, control.bound):
        sq = _energy(t)
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
              grads: list, *, group=None, stacked: list | None = None,
              feedback: FeedbackState | list | None = None,
              control: ControlState | None = None):
    """Compress this worker's gradient leaves and exchange them with the
    workers of ``group`` (the default process group when None).

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
    overwritten (module docstring): use the returned control.

    Returns ``(synced, new_feedback, stats)``: the averaged leaves, the new
    FeedbackState (None without error feedback) and SyncStats; with a
    control, ``(synced, new_feedback, new_control, stats)``.
    """
    if isinstance(feedback, FeedbackState):
        residual = feedback.residual
    else:
        residual = feedback
    if cfg.error_feedback and residual is None:
        raise ValueError(
            "sync_tree: error_feedback=True requires the per-worker residual "
            "(feedback=FeedbackState(...)); refusing to silently drop the "
            "compression error.")
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
    send, flags = grads, None
    if cfg.adaptive:
        send, flags, bounds = _delta_and_skips(cfg, grads, control)
    if cfg.wire == "dense":
        q, new_res, stats = compress_tree(cfg, generator, send,
                                          stacked=stacked, residual=residual)
        if flags is not None:    # skipped leaves add exact zeros
            for t, f in zip(q, flags):
                t.masked_fill_(f, 0)
        synced, wire = _sync_leaves_dense(q, group)
        del q
        wire_t = torch.tensor(wire, dtype=torch.float64, device=dev)
        overflow, layouts = zero, ()
    else:
        items, new_res, stats = compress_tree_sparse(
            cfg, generator, send, stacked=stacked, residual=residual)
        savings = _apply_skip(cfg, items, flags) if flags is not None \
            else None
        synced, wire, overflow = _bucketed_sync(items, grads, group, cfg)
        wire_t = wire.to(torch.float64)
        if savings is not None:
            wire_t = wire_t - savings
        overflow = overflow.to(F32)
        layouts = tuple((sg.rows, sg.d, sg.k_cap, sg.layout)
                        for kind, sg, _ in items if kind == "sparse")
        del items
    new_control = None
    if cfg.adaptive:
        new_control = _close_control(cfg, grads, send, residual, new_res,
                                     flags, bounds, synced, control)
    out_stats = SyncStats(
        bits=stats.bits, dense_bits=stats.dense_bits, wire_bytes=wire_t,
        wire_bytes_intra=wire_t, wire_bytes_inter=zero,
        density=stats.density, var_ratio=stats.var_ratio,
        overflow=overflow,
        skipped=(torch.stack(flags).sum(dtype=F32) if flags is not None
                 else zero),
        layouts=layouts)
    new_feedback = (FeedbackState(residual=new_res)
                    if cfg.error_feedback else None)
    if control is not None:
        return synced, new_feedback, new_control, out_stats
    return synced, new_feedback, out_stats


def _close_control(cfg, grads, send, res_in, new_res, flags, bounds, synced,
                   control: ControlState) -> ControlState:
    """After the exchange, a leaf at a time and in place: a skipped leaf's
    residual becomes its whole target ``send + r_in`` (its q was zero); the
    synced leaves become ``beta * last_avg + synced``, the receiver's
    closure of the delta; ``last_sent`` becomes ``S' = g + r_in - r_out``
    (``beta * S + Q(target)``, one formula for sent and skipped leaves)."""
    beta = cfg.delta_beta
    for t, r, nr, f in zip(send, res_in, new_res, flags):
        torch.where(f, t + r, nr, out=nr)
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
