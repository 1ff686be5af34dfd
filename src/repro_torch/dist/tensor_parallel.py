"""The split of the model axis's compute: the collectives GSPMD inserts
for the JAX package's rules (``repro.dist.sharding``'s ``DP_RULES`` and
the archs' overrides), placed by hand.

Past one model worker every arch (the dense decoders gemma-2b,
paligemma-3b, gemma2-9b, gemma2-27b, starcoder2-7b, the MoE phi3.5-moe,
the MLA and MoE deepseek-v2, the encoder-decoder seamless-m4t-large-v2,
the RWKV-6 rwkv6-1.6b and the Mamba-2 hybrid zamba2-2.7b) holds only its
shards of the leaves the rules split, and runs the forward and backward
on them with explicit collectives over the model group, under autograd.
What every worker computes alike (the norms, MoE's router, aux losses and
dispatch, MLA's down projections, RWKV-6's five token-shift streams and
its decay, zamba2's shared input and output projections) stays outside
the pair ``copy_to`` ... ``reduce_from``, so its gradient is whole on
every worker and is not summed again:

- ``copy_to``: identity forward, a sum over the model workers backward, at
  the input of each split branch (the attention over heads, and a cross
  attention's encoder output; MLA's three latents; RWKV-6's streams and
  decay, stacked; the MLP and RWKV-6's channel mix; MoE's dispatched
  tokens; the Mamba-2 mixer's input; the unembedding), so the gradient of
  the replicated activation is whole on every worker;
- ``reduce_from``: a sum forward, identity backward, after each
  row-parallel product (``wo`` over heads, ``down`` over mlp, the experts'
  ``w_down`` over expert_mlp, before the combine weights multiply it,
  RWKV-6's ``tm/wo`` and ``cm/wv``, Mamba-2's ``out_proj``); a whole bias
  (``bo``, ``down_b``) is added once, after it, and RWKV-6's receptance
  gate ``sigmoid(xr @ cm/wr)``, whole, multiplies it after it;
- ``reduce_both``: a sum forward and backward, where every worker goes on
  with the sum on its own part of the channels (Mamba-2's gated RMSNorm,
  whose variance spans all of ``d_inner``: each worker's sum of squares);
- ``vocab_embed``: this worker's rows of the table looked up where the
  token falls in them, zeros elsewhere, summed over the workers: one worker
  adds a nonzero row per position, so the embedding is the whole one, bit
  for bit;
- ``gather_leaf``: a leaf's shards put together forward (an all-gather in
  rank order), this worker's block of the gradient backward. The
  head_dim-split archs (gemma-2b, paligemma-3b, starcoder2-7b) gather one
  layer's attention leaves and compute that layer's attention whole on
  the identical normed input: RoPE pairs dimension ``i`` with ``i +
  D/2``, which fall in different workers' blocks, and scores split over
  head_dim would need a score-sized sum. Every worker's gradient of the
  gathered leaf is then the same, and it keeps its block (ROADMAP.md queue
  C: the same function as GSPMD's, the work split differently);
- ``gather_summed``: a leaf's shards put together forward, and backward
  the gradient summed over the model workers (each sends block k of its
  gradient to worker k, which adds the M blocks in rank order), then this
  worker's block: for a leaf every worker reads in part, where the parts
  do not follow the blocks (Mamba-2's ``in_proj``, ``conv_w`` and
  ``conv_b``: their columns concatenate z, x, B, C and dt, or x, B and C,
  and the blocks straddle them; a worker reads its heads' columns of z, x
  and dt inside the split). ``gather_leaf`` would drop the other
  workers' share of the gradient. The columns of B and C every worker
  reads alike, outside the split (B and C are formed whole on every
  worker and copied into the split in float32, so that their gradient
  over all the heads is summed before its one rounding, as in the whole
  model): their gradient is the same on every worker and is counted once.
  A leaf the specs leave whole there is read whole, its gradient summed
  over the workers.

Sums run in float32 for a narrower dtype and are rounded once to it.
Where a split changes what is rounded, the partials stay in float32 so
that a sum rounds once, as the whole model's product does: the
row-parallel partial products (``row``: each worker's product a bf16
GEMM with a float32 output, summed, then rounded), and the gradient of a
branch's input (``columns``: ``copy_to`` and the column-parallel products
of it in one function, whose backward takes each product's partial
gradient of the input as a float32 GEMM output and sums them over the
products and the model workers before the one rounding). The weights,
the forward products and the weight gradients stay in the model dtype,
as the whole model's. The SSM mixers, GQA attention over heads, MLA's
``wo``, the gated and plain MLPs and the vocab-parallel unembedding run
so; MLA's latents and MoE's experts still sum partials rounded to the
model dtype.
The rule for a whole leaf that split compute reads: its gradient is whole
on every worker (``SAME``), either because it is read before the
``copy_to`` of the branch (RWKV-6's streams and decay; MLA's down
projections), or because the leaf itself goes through ``copy_to`` before
a worker slices its part (RWKV-6's group norm ``tm/ln_scale`` and
``tm/ln_bias``, a worker's heads of which it reads). The one exception is
older: where the heads split and the kv heads do not divide by the model
workers, ``wk`` and ``wv`` (``bk``, ``bv``) stay whole, each worker reads
the kv heads of its q heads (global head ``h`` reads kv head ``h // G``),
and its gradient of them is its share (``PARTIAL``), summed over the model
workers in rank order before the sync. ``plan_split`` reads the specs of
``launch.train.leaf_specs`` for every block path (the prelude, the
periods, zamba2's shared block, the encoder and the cross-attention
sublayers) and returns the worker's ``TensorParallel``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (PARTIAL, SAME, SPLIT, ModelAxis,
                                       is_split, place_slices, sum_in_order,
                                       worker_slices)

F32 = torch.float32


def reduce_sum(x: torch.Tensor, ma: ModelAxis) -> torch.Tensor:
    """``x`` summed over the model workers: a new tensor of x's dtype, the
    sum in float32 (or x's wider dtype) rounded once."""
    acc = x.to(torch.promote_types(x.dtype, F32), copy=True)
    return ma.sum(acc).to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ma):
        ctx.ma = ma
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.ma), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ma):
        return reduce_sum(x, ma)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, spec, ma):
        ctx.spec, ctx.ma = spec, ma
        return place_slices(list(ma.stack(shard.contiguous())), spec,
                            ma.sizes, ("model",))

    @staticmethod
    def backward(ctx, g):
        block = worker_slices(g.shape, ctx.spec, ctx.ma.sizes,
                              {"model": ctx.ma.index})
        return g[block].contiguous(), None, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ma):
        ctx.ma = ma
        return reduce_sum(x, ma)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.ma), None


def _reduce_scatter(g: torch.Tensor, spec: tuple,
                    ma: ModelAxis) -> torch.Tensor:
    """This worker's block under ``spec`` of ``g`` summed over the model
    workers: block k of every worker's ``g`` goes to worker k (one
    all-to-all, as bytes), which adds the blocks in rank order in float32
    (or g's wider dtype) and rounds once; ``g`` summed whole (an
    all-reduce) where ``spec`` leaves it whole."""
    if not is_split(spec):
        return reduce_sum(g, ma)
    send = torch.stack([g[worker_slices(g.shape, spec, ma.sizes,
                                        {"model": k})]
                        for k in range(ma.size)])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv.view(ma.size, -1).view(torch.uint8),
                           send.view(ma.size, -1).view(torch.uint8),
                           group=ma.group)
    return sum_in_order(recv.to(torch.promote_types(g.dtype, F32))).to(
        g.dtype)


def _counted_once(g: torch.Tensor, spec: tuple, ma: ModelAxis,
                  same: torch.Tensor) -> torch.Tensor:
    """``g`` with its columns ``same`` (on the last axis: a gradient every
    worker holds alike) zeroed outside this worker's block under ``spec``
    (a whole leaf: on every worker but index 0), so that a sum over the
    workers counts them once."""
    mine = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    if is_split(spec):
        mine[worker_slices(g.shape, spec, ma.sizes,
                           {"model": ma.index})] = True
    elif ma.index == 0:
        mine.fill_(True)
    col = torch.zeros(g.shape[-1], dtype=torch.bool, device=g.device)
    col[same] = True
    return g.masked_fill(col & ~mine, 0)


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, spec, ma, same):
        ctx.spec, ctx.ma, ctx.same = spec, ma, same
        if not is_split(spec):
            return shard.view_as(shard)
        return place_slices(list(ma.stack(shard.contiguous())), spec,
                            ma.sizes, ("model",))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.same is not None:
            g = _counted_once(g, ctx.spec, ctx.ma, ctx.same)
        return _reduce_scatter(g, ctx.spec, ctx.ma), None, None, None


def copy_to(x: torch.Tensor, ma: ModelAxis) -> torch.Tensor:
    """Into the model group: ``x`` forward, its gradient summed backward."""
    return _Copy.apply(x, ma)


def reduce_from(x: torch.Tensor, ma: ModelAxis) -> torch.Tensor:
    """From the model group: ``x`` summed forward, identity backward."""
    return _Reduce.apply(x, ma)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 at least."""
    return x.to(torch.promote_types(x.dtype, F32))


def _mm_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two matrices, accumulated and returned in float32 at
    least: on the card a 16-bit GEMM with a float32 output (``out_dtype``),
    on the CPU, whose GEMMs take no output dtype, of the operands widened
    (the same products: two bf16 factors multiply exactly in float32)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                        torch.float16):
        return torch.mm(a, b, out_dtype=F32)
    return _widen(a) @ _widen(b)


def _mat(x: torch.Tensor, lead: int) -> torch.Tensor:
    """``x`` as a matrix of its first ``lead`` axes by the rest."""
    return x.reshape(math.prod(x.shape[:lead]), -1)


class _Columns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ma, which, *args):
        n = len(args) - len(which)
        xs, ws = args[:n], args[n:]
        ctx.ma, ctx.which, ctx.n = ma, which, n
        ctx.save_for_backward(*args)
        return tuple((_mat(xs[i], xs[i].dim() - 1) @ _mat(w, 1)).reshape(
            *xs[i].shape[:-1], *w.shape[1:]) for i, w in zip(which, ws))

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        xs, ws = saved[:ctx.n], saved[ctx.n:]
        gx: list = [None] * ctx.n
        gw = []
        for j, (i, w, g) in enumerate(zip(ctx.which, ws, gs)):
            x = _mat(xs[i], xs[i].dim() - 1)
            g = g.reshape(x.shape[0], -1)
            part = _mm_wide(g, _mat(w, 1).T)
            gx[i] = part if gx[i] is None else gx[i] + part
            gw.append((x.T @ g).reshape(w.shape)
                      if ctx.needs_input_grad[2 + ctx.n + j] else None)
        flat = ctx.ma.sum(torch.cat([g.reshape(-1) for g in gx]))
        out, at = [], 0
        for x in xs:                # each input's sum rounded once
            out.append(flat[at:at + x.numel()].view(x.shape).to(x.dtype))
            at += x.numel()
        return (None, None, *out, *gw)


def columns(pairs: list, ma: ModelAxis) -> list:
    """Into the model group, then the column-parallel products: for each
    ``(x, w)`` of ``pairs``, ``x @ w`` (x's last axis against w's first,
    the product in w's dtype, as ``einsum`` forms it). Backward, each
    input's gradient (an input may feed several products) is its
    products' partial gradients in float32, summed over them and over the
    model workers (one all-reduce), then rounded once to its dtype; each
    weight's gradient is this worker's, in its dtype."""
    xs: list = []
    which = []
    for x, _ in pairs:
        k = next((i for i, y in enumerate(xs) if y is x), None)
        if k is None:
            xs.append(x)
            k = len(xs) - 1
        which.append(k)
    return list(_Columns.apply(ma, tuple(which), *xs,
                               *(w for _, w in pairs)))


class _Row(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, ma):
        ctx.save_for_backward(a, w)
        k = w.dim() - 1
        y = ma.sum(_mm_wide(_mat(a, a.dim() - k), _mat(w, k)))
        return y.to(a.dtype).reshape(*a.shape[:a.dim() - k], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        k = w.dim() - 1
        am, wm = _mat(a, a.dim() - k), _mat(w, k)
        g = g.reshape(am.shape[0], -1)
        return ((g @ wm.T).reshape(a.shape) if ctx.needs_input_grad[0]
                else None,
                (am.T @ g).reshape(w.shape) if ctx.needs_input_grad[1]
                else None, None)


def row(a: torch.Tensor, w: torch.Tensor, ma: ModelAxis) -> torch.Tensor:
    """The row-parallel product of this worker's part of ``a`` and its
    rows of ``w`` (a's last ``w.dim() - 1`` axes against w's first),
    summed over the model workers: each worker's partial product in
    float32 (``_mm_wide``), the sum rounded once to a's dtype; backward
    the identity into the product (its gradients in a's dtype), as
    ``reduce_from``."""
    return _Row.apply(a, w, ma)


def gather_leaf(shard: torch.Tensor, spec: tuple,
                ma: ModelAxis) -> torch.Tensor:
    """The whole leaf from this worker's ``shard`` under ``spec``; backward,
    this worker's block of the (identical) gradient of the whole leaf."""
    return _Gather.apply(shard, spec, ma)


def reduce_both(x: torch.Tensor, ma: ModelAxis) -> torch.Tensor:
    """Over the model group: ``x`` summed forward, its gradient summed
    backward (each worker goes on with the sum on its own part)."""
    return _ReduceBoth.apply(x, ma)


def gather_summed(shard: torch.Tensor, spec: tuple, ma: ModelAxis,
                  same: torch.Tensor | None = None) -> torch.Tensor:
    """The whole leaf from this worker's ``shard`` under ``spec`` (the
    shard itself where ``spec`` leaves it whole); backward, this worker's
    block of the gradient summed over the model workers, each of which
    read a part of the whole leaf (``_reduce_scatter``). ``same``: the
    columns (last axis) every worker reads alike, outside the split, and
    no worker reads in part, so that their gradient is the same on every
    worker: it is counted once (``_counted_once``)."""
    return _GatherSummed.apply(shard, spec, ma, same)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, ma: ModelAxis,
                lo: int) -> torch.Tensor:
    """``table`` holds rows ``lo .. lo + n - 1`` of the whole table: the
    rows of ``tokens`` that fall there, zeros elsewhere, summed over the
    model workers (the whole ``table[tokens]``, exactly)."""
    n = table.shape[0]
    local = tokens - lo
    outside = (local < 0) | (local >= n)
    rows = table[local.clamp(0, n - 1)].masked_fill(outside[..., None], 0)
    return reduce_from(rows, ma)


@dataclasses.dataclass(frozen=True)
class AttnSplit:
    """How a block's attention runs on this worker: ``heads`` (its q heads
    ``q`` and the kv heads ``kv`` they read; ``kv_split``: ``wk``/``wv``
    are its shards, else whole and sliced to ``kv``), ``mla`` (MLA over
    its heads ``q``: the down projections whole, the three latents copied
    into the split), ``gather`` (the leaves in ``gather``, with their
    per-layer specs, put together and the attention computed whole) or
    ``whole`` (nothing split)."""
    mode: str
    q: tuple = (0, 0)
    kv: tuple = (0, 0)
    kv_split: bool = False
    gather: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class MixSplit:
    """How a recurrent mixer (RWKV-6's time mix, the Mamba-2 mixer) runs
    on this worker: over its heads ``[lo, hi)``; ``gather``: the leaves,
    with their per-layer specs, that every worker reads in part across the
    blocks (``gather_summed``: Mamba-2's ``in_proj``, ``conv_w`` and
    ``conv_b``)."""
    heads: tuple
    gather: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One worker's split: its model axis (``grads`` filled), by block
    path (``blocks/b0_attn_full``, ``prelude/p0_mla_dense``,
    ``encoder/blk``, ``cross/x0``, ``shared``) each attention's
    ``AttnSplit``, each recurrent mixer's ``MixSplit`` (``ssm``:
    ``blocks/b0_rwkv``, ``blocks/b1_mamba``) and the parts of each FFN
    that run split (``("mlp",)`` for a dense or gated MLP and RWKV-6's
    channel mix, ``"experts"`` and ``"shared"`` for MoE's routed and
    shared experts; ``()`` whole), and its rows of the embedding table
    ``[lo, hi)`` (None: the table is whole)."""
    axis: ModelAxis
    attn: dict
    ffn: dict
    vocab: tuple | None
    names: tuple
    ssm: dict = dataclasses.field(default_factory=dict)

    def keep(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This worker's shard of the whole leaf ``name`` (a copy, so the
        whole one can be freed; the leaf itself where it is whole)."""
        i = self.names.index(name)
        return self.axis.shard(t, i).clone() if self.axis.split(i) else t

    def vocab_axis(self):
        """``(axis, lo)`` of the vocab-parallel embedding and loss, None
        where the table is whole."""
        return None if self.vocab is None else (self.axis, self.vocab[0])

    def ffn_axis(self, path: str, part: str):
        """The model axis where ``part`` of the FFN at ``path`` runs split,
        else None."""
        return self.axis if part in self.ffn[path] else None


def _block_of(spec: tuple, dim: int, size: int, ma: ModelAxis) -> tuple:
    """This worker's ``[lo, hi)`` along ``dim`` of a leaf whose ``dim`` is
    ``size`` long (the whole ``(0, size)`` where ``spec`` leaves it)."""
    shape = [1] * len(spec)
    shape[dim] = size
    sl = worker_slices(tuple(shape), spec, ma.sizes, {"model": ma.index})
    return sl[dim].start, sl[dim].stop


def _gather_or_whole(specs: dict) -> AttnSplit:
    split = {k: s for k, s in specs.items() if is_split(s)}
    return AttnSplit("gather", gather=split) if split else AttnSplit("whole")


def _attn_split(cfg, path: str, specs: dict, ma: ModelAxis) -> AttnSplit:
    """A GQA attention's split from its leaves' per-layer ``specs``."""
    if specs["wq"][1] is not None:           # heads over the model axis
        h, kv = cfg.num_heads, cfg.num_kv_heads
        groups = h // kv
        q = _block_of(specs["wq"], 1, h, ma)
        kv_split = specs["wk"][1] is not None
        kvb = (_block_of(specs["wk"], 1, kv, ma) if kv_split
               else (q[0] // groups, (q[1] - 1) // groups + 1))
        nq, nkv = q[1] - q[0], kvb[1] - kvb[0]
        if nq % nkv or any((q[0] + j) // groups - kvb[0] != j // (nq // nkv)
                           for j in range(nq)):
            raise ValueError(
                f"{path}: q heads {q} of {h} read kv heads {kvb} of {kv} in "
                "no regular grouping; the split step cannot run it")
        return AttnSplit("heads", q=q, kv=kvb, kv_split=kv_split)
    return _gather_or_whole(specs)


# MLA's leaves split over heads (dim 1, ``wo`` dim 0) and kept whole
_MLA_HEADS = {"q_up": (None, "model", None), "k_up": (None, "model", None),
              "v_up": (None, "model", None), "wo": ("model", None, None)}
_MLA_WHOLE = ("q_down", "kv_down", "k_rope")


def _mla_split(cfg, specs: dict, ma: ModelAxis) -> AttnSplit:
    """An MLA attention's split: over heads where the up projections and
    ``wo`` split there and the down projections stay whole (deepseek-v2's
    rules), else gathered."""
    if all(specs[k] == s for k, s in _MLA_HEADS.items()) and not any(
            is_split(specs[k]) for k in _MLA_WHOLE):
        return AttnSplit("mla", q=_block_of(specs["q_up"], 1, cfg.num_heads,
                                            ma))
    return _gather_or_whole(specs)


# the routed experts' split: ``w_gate``/``w_up`` [E, d, f] by columns,
# ``w_down`` [E, f, d] by rows
_EXPERTS = {"w_gate": (None, None, "model"), "w_up": (None, None, "model"),
            "w_down": (None, "model", None)}


def _ffn_split(path: str, specs: dict) -> tuple:
    """The parts of an FFN that run split, from its leaves' per-layer
    ``specs``: ``("mlp",)``, or MoE's ``"experts"`` and ``"shared"``."""
    if "down" in specs:
        return ("mlp",) if is_split(specs["down"]) else ()
    parts = ()
    if any(is_split(specs[k]) for k in _EXPERTS):
        if any(specs[k] != s for k, s in _EXPERTS.items()):
            raise ValueError(f"{path}: experts split as {specs}; the split "
                             "step splits expert_mlp only")
        parts += ("experts",)
    if "shared/down" in specs and is_split(specs["shared/down"]):
        parts += ("shared",)
    return parts


# the recurrent mixers' leaves that split with their heads (per layer):
# RWKV-6's r, k, v and g projections by columns, its bonus ``u`` by heads
# and ``wo`` by rows; Mamba-2's per-head scalars, its norm's scale and
# ``out_proj``'s rows. Every other leaf of RWKV-6's time mix stays whole;
# Mamba-2's others (``in_proj``, ``conv_w``, ``conv_b``) are read in part
# by every worker
_RWKV_HEADS = {"wr": (None, "model"), "wk": (None, "model"),
               "wv": (None, "model"), "wg": (None, "model"),
               "u": ("model", None), "wo": ("model", None)}
_MAMBA_HEADS = {"a_log": ("model",), "dt_bias": ("model",),
                "d_skip": ("model",), "norm_scale": ("model",),
                "out_proj": ("model", None)}
# RWKV-6's channel mix: ``wk`` by columns, ``wv`` by rows, ``wr`` whole
_CHANNEL = {"wk": (None, "model"), "wv": ("model", None)}


def _heads_only(path: str, specs: dict, heads: dict, others=None) -> None:
    """Refuse a mixer whose leaves split other than over its heads: those
    in ``heads`` as given there, those in ``others`` any way, the rest
    whole."""
    bad = {k: s for k, s in specs.items()
           if (s != heads[k] if k in heads else
               k not in (others or ()) and is_split(s))}
    if bad:
        raise ValueError(f"{path}: {bad} split other than over the heads; "
                         "the split step cannot run it")


def _rwkv_split(cfg, path: str, specs: dict, ma: ModelAxis) -> MixSplit:
    """RWKV-6's time mix over the heads the bonus ``u`` splits."""
    _heads_only(path, specs, _RWKV_HEADS)
    return MixSplit(heads=_block_of(specs["u"], 0, cfg.rwkv.num_heads, ma))


def _mamba_split(cfg, path: str, specs: dict, ma: ModelAxis) -> MixSplit:
    """The Mamba-2 mixer over the heads ``a_log`` splits; the leaves
    outside ``_MAMBA_HEADS`` (the projection and the convolution, whose
    columns concatenate the parts) read through ``gather_summed``."""
    others = {k: s for k, s in specs.items() if k not in _MAMBA_HEADS}
    _heads_only(path, specs, _MAMBA_HEADS, others)
    return MixSplit(heads=_block_of(specs["a_log"], 0, cfg.mamba.num_heads,
                                    ma), gather=others)


def _channel_split(path: str, specs: dict) -> tuple:
    """RWKV-6's channel mix: ``("mlp",)`` where ``wk`` and ``wv`` split
    (``wr`` whole), ``()`` where every leaf is whole."""
    if not any(is_split(s) for s in specs.values()):
        return ()
    _heads_only(path, specs, _CHANNEL)
    return ("mlp",)


def _block_paths(cfg):
    """``(path, kind, stacked, ffn)`` of every block path: the prelude,
    the periods, zamba2's shared block, the encoder's block and the
    cross-attention sublayers (``ffn`` False: attention only)."""
    out = [(p, k, False, True) for p, k in cfg.prelude_blocks()]
    out += [(p, k, True, True) for p, k in cfg.blocks()]
    if "shared_attn" in cfg.pattern:
        out.append(("shared", "attn_full", False, True))
    if cfg.encoder_periods:
        out.append(("encoder/blk", "attn_full", True, True))
        out += [(p, "attn_full", True, False) for p in cfg.cross_blocks()]
    return out


def plan_split(cfg, names, ma: ModelAxis) -> TensorParallel:
    """This worker's ``TensorParallel`` for ``cfg`` whose leaves (in
    ``names``' order) ``ma.specs`` places; ``ma.grads`` filled. Raises
    ValueError where the specs split a block in a way the split step does
    not run (q heads that read kv heads in no regular grouping, a
    recurrent mixer split other than over its heads, experts split other
    than over expert_mlp)."""
    names = tuple(names)
    spec_of = dict(zip(names, ma.specs))
    attn, ffn, mix, partial = {}, {}, {}, set()
    for path, kind, stacked, has_ffn in _block_paths(cfg):
        def specs(part, path=path, stacked=stacked):
            n = len(path) + len(part) + 2
            return {k[n:]: s[1:] if stacked else s
                    for k, s in spec_of.items()
                    if k.startswith(f"{path}/{part}/")}
        if kind == "shared_attn":   # a site: its LoRA whole, outside the split
            continue
        if kind == "rwkv":
            mix[path] = _rwkv_split(cfg, path, specs("tm"), ma)
            ffn[path] = _channel_split(path, specs("cm"))
            continue
        if kind == "mamba":
            mix[path] = _mamba_split(cfg, path, specs("mix"), ma)
            continue
        if kind in ("mla", "mla_dense"):
            a = _mla_split(cfg, specs("attn"), ma)
        else:
            a = _attn_split(cfg, path, specs("attn"), ma)
        attn[path] = a
        if a.mode == "heads" and not a.kv_split:
            partial.update(f"{path}/attn/{k}" for k in ("wk", "wv", "bk",
                                                         "bv"))
        if has_ffn:
            ffn[path] = _ffn_split(path, specs("ffn"))
    table = spec_of["embed/table"]
    vocab = (_block_of(table, 0, cfg.vocab, ma) if is_split(table)
             else None)
    grads = tuple(SPLIT if ma.split(i) else PARTIAL if n in partial
                  else SAME for i, n in enumerate(names))
    return TensorParallel(axis=dataclasses.replace(ma, grads=grads),
                          attn=attn, ffn=ffn, vocab=vocab, names=names,
                          ssm=mix)
