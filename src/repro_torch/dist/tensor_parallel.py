"""The split of the model axis's compute: the collectives GSPMD inserts
for the JAX package's rules (``repro.dist.sharding``'s ``DP_RULES`` and
the archs' overrides), placed by hand.

Past one model worker an arch without SSM blocks (``splits``: the dense
decoders gemma-2b, paligemma-3b, gemma2-9b, gemma2-27b, starcoder2-7b, the
MoE phi3.5-moe, the MLA and MoE deepseek-v2, the encoder-decoder
seamless-m4t-large-v2) holds only its shards of the leaves the rules
split, and runs the forward and backward on them with explicit
collectives over the model group, under autograd. What every worker
computes alike (the norms, MoE's router, aux losses and dispatch, MLA's
down projections) stays outside the pair ``copy_to`` ... ``reduce_from``,
so its gradient is whole on every worker and is not summed again:

- ``copy_to``: identity forward, a sum over the model workers backward, at
  the input of each split branch (the attention over heads, and a cross
  attention's encoder output; MLA's three latents; the MLP; MoE's
  dispatched tokens; the unembedding), so the gradient of the replicated
  activation is whole on every worker;
- ``reduce_from``: a sum forward, identity backward, after each
  row-parallel product (``wo`` over heads, ``down`` over mlp, the experts'
  ``w_down`` over expert_mlp, before the combine weights multiply it); a
  whole bias (``bo``, ``down_b``) is added once, after it;
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
  C: the same function as GSPMD's, the work split differently).

Sums run in float32 for a narrower dtype and are rounded once to it.
Where the heads split and the kv heads do not divide by the model
workers, ``wk`` and ``wv`` (``bk``, ``bv``) stay whole: each worker reads
the kv heads of its q heads (global head ``h`` reads kv head ``h // G``),
so its gradient of them is its share (``PARTIAL``), summed over the model
workers before the sync. ``plan_split`` reads the specs of
``launch.train.leaf_specs`` for every block path (the prelude, the
periods, the encoder and the cross-attention sublayers) and returns the
worker's ``TensorParallel``. The SSM blocks (rwkv6, zamba2) take the
gathered step: Mamba-2's ``in_proj`` and ``conv_w`` concatenate five
parts along the one split axis, and RWKV-6 splits heads inside a chunked
scan (ROADMAP.md queue A item 10d).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import (PARTIAL, SAME, SPLIT, ModelAxis,
                                       is_split, place_slices, worker_slices)

F32 = torch.float32
# the SSM and hybrid block kinds (``models.transformer.SSM_KINDS``): an
# arch with one takes the gathered step
SSM_KINDS = ("rwkv", "mamba", "shared_attn")


def splits(cfg) -> bool:
    """Whether the split step takes ``cfg``: attention (GQA or MLA) blocks
    with a gated, plain or MoE FFN, a prelude, an encoder and its cross
    attention; not the SSM blocks, which take the gathered step."""
    return not (set(cfg.pattern) | set(cfg.prelude)) & set(SSM_KINDS)


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


def copy_to(x: torch.Tensor, ma: ModelAxis) -> torch.Tensor:
    """Into the model group: ``x`` forward, its gradient summed backward."""
    return _Copy.apply(x, ma)


def reduce_from(x: torch.Tensor, ma: ModelAxis) -> torch.Tensor:
    """From the model group: ``x`` summed forward, identity backward."""
    return _Reduce.apply(x, ma)


def gather_leaf(shard: torch.Tensor, spec: tuple,
                ma: ModelAxis) -> torch.Tensor:
    """The whole leaf from this worker's ``shard`` under ``spec``; backward,
    this worker's block of the (identical) gradient of the whole leaf."""
    return _Gather.apply(shard, spec, ma)


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
class TensorParallel:
    """One worker's split: its model axis (``grads`` filled), by block
    path (``blocks/b0_attn_full``, ``prelude/p0_mla_dense``,
    ``encoder/blk``, ``cross/x0``) each attention's ``AttnSplit`` and the
    parts of each FFN that run split (``("mlp",)`` for a dense or gated
    MLP, ``"experts"`` and ``"shared"`` for MoE's routed and shared
    experts; ``()`` whole), and its rows of the embedding table ``[lo,
    hi)`` (None: the table is whole)."""
    axis: ModelAxis
    attn: dict
    ffn: dict
    vocab: tuple | None
    names: tuple

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


def _block_paths(cfg):
    """``(path, kind, stacked, ffn)`` of every block path: the prelude,
    the periods, the encoder's block and the cross-attention sublayers
    (``ffn`` False: attention only)."""
    out = [(p, k, False, True) for p, k in cfg.prelude_blocks()]
    out += [(p, k, True, True) for p, k in cfg.blocks()]
    if cfg.encoder_periods:
        out.append(("encoder/blk", "attn_full", True, True))
        out += [(p, "attn_full", True, False) for p in cfg.cross_blocks()]
    return out


def plan_split(cfg, names, ma: ModelAxis) -> TensorParallel:
    """This worker's ``TensorParallel`` for ``cfg`` whose leaves (in
    ``names``' order) ``ma.specs`` places; ``ma.grads`` filled. Raises
    ValueError for an arch the split step does not take (an SSM block)."""
    if not splits(cfg):
        raise ValueError(f"{cfg.name}: the split step takes no SSM block "
                         f"({', '.join(SSM_KINDS)}); it runs the gathered "
                         "step")
    names = tuple(names)
    spec_of = dict(zip(names, ma.specs))
    attn, ffn, partial = {}, {}, set()
    for path, kind, stacked, has_ffn in _block_paths(cfg):
        def specs(part, path=path, stacked=stacked):
            n = len(path) + len(part) + 2
            return {k[n:]: s[1:] if stacked else s
                    for k, s in spec_of.items()
                    if k.startswith(f"{path}/{part}/")}
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
                          attn=attn, ffn=ffn, vocab=vocab, names=names)
