"""The fsdp mode's data axis under autograd: a leaf's data blocks put
together just before use and its gradient scattered back averaged, the
collectives GSPMD inserts for ``FSDP_RULES`` in the JAX package (which
has no module for them), placed by hand.

A worker holds its block of every leaf (``dist.sharding.FsdpLayout``).
The forward reads the parameters through ``Gathered``, a mapping that
gives a leaf, or one layer of a stacked leaf, put together over the data
workers (``gather``: an all-gather in rank order) at the moment the model
reads it, so that a period's leaves are gathered just before the period
runs. What comes out is the block of the model axis alone, the shard the
split compute (``dist.tensor_parallel``) takes past one model worker, or
the whole leaf at one. Backward, ``gather`` scatters the gradient of the
gathered piece back (``FsdpLayout.scatter_mean``: the reduce-scatter half
of the dense exchange's ordered mean), so that each worker's gradient of
its block is the mean over the data workers, in their order.

A norm's scale and bias (read only widened to float32, by
``layers.rmsnorm`` and ``layernorm``) come gathered in float32: their
gradient then reaches the mean as each worker's float32 sum over its
tokens, and the mean rounds it to the leaf's dtype once, where a bf16
gradient would be rounded on each worker first, one rounding more than
the whole model's. The other leaves' gradients come in their own dtype,
as each worker's products give them.

``regathered`` keeps no gathered copy past its period's forward: autograd
saves what a backward needs (a product saves its weight), and under it a
saved tensor that is (a view of) a gathered piece is packed as the shard
it came from and gathered again when the backward unpacks it: the same
bits, so the numerics are the unsaved ones. (Re-running each period under
``torch.utils.checkpoint`` would save the memory too, but a second forward
on the card need not repeat the first bit for bit: MoE's dispatch adds
with atomics.)

``shard_grads`` is the fsdp step's backward: its loss on this worker's
batch and its block of the gradient of every leaf averaged over the data
workers, a model-axis ``PARTIAL`` leaf's shares summed over the model
workers in rank order.
"""
from __future__ import annotations

import contextlib
import hashlib
from collections.abc import Mapping

import torch

from repro_torch.dist.sharding import FsdpLayout, data_only, is_split

F32 = torch.float32


def _gathered(shard, spec, layout, wide: bool) -> torch.Tensor:
    whole = layout.gather_data(shard, spec)
    return whole.to(torch.promote_types(whole.dtype, F32)) if wide \
        else whole


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, spec, layout, wide):
        ctx.spec, ctx.layout, ctx.dtype = spec, layout, shard.dtype
        return _gathered(shard, spec, layout, wide)

    @staticmethod
    def backward(ctx, g):
        return (ctx.layout.scatter_mean(g.contiguous(), ctx.spec, ctx.dtype),
                None, None, None)


def gather(shard: torch.Tensor, spec: tuple, layout: FsdpLayout,
           wide: bool = False) -> torch.Tensor:
    """``shard`` (a leaf's block, or one layer's, split under ``spec``)
    put together over the data workers; backward its gradient's mean over
    them, this worker's block. ``wide``: the piece in float32 at least, for
    a leaf every reader widens first (a norm's scale and bias), so that its
    gradient reaches the mean unrounded and is rounded to the leaf's dtype
    once, after the sum, as the whole model's is. ``shard`` itself where
    ``spec`` uses no data axis. The result is marked with where it came
    from, for ``regathered``."""
    if not is_split(data_only(spec)):
        return shard
    out = _GatherData.apply(shard, spec, layout, wide)
    out._fsdp_source = (shard, spec, layout, wide)
    return out


class _Layers:
    """The layers of a stacked leaf's shard, each gathered when taken."""

    def __init__(self, shard: torch.Tensor, spec: tuple,
                 layout: FsdpLayout, wide: bool):
        self.parts = shard.unbind(0)
        self.spec, self.layout, self.wide = spec[1:], layout, wide

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i: int) -> torch.Tensor:
        return gather(self.parts[i], self.spec, self.layout, self.wide)


class Gathered(Mapping):
    """The parameters as the forward reads them: ``params[name]`` this
    worker's shard of each leaf, ``self[name]`` the leaf gathered over the
    data workers, and ``layers(name)`` a stacked leaf's layers, each
    gathered when taken (``models.transformer._layers`` takes them so).
    The leaves in ``wide`` (the norms', ``models.transformer.
    norm_leaves``) come gathered in float32."""

    def __init__(self, params, layout: FsdpLayout, wide=()):
        self.params = dict(params)
        self.layout = layout
        self.index = {n: i for i, n in enumerate(layout.names)}
        self.wide = frozenset(wide)

    def _spec(self, name: str) -> tuple:
        return self.layout.specs[self.index[name]]

    def __getitem__(self, name: str) -> torch.Tensor:
        return gather(self.params[name], self._spec(name), self.layout,
                      name in self.wide)

    def __iter__(self):
        return iter(self.params)

    def __len__(self) -> int:
        return len(self.params)

    def layers(self, name: str) -> _Layers:
        return _Layers(self.params[name], self._spec(name), self.layout,
                       name in self.wide)


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    src = getattr(base, "_fsdp_source", None)
    if src is None:
        return t
    return src, tuple(t.shape), t.stride(), t.storage_offset()


def _unpack(x):
    if isinstance(x, torch.Tensor):
        return x
    (shard, spec, layout, wide), shape, stride, offset = x
    with torch.no_grad():
        whole = _gathered(shard, spec, layout, wide)
    return whole.as_strided(shape, stride, offset)


@contextlib.contextmanager
def regathered():
    """Within it, autograd saves a gathered piece as its shard and gathers
    it again in the backward (module docstring)."""
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


def shard_grads(model, layout: FsdpLayout, loss_fn, batch):
    """This worker's loss on ``batch`` and its block of each leaf's
    gradient averaged over the data workers (``loss_fn(params, batch)``
    reads ``Gathered`` parameters): a leaf whose spec uses the data axis
    is averaged by ``gather``'s backward, any other by the dense
    exchange's ordered mean; a model-axis ``PARTIAL`` leaf's shares are
    then summed over the model workers in rank order. A leaf the loss
    never reads gets exact zeros."""
    from repro_torch.comm.sync import _worker_order_mean
    from repro_torch.models.transformer import norm_leaves
    params = model.leaves()
    for p in params:
        p.grad = None
    with regathered():
        loss = loss_fn(Gathered(model.params, layout,
                                norm_leaves(model.cfg)), batch)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    for p in params:
        p.grad = None
    n = layout.data.size
    for i, g in enumerate(grads):
        if n > 1 and not layout.uses_data(i):
            _worker_order_mean(g.view(-1), n, layout.data.group)
        if layout.model.partial(i):
            grads[i] = layout.model.sum_in_rank_order(g.contiguous())
    return loss, grads


class KeyedUniforms:
    """The fsdp mode's compression uniforms: a row's shard draws float32
    uniforms from a stream of its own, keyed by ``seed``, ``step``, the
    leaf, the row and the shard's slices of the leaf, so that every worker
    holding the same block (a leaf's replicas over an axis its spec does
    not use) draws the same numbers. The stream is the port's own."""

    def __init__(self, seed: int, step: int, device):
        self.seed, self.step, self.device = seed, step, device

    def __call__(self, leaf: int, row: int, block: tuple,
                 n: int) -> torch.Tensor:
        key = repr((self.seed, self.step, leaf, row,
                    tuple((s.start, s.stop) for s in block)))
        seed = int.from_bytes(hashlib.blake2b(
            key.encode(), digest_size=8).digest(), "little") >> 1
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.rand(n, generator=gen, dtype=torch.float32,
                          device=self.device)
