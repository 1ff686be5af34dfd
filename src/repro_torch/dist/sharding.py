"""Logical-axis sharding rules and one worker's shard of a leaf (port of
``repro.dist.sharding``: ``DP_RULES``, ``FSDP_RULES``, ``with_pod``,
``_as_tuple`` and ``resolve_spec``; and ``repro.train.step._strip_manual``
as ``strip_manual``).

The rules map a parameter's logical axes (``models.transformer.
param_axes``: "embed", "heads", "mlp", "vocab", "layers", ...) onto the
mesh axes "pod", "data" and "model". ``resolve_spec`` turns (shape,
logical axes) into a spec with the JAX package's three rules: keep only
mesh axes that exist and are not used by an earlier dimension, use a mesh
axis at most once per leaf, and drop an assignment unless its size divides
the dimension. A spec is a tuple with one entry per dimension, as a JAX
``PartitionSpec`` has: None, a mesh axis name, or a tuple of names (major
to minor). The mesh is a ``{axis: size}`` mapping.

``worker_slices`` gives the block of a leaf that the worker at given mesh
coordinates holds under a spec, ``place_slices`` puts the blocks of the
workers back in rank order (the last axis minor, as ``jax.make_mesh``
orders devices). ``ModelAxis`` is one worker's place on the model axis of
the compressed step (``train.step.make_compressed_train_step``): each
leaf's spec under the rules with the manual axes stripped, its shard of a
leaf, the all-gather that puts the shards back and the sums over the model
workers.

The JAX module's ``tree_shardings``, ``activation_sharding`` and
``logical_constraint`` have no counterpart: they are GSPMD layout hints
(``NamedSharding`` and ``with_sharding_constraint``), and nothing here
places a tensor by a compiler. For every arch the split step
(``dist.tensor_parallel``) places the collectives GSPMD would insert by
hand: a worker holds its shards, runs the forward and backward on them,
and ``ModelAxis.grads`` records how its backward leaves each leaf's
gradient (``SPLIT``: its shard; ``SAME``: a whole leaf's gradient, equal
on every model worker; ``PARTIAL``: a whole leaf's gradient of this
worker's share of the compute, summed over the model workers before the
sync). The gathered step (a whole model: each data worker's gradient
computed whole on the gathered parameters, then its shard kept) is the
tests' yardstick for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.comm.sync import _all_gather


def _as_tuple(v) -> tuple[str, ...]:
    """Normalize a rules entry: None -> (), "model" -> ("model",)."""
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(a for a in v if a is not None)


# Compressed data-parallel mode (Algorithm 1): parameters replicated over the
# data axis; tensor-parallel dims go to "model".
DP_RULES: dict[str, Any] = {
    # activations
    "batch": ("data",),
    "seq": None,
    # dense transformer params
    "embed": None,
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    # MoE
    "experts": ("data",),
    "expert_mlp": ("model",),
    # MLA / low-rank adapters (deepseek, rwkv time-mix)
    "mla": None,
    "mla_dense": ("model",),
    "kv_lora": ("model",),
    "qk_rope": ("model",),
    "lora_a": None,
    "lora_b": ("model",),
    "w_lora_a": None,
    "w_lora_b": ("model",),
    # SSM / RWKV
    "conv": None,
    "state": None,
    "rwkv": None,
    # scan-over-layers stacks are never sharded along the layer axis
    "layers": None,
}

# The fsdp mode: like DP but parameter "embed" dims shard over the data axis.
FSDP_RULES: dict[str, Any] = dict(DP_RULES, embed=("data",))


def with_pod(rules: dict) -> dict:
    """Extend a rule set onto a ("pod", "data", "model") mesh: every use of
    the "data" axis is widened to span pods as well."""
    out = {}
    for k, v in rules.items():
        axes = _as_tuple(v)
        if "data" in axes:
            widened = []
            for a in axes:
                if a == "data":
                    widened += ["pod", "data"]
                else:
                    widened.append(a)
            out[k] = tuple(widened)
        else:
            out[k] = v
    return out


def strip_manual(rules: dict, manual: tuple[str, ...]) -> dict:
    """The rules inside the step's manual region, where the ``manual``
    axes ("data", with pods "pod" too) are already split by worker: drop
    them from every entry."""
    out = {}
    for k, v in rules.items():
        kept = tuple(a for a in _as_tuple(v) if a not in manual)
        out[k] = kept if kept else None
    return out


def launcher_rules(mode: str, overrides: dict, multi_pod: bool) -> dict:
    """The JAX launcher's rule set: ``DP_RULES`` in the compressed mode,
    ``FSDP_RULES`` in fsdp, then the arch's ``rules_overrides``, then
    ``with_pod`` under a pod axis."""
    rules = dict(DP_RULES if mode == "compressed" else FSDP_RULES)
    rules.update(overrides)
    return with_pod(rules) if multi_pod else rules


def resolve_spec(shape, axes, rules: dict, sizes: dict[str, int]) -> tuple:
    """(dim sizes, logical axes) -> spec under ``rules`` on a mesh of
    ``sizes``.

    Per dimension: look the logical axis up in the rules, keep only mesh
    axes that exist and are not already used by an earlier dimension, and
    drop the whole assignment unless the dimension size divides evenly.
    """
    used: set[str] = set()
    entries: list[Any] = []
    axes = tuple(axes) if axes is not None else ()
    for i, dim in enumerate(tuple(shape)):
        logical = axes[i] if i < len(axes) else None
        names = [a for a in _as_tuple(rules.get(logical) if logical else None)
                 if a in sizes and a not in used]
        prod = math.prod(sizes[a] for a in names)
        if not names or prod <= 1 or dim % prod != 0:
            entries.append(None)
            continue
        used.update(names)
        entries.append(names[0] if len(names) == 1 else tuple(names))
    return tuple(entries)


def mesh_coords(index: int, axes: tuple[str, ...],
                sizes: dict[str, int]) -> dict[str, int]:
    """The coordinates over ``axes`` of the ``index``-th worker in rank
    order (the last axis minor)."""
    out = {}
    for a in reversed(axes):
        index, out[a] = divmod(index, sizes[a])
    return out


def worker_slices(shape, spec: tuple, sizes: dict[str, int],
                  coords: dict[str, int]) -> tuple[slice, ...]:
    """The block of a leaf of ``shape`` that the worker at ``coords``
    holds under ``spec``: along a dimension split over axes (a, b), block
    ``coords[a] * sizes[b] + coords[b]`` of ``sizes[a] * sizes[b]``."""
    out = []
    for i, dim in enumerate(tuple(shape)):
        entry = spec[i] if i < len(spec) else None
        block, n = 0, 1
        for a in _as_tuple(entry):
            block = block * sizes[a] + coords[a]
            n *= sizes[a]
        width = dim // n
        out.append(slice(block * width, (block + 1) * width))
    return tuple(out)


def place_slices(parts: list, spec: tuple, sizes: dict[str, int],
                 axes: tuple[str, ...], out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The leaf from its workers' blocks: ``parts[k]`` is the block of the
    ``k``-th worker over ``axes`` in rank order (``mesh_coords``); the
    spec may use only those axes. Written into ``out`` when given."""
    shape = list(parts[0].shape)
    for i, entry in enumerate(spec):
        shape[i] *= math.prod(sizes[a] for a in _as_tuple(entry))
    if out is None:
        out = parts[0].new_empty(shape)
    for k, part in enumerate(parts):
        out[worker_slices(shape, spec, sizes,
                          mesh_coords(k, axes, sizes))] = part
    return out


def is_split(spec: tuple) -> bool:
    return any(e is not None for e in spec)


# how the split step's backward leaves a leaf's gradient (``ModelAxis.grads``)
SPLIT, SAME, PARTIAL = "split", "same", "partial"


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """One worker's place on the model axis of the compressed step.

    ``specs`` holds each leaf's spec (leaf order) under the launcher's
    rules with the manual axes stripped (``strip_manual``), so an entry
    names "model" or nothing. ``group`` is the process group of this
    worker's model workers (the same pod and data index, in rank order;
    None only where no collective is issued: ``size`` 1, or one process
    driving every shard itself), ``ranks`` their global ranks. At ``size``
    1 every leaf is whole and nothing is gathered, broadcast or reduced
    (``WHOLE``: the step of one model worker). ``grads`` holds, for the
    split step, each leaf's gradient kind (``SPLIT``, ``SAME`` or
    ``PARTIAL``; ``dist.tensor_parallel.plan_split`` fills it); empty for
    the gathered step."""
    size: int
    index: int
    specs: tuple
    group: Any = None
    ranks: tuple = ()
    grads: tuple = ()

    @property
    def sizes(self) -> dict[str, int]:
        return {"model": self.size}

    @property
    def reduction(self):
        """``stack`` past one model worker, None at one (nothing to
        reduce): ``train.step.shard_sync``'s ``model_stack``."""
        return self.stack if self.size > 1 else None

    def split(self, i: int) -> bool:
        """Whether leaf ``i`` is split over the model workers."""
        return self.size > 1 and is_split(self.specs[i])

    def shard(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This worker's block of leaf ``i``: a view of ``t``, ``t`` itself
        where the leaf is whole."""
        if not self.split(i):
            return t
        return t[worker_slices(t.shape, self.specs[i], self.sizes,
                               {"model": self.index})]

    def gather(self, full: torch.Tensor, i: int) -> None:
        """Every model worker's block of leaf ``i`` into ``full``, whose own
        block holds this worker's: an all-gather in rank order (as bytes:
        gloo takes no bfloat16)."""
        if not self.split(i):
            return
        parts = self.stack(self.shard(full, i))
        place_slices(list(parts), self.specs[i], self.sizes, ("model",),
                     out=full)

    def broadcast(self, t: torch.Tensor) -> None:
        """``t`` from the model worker of index 0, in place (as bytes)."""
        if self.size == 1:
            return
        buf = t.contiguous()
        dist.broadcast(buf.view(-1).view(torch.uint8), src=self.ranks[0],
                       group=self.group)
        if buf is not t:
            t.copy_(buf)

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every model worker's ``x``, in rank
        order (an all-gather over the model group)."""
        return _all_gather(x, self.group)

    def partial(self, i: int) -> bool:
        """Whether the split step's gradient of leaf ``i`` is this worker's
        share only (a whole leaf read by split compute)."""
        return bool(self.grads) and self.grads[i] == PARTIAL

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model workers, in place (an all-reduce;
        nothing at one worker). Returns ``t``."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the model workers, in
        place. Returns ``t``."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def sum_in_rank_order(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of model index 0 + 1 + ..., added in rank order, on every
        model worker (an all-gather, then the sum: the same bits
        everywhere, whatever the collective's own order)."""
        if self.size == 1:
            return t
        return sum_in_order(self.stack(t))


# one model worker: every leaf whole (the step without a model axis)
WHOLE = ModelAxis(size=1, index=0, specs=())


def sum_in_order(rows: torch.Tensor) -> torch.Tensor:
    """The sum of ``rows[0] + rows[1] + ...``, added in rank order."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc += r
    return acc



@dataclasses.dataclass(frozen=True)
class DataAxis:
    """One worker's place on the data side of the fsdp mode's mesh: the
    axes ``names`` (``("data",)``, or ``("pod", "data")`` under pods, pods
    major), their ``size`` (their product) and this worker's ``index``
    among them, and ``group``, the process group of the workers of its
    model index across them, in rank order (``dist.group.WORLD`` where that
    is every worker)."""
    names: tuple
    size: int
    index: int
    group: Any = None

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every data worker's ``x``, in rank
        order."""
        return _all_gather(x, self.group)


@dataclasses.dataclass(frozen=True)
class LeafGroups:
    """The axes over which one leaf's shards lie in the fsdp mode:
    ``model`` (the ``ModelAxis``) where the leaf's spec uses the model
    axis, ``data`` (the ``DataAxis``) where it uses the data axis (with
    pods: pod and data), None where it does not. A row of the leaf (a
    layer of a stacked leaf, or the whole leaf) is split the same way, so
    a per-row statistic of a shard is summed over exactly these."""
    model: Any = None
    data: Any = None


def data_only(spec: tuple) -> tuple:
    """``spec`` with every axis but "pod" and "data" dropped."""
    out = []
    for e in spec:
        kept = tuple(a for a in _as_tuple(e) if a in ("pod", "data"))
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


def model_only(spec: tuple) -> tuple:
    """``spec`` with "pod" and "data" dropped (``strip_manual``'s rule)."""
    out = []
    for e in spec:
        kept = tuple(a for a in _as_tuple(e) if a not in ("pod", "data"))
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FsdpLayout:
    """One worker's shards in the fsdp mode under ``FSDP_RULES``
    (``launcher_rules("fsdp", ...)``): ``specs`` each leaf's spec over the
    mesh axes ``sizes`` (data, model, and pod under pods), ``coords`` this
    worker's coordinates, ``shapes`` the whole leaves' shapes (leaf
    order), ``model`` its ``ModelAxis`` (the specs with data and pod
    dropped: the block the split compute takes) and ``data`` its
    ``DataAxis``. The worker holds ``shard(leaf, i)`` of every leaf; a
    leaf's data blocks are put together over ``data`` just before use
    (``gather_data``, ``dist.fsdp``), and its gradient is scattered back
    averaged (``scatter_mean``). It answers ``split``, ``shard`` and
    ``gather`` as ``ModelAxis`` does, for the checkpoint."""
    specs: tuple
    sizes: dict
    coords: dict
    shapes: tuple
    names: tuple
    model: ModelAxis
    data: DataAxis

    params_sharded = True      # the checkpoint gathers the parameters too

    def uses_data(self, i: int) -> bool:
        return is_split(data_only(self.specs[i]))

    def uses_model(self, i: int) -> bool:
        return self.model.split(i)

    def groups(self, i: int) -> LeafGroups:
        """The axes leaf ``i``'s rows lie over."""
        return LeafGroups(model=self.model if self.uses_model(i) else None,
                          data=self.data if self.uses_data(i) else None)

    def split(self, i: int) -> bool:
        return is_split(self.specs[i])

    def block(self, i: int) -> tuple[slice, ...]:
        """This worker's slices of leaf ``i``."""
        return worker_slices(self.shapes[i], self.specs[i], self.sizes,
                             self.coords)

    def shard(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This worker's block of the whole leaf ``t`` (a view)."""
        return t[worker_slices(t.shape, self.specs[i], self.sizes,
                               self.coords)]

    def keep(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``init_model``'s ``keep``: this worker's block of the whole leaf
        ``name``, copied so that the whole one can be freed."""
        i = self.names.index(name)
        return self.shard(t, i).clone() if self.split(i) else t

    def gather_data(self, shard: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The data workers' blocks of a piece split under ``spec`` (a
        leaf's, or one layer's), put together in rank order: the block of
        the model axis alone (``shard`` itself where ``spec`` uses no data
        axis)."""
        dspec = data_only(spec)
        if not is_split(dspec):
            return shard
        parts = self.data.stack(shard.contiguous())
        return place_slices(list(parts), dspec, self.sizes, self.data.names)

    def scatter_mean(self, g: torch.Tensor, spec: tuple,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
        """The reduce-scatter half of the dense exchange's mean
        (``comm.sync._worker_order_mean``) of ``g``, a gradient shaped like
        ``gather_data``'s result: block k of every data worker's ``g`` goes
        to data worker k (one all-to-all, as bytes), which adds its copies
        in worker order in float32 (or g's wider dtype), rounds the sum once
        to ``dtype`` (g's by default) and divides it by the data workers
        (an IEEE quotient): this worker's block of the mean."""
        from repro_torch.comm.sync import _div_workers
        dspec = data_only(spec)
        n = self.data.size
        send = torch.stack([g[worker_slices(
            g.shape, dspec, self.sizes,
            mesh_coords(k, self.data.names, self.sizes))] for k in range(n)])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv.view(n, -1).view(torch.uint8),
                               send.view(n, -1).view(torch.uint8),
                               group=self.data.group)
        del send
        acc = sum_in_order(recv.to(torch.promote_types(g.dtype,
                                                       torch.float32)))
        del recv
        return _div_workers(acc.to(dtype or g.dtype), n)

    def gather(self, full: torch.Tensor, i: int) -> None:
        """Every worker's block of leaf ``i`` into ``full``, whose own block
        holds this worker's: over the data workers, then over the model
        workers (all-gathers in rank order)."""
        if not self.split(i):
            return
        mine = self.gather_data(self.shard(full, i), self.specs[i])
        self.model.shard(full, i).copy_(mine)
        self.model.gather(full, i)

    def reduce_rows(self, leaf_of_row: list, sums: torch.Tensor,
                    maxes: torch.Tensor | None = None) -> None:
        """Per-row statistics of shards, whole, in place: ``sums [R, a]``
        and ``maxes [R, b]`` (float64) hold a row a row, row r of leaf
        ``leaf_of_row[r]``; each row's sums are added over the model
        workers, then over the data workers, each in rank order (one
        all-gather an axis, then the sum: the same bits on every rank), and
        its maxes are taken over them, where the leaf's spec uses that
        axis."""
        groups = {i: self.groups(i) for i in set(leaf_of_row)}
        for ax in ("model", "data"):
            sel = [r for r, i in enumerate(leaf_of_row)
                   if getattr(groups[i], ax) is not None]
            if not sel:
                continue
            ax = getattr(self, ax)
            idx = torch.tensor(sel, device=sums.device)
            a = sums.shape[1]
            pack = sums[idx] if maxes is None else torch.cat(
                [sums[idx], maxes[idx]], 1)
            st = ax.stack(pack)
            sums[idx] = sum_in_order(st[..., :a])
            if maxes is not None:
                maxes[idx] = st[..., a:].amax(0)


def fsdp_layout(shapes: list, axes: list, names: list, overrides: dict,
                mesh, coords: dict, data: DataAxis,
                model: ModelAxis) -> FsdpLayout:
    """The ``FsdpLayout`` of the leaves ``names`` (whole ``shapes``,
    logical ``axes``) on ``mesh`` (``(pods, data, model)``, pods None for
    none) for the worker at ``coords``: the JAX launcher's fsdp rules
    (``launcher_rules("fsdp", overrides, pods)``) resolved on the mesh's
    sizes. ``model``'s specs are replaced by the model-only ones."""
    pods, d, m = mesh
    sizes = {"data": d, "model": m}
    if pods is not None:
        sizes["pod"] = pods
    rules = launcher_rules("fsdp", overrides, pods is not None)
    specs = tuple(resolve_spec(s, a, rules, sizes)
                  for s, a in zip(shapes, axes))
    model = dataclasses.replace(model, specs=tuple(model_only(s)
                                                   for s in specs))
    return FsdpLayout(specs=specs, sizes=sizes, coords=coords,
                      shapes=tuple(tuple(s) for s in shapes),
                      names=tuple(names), model=model, data=data)
