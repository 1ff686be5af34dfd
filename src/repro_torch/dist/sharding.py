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

