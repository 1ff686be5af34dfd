"""Shape-bucketed compression plan (port of ``repro.core.grouping``).

Leaves smaller than ``cfg.min_leaf_size`` form one dense passthrough group;
every other leaf is keyed by ``(dtype, row length d, k_cap)``, where a
layer-stacked leaf of shape ``(L, ...)`` contributes L rows of length
``size // L`` and a flat leaf one row. Leaves sharing a key stack into one
``[rows, d]`` batch that the kernels take in one launch each. Group order is
first-member leaf order, which fixes the wire's bucket traversal and so the
wire bytes and the worker-major reduction order.

The plan is shape metadata only and is cached on the frozen config plus the
leaf specs.
"""
from __future__ import annotations

import dataclasses
import functools
import math


@dataclasses.dataclass(frozen=True)
class Group:
    """One shape bucket: ``kind`` "sparse" (rows of one ``[rows, d]``
    batch) or "dense" (the concatenated tiny-leaf passthrough).
    ``members`` maps it back to leaves: ``(leaf_index, rows)`` for sparse
    groups, ``(leaf_index, size)`` for the dense one. ``row_chunks`` is the
    rows per wire chunk if this group alone filled a bucket."""
    kind: str
    dtype: str
    d: int
    k_cap: int
    members: tuple[tuple[int, int], ...]
    row_chunks: tuple[int, ...] = ()

    @property
    def rows(self) -> int:
        return sum(r for _, r in self.members)


@dataclasses.dataclass(frozen=True)
class TreePlan:
    n_leaves: int
    groups: tuple[Group, ...]

    @property
    def chunk_count(self) -> int:
        return sum(len(g.row_chunks) for g in self.groups
                   if g.kind == "sparse")


def chunk_spans(entries, cap: int) -> list[tuple[tuple[int, int, int], ...]]:
    """Greedy row-granular chunking of one wire bucket: ``entries`` are
    ``(entry_id, rows, d)``; returns chunks of ``(entry_id, r0, n)`` row
    spans with ``sum(n * d) <= cap``, each one collective with its own int32
    coordinate space."""
    chunks: list = []
    cur: list = []
    cur_coords = 0
    for eid, rows, d in entries:
        if d > cap:
            raise ValueError(
                f"one row of entry {eid!r} spans {d} coordinates, more than "
                f"bucket_coord_cap={cap}: a single row cannot be split "
                "across wire chunks")
        r0 = 0
        while rows:
            room = (cap - cur_coords) // d
            if room == 0:
                chunks.append(tuple(cur))
                cur, cur_coords = [], 0
                room = cap // d
            n = min(rows, room)
            cur.append((eid, r0, n))
            cur_coords += n * d
            r0 += n
            rows -= n
    if cur:
        chunks.append(tuple(cur))
    return chunks


def leaf_rows(shape: tuple[int, ...], stacked: bool) -> tuple[int, int]:
    """(rows, d) of one leaf: a layer-stacked leaf with a real leading axis
    compresses per layer (paper section 5.2), anything else as one row."""
    size = math.prod(shape)
    if stacked and len(shape) >= 2 and shape[0] > 1:
        return shape[0], size // shape[0]
    return 1, size


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def plan_tree(cfg, leaves, stk_leaves) -> TreePlan:
    """Grouping plan for the ordered ``leaves`` (tensors or anything with
    ``.shape`` and ``.dtype``) and their per-leaf stacked flags."""
    specs = tuple((tuple(leaf.shape), _dtype_name(leaf.dtype), bool(stk))
                  for leaf, stk in zip(leaves, stk_leaves))
    return _plan_cached(cfg, specs)


@functools.lru_cache(maxsize=None)
def _plan_cached(cfg, specs) -> TreePlan:
    sparse: dict[tuple, list[tuple[int, int]]] = {}
    dense: list[tuple[int, int]] = []
    for i, (shape, dtype, stk) in enumerate(specs):
        size = math.prod(shape)
        if size < cfg.min_leaf_size:
            dense.append((i, size))
            continue
        rows, d = leaf_rows(shape, stk)
        sparse.setdefault((dtype, d, cfg.capacity(d)), []).append((i, rows))
    cap = cfg.bucket_coord_cap
    groups = [Group("sparse", dtype, d, k_cap, tuple(members),
                    row_chunks=tuple(
                        sum(n for _, _, n in chunk)
                        for chunk in chunk_spans(
                            [(0, sum(r for _, r in members), d)], cap)))
              for (dtype, d, k_cap), members in sparse.items()]
    if dense:
        groups.append(Group("dense", "float32", sum(n for _, n in dense), 0,
                            tuple(dense)))
    groups.sort(key=lambda g: g.members[0][0])
    return TreePlan(n_leaves=len(specs), groups=tuple(groups))
