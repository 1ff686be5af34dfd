"""Gradient compression over a model's ordered leaves (port of
``repro.core.api``: ``CompressionConfig``, ``TreeStats``, ``compress_leaf``,
``compress_tree`` for the dense wire, ``compress_tree_sparse`` for the
sparse wires, gather and packed, and ``zeros_like_residual``).

The paper sparsifies each layer independently (section 5.2): a leaf is one
parameter tensor, and a layer-stacked leaf ``[L, ...]`` is L rows. The
leaves come as a list in the JAX package's flatten order (sorted parameter
paths), so groups, member order and chunk offsets match its ``plan_tree``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core import coding
from repro_torch.core import schemes as schemes_lib
from repro_torch.core.grouping import plan_tree
from repro_torch.core._compressors import CompressedGrad
from repro_torch.core.sparse import (KernelBackend, resolve_backend,
                                     residual_from_buffers)

F32 = torch.float32


BACKENDS = ("auto", "reference", "pallas")
# the JAX package's XLA comm presets (repro.comm.xla_flags.PRESETS)
XLA_PRESETS = ("async", "latency_hiding", "none", "overlap")
# the JAX config's fields the port takes only at their defaults, and the
# ROADMAP.md item that ports each
UNPORTED_FIELDS = {"xla_preset": "queue A item 13"}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static configuration of the compression stage.

    ``name`` is a selector ∘ codec composition: a bare selector
    (``"gspar"``, ``"agspar"``, ``"unisp"``, ``"topk"``, ``"bernoulli"``,
    ``"identity"``) takes the f32 codec, ``"selector+codec"`` names both
    (``"gspar+qsgd8"``, ``"topk+ternary"``), and the aliases are
    ``"terngrad"`` (``bernoulli+ternary``), ``"qsgd"``
    (``identity+qsgd<qsgd_bits>``) and ``"none"`` (``identity+f32``). The
    port runs every composition on the dense wire (``wire="dense"``, the
    default, as in the JAX package: Q(g) in dense layout, pmean over the
    workers), gspar with ``algo="greedy"`` or ``"closed"``, each with the
    ``f32``, ``bf16``, ``qsgd<N>`` and ``ternary`` codecs; and every
    composition on the sparse wires: ``gather``, and ``packed``, which is
    gather with the codec raised to bf16 where the name gives none, with
    every wire layout (``auto``, ``coo``, ``bitmap``, ``dense``, ``rice``;
    with ``rice_fitted`` the data-fitted Golomb-Rice parameter of
    wire-format v4), with the sync or the overlapped exchange
    (``exchange="overlap"``, buckets of ``overlap_bucket_bytes``). Every
    wire runs with or without error feedback, with the pod hierarchy of
    ``comm.sync.sync_tree`` (``resparsify_pods``: Algorithm 1's step 7) and
    with the adaptive control loop (``adaptive``, which needs error
    feedback: delta coding against the last-sent state with
    ``delta_beta``, skipping with ``skip_tau`` and the EMA bound's
    ``bound_decay``; ``sync_tree``'s ``control``). Invalid values raise
    ValueError.

    The fields, their order and their defaults are the JAX package's, so
    ``CompressionConfig(**kwargs)`` takes any JAX config's keyword
    arguments. ``backend`` ``"auto"`` and ``"pallas"`` both select the
    port's CUDA kernel backend (the counterpart of the Pallas one, which
    hands agspar and identity on the sparse wires to the reference
    backend), ``"reference"`` the reference backend (``core.sparse``).
    ``kernel_interpret`` takes None and False (the kernels on a CUDA
    tensor, their plain versions on a CPU one) and refuses True: the port
    has no route from the card to the plain versions (ROADMAP.md queue A
    item 4). ``xla_preset`` (ROADMAP.md queue A item 13) is refused at any
    value but its default.
    """
    name: str = "gspar"              # selector[+codec] composition
    rho: float = 0.1                 # target density (gspar, unisp, topk)
    eps: float = 1.0                 # variance budget (gspar closed)
    algo: str = "greedy"             # gspar solver: greedy | closed
    num_iters: int = 2               # greedy rescale iterations (paper: 2)
    qsgd_bits: int = 4               # the legacy "qsgd" alias's levels
    float_bits: int = 32             # b in the coding model
    codec: str | None = None         # value codec; None -> from name, else f32
    error_feedback: bool = False     # carry the compression residual
    min_leaf_size: int = 256         # leaves smaller than this travel dense
    backend: str = "auto"            # auto | pallas: the CUDA kernels;
                                     # reference: dense apply + compact
    kernel_interpret: bool | None = None   # True is refused
    wire: str = "dense"              # dense | gather | packed
    wire_layout: str = "auto"        # auto (argmin bytes) / coo / bitmap /
                                     # dense / rice
    capacity_slack: float = 1.25     # k_cap slack over rho * d
    resparsify_pods: bool = False    # pod stage re-sparsifies (step 7)
    exchange: str = "sync"           # sync | overlap
    overlap_bucket_bytes: int = 1 << 20  # overlap's bucket cap
    bucket_coord_cap: int = 2**31 - 1   # coords per sparse wire chunk
    xla_preset: str = "none"         # XLA comm preset (item 13)
    adaptive: bool = False           # adaptive control loop (needs EF):
    delta_beta: float = 1.0          # last-sent EMA weight,
    skip_tau: float = 0.0            # skip threshold (0: never skip),
    bound_decay: float = 0.9         # energy-bound decay
    rice_fitted: bool = False        # data-fitted Rice parameter (v4)
    density_gain: float = 1.0        # agspar's density fit:
    density_floor: float = 0.1       # gain and floor

    def __post_init__(self):
        self._validate()
        self._refuse_unported()
        if self.wire not in ("dense", "gather", "packed"):
            raise ValueError(f"unknown wire format {self.wire!r}")
        if self.exchange not in ("sync", "overlap"):
            raise ValueError(f"unknown exchange mode {self.exchange!r}")
        if self.wire_layout not in ("auto", "coo", "bitmap", "dense",
                                    "rice"):
            raise ValueError(f"unknown wire layout {self.wire_layout!r}")
        if not 1 <= self.bucket_coord_cap <= 2**31 - 1:
            raise ValueError(f"bucket_coord_cap={self.bucket_coord_cap} is "
                             "outside the int32 coordinate space")
        if not 0.0 < self.rho <= 1.0:
            raise ValueError(f"rho={self.rho} outside (0, 1]")
        scheme = self.scheme()       # raises on unknown names
        if self.error_feedback and scheme.selector.name == "identity" \
                and not (scheme.codec.rounds_values
                         or scheme.codec.integer_coded):
            raise ValueError(
                f"unsupported (scheme, error_feedback) pair ({self.name!r}, "
                "True): identity selection with a lossless codec has zero "
                "residual; error feedback would be a silent no-op")

    def _validate(self) -> None:
        """The JAX config's ValueErrors for the fields the port refuses."""
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; have "
                             f"{BACKENDS}")
        if self.overlap_bucket_bytes < 4:
            raise ValueError(f"overlap_bucket_bytes="
                             f"{self.overlap_bucket_bytes} is below one "
                             "int32 word")
        if self.xla_preset not in XLA_PRESETS:
            raise ValueError(f"unknown xla_preset {self.xla_preset!r}; "
                             f"have {XLA_PRESETS}")
        if not 0.0 <= self.delta_beta <= 1.0:
            raise ValueError(f"delta_beta={self.delta_beta} outside [0, 1]")
        if self.skip_tau < 0.0:
            raise ValueError(f"skip_tau={self.skip_tau} is negative")
        if not 0.0 <= self.bound_decay < 1.0:
            raise ValueError(f"bound_decay={self.bound_decay} outside "
                             "[0, 1)")
        if not 0.0 < self.density_gain <= 1.0:
            raise ValueError(f"density_gain={self.density_gain} outside "
                             "(0, 1]")
        if not 0.0 <= self.density_floor <= 1.0:
            raise ValueError(f"density_floor={self.density_floor} outside "
                             "[0, 1]")
        if self.adaptive and not self.error_feedback:
            raise ValueError("adaptive=True requires error_feedback=True")
        if self.adaptive and self.resparsify_pods:
            raise ValueError("adaptive=True with resparsify_pods=True is "
                             "not supported")

    def _refuse_unported(self) -> None:
        """NotImplementedError, naming the ROADMAP.md item, for a valid
        value of a field the port does not run yet, or by design does not
        run (``kernel_interpret=True``)."""
        if self.kernel_interpret is True:
            raise NotImplementedError(
                "kernel_interpret=True is refused: the port runs a kernel's "
                "plain version only on a CPU tensor, never on the card "
                "(ROADMAP.md queue A item 4)")
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.name in UNPORTED_FIELDS and value != f.default:
                raise _not_ported(f"{f.name}={value!r}",
                                  UNPORTED_FIELDS[f.name])

    def scheme(self) -> schemes_lib.Scheme:
        return _resolve_scheme(self)

    def capacity(self, d: int) -> int:
        """Static sparse-wire capacity for a row of length d."""
        return self.scheme().selector.capacity(d, self.capacity_slack)

    def describe(self) -> str:
        parts = [self.scheme().name, f"rho={self.rho:g}",
                 f"wire={self.wire}"]
        if self.algo == "closed":    # Algorithm 2's budget (rho still
            parts.insert(1, f"algo=closed eps={self.eps:g}")  # sizes gather)
        if self.wire != "dense":     # the layout and exchange are sparse's
            parts += [f"layout={self.wire_layout}",
                      f"exchange={self.exchange}"]
        parts.append("backend=reference" if self.backend == "reference"
                     else "backend=kernel")
        if self.error_feedback:
            parts.append("ef")
        if self.adaptive:
            parts.append(f"adaptive(beta={self.delta_beta:g}"
                         f" tau={self.skip_tau:g}"
                         f" decay={self.bound_decay:g})")
        if self.rice_fitted:
            parts.append("rice_fitted")
        if self.resparsify_pods:
            parts.append("resparsify_pods")
        return " ".join(parts)


@functools.lru_cache(maxsize=None)
def _resolve_scheme(cfg: CompressionConfig) -> schemes_lib.Scheme:
    codec = cfg.codec
    if cfg.wire == "packed" and codec is None and "+" not in cfg.name:
        # the packed wire: bf16 values where the name gives no codec
        _, legacy_codec = schemes_lib.parse_composition(
            cfg.name, qsgd_bits=cfg.qsgd_bits)
        if legacy_codec is None:
            codec = "bf16"
    return schemes_lib.make_scheme(
        cfg.name, codec=codec, rho=cfg.rho, eps=cfg.eps, algo=cfg.algo,
        num_iters=cfg.num_iters, qsgd_bits=cfg.qsgd_bits,
        float_bits=cfg.float_bits, density_gain=cfg.density_gain,
        density_floor=cfg.density_floor)


@dataclasses.dataclass(frozen=True)
class TreeStats:
    """Per-step compression accounting over all leaves (float32 scalars)."""
    bits: torch.Tensor           # message bits this worker sends
    dense_bits: torch.Tensor     # what an uncompressed message would cost
    density: torch.Tensor        # realized nnz fraction over all coords
    var_ratio: torch.Tensor      # size-weighted mean ||Q(g)||^2/||g||^2


def compress_leaf(cfg: CompressionConfig, generator: torch.Generator,
                  g: torch.Tensor) -> CompressedGrad:
    """One leaf through the configured scheme on the dense wire's path
    (``Scheme.compress``): q in g's dtype and shape, scalar accounting."""
    return cfg.scheme().compress(generator, g)


def _require_residual(cfg: CompressionConfig, residual, where: str) -> None:
    if cfg.error_feedback and residual is None:
        raise ValueError(
            f"error_feedback=True but no residual reached {where}: the "
            "compression error would be silently dropped. Pass a "
            "FeedbackState (repro_torch.optim.optimizers.init_feedback).")


def _stack_group(grp, leaves: list, residual: list | None, ef: bool
                 ) -> torch.Tensor:
    """One sparse group's ``[rows, d]`` batch: the members' rows in member
    order, with error feedback the target ``leaf + residual`` formed in
    place in the batch; a single member without EF is a view of its
    leaf."""
    first = leaves[grp.members[0][0]]
    if len(grp.members) == 1 and not ef:
        return first.reshape(grp.rows, grp.d)
    stack = torch.empty((grp.rows, grp.d), dtype=first.dtype,
                        device=first.device)
    r0 = 0
    for i, rows in grp.members:
        dst = stack[r0:r0 + rows]
        src = leaves[i].reshape(rows, grp.d)
        if ef:
            torch.add(src, residual[i].reshape(rows, grp.d), out=dst)
        else:
            dst.copy_(src)
        r0 += rows
    return stack


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """A group's per-row float32 statistic summed in float64, rounded once:
    the same float32 on the card and on the CPU, whose reductions add in
    different orders (the rows' float32 values span far fewer than the 29
    spare bits of a float64 sum, which is then exact)."""
    return x.to(torch.float64).sum().to(F32)


def _fold(xs: list) -> torch.Tensor:
    """The groups' 0-d float32 values summed left to right, as the JAX
    package's ``sum(list)`` adds them, on any device."""
    return functools.reduce(torch.add, xs)


def _tree_stats(cfg, leaves, bits, nnz, wvar, tot: float | None = None
                ) -> TreeStats:
    """The tree's TreeStats from the groups' sums, over ``tot``
    coordinates (default: the leaves')."""
    if tot is None:
        tot = float(sum(leaf.numel() for leaf in leaves))
    dev = leaves[0].device
    # a float32 divisor on the device: PyTorch's CUDA division by a Python
    # number multiplies by its rounded reciprocal, not an IEEE quotient
    tot_t = torch.tensor(tot, dtype=F32, device=dev)
    return TreeStats(
        bits=_fold(bits),
        dense_bits=torch.tensor(tot * cfg.float_bits, dtype=F32, device=dev),
        density=_fold(nnz) / tot_t,
        var_ratio=_fold(wvar) / tot_t)


def compress_tree(cfg: CompressionConfig, generator: torch.Generator,
                  leaves: list, stacked: list | None = None,
                  residual: list | None = None):
    """The dense wire: compress the ordered ``leaves`` into Q(g) in dense
    layout, one kernel launch per shape group and kernel, each stacked leaf
    per layer (``stacked``).

    Each sparse group is stacked into one ``[rows, d]`` batch (with error
    feedback: the target ``leaf + residual``, formed in place in the
    batch) and takes its uniforms from ``generator``, in group order: the
    selector's as one ``[rows, d]`` float32 draw (none for topk and
    identity), the draw of ``compress_tree_sparse``, so one generator seed
    gives both wires the same kept coordinates; then a stochastic codec's
    (qsgd, ternary) as a second ``[rows, d]`` draw, one per coordinate as
    ``Scheme.apply_dense`` draws them (the gather wire draws ``[rows,
    k_cap]`` at compact rank). Each group's uniforms are freed before the
    next draw. Tiny leaves (< ``cfg.min_leaf_size``) pass through in their
    own dtype, with the identity's dense bits and a residual of exactly
    zero.

    The Q leaves of one dtype are views of one flat buffer, in group order,
    so that the exchange reduces each dtype in place
    (``comm.sync._sync_leaves_dense``); a codec that rounds (bf16) is
    decoded to the leaf's dtype there, and an integer codec's levels in the
    kernel, as the JAX package decodes before its pmean. With an integer
    codec the residual is ``target - decoded Q``, each difference rounded
    once to the leaf dtype, as the JAX package's identity-indexed scatter
    forms it.

    Returns ``(q, new_residual, stats)``: lists like ``leaves`` (the
    residual None without error feedback) and TreeStats.
    """
    _require_residual(cfg, residual, "compress_tree")
    backend = KernelBackend()
    scheme = cfg.scheme()
    codec = scheme.codec
    ef = cfg.error_feedback
    stk = stacked if stacked is not None else [False] * len(leaves)
    plan = plan_tree(cfg, leaves, stk)
    dev = leaves[0].device
    buckets = {dt: torch.empty(sum(leaf.numel() for leaf in leaves
                                   if leaf.dtype == dt), dtype=dt,
                               device=dev)
               for dt in {leaf.dtype for leaf in leaves}}
    used = dict.fromkeys(buckets, 0)

    def take(dtype, n: int) -> torch.Tensor:
        a = used[dtype]
        used[dtype] += n
        return buckets[dtype][a:a + n]

    q: list = [None] * len(leaves)
    new_res: list = [None] * len(leaves)
    bits, nnz, wvar = [], [], []
    for grp in plan.groups:
        if grp.kind == "dense":
            for i, n in grp.members:
                leaf = leaves[i]
                q[i] = take(leaf.dtype, n).view(leaf.shape)
                if ef:
                    torch.add(leaf, residual[i], out=q[i])
                    new_res[i] = torch.zeros_like(leaf)
                else:
                    q[i].copy_(leaf)
                t32 = q[i].reshape(-1).to(F32)
                bits.append(torch.tensor(
                    coding.dense_coding_bits(n, cfg.float_bits), dtype=F32,
                    device=dev))
                nnz.append(torch.count_nonzero(t32).to(F32))
                wvar.append(((t32 * t32).sum() > 0).to(F32) * float(n))
            continue

        stack = _stack_group(grp, leaves, residual, ef)
        u = u_cod = None
        if scheme.selector.samples:
            u = torch.rand((grp.rows, grp.d), generator=generator,
                           dtype=F32, device=stack.device)
        if codec.stochastic:
            u_cod = torch.rand((grp.rows, grp.d), generator=generator,
                               dtype=F32, device=stack.device)
        qg = take(stack.dtype, grp.rows * grp.d).view(grp.rows, grp.d)
        direct = codec.integer_coded \
            or codec.wire_dtype(stack.dtype) == stack.dtype
        cg, res_rows = backend.compress_dense(cfg, u, stack, ef,
                                              out=qg if direct else None,
                                              u_cod=u_cod)
        del u, u_cod, stack
        if not direct:
            qg.copy_(cg.q)
        r0 = 0
        for i, rows in grp.members:
            q[i] = qg[r0:r0 + rows].view(leaves[i].shape)
            if ef:
                new_res[i] = res_rows[r0:r0 + rows].view(leaves[i].shape)
            r0 += rows
        bits.append(_row_sum(cg.bits))
        nnz.append(cg.nnz.sum().to(F32))
        wvar.append(_row_sum(cg.var_ratio) * float(grp.d))
        del cg, res_rows
    return q, (new_res if ef else None), _tree_stats(cfg, leaves, bits, nnz,
                                                     wvar)


# a block of rows' float32 uniforms in ``compress_tree_sharded`` takes at
# most this many bytes (one row at least)
UNIFORM_BYTES = 1 << 30


class _RowShards:
    """The rows of one sharded group, row r a shard of leaf
    ``leaf_of_row[r]``'s row of length ``d``: ``ops.gspar_dense_lambda``'s
    ``shards``, each statistic taken whole over the row's shards
    (``FsdpLayout.reduce_rows``, in float64, rounded once)."""

    def __init__(self, layout, leaf_of_row: list, d: int):
        self.layout, self.rows, self.d = layout, leaf_of_row, d

    def stats(self, l1, l2, mx):
        sums = torch.stack([l1, l2], 1).to(torch.float64)
        maxes = mx[:, None].to(torch.float64)
        self.layout.reduce_rows(self.rows, sums, maxes)
        return sums[:, 0].to(F32), sums[:, 1].to(F32), maxes[:, 0].to(F32)

    def tail(self, count, l1):
        sums = torch.stack([count.to(torch.float64), l1.to(torch.float64)],
                           1)
        self.layout.reduce_rows(self.rows, sums)
        return sums[:, 0].to(count.dtype), sums[:, 1].to(F32)


def compress_tree_sharded(cfg: CompressionConfig, leaves: list, layout,
                          stacked: list | None = None,
                          residual: list | None = None, uniforms=None):
    """``compress_tree`` of a tree whose leaves lie in shards over workers
    (the fsdp mode: ``leaves`` this worker's blocks under ``layout``, a
    ``dist.sharding.FsdpLayout``), Q applied once to the whole tree: gspar
    (Algorithm 3) with a float codec (f32, bf16), with or without error
    feedback.

    A row is a layer of a stacked leaf, or a whole leaf, as in
    ``compress_tree``; its lambda is the whole row's. Each shard group
    (the shards of one dtype, shard row length and whole row length,
    in first-member order, one ``[rows, d]`` batch as ``compress_tree``
    stacks it) takes the stats pass and the tail passes on its shard rows,
    and their per-row outputs are summed (the max taken) over the row's
    shards in rank order between the passes (``ops.gspar_dense_lambda``),
    so that every worker forms the same lambda and gate; then kernel 6 (5
    without EF) writes Q and the residual of each shard row at that
    lambda. ``uniforms(leaf, row, block, n)`` gives a shard row's ``n``
    float32 uniforms (``block``: the shard's slices of the leaf;
    ``dist.fsdp.KeyedUniforms``), drawn in blocks of rows of at most
    ``UNIFORM_BYTES``. A leaf whose whole size is under
    ``cfg.min_leaf_size`` passes through with a zero residual.

    The accounting counts each row once: every worker holds every row's
    whole counts after the reductions, so the TreeStats (bits, density and
    var_ratio over the whole tree's coordinates) are the same on every
    worker. Returns ``(q, new_residual, stats)`` like ``compress_tree``,
    the lists shaped like ``leaves``."""
    from repro_torch.core.grouping import leaf_rows
    from repro_torch.kernels.sparsify import ops
    _require_residual(cfg, residual, "compress_tree_sharded")
    scheme = cfg.scheme()
    sel, codec = scheme.selector, scheme.codec
    if sel.name != "gspar" or getattr(sel, "algo", "") != "greedy" or \
            codec.integer_coded or codec.stochastic:
        raise _not_ported(f"the fsdp mode's sharded Q of {cfg.name!r} "
                          "(gspar, greedy, with a float codec, is)",
                          "queue A item 10d")
    ef = cfg.error_feedback
    n = len(leaves)
    stk = stacked if stacked is not None else [False] * n
    whole = [math.prod(s) for s in layout.shapes]
    dev = leaves[0].device
    sparse: dict = {}
    dense = []
    for i, leaf in enumerate(leaves):
        if whole[i] < cfg.min_leaf_size:
            dense.append(i)
            continue
        rows, d = leaf_rows(tuple(leaf.shape), stk[i])
        sparse.setdefault((leaf.dtype, d, whole[i] // rows), []).append(
            (i, rows))
    q: list = [None] * n
    new_res: list = [None] * n
    bits, nnz, wvar = [], [], []
    if dense:
        sums = []
        for i in dense:
            q[i] = leaves[i] + residual[i] if ef else leaves[i]
            if ef:
                new_res[i] = torch.zeros_like(leaves[i])
            t32 = q[i].reshape(-1).to(F32)
            sums.append(torch.stack([
                torch.count_nonzero(t32).to(torch.float64),
                (t32 * t32).sum().to(torch.float64)]))
        sums = torch.stack(sums)
        layout.reduce_rows(dense, sums)
        for k, i in enumerate(dense):
            bits.append(torch.tensor(
                coding.dense_coding_bits(whole[i], cfg.float_bits),
                dtype=F32, device=dev))
            nnz.append(sums[k, 0].to(F32))
            wvar.append((sums[k, 1] > 0).to(F32) * float(whole[i]))
    for (dtype, d, d_whole), members in sparse.items():
        grp = _ShardGroup(members, d)
        stack = _stack_group(grp, leaves, residual, ef)
        leaf_of_row = [i for i, rows in members for _ in range(rows)]
        lam, den = ops.gspar_dense_lambda(
            stack, sel.rho, sel.num_iters,
            _RowShards(layout, leaf_of_row, d_whole))
        direct = codec.wire_dtype(dtype) == dtype
        qg = torch.empty((grp.rows, d), dtype=dtype, device=dev)
        per = max(1, UNIFORM_BYTES // (4 * d))
        starts, r0 = {}, 0
        for i, rows in members:
            starts[i] = r0
            q[i] = qg[r0:r0 + rows].view(leaves[i].shape)
            r0 += rows
        blocks = {i: layout.block(i) for i, _ in members}
        counts = []
        for a in range(0, grp.rows, per):
            b = min(grp.rows, a + per)
            us = [uniforms(i, r - starts[i], blocks[i], d)
                  for r, i in enumerate(leaf_of_row[a:b], a)]
            u = us[0].view(1, d) if len(us) == 1 else torch.stack(us)
            del us
            r = ops.lam_dense(stack[a:b], u, lam[a:b], den[a:b],
                              codec=codec, ef=ef,
                              out=qg[a:b] if direct else None)
            del u
            if not direct:
                qg[a:b].copy_(r.q)
            for i, rows in members if ef else ():
                lo, hi = max(a, starts[i]), min(b, starts[i] + rows)
                if lo >= hi:
                    continue
                if (lo, hi) == (starts[i], starts[i] + rows):
                    new_res[i] = r.residual[lo - a:hi - a].view(
                        leaves[i].shape)       # the block holds the leaf
                    continue
                if new_res[i] is None:
                    new_res[i] = torch.empty_like(leaves[i])
                new_res[i].view(rows, d)[lo - starts[i]:hi - starts[i]] \
                    .copy_(r.residual[lo - a:hi - a])
            counts.append(torch.stack([r.nnz.to(torch.float64),
                                       r.n_sure.to(torch.float64),
                                       r.sum_sq.to(torch.float64)], 1))
            del r
        del stack
        counts = torch.cat(counts)
        layout.reduce_rows(leaf_of_row, counts)
        row_nnz = counts[:, 0].to(torch.int64)
        row_bits = scheme.message_bits(d_whole, row_nnz,
                                       counts[:, 1].to(torch.int64))
        ok = den > 0
        ratio = torch.where(ok, counts[:, 2].to(F32)
                            / torch.where(ok, den, 1.0), 0.0)
        bits.append(_row_sum(row_bits))
        nnz.append(row_nnz.sum().to(F32))
        wvar.append(_row_sum(ratio) * float(d_whole))
    return q, (new_res if ef else None), _tree_stats(
        cfg, leaves, bits, nnz, wvar, tot=float(sum(whole)))


@dataclasses.dataclass(frozen=True)
class _ShardGroup:
    """A shard group's members ``(leaf, rows)`` and row length, as
    ``_stack_group`` reads a ``grouping.Group``."""
    members: tuple
    d: int

    @property
    def rows(self) -> int:
        return sum(r for _, r in self.members)


def compress_tree_sparse(cfg: CompressionConfig, generator: torch.Generator,
                         leaves: list, stacked: list | None = None,
                         residual: list | None = None):
    """Compress the ordered ``leaves`` straight into ``SparseGrad`` wire
    buffers, one kernel launch per shape group and kernel.

    Each sparse group is stacked into one ``[rows, d]`` batch (with error
    feedback: the target ``leaf + residual``, formed in place in the
    batch) and takes its uniforms from ``generator`` (the paper's
    section-5.3 pregenerated randoms), in group order: the selector's as
    one ``[rows, d]`` float32 draw (none for the deterministic topk and
    identity), then a stochastic codec's as one ``[rows, k_cap]`` draw
    (``[rows, d]`` on the reference backend, which compresses as the dense
    wire does: ``compress_tree``'s draws, so one seed gives both wires the
    same Q). The backend is ``cfg.backend``'s (``sparse.resolve_backend``;
    the kernel backend hands agspar and identity to the reference
    backend). Tiny leaves (<
    ``cfg.min_leaf_size``) form one dense float32 passthrough whose
    residual is exactly zero.

    Returns ``(items, new_residual, stats)``: ``items`` are
    ``("dense", flat, members)`` and ``("sparse", SparseGrad, members)``
    with ``members`` as in ``grouping.Group``; ``new_residual`` is a list
    like ``leaves`` (None without error feedback).
    """
    _require_residual(cfg, residual, "compress_tree_sparse")
    backend = resolve_backend(cfg)
    scheme = cfg.scheme()
    ef = cfg.error_feedback
    stk = stacked if stacked is not None else [False] * len(leaves)
    plan = plan_tree(cfg, leaves, stk)

    def target_of(i: int) -> torch.Tensor:
        return leaves[i] + residual[i] if ef else leaves[i]

    items, bits, nnz, wvar = [], [], [], []
    new_res: list = [None] * len(leaves)
    for grp in plan.groups:
        if grp.kind == "dense":
            parts = []
            for i, n in grp.members:
                t32 = target_of(i).reshape(-1).to(F32)
                parts.append(t32)
                if ef:
                    new_res[i] = torch.zeros_like(leaves[i])
                bits.append(torch.tensor(
                    coding.dense_coding_bits(n, cfg.float_bits), dtype=F32,
                    device=t32.device))
                nnz.append(torch.count_nonzero(t32).to(F32))
                wvar.append(((t32 * t32).sum() > 0).to(F32) * float(n))
            items.append(("dense", torch.cat(parts), grp.members))
            continue

        stack = _stack_group(grp, leaves, residual, ef)
        u = u_cod = None
        if scheme.selector.samples:
            u = torch.rand((grp.rows, grp.d), generator=generator,
                           dtype=F32, device=stack.device)
        if scheme.codec.stochastic:
            # at compact rank for the two-pass emit, shaped like the group
            # for the reference backend's dense pass
            u_cod = torch.rand((grp.rows, grp.d if backend.uses_dense(
                scheme) else grp.k_cap), generator=generator, dtype=F32,
                device=stack.device)
        if not ef:
            sg = backend.compress_sparse(cfg, u, stack, grp.k_cap, u_cod)
        elif scheme.codec.integer_coded:
            # the residual is scattered from the compact buffers alone: the
            # uniforms (two [rows, d] draws for bernoulli) go first
            sg = backend.compress_sparse(cfg, u, stack, grp.k_cap, u_cod)
            del u, u_cod
            res_rows = residual_from_buffers(stack, sg)
        else:
            sg, res_rows = backend.compress_sparse_ef(cfg, u, stack,
                                                      grp.k_cap, u_cod)
        if ef:
            r0 = 0
            for i, rows in grp.members:
                new_res[i] = res_rows[r0:r0 + rows].reshape(leaves[i].shape)
                r0 += rows
        del stack
        items.append(("sparse", sg, grp.members))
        bits.append(_row_sum(sg.bits))
        nnz.append(sg.nnz.sum().to(F32))
        wvar.append(_row_sum(sg.var_ratio) * float(grp.d))

    return items, (new_res if ef else None), _tree_stats(cfg, leaves, bits,
                                                         nnz, wvar)


def zeros_like_residual(params: list) -> list:
    """A zero residual, one tensor like each leaf."""
    return [torch.zeros_like(p) for p in params]
