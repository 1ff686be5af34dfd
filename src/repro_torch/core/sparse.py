"""Compact sparse-gradient representation and the compression backends
(port of ``repro.core.sparse``: ``SparseGrad``, ``ReferenceBackend``, the
counterpart of ``PallasBackend``, which here also compresses the dense
wire's groups, and ``resolve_backend``).

``SparseGrad`` is the wire form of one compressed shape group: fixed-
capacity ``values [rows, k_cap]`` (codec-encoded, wire dtype) and ``idx
[rows, k_cap]`` (int32, ascending per row; padding slots idx 0 / value 0),
under the RICE layout also the index words the kernel packed, plus per-row
accounting. Selection happens once, in the backend; the sync layer ships
the buffers as they are.

``KernelBackend`` runs the two-pass emit of ``repro_torch.kernels.sparsify``
(and, for the dense wire, the selector's dense pipeline, ``ops.*_dense``)
on a whole group: the CUDA kernels for tensors on the card, their plain
PyTorch versions for tensors on the CPU. Every composition runs on the
dense wire; on the sparse wires its two-pass emit runs gspar, unisp, topk
and bernoulli, and it hands agspar and identity to ``ReferenceBackend``,
as the JAX package's Pallas backend does.

``ReferenceBackend`` (``backend="reference"``) is the dense wire's
computation followed by one magnitude compaction per row
(``compaction.compact``: on the card ``topk_threshold`` and passes 1-2 of
topk, no sort), so on the same uniforms its buffers scatter to the dense
wire's Q bit for bit; topk with a codec that neither rounds nor codes
integers takes ``_topk_fast``, one selection that is also the compaction.
Its uniforms are the dense wire's: the selector's and an integer codec's,
each ``[rows, d]`` (``uses_dense``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import compaction, wire_layout
from repro_torch.core import codecs, coding
from repro_torch.core._compressors import CompressedGrad, finish_compressed
from repro_torch.kernels.sparsify import kernel as K
from repro_torch.kernels.sparsify import ops

F32 = torch.float32
# Slots per tile of the accounting in KernelBackend._finish: about 1.5 GB
# of float32 temporaries.
ACCOUNT_UNITS = 1 << 27
# The selectors the two-pass emit runs on the gather wire (the JAX
# package's PallasBackend.FUSED_SELECTORS).
FUSED_SELECTORS = ("gspar", "unisp", "topk", "bernoulli")


@dataclasses.dataclass
class SparseGrad:
    """Fixed-capacity compact form of one shape group (one row per layer of
    a stacked leaf, one per flat leaf)."""
    values: torch.Tensor       # [rows, k_cap] wire values; padding is 0
    idx: torch.Tensor          # [rows, k_cap] int32 row coordinates,
                               # ascending over the valid prefix
    nnz: torch.Tensor          # [rows] int32 survivors before the cap
    p_sum: torch.Tensor        # [rows] sum of keep probabilities (E[nnz])
    bits: torch.Tensor         # [rows] coding-model message bits
    var_ratio: torch.Tensor    # [rows] ||Q(g)||^2 / ||g||^2
    scale: torch.Tensor        # [rows] codec scale (ones for float codecs)
    d: int                     # coordinates per row
    codec: str = "f32"
    layout: str = "coo"        # wire layout (comm.wire_layout), stamped
                               # from (k_cap, d, wire width)
    rice_words: torch.Tensor | None = None
                               # [rows, cap_words] Golomb-Rice index words
                               # the kernel packed (rice layout only)
    rice_used: torch.Tensor | None = None
                               # [rows] used words of rice_words (the
                               # fitted header (r << 26) | used when
                               # rice_window is set)
    rice_window: tuple = ()    # wire-format v4: the candidate parameters
                               # the words were fitted over (() static)
    live: torch.Tensor | None = None
                               # [rows] int32 slots of the ascending prefix
                               # that carry a value, where that is not
                               # min(nnz, k_cap): the pod stage's integer
                               # levels that rounded to zero are dropped
                               # (compaction.live_prefix)

    @property
    def k_cap(self) -> int:
        return self.values.shape[-1]

    @property
    def rows(self) -> int:
        return self.values.shape[0]

    @property
    def n_valid(self) -> torch.Tensor:
        """Per row, the count whose ``min(., k_cap)`` is the live prefix of
        the buffers."""
        return self.nnz if self.live is None else self.live

    def overflow(self) -> torch.Tensor:
        """Survivors dropped because nnz exceeded the capacity, per row."""
        return torch.clamp_min(self.nnz - self.k_cap, 0)

    def decode_values(self, rows: slice = slice(None),
                      cols: slice = slice(None)) -> torch.Tensor:
        """Codec-decoded float32 values ``[rows, k_cap]`` (or the tile
        ``[rows, cols]`` of them): what the receiver reconstructs, each row
        with its own scale."""
        return codecs.get(self.codec).decode(self.values[rows, cols],
                                             self.scale[rows, None])


def _choose_layout(cfg, codec, leaf_dtype, k_cap: int, d: int) -> str:
    return wire_layout.choose(
        k_cap, d, wire_layout.value_bits_of(codec.wire_dtype(leaf_dtype)),
        cfg.wire_layout)


def residual_from_buffers(g: torch.Tensor, sg: SparseGrad) -> torch.Tensor:
    """The EF residual from the compact buffers: ``g`` (the target, ``[rows,
    d]``) with each live slot's decoded value subtracted at its coordinate,
    ``g[idx] += -decoded.to(g.dtype)`` as the JAX package's
    ``_residual_from_buffers`` computes it. Only the live prefix of each row
    is scattered (``wire_layout.scatter_live``): the padding slots, which
    would add zeros to each row's coordinate 0, go to a scratch tail."""
    def neg_decoded(a: int, b: int, j0: int, j1: int) -> torch.Tensor:
        # out of place: a float codec's decode may return the values
        return sg.decode_values(slice(a, b), slice(j0, j1)).to(
            g.dtype).neg()
    return wire_layout.scatter_live(neg_decoded, sg.idx, sg.n_valid, sg.d,
                                    base=g, add=True)


def dense_group(scheme, u: torch.Tensor | None, g: torch.Tensor, ef: bool,
                out: torch.Tensor | None = None,
                u_cod: torch.Tensor | None = None):
    """The dense wire's compression of one ``[rows, d]`` group (``g`` the EF
    target with ``ef``) through the selector's pipeline in ``ops``, with
    the selector's float32 uniforms ``u`` (None for topk and identity) and
    an integer codec's ``u_cod`` (both shaped like g). Returns the
    ``ops.DenseResult``: Q in the codec's wire dtype (an integer codec's
    decoded levels in g's dtype; into ``out`` when given), with ``ef`` the
    residual ``g - Q`` after the rounding."""
    sel, codec = scheme.selector, scheme.codec
    kw = dict(codec=codec, ef=ef, out=out)
    if sel.name == "gspar" and sel.algo == "greedy":
        return ops.gspar_dense(g, u, u_cod, rho=sel.rho,
                               num_iters=sel.num_iters, **kw)
    if sel.name == "gspar":
        return ops.closed_dense(g, u, u_cod, eps=sel.eps, **kw)
    if sel.name == "agspar":
        return ops.agspar_dense(g, u, u_cod, rho=sel.rho,
                                num_iters=sel.num_iters,
                                density_gain=sel.density_gain,
                                density_floor=sel.density_floor, **kw)
    if sel.name == "unisp":
        return ops.unisp_dense(g, u, u_cod, rho=sel.rho, **kw)
    if sel.name == "bernoulli":
        return ops.bern_dense(g, u, u_cod, **kw)
    if sel.name == "topk":
        return ops.topk_dense(g, u_cod, k_target=sel.k_target(g.shape[1]),
                              **kw)
    return ops.identity_dense(g, u_cod, **kw)


def _finish_rows(scheme, r, d: int) -> CompressedGrad:
    """A dense pass's per-row accounting: the coding-model bits of
    ``Scheme.message_bits`` and the variance ratio."""
    bits = scheme.message_bits(d, r.nnz, r.n_sure)
    return finish_compressed(r.q, r.lam, bits, r.sum_sq, r.den, r.nnz)


def compress_vector(scheme, generator: torch.Generator,
                    g: torch.Tensor) -> CompressedGrad:
    """``Scheme.compress``: one vector through the dense wire's path as one
    row, the uniforms drawn from ``generator`` (the selector's, then an
    integer codec's, each shaped like g). Returns q in g's dtype and shape,
    with scalar accounting and the probabilities p it sampled with."""
    row = g.reshape(1, -1)
    f32 = dict(generator=generator, dtype=F32, device=g.device)
    u = torch.rand(row.shape, **f32) if scheme.selector.samples else None
    u_cod = torch.rand(row.shape, **f32) if scheme.codec.stochastic \
        else None
    r = dense_group(scheme, u, row, False, u_cod=u_cod)
    bits = scheme.message_bits(row.shape[1], r.nnz, r.n_sure)
    cg = finish_compressed(r.q.to(g.dtype).reshape(g.shape), r.lam,
                           bits[0], r.sum_sq[0], r.den[0], r.nnz[0])
    cg.p = ops.probabilities(r, row).reshape(g.shape)
    return cg


class KernelBackend:
    """Two-pass emit on the sparsify kernels, one launch per kernel per
    shape group: pass 1 reduces survivor counts and the codec-scale
    statistics, pass 2 writes the compact wire buffers (and, with error
    feedback and a float codec, the residual ``g - wire value`` in the same
    pass). Everything after the kernels is O(rows * k_cap) accounting.
    Selectors gspar (greedy and closed), unisp, topk and bernoulli on the
    gather wire, every selector on the dense wire; codecs f32, bf16,
    qsgd<N> and ternary."""

    def compress_dense(self, cfg, u: torch.Tensor | None, g: torch.Tensor,
                       ef: bool, out: torch.Tensor | None = None,
                       u_cod: torch.Tensor | None = None
                       ) -> tuple[CompressedGrad, torch.Tensor | None]:
        """One ``[rows, d]`` group for the dense wire (``dense_group``): Q
        and the accounting per row, and with ``ef`` the residual (None
        without)."""
        scheme = cfg.scheme()
        r = dense_group(scheme, u, g, ef, out, u_cod)
        return _finish_rows(scheme, r, g.shape[1]), r.residual

    @staticmethod
    def uses_dense(scheme) -> bool:
        """True where the group goes to ``ReferenceBackend`` (agspar and
        identity), whose codec uniforms are ``[rows, d]``."""
        return scheme.selector.name not in FUSED_SELECTORS

    def compress_sparse(self, cfg, u: torch.Tensor | None, g: torch.Tensor,
                        k_cap: int,
                        u_cod: torch.Tensor | None = None) -> SparseGrad:
        """One ``[rows, d]`` group with the selector's uniforms ``u`` (None
        for topk) and the codec's ``u_cod [rows, k_cap]`` (stochastic codecs
        only; ``[rows, d]`` where ``uses_dense``)."""
        scheme = cfg.scheme()
        if self.uses_dense(scheme):
            return ReferenceBackend().compress_sparse(cfg, u, g, k_cap, u_cod)
        er, layout, s, window = self._emit(scheme, cfg, u, g, k_cap, False,
                                           u_cod)
        return self._finish(scheme, g, er, layout, s, window)

    def compress_sparse_ef(self, cfg, u: torch.Tensor | None,
                           g: torch.Tensor, k_cap: int,
                           u_cod: torch.Tensor | None = None
                           ) -> tuple[SparseGrad, torch.Tensor]:
        """``g`` is the EF target (gradient plus carried residual); also
        returns the new residual ``g - wire value``. With a float codec the
        kernel writes it, every sampled survivor subtracted (on overflow the
        dropped ones too: the fused-EF semantics of the TPU kernel). An
        integer codec's residual subtracts the decoded levels of the
        transmitted slots, scattered from the compact buffers
        (``residual_from_buffers``), as the JAX package does."""
        scheme = cfg.scheme()
        if self.uses_dense(scheme):
            return ReferenceBackend().compress_sparse_ef(cfg, u, g, k_cap,
                                                         u_cod)
        if scheme.codec.integer_coded:
            sg = self.compress_sparse(cfg, u, g, k_cap, u_cod)
            return sg, residual_from_buffers(g, sg)
        er, layout, s, window = self._emit(scheme, cfg, u, g, k_cap, True,
                                           u_cod)
        return self._finish(scheme, g, er, layout, s, window), er.residual

    def _emit(self, scheme, cfg, u, g, k_cap, ef: bool, u_cod):
        """Run the selector's emit pipeline on one ``[rows, d]`` group.
        Returns the EmitResult, the wire layout, the selector's accounting
        scalar per row (lambda for gspar, max|g| for bernoulli, None
        otherwise) and the fitted Golomb-Rice window (``cfg.rice_fitted``
        on a RICE group; else ())."""
        sel, codec = scheme.selector, scheme.codec
        d = g.shape[1]
        # the layout is static in (k_cap, d, wire width), so it is decided
        # before the kernels: under RICE they pack the index words too
        layout, rice_r, window = _plan_layout(cfg, codec, g.dtype, k_cap, d)
        kw = dict(k_cap=k_cap, codec=codec, rice_r=rice_r, ef=ef,
                  rice_window=window)
        if sel.name == "topk":
            return (ops.topk_emit(g, u_cod, k_target=sel.k_target(d), **kw),
                    layout, None, window)
        if sel.name == "gspar" and sel.algo == "greedy":
            er, lam = ops.gspar_emit(g, u, u_cod, rho=sel.rho,
                                     num_iters=sel.num_iters, **kw)
            return er, layout, lam, window
        if sel.name == "gspar":
            er, lam = ops.closed_emit(g, u, u_cod, eps=sel.eps, **kw)
            return er, layout, lam, window
        if sel.name == "unisp":
            return (ops.unisp_emit(g, u, u_cod, rho=sel.rho, **kw), layout,
                    None, window)
        er, mx = ops.bern_emit(g, u, u_cod, **kw)
        return er, layout, mx, window

    def _finish(self, scheme, g, er, layout, s, window) -> SparseGrad:
        """Per-row accounting from the kernels' reductions and the compact
        buffers (``PallasBackend._finish``): the variance ratio over the
        decoded values, and the coding-model bits of
        ``Scheme.message_bits`` — for gspar and bernoulli from the
        sure-vs-sampled split of the kept coordinates (p at the kept
        coordinates is one gather). The buffers are read in tiles
        of at most ``ACCOUNT_UNITS`` slots (bernoulli's capacity is d: a
        whole group's float32 copy would be 4 B per coordinate)."""
        sel, codec = scheme.selector, scheme.codec
        rows, d = g.shape
        zeros = dict(dtype=torch.int64, device=g.device)
        # float64 sums, rounded once: the same float32 on the card and the
        # CPU, whose reductions add in different orders
        sumsq = torch.zeros(rows, dtype=torch.float64, device=g.device)
        n_nz, n_a, n_b = (torch.zeros(rows, **zeros) for _ in range(3))
        for a, b, j0, j1 in compaction.slot_tiles(rows, er.values.shape[1],
                                                  ACCOUNT_UNITS):
            vals = er.values[a:b, j0:j1]
            v32 = (codec.decode(vals, er.scale[a:b, None])
                   if codec.integer_coded else vals.to(F32))
            sumsq[a:b] += v32.to(torch.float64).square().sum(-1)
            if codec.integer_coded:
                n_nz[a:b] += torch.count_nonzero(v32.abs() > 0, dim=-1)
            elif sel.name in ("gspar", "bernoulli"):
                a_idx = torch.gather(g[a:b], 1, er.idx[a:b, j0:j1].long()
                                     ).to(F32).abs()
                sb = s[a:b, None]
                if sel.name == "gspar":
                    p_idx = torch.clamp_max(sb * a_idx, 1.0)
                else:
                    p_idx = torch.where(
                        sb > 0, a_idx / torch.where(sb > 0, sb, 1.0), 0.0)
                valid = v32 != 0
                sure = p_idx >= 1.0
                n_a[a:b] += torch.count_nonzero(valid & sure, dim=-1)
                n_b[a:b] += torch.count_nonzero(valid & ~sure, dim=-1)
            del v32
        p_sum = er.p_sum
        if sel.name == "topk":
            p_sum = torch.full_like(er.p_sum, float(sel.k_target(d)))
        # the transmitted count each rule reads: the decoded nonzeros of an
        # integer codec, unisp's survivors before the cut, else the kept
        # coordinates of the buffers
        nnz = n_nz if codec.integer_coded else (
            er.nnz if sel.name == "unisp" else n_a + n_b)
        bits = scheme.message_bits(d, nnz, n_a)
        ok = er.den > 0
        sumsq = sumsq.to(F32)
        var = torch.where(ok, sumsq / torch.where(ok, er.den, 1.0), 0.0)
        return SparseGrad(values=er.values, idx=er.idx, nnz=er.nnz,
                          p_sum=p_sum, bits=bits, var_ratio=var,
                          scale=er.scale, d=d, codec=codec.name,
                          layout=layout, rice_words=er.rice_words,
                          rice_used=er.rice_used, rice_window=window)


def _kept_values(pkind: str, x: torch.Tensor, s1, s2) -> torch.Tensor:
    """The selector's value ``v`` at coordinates it kept (float32 ``x``,
    per-row scalars as columns), in ``ref._select_row``'s order: ``x / p``
    for the sampling kinds, ``x`` for topk and identity."""
    if pkind in ("topk", "one"):
        return x
    a = x.abs()
    if pkind == "lam":
        p = torch.clamp_max(s1 * a, 1.0)
    elif pkind == "rho":
        p = torch.where(a > 0, s1, 0.0)
    else:
        p = torch.where(s2 > 0, a / torch.where(s2 > 0, s2, 1.0), 0.0)
    return x / torch.where(p > 0, p, 1.0)


class ReferenceBackend:
    """The dense wire's pipeline plus one magnitude compaction per row
    (``repro.core.sparse.ReferenceBackend``): it shares the dense wire's
    computation, hence on the same uniforms its buffers scatter to the
    dense wire's Q bit for bit. The compaction keeps the nonzeros of Q by
    magnitude (``ops.magnitude_compact``, at most ``k_cap`` a row) and the
    buffers carry the codec's wire values there: Q itself for a float
    codec; an integer codec's levels, formed again at the kept coordinates
    from the selector's value and the coordinate's codec uniform as the
    dense pass formed them before it decoded them. The buffers ascend by
    coordinate, the JAX package's descend by magnitude (ROADMAP.md C).
    topk with a codec that neither rounds nor codes integers is
    ``_topk_fast``."""

    @staticmethod
    def uses_dense(scheme) -> bool:
        return True

    def compress_sparse(self, cfg, u: torch.Tensor | None, g: torch.Tensor,
                        k_cap: int,
                        u_cod: torch.Tensor | None = None) -> SparseGrad:
        """One ``[rows, d]`` group with the dense wire's uniforms (the
        selector's ``u`` and an integer codec's ``u_cod``, each shaped like
        g)."""
        scheme = cfg.scheme()
        sel, codec = scheme.selector, scheme.codec
        if sel.name == "topk" \
                and not (codec.rounds_values or codec.integer_coded):
            return self._topk_fast(cfg, scheme, g, k_cap, False)[0]
        rows, d = g.shape
        layout, rice_r, window = _plan_layout(cfg, codec, g.dtype, k_cap, d)
        r = dense_group(scheme, u, g, False, u_cod=u_cod)
        cg = _finish_rows(scheme, r, d)
        integer = codec.integer_coded
        c = ops.magnitude_compact(r.q, k_cap=k_cap,
                                  rice_r=-1 if integer else rice_r,
                                  rice_window=window)
        values, words, used = c.values, c.rice_words, c.rice_used
        if integer:
            values = _levels_at(r, g, u_cod, c.idx, c.live, codec)
            words, used = ops.rice_words(c.idx, c.live, d, rice_r, window)
        f32 = dict(dtype=F32, device=g.device)
        if sel.samples:       # sum p, from the selector's pass 1
            p_sum = K.select_stats(g, u, r.lam, k_cap, pkind=r.pkind,
                                   s2=r.s2).p_sum
        elif sel.name == "topk":
            p_sum = torch.full((rows,), float(sel.k_target(d)), **f32)
        else:
            p_sum = torch.full((rows,), float(d), **f32)
        scale = r.scale if integer else torch.ones(rows, **f32)
        return SparseGrad(values=values, idx=c.idx, nnz=c.nnz, p_sum=p_sum,
                          bits=cg.bits, var_ratio=cg.var_ratio, scale=scale,
                          d=d, codec=codec.name, layout=layout,
                          rice_words=words, rice_used=used,
                          rice_window=window)

    def compress_sparse_ef(self, cfg, u: torch.Tensor | None,
                           g: torch.Tensor, k_cap: int,
                           u_cod: torch.Tensor | None = None
                           ) -> tuple[SparseGrad, torch.Tensor]:
        """``compress_sparse`` of the EF target ``g``, and the residual
        ``g`` less the decoded buffers (``residual_from_buffers``; topk's
        fast path forms the same residual in pass 2)."""
        scheme = cfg.scheme()
        codec = scheme.codec
        if scheme.selector.name == "topk" \
                and not (codec.rounds_values or codec.integer_coded):
            return self._topk_fast(cfg, scheme, g, k_cap, True)
        sg = self.compress_sparse(cfg, u, g, k_cap, u_cod)
        return sg, residual_from_buffers(g, sg)

    @staticmethod
    def _topk_fast(cfg, scheme, g: torch.Tensor, k_cap: int, ef: bool):
        """Deterministic top-k with a passthrough codec: the ``min(k_cap,
        k_target)`` largest magnitudes of each row, one selection that is
        also the compaction (``ops.topk_emit``), with ``nnz`` the scheme's
        intended selection ``min(nonzeros, k_target)`` before the cut, so
        ``overflow`` reports a ``k_cap < k_target`` drop."""
        sel, codec = scheme.selector, scheme.codec
        d = g.shape[1]
        k_target = sel.k_target(d)
        layout, rice_r, window = _plan_layout(cfg, codec, g.dtype, k_cap, d)
        er = ops.topk_emit(g, None, k_cap=k_cap, k_target=min(k_cap,
                                                              k_target),
                           codec=codec, rice_r=rice_r, ef=ef,
                           rice_window=window)
        sg = KernelBackend()._finish(scheme, g, er, layout, None, window)
        sg.nnz = torch.clamp_max(er.nonzeros, k_target)
        return sg, er.residual


def _plan_layout(cfg, codec, leaf_dtype, k_cap: int, d: int):
    """The wire layout of one group, its static Golomb-Rice parameter (-1
    off RICE) and its fitted window (``cfg.rice_fitted`` on RICE, else
    ())."""
    layout = _choose_layout(cfg, codec, leaf_dtype, k_cap, d)
    rice = layout == "rice"
    return (layout, coding.rice_parameter(k_cap, d) if rice else -1,
            coding.rice_fit_window(k_cap, d) if rice and cfg.rice_fitted
            else ())


def _levels_at(r, g: torch.Tensor, u_cod: torch.Tensor, idx: torch.Tensor,
               live: torch.Tensor, codec) -> torch.Tensor:
    """An integer codec's levels ``[rows, k_cap]`` at the compact ``idx``
    of a dense pass ``r`` over ``g``: the selector's value at each kept
    coordinate, rounded to g's dtype as the dense pass rounds it, encoded
    with the row's scale and the coordinate's uniform ``u_cod[row, i]``;
    0 past each row's ``live`` prefix. In tiles of ``ACCOUNT_UNITS``
    slots."""
    rows, k = idx.shape
    out = torch.zeros((rows, k), dtype=codec.wire_dtype(g.dtype),
                      device=g.device)
    for a, b, j0, j1 in compaction.slot_tiles(rows, k, ACCOUNT_UNITS):
        ix = idx[a:b, j0:j1].long()
        x = torch.gather(g[a:b], 1, ix).to(F32)
        v = _kept_values(r.pkind, x,
                         None if r.lam is None else r.lam[a:b, None],
                         None if r.s2 is None else r.s2[a:b, None])
        lev = codec.encode(v.to(g.dtype).to(F32), r.scale[a:b, None],
                           torch.gather(u_cod[a:b], 1, ix))
        slot = torch.arange(j0, j1, device=g.device)
        out[a:b, j0:j1] = torch.where(slot < live[a:b, None], lev, 0)
    return out


def resolve_backend(cfg):
    """The backend of ``cfg.backend``: ``"reference"`` the reference
    backend, ``"auto"`` and ``"pallas"`` the kernel backend (which hands
    agspar and identity to the reference backend)."""
    return ReferenceBackend() if cfg.backend == "reference" \
        else KernelBackend()
