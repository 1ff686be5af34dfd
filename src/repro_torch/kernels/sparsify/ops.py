"""The emit pipelines on the sparsify kernels (port of
``repro.kernels.sparsify.ops``: ``greedy_lambda``, the tail function,
``_two_pass``, ``gspar_emit``, ``closed_emit``, ``unisp_emit``,
``bern_emit``, ``topk_emit`` and ``EmitResult``; the leaf ops
``gspar_stats``, ``gspar_lambda``, ``gspar_sparsify`` and
``gspar_sparsify_prng``; and the dense wire's pipelines, one per selector:
``gspar_dense``, ``closed_dense``, ``agspar_dense``, ``unisp_dense``,
``bern_dense``, ``topk_dense`` and ``identity_dense``).

Algorithm 3 (greedy lambda) fully on the device: one stats pass, up to
``num_iters`` saturation-aware tail passes driving the scalar rescale, then
the two-pass compact emit; the baselines hand the same two passes their
own per-row scalars (rho; max|g| from the stats pass; topk's threshold and
tie budget from the radix-select kernel ``topk_threshold``). Pass 1
reduces survivor counts and the codec scale statistics, pass 2 writes the
wire buffers and, for the RICE wire layout (``rice_r >= 0``), a fifth
kernel packs pass 2's index stream (under wire-format v4 ``rice_fit``
first picks each row's parameter, and the packing takes it). Everything runs over one shape group
``[rows, d]`` with per-row scalars, so a group is one launch per kernel,
and no scalar is read back to the host between the passes.

The JAX ops layer pads every leaf into the TPU tile layout (``_pad_2d``) and
corrects the tail counts for the padding; the CUDA kernels mask the ragged
end of a row themselves, so neither exists here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.comm import compaction
from repro_torch.core import codecs as codecs_lib
from repro_torch.core import sparsify as sparsify_lib
from repro_torch.kernels.sparsify import kernel as K
from repro_torch.kernels.sparsify import ref

F32 = torch.float32


def _safe_div(num, den: torch.Tensor) -> torch.Tensor:
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def greedy_lambda(l1: torch.Tensor, mx: torch.Tensor, rho, d: int,
                  num_iters: int = 2,
                  tail_fn: Callable | None = None) -> torch.Tensor:
    """Algorithm 3's scalar fixed point per row, from the row statistics
    (``repro.kernels.sparsify.ops.greedy_lambda``)::

        lam_0 = rho * d / ||g||_1
        c_k   = max(1, (rho*d - (d - n_active)) / (lam_k * l1_active))
        lam_{k+1} = c_k * lam_k

    where the active set is ``|g| < 1/lam_k``. ``tail_fn(thresh, gate) ->
    (n_below, l1_below)`` supplies its count and mass per row; ``gate`` is
    ``lam_0 * max|g| > 1``. Rows where nothing saturates keep lam_0 (the
    TPU's ``lax.cond``): the tail kernel reads the gate on the device and
    does no work for them, so the branch costs no host round trip. ``rho``
    is a float or a float32 tensor per row (agspar's fitted density)."""
    d_f = torch.tensor(float(d), dtype=F32, device=l1.device)
    rho_d = torch.as_tensor(rho, dtype=F32, device=l1.device) * d_f
    lam0 = _safe_div(rho_d, l1.to(F32))
    if tail_fn is None or num_iters <= 0:
        return lam0
    gate = lam0 * mx.to(F32) > 1.0
    lam = lam0
    for _ in range(num_iters):
        n_below, l1_below = tail_fn(_safe_div(1.0, lam), gate)
        target = rho_d - (d_f - n_below.to(F32))
        c = torch.clamp_min(_safe_div(target, lam * l1_below), 1.0)
        lam = torch.where(gate, c * lam, lam)
    return lam


def _kernel_tail_fn(g2d: torch.Tensor) -> Callable:
    def tail(thresh, gate):
        return K.tail_stats(g2d, thresh, gate)
    return tail


class EmitResult(NamedTuple):
    """Wire buffers and accounting scalars of one group, per row: ``values``
    /``idx`` the compact buffers (values in the wire dtype, idx ascending by
    coordinate, padding slots idx 0 / value 0), ``nnz`` the survivors before
    the capacity cut, ``nonzeros`` the support, ``p_sum``/``den`` sum p and
    sum g^2, ``scale`` the codec scale, ``rice_words``/``rice_used`` the
    Golomb-Rice index words and their used count (the fitted header under
    wire-format v4; None unless ``rice_r >= 0``), ``residual`` the EF
    residual ``g - wire value`` (None without EF)."""
    values: torch.Tensor
    idx: torch.Tensor
    nnz: torch.Tensor
    nonzeros: torch.Tensor
    p_sum: torch.Tensor
    den: torch.Tensor
    scale: torch.Tensor
    rice_words: torch.Tensor | None
    rice_used: torch.Tensor | None
    residual: torch.Tensor | None


_F32 = codecs_lib.FloatCodec()


def _two_pass(g2d: torch.Tensor, u2d: torch.Tensor | None, s1: torch.Tensor,
              *, pkind: str, codec, k_cap: int, rice_r: int, ef: bool,
              s2: torch.Tensor | None = None,
              budget: torch.Tensor | None = None,
              u_cod: torch.Tensor | None = None,
              rice_window: tuple = ()) -> EmitResult:
    """Pass 1 select + reduce, the codec scale, pass 2 compact write, and
    with ``rice_r >= 0`` the Golomb-Rice packing of the compact idx: at
    ``rice_r``, or with a ``rice_window`` (wire-format v4) at each row's
    fitted parameter (``rice_fit``, then ``rice_pack_fitted``; ``rice_used``
    is then the header ``(r << 26) | used``). The JAX package packs the
    static stream and discards it under v4 (``sync._strip_prepack``); here
    only the fitted one is packed. ``u2d`` are the selector's uniforms
    (None for topk), ``u_cod [rows, k_cap]`` the codec's (stochastic
    codecs), taken at compact rank."""
    kind = dict(pkind=pkind, s2=s2, budget=budget)
    sel = K.select_stats(g2d, u2d, s1, k_cap, **kind)
    scale = codecs_lib.finalize_scale(codec, sel.sum_sq, sel.max_abs)
    vals, idx, res = K.compact_emit(
        g2d, u2d, s1, sel, k_cap=k_cap, codec=codec, ef=ef, scale=scale,
        u_cod=u_cod, **kind)
    words, used = rice_words(idx, sel.nnz, g2d.shape[1], rice_r,
                             rice_window)
    return EmitResult(vals, idx, sel.nnz, sel.nonzeros, sel.p_sum, sel.den,
                      scale, words, used, res)


def rice_words(idx: torch.Tensor, live: torch.Tensor, d: int, rice_r: int,
               rice_window: tuple = ()):
    """The Golomb-Rice words of compact index streams ``idx [rows, k_cap]``
    whose first ``min(live, k_cap)`` slots ascend: ``(None, None)`` for
    ``rice_r < 0``; at ``rice_r`` (``rice_pack``); with a ``rice_window``
    at each row's fitted parameter (``rice_fit_pack``: the fit, then the
    fitted packing from the fit's tile bases; the used count is the header
    ``(r << 26) | used``)."""
    if rice_r < 0:
        return None, None
    if rice_window:
        return K.rice_fit_pack(idx, live, d=d, window=rice_window)
    return K.rice_pack(idx, live, d=d, r=rice_r)


class Compacted(NamedTuple):
    """A magnitude compaction of one ``[rows, d]`` group
    (``magnitude_compact``): ``values``/``idx [rows, k_cap]`` (ascending by
    coordinate, dead slots idx 0 and value 0), per row ``nnz`` the nonzeros
    before the capacity cut (int32), ``live`` the slots of the ascending
    prefix that carry a nonzero value, the codec ``scale``, and the
    Golomb-Rice words of the live prefix (None unless ``rice_r >= 0``)."""
    values: torch.Tensor
    idx: torch.Tensor
    nnz: torch.Tensor
    live: torch.Tensor
    scale: torch.Tensor
    rice_words: torch.Tensor | None
    rice_used: torch.Tensor | None


def magnitude_compact(g2d: torch.Tensor, *, k_cap: int, codec=_F32,
                      rice_r: int = -1, rice_window: tuple = ()
                      ) -> Compacted:
    """``compaction.compact`` of every row of a group, then the codec's
    deterministic encode (``repro.comm.sync._encode_det``): keep the
    ``k_cap`` largest magnitudes of each row, ties at the k_cap-th by
    lowest coordinate (XLA ``top_k``'s order) and never a zero, written in
    coordinate order, an integer codec's levels rounded deterministically
    (``det_round``).

    A bfloat16 group takes two reads of g: ``compact_bins`` (the magnitude
    histogram and, from its bins, each row's threshold, tie budget,
    nonzeros, kept count and the codec scale's inputs over the kept
    values), then ``compact_select`` (one pass that selects and writes,
    ordered by a chained scan). A float32 group, whose magnitudes take
    three radix rounds and whose bins are not single values, takes
    ``topk_threshold`` at ``k_target = k_cap`` and passes 1 and 2 with
    ``pkind="topk"``. With fewer nonzeros than k_cap the threshold is 0 and
    every nonzero is kept. A level that rounds to zero is no live slot
    (the JAX package's wire codecs drop zero values): the live slots move
    to the front of the prefix, in order (``compaction.live_prefix``),
    before the Golomb-Rice words are packed."""
    _group(g2d, "magnitude_compact")
    if g2d.dtype == torch.bfloat16:
        bins = K.compact_bins(g2d, k_cap)
        scale = codecs_lib.finalize_scale(codec, bins.sum_sq, bins.max_abs)
        vals, idx = K.compact_select(g2d, bins, k_cap=k_cap, codec=codec,
                                     scale=scale)
        nonzeros, live = bins.nonzeros, bins.kept
    else:
        t, budget = topk_threshold(g2d, k_cap)
        sel = K.select_stats(g2d, None, t, k_cap, pkind="topk",
                             budget=budget)
        scale = codecs_lib.finalize_scale(codec, sel.sum_sq, sel.max_abs)
        vals, idx, _ = K.compact_emit(
            g2d, None, t, sel, k_cap=k_cap, codec=codec, ef=False,
            pkind="topk", budget=budget, scale=scale,
            det_round=codec.integer_coded)
        nonzeros, live = sel.nonzeros, sel.nnz
    if codec.integer_coded:
        vals, idx, live = compaction.live_prefix(vals, idx, live)
    words, used = rice_words(idx, live, g2d.shape[1], rice_r, rice_window)
    return Compacted(vals, idx, nonzeros, live, scale, words, used)


def _group(g2d: torch.Tensor, name: str) -> None:
    if g2d.dim() != 2:
        raise ValueError(f"{name} takes a [rows, d] group, got "
                         f"{tuple(g2d.shape)}")


def gspar_emit(g2d: torch.Tensor, u2d: torch.Tensor,
               u_cod: torch.Tensor | None = None, *, k_cap: int,
               rho: float = 0.1, num_iters: int = 2, codec=_F32,
               rice_r: int = -1, ef: bool = False, rice_window: tuple = ()
               ) -> tuple[EmitResult, torch.Tensor]:
    """Algorithm 3 on a ``[rows, d]`` group: stats -> per-row lambda ->
    two-pass compact emit (and the RICE packing with ``rice_r >= 0``), with
    the uniforms ``u2d`` (float32, shaped like ``g2d``) as input. Returns
    ``(EmitResult, lam)``."""
    _group(g2d, "gspar_emit")
    l1, mx = K.stats_l1max(g2d)
    lam = greedy_lambda(l1, mx, rho, g2d.shape[1], num_iters,
                        tail_fn=_kernel_tail_fn(g2d))
    er = _two_pass(g2d, u2d, lam, pkind="lam", codec=codec, k_cap=k_cap,
                   rice_r=rice_r, ef=ef, u_cod=u_cod, rice_window=rice_window)
    return er, lam


def closed_lambda(g2d: torch.Tensor, eps: float) -> torch.Tensor:
    """Algorithm 2's lambda per row (``sparsify.closed_form_lambda_rows``).
    A bfloat16 group: its magnitude histogram (``kernel.magnitude_hist``,
    the ``topk_threshold`` kernel's histogram pass), then the bin solve
    (``kernel.closed_lambda``, one block a row). A float32 group: the
    plain solve, a sort a row."""
    if g2d.dtype == torch.bfloat16:
        return K.closed_lambda(K.magnitude_hist(g2d), eps)[0]
    return sparsify_lib.closed_form_lambda_rows(g2d, eps)


def closed_emit(g2d: torch.Tensor, u2d: torch.Tensor,
                u_cod: torch.Tensor | None = None, *, k_cap: int,
                eps: float = 0.1, codec=_F32, rice_r: int = -1,
                ef: bool = False, rice_window: tuple = ()
                ) -> tuple[EmitResult, torch.Tensor]:
    """Algorithm 2 on a ``[rows, d]`` group: the closed-form lambda per row
    (``sparsify.closed_form_lambda_rows``), then the same two-pass emit as
    the greedy path. Returns ``(EmitResult, lam)``."""
    _group(g2d, "closed_emit")
    lam = closed_lambda(g2d, eps)
    er = _two_pass(g2d, u2d, lam, pkind="lam", codec=codec, k_cap=k_cap,
                   rice_r=rice_r, ef=ef, u_cod=u_cod, rice_window=rice_window)
    return er, lam


def unisp_emit(g2d: torch.Tensor, u2d: torch.Tensor,
               u_cod: torch.Tensor | None = None, *, k_cap: int,
               rho: float = 0.1, codec=_F32, rice_r: int = -1,
               ef: bool = False, rice_window: tuple = ()) -> EmitResult:
    """UniSp, the paper's baseline: p = rho on the support."""
    _group(g2d, "unisp_emit")
    s1 = torch.tensor(rho, dtype=F32, device=g2d.device)
    return _two_pass(g2d, u2d, s1, pkind="rho", codec=codec, k_cap=k_cap,
                     rice_r=rice_r, ef=ef, u_cod=u_cod,
                     rice_window=rice_window)


def bern_emit(g2d: torch.Tensor, u2d: torch.Tensor,
              u_cod: torch.Tensor | None = None, *, k_cap: int,
              codec=_F32, rice_r: int = -1, ef: bool = False,
              rice_window: tuple = ()) -> tuple[EmitResult, torch.Tensor]:
    """Bernoulli selection (TernGrad's): p = |g| / max|g|, with max|g| from
    the stats kernel. Returns ``(EmitResult, max|g| per row)``."""
    _group(g2d, "bern_emit")
    _, mx = K.stats_l1max(g2d)
    zero = torch.zeros((), dtype=F32, device=g2d.device)
    er = _two_pass(g2d, u2d, zero, pkind="bern", codec=codec, k_cap=k_cap,
                   rice_r=rice_r, ef=ef, s2=mx, u_cod=u_cod,
                   rice_window=rice_window)
    return er, mx


def topk_threshold(g2d: torch.Tensor, k_target: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row, the k-th largest magnitude ``t`` (float32) and the tie
    budget ``k_target - #{|g| > t}`` (int64): the ``topk_threshold`` kernel
    (a radix select on the magnitudes' bits; on the CPU its plain version).
    The JAX package forms the budget in float32 from one ``lax.top_k``,
    which is inexact past 2^24 (ROADMAP.md queue C); here it stays an
    integer."""
    return K.topk_threshold(g2d, k_target)


def topk_emit(g2d: torch.Tensor, u_cod: torch.Tensor | None = None, *,
              k_cap: int, k_target: int, codec=_F32, rice_r: int = -1,
              ef: bool = False, rice_window: tuple = ()) -> EmitResult:
    """Deterministic top-k: keep |g| > t and the first ``budget``
    coordinates with |g| == t > 0 (``topk_threshold``), which is XLA
    top_k's lowest-index-first selection, as a counting compaction. Reads
    no uniforms."""
    _group(g2d, "topk_emit")
    t, budget = topk_threshold(g2d, k_target)
    return _two_pass(g2d, None, t, pkind="topk", codec=codec, k_cap=k_cap,
                     rice_r=rice_r, ef=ef, budget=budget, u_cod=u_cod,
                     rice_window=rice_window)


def _leaf_row(g: torch.Tensor) -> torch.Tensor:
    """A leaf of any shape as one ``[1, size]`` row."""
    return g.contiguous().reshape(1, -1)


def gspar_stats(g: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum|g|, sum g^2, max|g|) of a leaf, float32 scalars — one pass
    (kernel 7)."""
    l1, l2, mx = K.stats(_leaf_row(g))
    return l1[0], l2[0], mx[0]


def gspar_lambda(g: torch.Tensor, rho: float = 0.1,
                 num_iters: int = 2) -> torch.Tensor:
    """The saturation-aware greedy lambda of a leaf (float32 scalar): the
    stats pass, then the tail passes of ``greedy_lambda``."""
    g2d = _leaf_row(g)
    l1, mx = K.stats_l1max(g2d)
    return greedy_lambda(l1, mx, rho, g2d.shape[1], num_iters,
                         tail_fn=_kernel_tail_fn(g2d))[0]


def gspar_sparsify(g: torch.Tensor, u: torch.Tensor, rho: float = 0.1,
                   num_iters: int = 2) -> torch.Tensor:
    """Q(g) of a leaf with the pregenerated float32 uniforms ``u`` (shaped
    like g; the paper's section-5.3 trick): the greedy lambda, then one
    sample-and-scale pass (kernel 5). Returns g's shape and dtype."""
    g2d = _leaf_row(g)
    lam = gspar_lambda(g2d, rho, num_iters)
    return K.sparsify(g2d, _leaf_row(u.to(F32)), lam).q.reshape(g.shape)


def gspar_sparsify_prng(g: torch.Tensor, seed: int, rho: float = 0.1,
                        num_iters: int = 2) -> torch.Tensor:
    """``gspar_sparsify`` with the uniforms drawn inside the kernel from
    Philox4x32-10 under ``seed`` (kernel 8), so no uniform buffer is read.
    Returns g's shape and dtype."""
    g2d = _leaf_row(g)
    lam = gspar_lambda(g2d, rho, num_iters)
    return K.sparsify_prng(g2d, lam, seed).q.reshape(g.shape)


class DenseResult(NamedTuple):
    """The dense wire's compression of one ``[rows, d]`` group: ``q`` in
    the wire dtype (an integer codec's decoded levels in the leaf dtype),
    the EF ``residual`` (None without EF), and per row the selector's
    scalar ``lam`` (lambda, rho or topk's threshold; None for identity),
    the nonzeros of q (``nnz``), those with p = 1 (``n_sure``), sum q^2
    (``sum_sq``), sum g^2 (``den``) and an integer codec's ``scale``; and
    the selector kind with its other scalars, from which ``probabilities``
    rebuilds p."""
    q: torch.Tensor
    residual: torch.Tensor | None
    lam: torch.Tensor | None
    nnz: torch.Tensor
    n_sure: torch.Tensor
    sum_sq: torch.Tensor
    den: torch.Tensor
    scale: torch.Tensor | None = None
    pkind: str = "lam"
    s2: torch.Tensor | None = None
    budget: torch.Tensor | None = None


def _dense_pass(g2d: torch.Tensor, u2d: torch.Tensor | None,
                s1: torch.Tensor | None, *, pkind: str, codec, ef: bool,
                out: torch.Tensor | None, s2: torch.Tensor | None = None,
                budget: torch.Tensor | None = None,
                u_cod: torch.Tensor | None = None,
                l2mx: tuple | None = None,
                den: torch.Tensor | None = None) -> DenseResult:
    """The dense emit (kernel 5, or 6 with ``ef``) of one group for the
    selector kind ``pkind`` and its per-row scalars, after what it needs
    first: topk's tie bases from pass 1 (``select_stats``, which also gives
    an integer codec its scale there: topk's v is g itself), and an integer
    codec's scale over v rounded to the leaf dtype (``select_stats`` with
    ``round_v`` at ``k_cap = d``; for identity ``l2mx``, the stats
    kernel's sum g^2 and max|g|). Sum g^2 comes from the first of ``den``
    (the stats pass's), ``l2mx`` and pass 1 that ran; the dense emit
    reduces it only where none did."""
    d = g2d.shape[1]
    scale = tie_base = None
    if den is None and l2mx is not None:
        den = l2mx[0]
    if pkind == "topk":
        st = K.select_stats(g2d, None, s1, d, pkind="topk", budget=budget)
        tie_base = st.tie_base
        if codec.integer_coded:
            scale = codecs_lib.finalize_scale(codec, st.sum_sq, st.max_abs)
        den = st.den if den is None else den
        del st
    elif codec.integer_coded:
        if pkind == "one":
            scale = codecs_lib.finalize_scale(codec, *l2mx)
        else:
            st = K.select_stats(g2d, u2d, s1, d, pkind=pkind, s2=s2,
                                round_v=True)
            scale = codecs_lib.finalize_scale(codec, st.sum_sq, st.max_abs)
            den = st.den if den is None else den
            del st
    out_dtype = g2d.dtype if codec.integer_coded \
        else codec.wire_dtype(g2d.dtype)
    sp = (K.sparsify_ef if ef else K.sparsify)(
        g2d, u2d, s1, out_dtype, out=out, pkind=pkind, s2=s2, budget=budget,
        tie_base=tie_base, codec=codec, scale=scale, u_cod=u_cod, den=den)
    return DenseResult(sp.q, sp.residual, s1, sp.nnz, sp.n_sure, sp.sum_sq,
                       sp.den, scale, pkind, s2, budget)


def gspar_dense(g2d: torch.Tensor, u2d: torch.Tensor,
                u_cod: torch.Tensor | None = None, *, rho: float = 0.1,
                num_iters: int = 2, codec=_F32, ef: bool = False,
                out: torch.Tensor | None = None) -> DenseResult:
    """Algorithm 3 on a ``[rows, d]`` group for the dense wire: the stats
    pass (kernel 7: lambda_0, the saturation gate and sum g^2), the tail
    passes of ``greedy_lambda``, then one sample-and-scale pass writing Q
    (kernel 5), or Q and the EF residual (kernel 6), with the accounting
    sums fused into it. ``codec`` as in ``_dense_pass``; ``out`` takes Q in
    place."""
    _group(g2d, "gspar_dense")
    l1, l2, mx = K.stats(g2d)
    lam = greedy_lambda(l1, mx, rho, g2d.shape[1], num_iters,
                        tail_fn=_kernel_tail_fn(g2d))
    return _dense_pass(g2d, u2d, lam, pkind="lam", codec=codec, ef=ef,
                       out=out, u_cod=u_cod, den=l2)


def closed_dense(g2d: torch.Tensor, u2d: torch.Tensor,
                 u_cod: torch.Tensor | None = None, *, eps: float = 1.0,
                 codec=_F32, ef: bool = False,
                 out: torch.Tensor | None = None) -> DenseResult:
    """Algorithm 2 on the dense wire: the closed-form lambda per row, then
    the same pass as ``gspar_dense``."""
    _group(g2d, "closed_dense")
    lam = closed_lambda(g2d, eps)
    return _dense_pass(g2d, u2d, lam, pkind="lam", codec=codec, ef=ef,
                       out=out, u_cod=u_cod)


def fitted_rho(l1: torch.Tensor, l2: torch.Tensor, d: int, rho: float,
               density_gain: float, density_floor: float) -> torch.Tensor:
    """agspar's density target per row (float32), from the row's sum |g|
    and sum g^2: ``clip(gain * s / d, floor * rho, rho)`` with the
    participation ratio ``s = ||g||_1^2 / ||g||_2^2``
    (``AdaptiveGsparSelector.rho_fitted``, repro/core/schemes.py:112)."""
    l1, l2 = l1.to(F32), l2.to(F32)
    s = _safe_div(l1 * l1, l2)
    f32 = dict(dtype=F32, device=l1.device)
    return torch.clamp(
        torch.tensor(density_gain, **f32) * s
        / torch.tensor(float(d), **f32),
        torch.tensor(density_floor * rho, **f32), torch.tensor(rho, **f32))


def agspar_dense(g2d: torch.Tensor, u2d: torch.Tensor,
                 u_cod: torch.Tensor | None = None, *, rho: float = 0.1,
                 num_iters: int = 2, density_gain: float = 1.0,
                 density_floor: float = 0.1, codec=_F32, ef: bool = False,
                 out: torch.Tensor | None = None) -> DenseResult:
    """agspar on the dense wire: the stats pass, each row's fitted density
    (``fitted_rho``), Algorithm 3's lambda at it, then ``gspar_dense``'s
    pass."""
    _group(g2d, "agspar_dense")
    d = g2d.shape[1]
    l1, l2, mx = K.stats(g2d)
    rho_row = fitted_rho(l1, l2, d, rho, density_gain, density_floor)
    lam = greedy_lambda(l1, mx, rho_row, d, num_iters,
                        tail_fn=_kernel_tail_fn(g2d))
    return _dense_pass(g2d, u2d, lam, pkind="lam", codec=codec, ef=ef,
                       out=out, u_cod=u_cod, den=l2)


def unisp_dense(g2d: torch.Tensor, u2d: torch.Tensor,
                u_cod: torch.Tensor | None = None, *, rho: float = 0.1,
                codec=_F32, ef: bool = False,
                out: torch.Tensor | None = None) -> DenseResult:
    """UniSp on the dense wire: p = rho on the support."""
    _group(g2d, "unisp_dense")
    s1 = torch.full((g2d.shape[0],), rho, dtype=F32, device=g2d.device)
    return _dense_pass(g2d, u2d, s1, pkind="rho", codec=codec, ef=ef,
                       out=out, u_cod=u_cod)


def bern_dense(g2d: torch.Tensor, u2d: torch.Tensor,
               u_cod: torch.Tensor | None = None, *, codec=_F32,
               ef: bool = False,
               out: torch.Tensor | None = None) -> DenseResult:
    """Bernoulli selection (TernGrad's) on the dense wire: p = |g| / max|g|
    with max|g| from the stats pass."""
    _group(g2d, "bern_dense")
    _, l2, mx = K.stats(g2d)
    zero = torch.zeros(g2d.shape[0], dtype=F32, device=g2d.device)
    return _dense_pass(g2d, u2d, zero, pkind="bern", codec=codec, ef=ef,
                       out=out, s2=mx, u_cod=u_cod, den=l2)


def topk_dense(g2d: torch.Tensor, u_cod: torch.Tensor | None = None, *,
               k_target: int, codec=_F32, ef: bool = False,
               out: torch.Tensor | None = None) -> DenseResult:
    """Deterministic top-k on the dense wire: the threshold and tie budget
    (``topk_threshold``), pass 1's tie bases, then the dense pass keeping
    |g| > t and the first ``budget`` ties of each row. Reads no
    uniforms."""
    _group(g2d, "topk_dense")
    t, budget = topk_threshold(g2d, k_target)
    return _dense_pass(g2d, None, t, pkind="topk", codec=codec, ef=ef,
                       out=out, budget=budget, u_cod=u_cod)


def identity_dense(g2d: torch.Tensor, u_cod: torch.Tensor | None = None, *,
                   codec=_F32, ef: bool = False,
                   out: torch.Tensor | None = None) -> DenseResult:
    """The identity selector on the dense wire (p = 1, v = g) through the
    codec: for an integer codec the stats pass gives the scale (sum g^2,
    max|g|); a float codec needs none."""
    _group(g2d, "identity_dense")
    l2mx = None
    if codec.integer_coded:
        _, l2, mx = K.stats(g2d)
        l2mx = (l2, mx)
    return _dense_pass(g2d, None, None, pkind="one", codec=codec, ef=ef,
                       out=out, u_cod=u_cod, l2mx=l2mx)


def probabilities(r: DenseResult, g2d: torch.Tensor) -> torch.Tensor:
    """The keep probabilities ``[rows, d]`` (float32) that a dense pass
    sampled with, from its kind and scalars: ``ref``'s selector rows (topk:
    the kept mask; identity: ones)."""
    if r.pkind == "one":
        return torch.ones(g2d.shape, dtype=F32, device=g2d.device)
    p = torch.empty(g2d.shape, dtype=F32, device=g2d.device)
    for row in range(g2d.shape[0]):
        u_row = torch.zeros(g2d.shape[1], dtype=F32, device=g2d.device)
        p[row] = ref._select_row(
            r.pkind, g2d[row], u_row, r.lam[row],
            None if r.s2 is None else r.s2[row],
            None if r.budget is None else r.budget[row])[2]
    return p
