"""Compact sparse-gradient representation and the kernel backend (port of
``repro.core.sparse``: ``SparseGrad`` and the counterpart of
``PallasBackend``, which here also compresses the dense wire's groups).

``SparseGrad`` is the wire form of one compressed shape group: fixed-
capacity ``values [rows, k_cap]`` (codec-encoded, wire dtype) and ``idx
[rows, k_cap]`` (int32, ascending per row; padding slots idx 0 / value 0),
under the RICE layout also the index words the kernel packed, plus per-row
accounting. Selection happens once, in the backend; the sync layer ships
the buffers as they are.

``KernelBackend`` runs the two-pass emit of ``repro_torch.kernels.sparsify``
(and, for the dense wire, ``ops.gspar_dense``) on a whole group: the CUDA
kernels for tensors on the card, their plain PyTorch versions for tensors
on the CPU. The reference backend of the JAX
package (dense apply plus a magnitude ``top_k``), which the identity
selector runs on, is a different algorithm and is ROADMAP.md queue A item
4.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import compaction, wire_layout
from repro_torch.core import codecs, coding
from repro_torch.core._compressors import CompressedGrad, finish_compressed
from repro_torch.kernels.sparsify import ops

F32 = torch.float32
# Slots per tile of the accounting in KernelBackend._finish: about 1.5 GB
# of float32 temporaries.
ACCOUNT_UNITS = 1 << 27
# The ROADMAP.md queue A item that ports the dense wire's other compositions.
DENSE_WIRE_ITEM = 14


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
                               # [rows] used words of rice_words

    @property
    def k_cap(self) -> int:
        return self.values.shape[-1]

    @property
    def rows(self) -> int:
        return self.values.shape[0]

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
        return sg.decode_values(slice(a, b), slice(j0, j1)).to(
            g.dtype).neg_()
    return wire_layout.scatter_live(neg_decoded, sg.idx, sg.nnz, sg.d,
                                    base=g, add=True)


class KernelBackend:
    """Two-pass emit on the sparsify kernels, one launch per kernel per
    shape group: pass 1 reduces survivor counts and the codec-scale
    statistics, pass 2 writes the compact wire buffers (and, with error
    feedback and a float codec, the residual ``g - wire value`` in the same
    pass). Everything after the kernels is O(rows * k_cap) accounting.
    Selectors gspar (greedy), unisp, topk and bernoulli; codecs f32, bf16,
    qsgd<N> and ternary."""

    def compress_dense(self, cfg, u: torch.Tensor, g: torch.Tensor,
                       ef: bool, out: torch.Tensor | None = None
                       ) -> tuple[CompressedGrad, torch.Tensor | None]:
        """One ``[rows, d]`` group for the dense wire (``g`` the EF target
        with ``ef``) with the selector's float32 uniforms ``u``: Q in the
        codec's wire dtype (into ``out`` when given) and the accounting,
        and with ``ef`` the residual ``g - Q`` after the wire rounding
        (None without). gspar (greedy) with a float codec runs
        ``ops.gspar_dense``; every other composition raises."""
        scheme = cfg.scheme()
        sel, codec = scheme.selector, scheme.codec
        if sel.name != "gspar" or codec.integer_coded:
            raise NotImplementedError(
                f"{scheme.name} on the dense wire is not ported yet "
                f"(ROADMAP.md queue A item {DENSE_WIRE_ITEM})")
        d = g.shape[1]
        r = ops.gspar_dense(g, u, rho=sel.rho, num_iters=sel.num_iters,
                            out_dtype=codec.wire_dtype(g.dtype), ef=ef,
                            out=out)
        bits = scheme.message_bits(d, r.n_sure, r.nnz - r.n_sure)
        return (finish_compressed(r.q, r.lam, bits, r.sum_sq, r.den, r.nnz),
                r.residual)

    def compress_sparse(self, cfg, u: torch.Tensor | None, g: torch.Tensor,
                        k_cap: int,
                        u_cod: torch.Tensor | None = None) -> SparseGrad:
        """One ``[rows, d]`` group with the selector's uniforms ``u`` (None
        for topk) and the codec's ``u_cod [rows, k_cap]`` (stochastic codecs
        only)."""
        scheme = cfg.scheme()
        er, layout, s = self._emit(scheme, cfg, u, g, k_cap, False, u_cod)
        return self._finish(scheme, g, er, layout, s)

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
        if scheme.codec.integer_coded:
            sg = self.compress_sparse(cfg, u, g, k_cap, u_cod)
            return sg, residual_from_buffers(g, sg)
        er, layout, s = self._emit(scheme, cfg, u, g, k_cap, True, u_cod)
        return self._finish(scheme, g, er, layout, s), er.residual

    def _emit(self, scheme, cfg, u, g, k_cap, ef: bool, u_cod):
        """Run the selector's emit pipeline on one ``[rows, d]`` group.
        Returns the EmitResult, the wire layout and the selector's
        accounting scalar per row (lambda for gspar, max|g| for bernoulli,
        None otherwise)."""
        sel, codec = scheme.selector, scheme.codec
        d = g.shape[1]
        # the layout is static in (k_cap, d, wire width), so it is decided
        # before the kernels: under RICE they pack the index words too
        layout = _choose_layout(cfg, codec, g.dtype, k_cap, d)
        rice_r = coding.rice_parameter(k_cap, d) if layout == "rice" else -1
        kw = dict(k_cap=k_cap, codec=codec, rice_r=rice_r, ef=ef)
        if sel.name == "topk":
            return (ops.topk_emit(g, u_cod, k_target=sel.k_target(d), **kw),
                    layout, None)
        if sel.name == "gspar":
            er, lam = ops.gspar_emit(g, u, u_cod, rho=sel.rho,
                                     num_iters=sel.num_iters, **kw)
            return er, layout, lam
        if sel.name == "unisp":
            return ops.unisp_emit(g, u, u_cod, rho=sel.rho, **kw), layout, \
                None
        er, mx = ops.bern_emit(g, u, u_cod, **kw)
        return er, layout, mx

    def _finish(self, scheme, g, er, layout, s) -> SparseGrad:
        """Per-row accounting from the kernels' reductions and the compact
        buffers (``PallasBackend._finish``): the variance ratio over the
        decoded values, and the coding-model bits — an integer codec's
        levels (``coding.quantized_coding_bits``), topk's fixed k_target
        message, unisp's ``nnz (b + log2 d) + b``, or for gspar and
        bernoulli the sure-vs-sampled split of the kept coordinates (p at
        the kept coordinates is one gather). The buffers are read in tiles
        of at most ``ACCOUNT_UNITS`` slots (bernoulli's capacity is d: a
        whole group's float32 copy would be 4 B per coordinate)."""
        sel, codec = scheme.selector, scheme.codec
        rows, d = g.shape
        vb = codec.value_bits
        logd = torch.log2(torch.tensor(float(d), dtype=F32,
                                       device=g.device))
        zeros = dict(dtype=torch.int64, device=g.device)
        sumsq = torch.zeros(rows, dtype=F32, device=g.device)
        n_nz, n_a, n_b = (torch.zeros(rows, **zeros) for _ in range(3))
        for a, b, j0, j1 in compaction.slot_tiles(rows, er.values.shape[1],
                                                  ACCOUNT_UNITS):
            vals = er.values[a:b, j0:j1]
            v32 = (codec.decode(vals, er.scale[a:b, None])
                   if codec.integer_coded else vals.to(F32))
            sumsq[a:b] += (v32 * v32).sum(-1)
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
        if codec.integer_coded:
            bits = coding.quantized_coding_bits(
                n_nz.to(F32), d, vb, codec.dense_map_bits, codec.header_bits)
        elif sel.name == "topk":
            k = float(sel.k_target(d))
            p_sum = torch.full_like(er.p_sum, k)
            bits = (k * (vb + logd) + vb).expand_as(p_sum)
        elif sel.name == "unisp":
            bits = er.nnz.to(F32) * (vb + logd) + vb
        else:
            bits = scheme.message_bits(d, n_a, n_b)
        ok = er.den > 0
        var = torch.where(ok, sumsq / torch.where(ok, er.den, 1.0), 0.0)
        return SparseGrad(values=er.values, idx=er.idx, nnz=er.nnz,
                          p_sum=p_sum, bits=bits, var_ratio=var,
                          scale=er.scale, d=d, codec=codec.name,
                          layout=layout, rice_words=er.rice_words,
                          rice_used=er.rice_used)
