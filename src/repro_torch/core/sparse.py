"""Compact sparse-gradient representation and the kernel backend (port of
``repro.core.sparse``: ``SparseGrad`` and the counterpart of
``PallasBackend``).

``SparseGrad`` is the wire form of one compressed shape group: fixed-
capacity ``values [rows, k_cap]`` (codec-encoded, wire dtype) and ``idx
[rows, k_cap]`` (int32, ascending per row; padding slots idx 0 / value 0),
under the RICE layout also the index words the kernel packed, plus per-row
accounting. Selection happens once, in the backend; the sync layer ships
the buffers as they are.

``KernelBackend`` runs the two-pass emit of ``repro_torch.kernels.sparsify``
on a whole group: the CUDA kernels for tensors on the card, their plain
PyTorch versions for tensors on the CPU. The reference backend of the JAX
package (dense apply plus a magnitude ``top_k``) is a different algorithm
and is ROADMAP.md queue A item 4.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import wire_layout
from repro_torch.core import coding
from repro_torch.kernels.sparsify import ops

F32 = torch.float32


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


def _choose_layout(cfg, codec, leaf_dtype, k_cap: int, d: int) -> str:
    return wire_layout.choose(
        k_cap, d, wire_layout.value_bits_of(codec.wire_dtype(leaf_dtype)),
        cfg.wire_layout)


class KernelBackend:
    """Two-pass emit on the sparsify kernels, one launch per kernel per
    shape group: pass 1 reduces survivor counts and the codec-scale
    statistics, pass 2 writes the compact wire buffers (and, with error
    feedback, the residual ``g - wire value`` in the same pass). Everything
    after the kernels is O(rows * k_cap) accounting."""

    def compress_sparse(self, cfg, u: torch.Tensor, g: torch.Tensor,
                        k_cap: int) -> SparseGrad:
        er, layout, lam = self._emit(cfg, u, g, k_cap, ef=False)
        return self._finish(cfg.scheme(), g, er, layout, lam)

    def compress_sparse_ef(self, cfg, u: torch.Tensor, g: torch.Tensor,
                           k_cap: int) -> tuple[SparseGrad, torch.Tensor]:
        """``g`` is the EF target (gradient plus carried residual); also
        returns the new residual ``g - wire value``. Every sampled survivor
        is subtracted, so on overflow the dropped ones leave the residual
        too (the fused-EF semantics of the TPU kernel)."""
        er, layout, lam = self._emit(cfg, u, g, k_cap, ef=True)
        return self._finish(cfg.scheme(), g, er, layout, lam), er.residual

    def _emit(self, cfg, u, g, k_cap, ef: bool):
        """Run gspar_emit on one ``[rows, d]`` group with the uniforms
        ``u``. Returns the EmitResult, the wire layout and lambda."""
        scheme = cfg.scheme()
        sel, codec = scheme.selector, scheme.codec
        d = g.shape[1]
        # the layout is static in (k_cap, d, wire width), so it is decided
        # before the kernels: under RICE they pack the index words too
        layout = _choose_layout(cfg, codec, g.dtype, k_cap, d)
        rice_r = coding.rice_parameter(k_cap, d) if layout == "rice" else -1
        er, lam = ops.gspar_emit(g, u, k_cap=k_cap, rho=sel.rho,
                                 num_iters=sel.num_iters, codec=codec,
                                 rice_r=rice_r, ef=ef)
        return er, layout, lam

    def _finish(self, scheme, g, er, layout, lam) -> SparseGrad:
        """Per-row accounting from the kernel's reductions and the compact
        buffers: the variance ratio, and the coding-model bits from the
        sure-vs-sampled split of the kept coordinates (p at the kept
        coordinates is one gather)."""
        codec = scheme.codec
        d = g.shape[1]
        v32 = er.values.to(F32)
        den = er.den
        ok = den > 0
        var = torch.where(ok, (v32 * v32).sum(-1) / torch.where(ok, den, 1.0),
                          0.0)
        vb = codec.value_bits
        logd = torch.log2(torch.tensor(float(d), dtype=F32,
                                       device=g.device))
        a_idx = torch.gather(g, 1, er.idx.long()).to(F32).abs()
        p_idx = torch.clamp_max(lam[:, None] * a_idx, 1.0)
        valid = v32 != 0
        sure = p_idx >= 1.0
        n_a = (valid & sure).sum(-1).to(F32)
        n_b = (valid & ~sure).sum(-1).to(F32)
        bits = (n_a * (vb + logd)
                + coding.hybrid_branch_bits(n_b, d, logd, 2.0) + vb)
        return SparseGrad(values=er.values, idx=er.idx, nnz=er.nnz,
                          p_sum=er.p_sum, bits=bits, var_ratio=var,
                          scale=er.scale, d=d, codec=codec.name,
                          layout=layout, rice_words=er.rice_words,
                          rice_used=er.rice_used)
