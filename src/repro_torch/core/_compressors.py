"""A compressed gradient in dense layout (port of the part of
``repro.core._compressors`` the dense wire uses: ``CompressedGrad`` and
``finish_compressed``).

The JAX package compresses one leaf (a layer of a stacked leaf under vmap)
at a time and keeps the probability vector p. Here a whole ``[rows, d]``
shape group is one ``CompressedGrad``, every field per row, and p is
``min(lam |g|, 1)`` of the row's lambda: it is never materialised. The
registry of compressor names is ``repro_torch.core.schemes``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CompressedGrad:
    """One group compressed in dense layout, plus per-row accounting."""
    q: torch.Tensor            # [rows, d] Q(g), the wire dtype
    lam: torch.Tensor          # [rows] p = min(lam |g|, 1)
    bits: torch.Tensor         # [rows] realized coding-model bits
    var_ratio: torch.Tensor    # [rows] ||q||^2 / ||g||^2 (the paper's var)
    nnz: torch.Tensor          # [rows] int64: nonzeros of q


def finish_compressed(q: torch.Tensor, lam: torch.Tensor, bits: torch.Tensor,
                      sum_sq: torch.Tensor, den: torch.Tensor,
                      nnz: torch.Tensor) -> CompressedGrad:
    """Assemble a CompressedGrad from the kernels' per-row sums: the
    variance ratio is sum q^2 / sum g^2 (0 where g is all zero)."""
    ok = den > 0
    var_ratio = torch.where(ok, sum_sq / torch.where(ok, den, 1.0), 0.0)
    return CompressedGrad(q=q, lam=lam, bits=bits.to(torch.float32),
                          var_ratio=var_ratio, nnz=nnz)
