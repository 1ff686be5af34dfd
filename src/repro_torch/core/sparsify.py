"""Unbiased gradient sparsification, the pure solvers (port of
``repro.core.sparsify``).

    Q(g)_i = Z_i g_i / p_i,   Z_i ~ Bernoulli(p_i)

The paper's two probability solvers, ``closed_form_probabilities``
(Algorithm 2: optimal for the variance budget ``(1 + eps) sum g^2``, from a
sort) and ``greedy_probabilities`` (Algorithm 3: sort-free, rescaled toward
density rho), the baseline ``uniform_probabilities`` (UniSp), and the
sampling itself. 0/0 is 0: an exactly-zero coordinate gets p = 0 and Q = 0.

The randomness is an input: ``sample_mask`` and ``sparsify`` take float32
uniforms shaped like p (the JAX functions take a key), so the same numpy
draws reproduce the JAX package's masks bit for bit. Sums run in float64
and round to float32 once, so the scalars agree with the JAX package's
float32 reductions within their rounding (tests: rtol 1e-6).

``closed_form_lambda`` is the plain solve: one descending sort of a vector
and two reversed cumulative sums. ``closed_form_lambda_rows`` gives the same
scalar for every row of a ``[rows, d]`` shape group: a bfloat16 group from
its magnitude histogram (one read of g, the ``topk_threshold`` kernel's
histogram pass on the card) with no sort, a float32 group with the plain
solve one row at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sparsify import ref

F32 = torch.float32
F64 = torch.float64


def _safe_div(num, den: torch.Tensor) -> torch.Tensor:
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def closed_form_lambda(g: torch.Tensor, eps: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2's scalar ``(lambda, any_ok)`` for the variance budget
    ``(1 + eps) sum g^2``: the smallest k (in descending order of |g|) with

        |g_(k)| sum_{i>=k} |g_(i)|  <=  eps sum g^2 + sum_{i>=k} g_(i)^2

    and ``lambda = sum_{i>=k} |g_(i)| / (eps sum g^2 + sum_{i>=k} g_(i)^2)``
    (float32; the sums in float64). The tail sums accumulate from the small
    end (reversed cumulative sums), as in the JAX package: ``total -
    prefix`` would cancel on the tiny tails that decide k. ``any_ok`` is
    the feasibility bit, always true for eps >= 0."""
    a = g.reshape(-1).to(F32).abs()
    d = a.numel()
    s = torch.sort(a, descending=True).values.to(F64)
    tail_l1 = torch.cumsum(s.flip(0), 0).flip(0)
    tail_l2 = torch.cumsum((s * s).flip(0), 0).flip(0)
    budget = eps * tail_l2[0] + tail_l2
    cond = s * tail_l1 <= budget
    any_ok = cond.any()
    k = int(torch.argmax(cond.to(torch.int8))) if bool(any_ok) else d - 1
    lam = torch.where(any_ok, _safe_div(tail_l1[k], budget[k]), 0.0)
    return lam.to(F32), any_ok


def closed_form_lambda_rows(g2d: torch.Tensor, eps: float,
                            counts: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """``closed_form_lambda`` of every row of a ``[rows, d]`` group, float32
    ``[rows]``: the lambda of the gather and dense wires' ``algo="closed"``
    (``ops.closed_emit``, ``ops.closed_dense``).

    A bfloat16 row needs no sort. Its bins hold one value each, so the
    condition is constant over a bin's run in descending order and k* is
    the first position of the highest bin where it holds; the counts alone
    give every sum (``ref.closed_lambda_bins_ref``): ``counts [rows,
    2^15]`` (``kernel.magnitude_hist``) or ``torch.bincount`` of the keys.
    A float32 row is solved by ``closed_form_lambda``, one row at a time.
    Rows where the condition never holds (eps < 0) get 0, as the JAX
    package's fused path takes ``lambda = 0`` there."""
    rows, dev = g2d.shape[0], g2d.device
    if g2d.dtype != torch.bfloat16:
        lam = torch.empty(rows, dtype=F32, device=dev)
        for r in range(rows):
            lam[r] = closed_form_lambda(g2d[r], eps)[0]
        return lam
    if counts is None:
        counts = ref.magnitude_counts(g2d)
    return ref.closed_lambda_bins_ref(counts, eps)[0]


def closed_form_probabilities(g: torch.Tensor, eps: float) -> torch.Tensor:
    """Algorithm 2: ``p = min(lambda |g|, 1)``; all of the support where the
    condition never holds; 0 off the support."""
    a = g.reshape(-1).to(F32).abs()
    lam, any_ok = closed_form_lambda(a, eps)
    p = torch.clamp_max(lam * a, 1.0)
    p = torch.where(any_ok, p, torch.ones_like(p))
    return torch.where(a > 0, p, 0.0).reshape(g.shape)


def greedy_probabilities(g: torch.Tensor, rho, num_iters: int = 2
                         ) -> torch.Tensor:
    """Algorithm 3: ``p0 = min(rho d |g| / ||g||_1, 1)``, then ``num_iters``
    rescales of the unsaturated set toward ``sum p = rho d`` (``rho`` a
    float or a float32 scalar tensor)."""
    a = g.reshape(-1).to(F32).abs()
    d_f = torch.tensor(float(a.numel()), dtype=F32, device=a.device)
    rho_d = torch.as_tensor(rho, dtype=F32, device=a.device) * d_f
    p = torch.clamp_max(_safe_div(rho_d * a, a.sum(dtype=F64).to(F32)), 1.0)
    for _ in range(num_iters):
        active = p < 1.0
        n_active = active.sum().to(F32)
        target = rho_d - (d_f - n_active)
        c = _safe_div(target, torch.where(active, p, 0.0).sum(
            dtype=F64).to(F32))
        p = torch.clamp_max(torch.clamp_min(c, 1.0) * p, 1.0)
    return torch.where(a > 0, p, 0.0).reshape(g.shape)


def uniform_probabilities(g: torch.Tensor, rho: float) -> torch.Tensor:
    """UniSp: ``p = rho`` on the support, 0 off it."""
    p = torch.full(g.shape, rho, dtype=F32, device=g.device)
    return torch.where(g.abs() > 0, p, 0.0)


def sample_mask(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``Z = [u < p]`` as {0, 1} in p's dtype, from float32 uniforms ``u``
    shaped like p."""
    return (u < p).to(p.dtype)


def apply_mask(g: torch.Tensor, p: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """``Q(g) = Z g / p`` (0/0 = 0), in g's dtype."""
    return (z * _safe_div(g.to(F32), p)).to(g.dtype)


def sparsify(u: torch.Tensor, g: torch.Tensor,
             p: torch.Tensor) -> torch.Tensor:
    """One sample of Q(g) for the probabilities p and the uniforms u."""
    return apply_mask(g, p, sample_mask(u, p))


def expected_density(p: torch.Tensor) -> torch.Tensor:
    """``E ||Q(g)||_0 / d = mean(p)``."""
    return p.to(F32).mean(dtype=F64).to(F32)


def variance_inflation(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``E||Q(g)||^2 / ||g||^2 = (sum g^2 / p) / sum g^2``, at least 1."""
    g = g.reshape(-1).to(F32)
    p = p.reshape(-1)
    num = torch.where(p > 0, _safe_div(g * g, p), 0.0).sum(dtype=F64)
    return _safe_div(num, (g * g).sum(dtype=F64)).to(F32)
