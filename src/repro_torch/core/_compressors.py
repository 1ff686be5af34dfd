"""The gradient compressor zoo (port of ``repro.core._compressors``):
``CompressedGrad``, ``finish_compressed``, the paper's method and its
baselines as registry aliases over the selector ∘ codec schemes, and
``make_compressor``.

Each registry entry maps its options to a ``Scheme``: ``gspar``/``unisp``/
``topk`` are their selector with the f32 codec, ``qsgd`` is identity ∘
qsgd<bits>, ``terngrad`` bernoulli ∘ ternary and ``none`` the identity; any
other composition (``"gspar+qsgd8"``) goes through ``make_compressor``.
Its ``Compressor`` maps ``(generator, g)`` to a ``CompressedGrad`` through
the dense wire's path on one row (``Scheme.compress``: the selector's
float32 uniforms, then an integer codec's, drawn from ``generator`` shaped
like g, where the JAX zoo takes a key), and compresses a ``[rows, d]``
batch of independent messages from given uniforms (``Compressor.rows``:
the JAX zoo's ``vmap`` over workers), one launch per kernel.

The dense wire's groups compress a whole ``[rows, d]`` batch into one
``CompressedGrad`` with every field per row and never materialise p (it is
``min(lam |g|, 1)`` of the row's lambda); a compressor of the zoo returns
one vector with its p, as the JAX one does.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from repro_torch.core import schemes


@dataclasses.dataclass
class CompressedGrad:
    """Q(g) in dense layout plus accounting: per row for a dense-wire group
    (``q [rows, d]``), scalars for one vector of the zoo (``q`` shaped like
    g, with its ``p``)."""
    q: torch.Tensor            # Q(g), the wire dtype (the zoo: g's dtype)
    lam: torch.Tensor | None   # the selector's scalar per row (lambda,
                               # rho or topk's threshold; None: identity)
    bits: torch.Tensor         # realized coding-model bits
    var_ratio: torch.Tensor    # ||q||^2 / ||g||^2 (the paper's var)
    nnz: torch.Tensor          # int64: nonzeros of q
    p: torch.Tensor | None = None   # the zoo: the probabilities sampled


def finish_compressed(q: torch.Tensor, lam, bits: torch.Tensor,
                      sum_sq: torch.Tensor, den: torch.Tensor,
                      nnz: torch.Tensor) -> CompressedGrad:
    """Assemble a CompressedGrad from the kernels' per-row sums: the
    variance ratio is sum q^2 / sum g^2 (0 where g is all zero)."""
    ok = den > 0
    var_ratio = torch.where(ok, sum_sq / torch.where(ok, den, 1.0), 0.0)
    return CompressedGrad(q=q, lam=lam, bits=bits.to(torch.float32),
                          var_ratio=var_ratio, nnz=nnz)


def gspar(*, eps: float = 1.0, algo: str = "greedy", rho: float = 0.1,
          num_iters: int = 2, b: int = 32,
          codec: str | None = None) -> schemes.Scheme:
    """The paper's method: Algorithm 2 (``algo="closed"``, variance budget
    1 + eps) or Algorithm 3 (``algo="greedy"``, density rho, 2 rescales)."""
    return schemes.make_scheme("gspar", codec=codec, eps=eps, algo=algo,
                               rho=rho, num_iters=num_iters, float_bits=b)


def unisp(*, rho: float = 0.1, b: int = 32,
          codec: str | None = None) -> schemes.Scheme:
    """Uniform sampling baseline: p = rho on the support (unbiased)."""
    return schemes.make_scheme("unisp", codec=codec, rho=rho, float_bits=b)


def topk(*, rho: float = 0.1, b: int = 32,
         codec: str | None = None) -> schemes.Scheme:
    """Deterministic top-k by magnitude (biased: pair with error
    feedback); ties at the k-th magnitude by lowest coordinate."""
    return schemes.make_scheme("topk", codec=codec, rho=rho, float_bits=b)


def qsgd(*, bits: int = 4) -> schemes.Scheme:
    """QSGD: identity selection with stochastic quantization to 2^bits - 1
    levels of |g_i| / ||g||_2."""
    return schemes.make_scheme("qsgd", qsgd_bits=bits)


def terngrad(*, b: int = 32) -> schemes.Scheme:
    """TernGrad: Bernoulli(|g_i| / max|g|) selection with the ternary
    codec."""
    return schemes.make_scheme("terngrad", float_bits=b)


def identity(*, b: int = 32) -> schemes.Scheme:
    """No compression (the paper's "baseline")."""
    return schemes.make_scheme("none", float_bits=b)


REGISTRY: dict[str, Callable[..., schemes.Scheme]] = {
    "gspar": gspar,
    "unisp": unisp,
    "topk": topk,
    "qsgd": qsgd,
    "terngrad": terngrad,
    "none": identity,
}


def _generic(*, name: str, rho: float = 0.1, eps: float = 1.0,
             algo: str = "greedy", num_iters: int = 2, b: int = 32,
             bits: int = 4, codec: str | None = None) -> schemes.Scheme:
    return schemes.make_scheme(name, codec=codec, rho=rho, eps=eps,
                               algo=algo, num_iters=num_iters,
                               qsgd_bits=bits, float_bits=b)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A compressor of the zoo with its options bound: ``(generator, g) ->
    CompressedGrad`` for one vector, and ``rows`` for a batch."""
    scheme: schemes.Scheme

    def __call__(self, generator, g) -> CompressedGrad:
        return self.scheme.compress(generator, g)

    def rows(self, g: torch.Tensor, u: torch.Tensor | None = None,
             u_cod: torch.Tensor | None = None) -> CompressedGrad:
        """Each row of ``g [rows, d]`` as its own message (the JAX zoo's
        ``vmap`` over workers), through the dense wire's path in one launch
        per kernel, with the selector's float32 uniforms ``u`` and an
        integer codec's ``u_cod`` (each shaped like g; None where the
        scheme draws none). Per-row accounting; no p."""
        from repro_torch.core.sparse import _finish_rows, dense_group
        return _finish_rows(self.scheme, dense_group(
            self.scheme, u, g, False, u_cod=u_cod), g.shape[1])


def make_compressor(name: str, **kwargs) -> Compressor:
    """The compressor ``name`` (a registry key or a ``selector+codec``
    composition) with its options bound."""
    build = REGISTRY.get(name) or partial(_generic, name=name)
    return Compressor(build(**kwargs))
