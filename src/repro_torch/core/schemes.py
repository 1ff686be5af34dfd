"""Compression schemes: selector ∘ value codec (port of
``repro.core.schemes``).

The selector decides which coordinates travel and owns the sparse wire's
static capacity; the codec (``repro_torch.core.codecs``) owns how each kept
value is represented.

  gspar     -- the paper's method: p = min(lambda |g|, 1), lambda from
               Algorithm 3 (greedy) at target density rho, or Algorithm 2
               (closed form) at variance budget (1 + eps) sum g^2.
  agspar    -- gspar's greedy solver at a density refit per row from the
               gradient's participation ratio (Deng et al.), at most rho.
  unisp     -- uniform sampling, p = rho on the support (the paper's
               baseline).
  topk      -- deterministic top-k by magnitude, k = round(rho d); biased,
               paired with error feedback.
  bernoulli -- TernGrad's selection, p = |g| / max|g|; its expected nnz is
               data-dependent, so its capacity is d (never truncates).
  identity  -- keep everything (p = 1); with a quantizing codec the dense
               quantizers (``qsgd`` = identity+qsgd<bits>).

``terngrad`` is ``bernoulli+ternary`` and ``none`` is ``identity+f32``.
Every composition runs on the dense wire (``Scheme.compress``,
``sparse.KernelBackend.compress_dense``) and on the sparse wires (agspar
and identity on the reference backend, ``sparse.ReferenceBackend``, as
the JAX package runs them). The probabilities a scheme samples with are
the kernels' (``kernels.sparsify.ops``); the pure solvers of the JAX
selectors are ``repro_torch.core.sparsify``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm.compaction import capacity_for
from repro_torch.core import codecs as codecs_lib
from repro_torch.core import coding

SELECTOR_NAMES = ("gspar", "agspar", "unisp", "topk", "bernoulli",
                  "identity")
LEGACY_ALIASES = {
    "qsgd": ("identity", "__qsgd_bits__"),
    "terngrad": ("bernoulli", "ternary"),
    "none": ("identity", None),
}


@dataclasses.dataclass(frozen=True)
class GsparSelector:
    """The paper's method: p = min(lambda |g|, 1), lambda from Algorithm 3
    (``algo="greedy"``) at target density ``rho`` or Algorithm 2
    (``algo="closed"``) at variance budget ``(1 + eps) sum g^2``."""
    rho: float = 0.1
    eps: float = 1.0
    algo: str = "greedy"
    num_iters: int = 2

    name = "gspar"
    samples = True

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class AdaptiveGsparSelector:
    """gspar's greedy solver at a density fitted per row (per layer of a
    stacked leaf) from the participation ratio ``s = ||g||_1^2 /
    ||g||_2^2``: ``rho_eff = clip(gain s / d, floor rho, rho)``
    (``ops.fitted_rho``). ``rho`` stays the ceiling, so the capacity is
    sized from it."""
    rho: float = 0.1
    num_iters: int = 2
    density_gain: float = 1.0
    density_floor: float = 0.1

    name = "agspar"
    samples = True

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class UnispSelector:
    """Uniform sampling baseline: p = rho on the support (unbiased)."""
    rho: float = 0.1

    name = "unisp"
    samples = True

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class TopkSelector:
    """Deterministic top-k by magnitude with a strict k cut (ties at the
    k-th magnitude broken by lowest coordinate, as XLA's ``top_k``);
    never transmits exact zeros."""
    rho: float = 0.1

    name = "topk"
    samples = False

    def k_target(self, d: int) -> int:
        return max(1, int(round(self.rho * d)))

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class BernoulliSelector:
    """TernGrad's selection: Z_i ~ Bern(|g_i| / max|g|); every kept value
    amplifies to sign(g_i) max|g|."""

    name = "bernoulli"
    samples = True

    def capacity(self, d: int, slack: float) -> int:
        del slack
        return d


@dataclasses.dataclass(frozen=True)
class IdentitySelector:
    """Keep every coordinate (p = 1): alone the identity compressor, with a
    quantizing codec the dense quantizers."""

    name = "identity"
    samples = False

    def capacity(self, d: int, slack: float) -> int:
        del slack
        return d


@dataclasses.dataclass(frozen=True)
class Scheme:
    """selector ∘ codec."""
    selector: object
    codec: object

    @property
    def name(self) -> str:
        return f"{self.selector.name}+{self.codec.name}"

    def message_bits(self, d: int, nnz: torch.Tensor,
                     n_sure: torch.Tensor) -> torch.Tensor:
        """Realized coding-model bits of one sampled message per row, from
        the count of its transmitted coordinates (``nnz``) and of those
        with p = 1 (``n_sure``), by the JAX package's rules: an integer
        codec's levels (``coding.quantized_coding_bits``); gspar, agspar
        and bernoulli the sure-vs-sampled hybrid code
        (``coding.realized_coding_bits``); unisp ``nnz (b + log2 d) + b``;
        topk its fixed ``k_target (b + log2 d) + b``; identity ``d b``."""
        codec, sel = self.codec, self.selector
        vb = codec.value_bits
        nnz = nnz.to(torch.float32)
        if codec.integer_coded:
            return coding.quantized_coding_bits(
                nnz, d, vb, codec.dense_map_bits, codec.header_bits)
        if sel.name in ("gspar", "agspar", "bernoulli"):
            return coding.realized_coding_bits(n_sure, nnz - n_sure.to(
                torch.float32), d, vb)
        logd = torch.log2(torch.tensor(float(d), dtype=torch.float32,
                                       device=nnz.device))
        if sel.name == "unisp":
            return nnz * (vb + logd) + vb
        if sel.name == "topk":
            return (float(sel.k_target(d)) * (vb + logd) + vb).expand_as(nnz)
        return torch.full_like(nnz, coding.dense_coding_bits(d, int(vb)))

    def compress(self, generator: torch.Generator, g: torch.Tensor):
        """``(generator, g) -> CompressedGrad`` on the dense wire's path,
        one row: the selector's float32 uniforms shaped like g (sampling
        selectors), then an integer codec's. The JAX package's
        ``Scheme.compress(key, g)``."""
        from repro_torch.core.sparse import compress_vector
        return compress_vector(self, generator, g)


def parse_composition(name: str,
                      qsgd_bits: int = 4) -> tuple[str, str | None]:
    """``"gspar+qsgd8"`` -> ("gspar", "qsgd8"); legacy monolithic names map
    onto their (selector, codec) factorization."""
    parts = name.split("+")
    if len(parts) > 2:
        raise ValueError(f"malformed composition {name!r}; "
                         "expected 'selector' or 'selector+codec'")
    head, codec = parts[0], (parts[1] if len(parts) == 2 else None)
    if head in LEGACY_ALIASES:
        sel, legacy_codec = LEGACY_ALIASES[head]
        if legacy_codec == "__qsgd_bits__":
            legacy_codec = f"qsgd{qsgd_bits}"
        if codec is not None:
            raise ValueError(f"{head!r} is a legacy monolithic scheme name; "
                             f"it cannot take another codec ({name!r})")
        return sel, legacy_codec
    if head not in SELECTOR_NAMES:
        raise ValueError(f"unknown selector {head!r} in composition "
                         f"{name!r}; have {SELECTOR_NAMES}")
    return head, codec


def make_selector(name: str, *, rho: float = 0.1, eps: float = 1.0,
                  algo: str = "greedy", num_iters: int = 2,
                  density_gain: float = 1.0, density_floor: float = 0.1):
    if name == "gspar":
        if algo not in ("greedy", "closed"):
            raise ValueError(f"unknown gspar algo: {algo!r}")
        return GsparSelector(rho=rho, eps=eps, algo=algo,
                             num_iters=num_iters)
    if name == "agspar":
        return AdaptiveGsparSelector(rho=rho, num_iters=num_iters,
                                     density_gain=density_gain,
                                     density_floor=density_floor)
    if name == "unisp":
        return UnispSelector(rho=rho)
    if name == "topk":
        return TopkSelector(rho=rho)
    if name == "bernoulli":
        return BernoulliSelector()
    if name == "identity":
        return IdentitySelector()
    raise ValueError(f"unknown selector {name!r}; have {SELECTOR_NAMES}")


def make_scheme(name: str, *, codec: str | None = None, rho: float = 0.1,
                eps: float = 1.0, algo: str = "greedy", num_iters: int = 2,
                qsgd_bits: int = 4, float_bits: int = 32,
                density_gain: float = 1.0,
                density_floor: float = 0.1) -> Scheme:
    """Build a Scheme from a composition name; ``codec`` and a ``+codec``
    suffix in ``name`` must agree."""
    sel_name, parsed_codec = parse_composition(name, qsgd_bits=qsgd_bits)
    if parsed_codec is not None and codec is not None \
            and parsed_codec != codec:
        raise ValueError(f"conflicting codecs: composition {name!r} names "
                         f"{parsed_codec!r} but codec={codec!r} was also "
                         "given")
    return Scheme(
        selector=make_selector(sel_name, rho=rho, eps=eps, algo=algo,
                               num_iters=num_iters,
                               density_gain=density_gain,
                               density_floor=density_floor),
        codec=codecs_lib.get(parsed_codec or codec or "f32",
                             float_bits=float_bits))
