"""Compression schemes: selector ∘ value codec (port of the parts of
``repro.core.schemes`` the kernel backend runs).

The selector decides which coordinates travel and owns the sparse wire's
static capacity; the codec (``repro_torch.core.codecs``) owns how each kept
value is represented.

  gspar     -- the paper's method: p = min(lambda |g|, 1), lambda from
               Algorithm 3 (greedy) at target density rho.
  unisp     -- uniform sampling, p = rho on the support (the paper's
               baseline).
  topk      -- deterministic top-k by magnitude, k = round(rho d); biased,
               paired with error feedback.
  bernoulli -- TernGrad's selection, p = |g| / max|g|; its expected nnz is
               data-dependent, so its capacity is d (never truncates).

``terngrad`` is ``bernoulli+ternary``. Algorithm 2's closed form, the
adaptive ``agspar`` and the ``identity`` selector (and with it the ``qsgd``
and ``none`` aliases), which the JAX package runs on its reference
backend, are ROADMAP.md queue A items 1, 3 and 4.
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
    (greedy) at target density ``rho``; ``eps`` is Algorithm 2's variance
    budget, which only ``algo="closed"`` (not ported) reads."""
    rho: float = 0.1
    eps: float = 1.0
    algo: str = "greedy"
    num_iters: int = 2

    name = "gspar"

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class UnispSelector:
    """Uniform sampling baseline: p = rho on the support (unbiased)."""
    rho: float = 0.1

    name = "unisp"

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class TopkSelector:
    """Deterministic top-k by magnitude with a strict k cut (ties at the
    k-th magnitude broken by lowest coordinate, as XLA's ``top_k``);
    never transmits exact zeros."""
    rho: float = 0.1

    name = "topk"

    def k_target(self, d: int) -> int:
        return max(1, int(round(self.rho * d)))

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class BernoulliSelector:
    """TernGrad's selection: Z_i ~ Bern(|g_i| / max|g|); every kept value
    amplifies to sign(g_i) max|g|."""

    name = "bernoulli"

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

    def message_bits(self, d: int, n_sure: torch.Tensor,
                     n_sampled: torch.Tensor) -> torch.Tensor:
        """Realized coding-model bits of one sampled message per row of a
        float-codec gspar or bernoulli message, from its kept coordinates'
        counts with p = 1 (``n_sure``) and p < 1 (``n_sampled``): the
        selectors' ``realized_bits`` in the JAX package. The other
        selectors and the integer codecs are priced by the gather wire's
        accounting (``sparse.KernelBackend._finish``)."""
        if self.selector.name not in ("gspar", "bernoulli") \
                or self.codec.integer_coded:
            raise NotImplementedError(
                f"message_bits of {self.name} from sure/sampled counts")
        return coding.realized_coding_bits(n_sure, n_sampled, d,
                                           self.codec.value_bits)


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
                  algo: str = "greedy", num_iters: int = 2):
    if name == "gspar":
        if algo != "greedy":
            raise NotImplementedError(
                f"gspar algo {algo!r} is not ported yet (ROADMAP.md queue A "
                "item 1: closed_form_lambda and closed_emit)")
        return GsparSelector(rho=rho, eps=eps, algo=algo,
                             num_iters=num_iters)
    if name == "unisp":
        return UnispSelector(rho=rho)
    if name == "topk":
        return TopkSelector(rho=rho)
    if name == "bernoulli":
        return BernoulliSelector()
    if name == "identity":
        raise NotImplementedError(
            "selector 'identity' (and the 'qsgd' and 'none' aliases) runs on "
            "the JAX package's reference backend, which is not ported yet "
            "(ROADMAP.md queue A item 4: ReferenceBackend)")
    if name == "agspar":
        raise NotImplementedError(
            "selector 'agspar' is not ported yet (ROADMAP.md queue A item 3)")
    raise ValueError(f"unknown selector {name!r}; have {SELECTOR_NAMES}")


def make_scheme(name: str, *, codec: str | None = None, rho: float = 0.1,
                eps: float = 1.0, algo: str = "greedy", num_iters: int = 2,
                qsgd_bits: int = 4, float_bits: int = 32) -> Scheme:
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
                               num_iters=num_iters),
        codec=codecs_lib.get(parsed_codec or codec or "f32",
                             float_bits=float_bits))
