"""Compression schemes: selector ∘ value codec (port of the parts of
``repro.core.schemes`` this slice runs).

The selector decides which coordinates travel and owns the sparse wire's
static capacity; the codec (``repro_torch.core.codecs``) owns how each kept
value is represented. This slice has the paper's selector, ``gspar`` with
Algorithm 3's greedy solver, composed with the float codecs. The other
selectors (agspar, unisp, topk, bernoulli, identity) and Algorithm 2's
closed form are ROADMAP.md queue A item 3 and queue B (kernels 3-4's
``rho``/``bern``/``topk`` selectors).
"""
from __future__ import annotations

import dataclasses

from repro_torch.comm.compaction import capacity_for
from repro_torch.core import codecs as codecs_lib

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
    (greedy) at target density ``rho``."""
    rho: float = 0.1
    algo: str = "greedy"
    num_iters: int = 2

    name = "gspar"

    def capacity(self, d: int, slack: float) -> int:
        return capacity_for(d, self.rho, slack)


@dataclasses.dataclass(frozen=True)
class Scheme:
    """selector ∘ codec."""
    selector: GsparSelector
    codec: codecs_lib.FloatCodec

    @property
    def name(self) -> str:
        return f"{self.selector.name}+{self.codec.name}"


def parse_composition(name: str,
                      qsgd_bits: int = 4) -> tuple[str, str | None]:
    """``"gspar+bf16"`` -> ("gspar", "bf16"); legacy monolithic names map
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


def make_scheme(name: str, *, codec: str | None = None, rho: float = 0.1,
                algo: str = "greedy", num_iters: int = 2,
                qsgd_bits: int = 4, float_bits: int = 32) -> Scheme:
    sel_name, parsed_codec = parse_composition(name, qsgd_bits=qsgd_bits)
    if parsed_codec is not None and codec is not None \
            and parsed_codec != codec:
        raise ValueError(f"conflicting codecs: composition {name!r} names "
                         f"{parsed_codec!r} but codec={codec!r} was also "
                         "given")
    if sel_name != "gspar":
        raise NotImplementedError(
            f"selector {sel_name!r} is not ported yet (ROADMAP.md queue A "
            "item 3, queue B: select/compact pkinds rho, bern, topk)")
    if algo != "greedy":
        raise NotImplementedError(
            f"gspar algo {algo!r} is not ported yet (ROADMAP.md queue A "
            "item 1: closed_form_lambda and closed_emit)")
    return Scheme(
        selector=GsparSelector(rho=rho, algo=algo, num_iters=num_iters),
        codec=codecs_lib.get(parsed_codec or codec or "f32",
                             float_bits=float_bits))
