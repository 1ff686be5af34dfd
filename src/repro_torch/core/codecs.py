"""Value codecs (port of ``repro.core.codecs``, float codecs only).

A codec owns the wire representation of the kept values: the dtype the
collective moves, the per-value bit cost in the coding model, and the
encode/decode pair. This slice carries the float codecs:

  f32  -- passthrough at the leaf dtype; ``value_bits`` is the coding
          model's float width b (accounting only, it never rounds the wire).
  bf16 -- round kept values to bfloat16.

The integer codecs (qsgd<N>, ternary) are ROADMAP.md queue A item 2 and
queue B (kernel 4's fused integer encode).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FloatCodec:
    """Float passthrough (``rounding=False``, wire dtype = leaf dtype) or
    bf16 rounding (``rounding=True``)."""
    bits: int = 32
    rounding: bool = False

    scale_kind = "none"          # no per-message scale (see finalize_scale)

    @property
    def name(self) -> str:
        return "bf16" if self.rounding else "f32"

    @property
    def value_bits(self) -> float:
        return float(self.bits)

    @property
    def rounds_values(self) -> bool:
        return self.rounding

    def wire_dtype(self, leaf_dtype: torch.dtype) -> torch.dtype:
        return torch.bfloat16 if self.rounding else leaf_dtype

    def decode(self, wire_vals: torch.Tensor, scale=None) -> torch.Tensor:
        return wire_vals.to(torch.float32)


def finalize_scale(codec, sum_sq: torch.Tensor,
                   max_abs: torch.Tensor) -> torch.Tensor:
    """Fold pass 1's streaming statistics into the codec's per-message
    scale: "l2" -> sqrt(sum v^2), "max" -> max|v|, else ones."""
    if codec.scale_kind == "l2":
        return torch.sqrt(sum_sq.to(torch.float32))
    if codec.scale_kind == "max":
        return max_abs.to(torch.float32)
    return torch.ones_like(sum_sq, dtype=torch.float32)


def get(name: str, float_bits: int = 32) -> FloatCodec:
    """Codec registry lookup."""
    if name in ("f32", "fp32", "float32"):
        return FloatCodec(bits=float_bits, rounding=False)
    if name == "bf16":
        return FloatCodec(bits=16, rounding=True)
    if name == "ternary" or name.startswith("qsgd"):
        raise NotImplementedError(
            f"codec {name!r} is not ported yet (ROADMAP.md queue A item 2 "
            "and queue B: integer codecs in kernel 4)")
    raise ValueError(f"unknown value codec {name!r}; have ('f32', 'bf16')")
