"""Value codecs (port of ``repro.core.codecs``).

A codec owns the wire representation of the kept values: the dtype the
collective moves, the per-value bit cost in the coding model, and the
encode/decode pair between full-precision values and that representation.

  f32     -- passthrough at the leaf dtype; ``value_bits`` is the coding
             model's float width b (accounting only, it never rounds the
             wire).
  bf16    -- round kept values to bfloat16.
  qsgd<N> -- QSGD stochastic levels of ``|v| / ||v||_2`` at ``s = 2^N - 1``
             levels; signed integer levels on the wire (int8 while ``s <=
             127``, else int16) plus one float32 scale per message (row).
  ternary -- TernGrad: stochastic rounding to ``{-scale, 0, +scale}`` with
             ``scale = max|v|``; int8 signs plus one float32 scale.

Encode is elementwise given the per-row ``scale`` and one uniform per value
(the codec's pregenerated uniforms, gathered at compact rank by the
kernel), so encoding inside the compact write equals encoding the compact
buffer. The arithmetic is the JAX package's, operation for operation:
the CUDA kernel repeats it without contraction, so the levels agree bit for
bit. ``finalize_scale`` turns pass 1's streaming statistics into the scale.

On the dense wire the scale is over v rounded to the leaf dtype
(``Scheme.apply_dense`` casts v before the codec sees it): pass 1 with
``round_v`` reduces it there, so on bfloat16 leaves it differs from the
gather wire's, which pass 1 reduces over float32 v.
"""
from __future__ import annotations

import dataclasses
import re

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class FloatCodec:
    """Float passthrough (``rounding=False``, wire dtype = leaf dtype) or
    bf16 rounding (``rounding=True``)."""
    bits: int = 32
    rounding: bool = False

    scale_kind = "none"          # no per-message scale (see finalize_scale)
    stochastic = False
    has_scale = False
    integer_coded = False
    dense_map_bits = None
    header_bits = 0.0

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
        return wire_vals.to(F32)


def _safe_ratio(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``where(scale > 0, a / where(scale > 0, scale, 1), 0)``."""
    ok = scale > 0
    return torch.where(ok, a / torch.where(ok, scale, 1.0), 0.0)


@dataclasses.dataclass(frozen=True)
class QsgdCodec:
    """QSGD levels over the kept values: ``level ~ round(s |v| / scale)``
    with ``scale = ||v||_2``, signed integer levels on the wire, decode =
    ``level * (scale / s)``."""
    bits: int = 8

    header_bits = 32.0           # the scale float
    stochastic = True
    has_scale = True
    integer_coded = True
    rounds_values = True
    scale_kind = "l2"

    def __post_init__(self):
        if not 1 <= self.bits <= 14:
            raise ValueError(f"qsgd bits must be in [1, 14], got {self.bits}")

    @property
    def name(self) -> str:
        return f"qsgd{self.bits}"

    @property
    def levels(self) -> float:
        return float(2 ** self.bits - 1)

    @property
    def value_bits(self) -> float:
        return float(self.bits)      # the sign folds into the signed level

    @property
    def dense_map_bits(self) -> float:
        return float(self.bits)      # dense level map, one entry per coord

    def wire_dtype(self, leaf_dtype: torch.dtype) -> torch.dtype:
        return torch.int8 if self.levels <= 127 else torch.int16

    def encode(self, vals: torch.Tensor, scale: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
        v = vals.to(F32)
        scaled = _safe_ratio(v.abs(), scale) * self.levels
        lo = torch.floor(scaled)
        frac = scaled - lo
        level = lo + (u < frac).to(F32)
        return (torch.sign(v) * level).to(self.wire_dtype(vals.dtype))

    def decode(self, wire_vals: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
        # scale / s as an IEEE quotient on any device: the divisor is a
        # tensor, as PyTorch's CUDA division by a Python number multiplies
        # by its rounded reciprocal instead
        s = scale.to(F32)
        return wire_vals.to(F32) * (s / torch.full_like(s, self.levels))


@dataclasses.dataclass(frozen=True)
class TernaryCodec:
    """TernGrad values: stochastic rounding of kept values to ``{-scale,
    0, +scale}``, ``scale = max|v|``; int8 signs on the wire."""

    name = "ternary"
    value_bits = 1.0                 # one sign bit per kept value
    dense_map_bits = 2.0             # the dense ternary map of section 3.3
    header_bits = 32.0               # the scale float
    stochastic = True
    has_scale = True
    integer_coded = True
    rounds_values = True
    scale_kind = "max"

    def wire_dtype(self, leaf_dtype: torch.dtype) -> torch.dtype:
        return torch.int8

    def encode(self, vals: torch.Tensor, scale: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
        v = vals.to(F32)
        keep = u < _safe_ratio(v.abs(), scale)
        return (torch.sign(v) * keep.to(F32)).to(torch.int8)

    def decode(self, wire_vals: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
        return wire_vals.to(F32) * scale.to(F32)


def finalize_scale(codec, sum_sq: torch.Tensor,
                   max_abs: torch.Tensor) -> torch.Tensor:
    """Fold pass 1's streaming statistics into the codec's per-message
    scale: "l2" -> sqrt(sum v^2), "max" -> max|v|, else ones."""
    if codec.scale_kind == "l2":
        return torch.sqrt(sum_sq.to(F32))
    if codec.scale_kind == "max":
        return max_abs.to(F32)
    return torch.ones_like(sum_sq, dtype=F32)


_QSGD_RE = re.compile(r"^qsgd(\d+)$")
CODEC_NAMES = ("f32", "bf16", "qsgd4", "qsgd8", "ternary")


def get(name: str, float_bits: int = 32):
    """Codec registry lookup. ``f32`` carries ``float_bits`` as the coding
    model's b (accounting only); ``bf16`` is the codec that rounds."""
    if name in ("f32", "fp32", "float32"):
        return FloatCodec(bits=float_bits, rounding=False)
    if name == "bf16":
        return FloatCodec(bits=16, rounding=True)
    if name == "ternary":
        return TernaryCodec()
    m = _QSGD_RE.match(name)
    if m:
        return QsgdCodec(bits=int(m.group(1)))
    raise ValueError(f"unknown value codec {name!r}; have "
                     "('f32', 'bf16', 'qsgd<bits>', 'ternary')")
