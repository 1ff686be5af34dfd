"""Norms, rotary embeddings, the gated and plain MLPs, the tied embedding
and the logit softcap (port of ``repro.models.layers``), with the JAX
package's numerics:

- RMSNorm computes in float32 and scales by ``1 + scale`` (gemma);
- LayerNorm computes in float32 with the population variance, eps 1e-5,
  then ``scale`` and ``bias`` (starcoder2);
- RoPE rotates half-split pairs (``x[:half]``, ``x[half:]``), float32
  tables, result cast back to the input dtype;
- ``jax.nn.gelu`` is the tanh approximation by default;
- the embedding is scaled by sqrt(d_model) rounded to the parameter dtype.

Past one model worker (``dist.tensor_parallel``, a ``ModelAxis`` passed as
``model_axis``) the MLPs take this worker's shards: ``gate``, ``up`` (and
``up_b``) column-parallel over the hidden width, ``down`` row-parallel,
its product summed over the model workers before ``down_b``, whole, is
added once; the embedding and the tied unembedding take this worker's
rows of the table (``vocab``: the axis and the first row), the logits
then its vocab shard. Their input goes in and their products out through
``tensor_parallel.columns`` and ``row``, which keep the partials in
float32 until their sum, so that each sum rounds once as the whole
product does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp

F32 = torch.float32

# the logical axes of each leaf (``repro.models.layers``' init functions):
# a norm's scale and bias, the MLPs' leaves, the embedding table
NORM_AXES = {"scale": ("embed",), "bias": ("embed",)}
GATED_MLP_AXES = {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
                  "down": ("mlp", "embed")}
DENSE_MLP_AXES = {"up": ("embed", "mlp"), "up_b": ("mlp",),
                  "down": ("mlp", "embed"), "down_b": ("embed",)}
EMBED_AXES = {"table": ("vocab", "embed")}


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(F32)
    var = (x32 * x32).mean(-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.to(F32))).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(F32)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.to(F32) + bias.to(F32)).to(x.dtype)


def scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``value`` rounded to ``dtype``, filled on
    ``device`` (``torch.tensor`` would copy it from the host, and a copy
    to the card waits for the card's queue to drain)."""
    return torch.full((), value, dtype=dtype, device=device)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [S] -> (sin, cos) [S, head_dim/2], float32."""
    half = head_dim // 2
    exponent = -torch.arange(half, dtype=F32, device=positions.device) / half
    freq = torch.pow(scalar(theta, F32, positions.device), exponent)
    angles = positions.to(F32)[..., None] * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] with (sin, cos) [S, D/2], broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def gated_mlp(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
              x: torch.Tensor, act: str = "gelu",
              model_axis=None) -> torch.Tensor:
    """GeGLU (gemma) / SwiGLU; with ``model_axis`` on this worker's
    shards (module docstring)."""
    h_gate, h_up = (tp.columns([(x, gate), (x, up)], model_axis)
                    if model_axis is not None else (x @ gate, x @ up))
    h_gate = (F.gelu(h_gate, approximate="tanh") if act == "gelu"
              else F.silu(h_gate))
    h = h_gate * h_up
    return h @ down if model_axis is None else tp.row(h, down, model_axis)


def dense_mlp(up: torch.Tensor, up_b: torch.Tensor, down: torch.Tensor,
              down_b: torch.Tensor, x: torch.Tensor,
              act: str = "gelu", model_axis=None) -> torch.Tensor:
    """The plain two-layer MLP with biases (starcoder2); with
    ``model_axis`` on this worker's shards, ``down_b`` added once after
    the sum."""
    h = (x @ up if model_axis is None
         else tp.columns([(x, up)], model_axis)[0]) + up_b
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    out = h @ down if model_axis is None else tp.row(h, down, model_axis)
    return out + down_b


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``tanh(x / cap) * cap`` in x's dtype (gemma2's logit caps); the
    divisor is a 0-d tensor of x's dtype on its device, since PyTorch's
    CUDA division by a Python number multiplies by its reciprocal."""
    if cap is None:
        return x
    c = scalar(cap, x.dtype, x.device)
    return torch.tanh(x / c) * c


def embed(table: torch.Tensor, tokens: torch.Tensor,
          scale: bool = False, vocab=None) -> torch.Tensor:
    """``table[tokens]``; ``vocab`` ``(axis, lo)``: ``table`` holds rows
    ``lo ..`` of the whole table (``tensor_parallel.vocab_embed``)."""
    x = table[tokens] if vocab is None else tp.vocab_embed(table, tokens,
                                                           *vocab)
    if scale:
        x = x * scalar(x.shape[-1] ** 0.5, x.dtype, x.device)
    return x


def unembed(table: torch.Tensor, x: torch.Tensor,
            model_axis=None) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T (with ``model_axis``, the
    logits of this worker's rows of the table)."""
    if model_axis is not None:
        return tp.columns([(x, table.T)], model_axis)[0]
    return x @ table.T
