"""Causal GQA/MQA attention with RoPE, the naive train path (port of
``repro.models.attention``: ``AttnConfig``, ``_qkv``, ``_sdpa``,
``_proj_out`` and ``attention_train``). Scores and the softmax run in
float32; the probabilities are cast to the value dtype before the second
product, as in JAX. Weights keep the JAX layout: ``wq [d, h, hd]``,
``wk``/``wv [d, kv, hd]``, ``wo [h, hd, d]``.

Chunked (flash-style) attention, sliding windows, softcaps, biases and the
prefill/decode caches are ROADMAP.md queue A item 10.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import apply_rope, rope_table

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.5


def causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    return (j <= i)[None]                               # [1, Sq, Sk]


def _sdpa(q, k, v, mask):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D], mask [1,Sq,Sk] bool."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    q = q.reshape(b, sq, kvh, groups, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, d)


def attention_train(wq, wk, wv, wo, cfg: AttnConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention on x [B, S, d]."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, wq) * cfg.scale
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    sin, cos = rope_table(torch.arange(s, device=x.device), cfg.head_dim,
                          cfg.rope_theta)
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    out = _sdpa(q, k, v, causal_mask(s, s, x.device))
    return torch.einsum("bshk,hkd->bsd", out, wo)
