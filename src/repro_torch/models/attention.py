"""Causal GQA/MQA attention with RoPE, sliding windows, logit softcaps and
biases, the naive train path (port of ``repro.models.attention``:
``AttnConfig``, ``causal_mask``, ``_qkv``, ``_sdpa``, ``_proj_out`` and
``attention_train``). Scores and the softmax run in float32, the softcap
on the float32 scores before the mask; the probabilities are cast to the
value dtype before the second product, as in JAX. Weights keep the JAX
layout: ``wq [d, h, hd]``, ``wk``/``wv [d, kv, hd]``, ``wo [h, hd, d]``,
biases ``bq [h, hd]``, ``bk``/``bv [kv, hd]``, ``bo [d]``.

The query scale multiplies q in q's dtype by the scale rounded to that
dtype first, as JAX multiplies by a weakly typed Python float (in bf16,
gemma2-27b's 144^-0.5 and starcoder2's 128^-0.5 are not exact).

Chunked (flash-style) attention (``impl="chunked"``, the dry-run's
``--attn-impl``) is ROADMAP.md queue A item 13; the prefill/decode caches
and cross-attention are item 10.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import apply_rope, rope_table, softcap

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (None = global)
    logit_softcap: float | None = None
    query_scale: float | None = None   # default head_dim ** -0.5
    use_bias: bool = False
    use_rope: bool = True
    impl: str = "naive"

    def __post_init__(self):
        if self.impl != "naive":
            raise NotImplementedError(
                f"attention impl={self.impl!r} (chunked, flash-style) is not "
                "ported yet (ROADMAP.md queue A item 13); the port runs the "
                "naive path")

    @property
    def scale(self) -> float:
        return (self.query_scale if self.query_scale is not None
                else self.head_dim ** -0.5)


def causal_mask(sq: int, sk: int, device,
                window: int | None = None) -> torch.Tensor:
    """[1, Sq, Sk] bool: key j visible to query i when ``j <= i`` and,
    with a window, ``i - j < window``."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    return m[None]


def _qkv(p: dict, cfg: AttnConfig, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q * torch.tensor(cfg.scale, dtype=q.dtype, device=q.device), k, v


def _sdpa(cfg: AttnConfig, q, k, v, mask):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D], mask [1,Sq,Sk] bool."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    q = q.reshape(b, sq, kvh, groups, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    scores = softcap(scores, cfg.logit_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, d)


def _proj_out(p: dict, cfg: AttnConfig, out):
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if cfg.use_bias:
        y = y + p["bo"]
    return y


def attention_train(p: dict, cfg: AttnConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention on x [B, S, d]; ``p`` holds
    ``wq``, ``wk``, ``wv``, ``wo`` (and with ``use_bias`` the biases)."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        sin, cos = rope_table(torch.arange(s, device=x.device),
                              cfg.head_dim, cfg.rope_theta)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    out = _sdpa(cfg, q, k, v, causal_mask(s, s, x.device, cfg.window))
    return _proj_out(p, cfg, out)
