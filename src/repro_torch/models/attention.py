"""GQA/MQA attention with RoPE, sliding windows, logit softcaps and biases,
causal or not, and cross-attention, the naive train path (port of
``repro.models.attention``: ``AttnConfig``, ``causal_mask``, ``_qkv``,
``_sdpa``, ``_proj_out`` and ``attention_train``). Cross-attention takes
its keys and values from ``kv_x`` (an encoder's output) and carries no
RoPE; seamless's encoder and its decoder's cross-attention run
non-causal. Scores and the softmax run in float32, the softcap
on the float32 scores before the mask; the probabilities are cast to the
value dtype before the second product, as in JAX. Weights keep the JAX
layout: ``wq [d, h, hd]``, ``wk``/``wv [d, kv, hd]``, ``wo [h, hd, d]``,
biases ``bq [h, hd]``, ``bk``/``bv [kv, hd]``, ``bo [d]``.

The query scale multiplies q in q's dtype by the scale rounded to that
dtype first, as JAX multiplies by a weakly typed Python float (in bf16,
gemma2-27b's 144^-0.5 and starcoder2's 128^-0.5 are not exact).

DeepSeek-V2's Multi-head Latent Attention, the train path (``MLAConfig``,
``init_mla``, ``_mla_qc``, ``mla_train``): queries through a low-rank
``q_down`` / ``q_up`` pair (``x @ q_down`` contracted first, the JAX
contraction path's order), keys and values from a shared latent
``c_kv = x @ kv_down``, and a RoPE part of the key shared by every head.
The score scale multiplies the summed scores in their dtype by the scale
rounded to that dtype, as for the query scale above.

Chunked (flash-style) attention (``impl="chunked"``, the dry-run's
``--attn-impl``) is ROADMAP.md queue A item 13; the prefill/decode caches
(MLA's ``mla_prefill`` and ``mla_decode`` and the cross cache among them)
are item 10c.
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


def _qkv(p: dict, cfg: AttnConfig, x: torch.Tensor,
         kv_x: torch.Tensor | None = None):
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_x, p["wv"])
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q * torch.tensor(cfg.scale, dtype=q.dtype, device=q.device), k, v


def _sdpa(cfg: AttnConfig, q, k, v, mask):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D], mask [1,Sq,Sk] bool, or None for
    every key visible (JAX's all-ones mask: its ``where`` is the
    identity, so it is skipped)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    q = q.reshape(b, sq, kvh, groups, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    scores = softcap(scores, cfg.logit_softcap)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, d)


def _proj_out(p: dict, cfg: AttnConfig, out):
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if cfg.use_bias:
        y = y + p["bo"]
    return y


def attention_train(p: dict, cfg: AttnConfig, x: torch.Tensor, *,
                    kv_x: torch.Tensor | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention on x [B, S, d] (train, encoder): self-
    attention with RoPE at positions ``0 .. S-1``, or with ``kv_x`` [B, T,
    d] cross-attention to it, without RoPE; causal (and windowed) or, with
    ``causal=False``, every key visible. ``p`` holds ``wq``, ``wk``,
    ``wv``, ``wo`` (and with ``use_bias`` the biases)."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x, kv_x)
    if cfg.use_rope and kv_x is None:    # cross-attention carries no rope
        sin, cos = rope_table(torch.arange(s, device=x.device),
                              cfg.head_dim, cfg.rope_theta)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    mask = (causal_mask(s, k.shape[1], x.device, cfg.window) if causal
            else None)
    return _proj_out(p, cfg, _sdpa(cfg, q, k, v, mask))


# ---------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0
    logit_softcap: float | None = None

    @property
    def scale(self) -> float:
        return (self.qk_nope + self.qk_rope) ** -0.5


def mla_shapes(cfg: MLAConfig) -> dict[str, tuple[int, ...]]:
    """MLA's leaves (under ``attn/``) and their shapes, in the JAX order."""
    d, h = cfg.d_model, cfg.num_heads
    return {"q_down": (d, cfg.q_lora),
            "q_up": (cfg.q_lora, h, cfg.qk_nope + cfg.qk_rope),
            "kv_down": (d, cfg.kv_lora), "k_rope": (d, cfg.qk_rope),
            "k_up": (cfg.kv_lora, h, cfg.qk_nope),
            "v_up": (cfg.kv_lora, h, cfg.v_dim), "wo": (h, cfg.v_dim, d)}


def init_mla(ini, cfg: MLAConfig, layers: int | None = None
             ) -> dict[str, torch.Tensor]:
    """N(0, 1/fan-in) on axis 0, ``wo``'s on axis 1 (the JAX package's);
    ``layers`` stacks that many copies on a leading axis."""
    return {name: ini.fan_in(shape, 1 if name == "wo" else 0, layers=layers)
            for name, shape in mla_shapes(cfg).items()}


def _mla_qc(p: dict, cfg: MLAConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """Queries and the latent (c_kv, k_rope) for a block of tokens."""
    q = torch.einsum("bsl,lhk->bshk",
                     torch.einsum("bsd,dl->bsl", x, p["q_down"]), p["q_up"])
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    c_kv = torch.einsum("bsd,dl->bsl", x, p["kv_down"])
    k_rope = torch.einsum("bsd,dr->bsr", x, p["k_rope"])
    sin, cos = rope_table(positions, cfg.qk_rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_train(p: dict, cfg: MLAConfig, x: torch.Tensor) -> torch.Tensor:
    """Training-time MLA on x [B, S, d]: per-head keys and values
    materialized from the latent, causal. ``p`` holds ``q_down``, ``q_up``,
    ``kv_down``, ``k_rope``, ``k_up``, ``v_up`` and ``wo``."""
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qc(
        p, cfg, x, torch.arange(s, device=x.device))
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["k_up"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["v_up"])
    scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope))
    scale = torch.tensor(cfg.scale, dtype=scores.dtype, device=x.device)
    scores = softcap((scores * scale).to(torch.float32), cfg.logit_softcap)
    mask = causal_mask(s, s, x.device)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthk->bshk", probs, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
