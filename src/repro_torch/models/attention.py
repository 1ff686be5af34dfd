"""GQA/MQA attention with RoPE, sliding windows, logit softcaps and biases,
causal or not, and cross-attention (port of ``repro.models.attention``:
``AttnConfig``, ``causal_mask``, ``_qkv``, ``_sdpa``, ``_proj_out`` and
``attention_train``, and the serving and chunked parts below). Cross-attention takes
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

DeepSeek-V2's Multi-head Latent Attention (``MLAConfig``, ``init_mla``,
``_mla_qc``, ``mla_train``): queries through a low-rank
``q_down`` / ``q_up`` pair (``x @ q_down`` contracted first, the JAX
contraction path's order), keys and values from a shared latent
``c_kv = x @ kv_down``, and a RoPE part of the key shared by every head.
The score scale multiplies the summed scores in their dtype by the scale
rounded to that dtype, as for the query scale above.

Chunked (flash-style) attention (``impl="chunked"``: ``_sdpa_chunked``,
``_sdpa_dispatch``) keeps JAX's arithmetic: float32 scores after the
product, the softcap before the mask, ``NEG_INF``, the online ``m``,
``l``, ``acc`` update, ``p`` cast to v's dtype before the second product,
``acc / max(l, 1e-30)`` cast back to q's dtype; a sequence that the
chunks do not divide runs the naive path, as in JAX. ``impl=
"seq_parallel"`` (the sharded ``_sdpa_seq_parallel``) is ROADMAP.md queue
A item 10d and refused.

Serving (the caches of prefill and decode, port of ``init_cache``,
``attention_prefill``, ``attention_decode``, ``init_cross_cache``,
``cross_attention_step``, ``init_mla_cache``, ``mla_prefill`` and
``mla_decode``): a cache is a dict of tensors that prefill and decode
write in place (JAX returns a new one), so a step never copies it. A
global cache holds ``max_seq`` positions, a window cache
``min(max_seq, window)`` as a ring (position t in slot ``t % w``), an
MLA cache the latent ``c_kv`` and the shared RoPE key, a cross cache the
encoder's keys and values. Serving runs without autograd.

Past one model worker (``dist.tensor_parallel``) ``attention_train``
takes the block's ``AttnSplit`` and the ``ModelAxis``: over heads
(gemma2, phi3.5-moe, seamless), this worker's q heads and the kv heads
they read, ``wo`` row-parallel, its product summed over the model workers
before ``bo``, whole, is added once (the q, k and v products of the
copied input through ``tensor_parallel.columns``, ``wo``'s through
``row``: the partials kept in float32 until their sum); a whole
``wk``/``wv`` is sliced to
the kv heads read (its gradient then this worker's share); a cross
attention's ``kv_x`` (the encoder's output) is copied into the split as
``x`` is. Over head_dim (gemma-2b, paligemma, starcoder2) the layer's
attention leaves are gathered and the attention runs whole. ``mla_train``
over heads (deepseek-v2) computes the three latents (the query's, ``c_kv``
and the roped ``k_rope``) from the whole down projections on every
worker, copies them into the split, and runs its heads of ``q_up``,
``k_up``, ``v_up`` and ``wo``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import tensor_parallel as tp
from repro_torch.models.layers import apply_rope, rope_table, scalar, softcap

F32 = torch.float32

NEG_INF = -2.0e38
IMPLS = ("naive", "chunked")
# a chunked pass batches as many query blocks as keep one step's float32
# scores [blocks, B, KV, G, q_chunk, kv_chunk] within this many elements
CHUNK_STEP_ELEMS = 1 << 27


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
    impl: str = "naive"                # naive | chunked (flash-style)
    q_chunk: int = 512
    kv_chunk: int = 1024

    def __post_init__(self):
        if self.impl == "seq_parallel":
            raise NotImplementedError(
                "attention impl='seq_parallel' (keys and values sharded "
                "over a mesh axis) is not ported yet (ROADMAP.md queue A "
                "item 10d); the port runs naive or chunked")
        if self.impl not in IMPLS:
            raise ValueError(f"impl={self.impl!r}: want one of {IMPLS}")

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


def _gathered(p: dict, split, model_axis) -> dict:
    """``p`` with the leaves a ``gather`` split names put together."""
    if split is None or split.mode != "gather":
        return p
    return {k: tp.gather_leaf(v, split.gather[k], model_axis)
            if k in split.gather else v for k, v in p.items()}


def _kv_read(p: dict, split) -> dict:
    """A heads split's kv leaves: its shards, or the whole ``wk``/``wv``
    (``bk``/``bv``) sliced to the kv heads its q heads read."""
    if split is None or split.kv_split:
        return p
    lo, hi = split.kv
    out = dict(p, wk=p["wk"][:, lo:hi], wv=p["wv"][:, lo:hi])
    if "bk" in p:
        out.update(bk=p["bk"][lo:hi], bv=p["bv"][lo:hi])
    return out


def _qkv(p: dict, cfg: AttnConfig, x: torch.Tensor,
         kv_x: torch.Tensor | None = None, split=None, model_axis=None):
    """The queries, keys and values; with ``model_axis`` (a heads split)
    this worker's heads, ``x`` and ``kv_x`` copied into the split."""
    kv_x = x if kv_x is None else kv_x
    p = _kv_read(p, split)
    if model_axis is not None:
        q, k, v = tp.columns([(x, p["wq"]), (kv_x, p["wk"]),
                              (kv_x, p["wv"])], model_axis)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", kv_x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", kv_x, p["wv"])
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q * scalar(cfg.scale, q.dtype, q.device), k, v


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


def _proj_out(p: dict, cfg: AttnConfig, out, model_axis=None):
    """``out @ wo`` (+ ``bo``); with ``model_axis`` ``wo`` is this worker's
    heads and the product is summed over the model workers first."""
    y = (torch.einsum("bshk,hkd->bsd", out, p["wo"]) if model_axis is None
         else tp.row(out, p["wo"], model_axis))
    if cfg.use_bias:
        y = y + p["bo"]
    return y


def _live_blocks(qc: int, kc: int, nk: int, lo: int, hi: int,
                 q_offset: int, causal: bool, window: int | None):
    """The kv blocks that some query of query blocks ``lo .. hi-1`` sees
    (the others are masked for every row of those blocks)."""
    q0, q1 = q_offset + lo * qc, q_offset + hi * qc - 1
    out = []
    for ki in range(nk):
        k0, k1 = ki * kc, ki * kc + kc - 1
        if causal and k0 > q1:
            continue
        if window is not None and q0 - k1 >= window:
            continue
        out.append(ki)
    return out


def _sdpa_chunked(cfg: AttnConfig, q, k, v, *, causal: bool,
                  q_offset: int = 0, skip_masked: bool = True):
    """Flash-style attention: the online softmax over kv blocks of
    ``kv_chunk`` keys for query blocks of ``q_chunk`` queries, scores held
    a block pair at a time. q [B, Sq, H, D]; k, v [B, Sk, Hkv, D];
    ``q_offset``: the position of q[0]. A ragged shape (``q_chunk`` or
    ``kv_chunk`` not dividing Sq or Sk) runs the naive path, as in JAX.

    JAX scans the query blocks, each over every kv block. Here query
    blocks run as a batch dimension, as many at a time as keep a step's
    scores within ``CHUNK_STEP_ELEMS``, each batch over the kv blocks its
    rows can see: a block masked for every row adds exactly nothing
    (before the first visible block its sums are scaled by ``exp(NEG_INF
    - m) = 0``; after one, ``exp(NEG_INF - m) = 0`` is added), so the
    result is JAX's expression (``skip_masked=False`` computes them)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    qc, kc = min(cfg.q_chunk, sq), min(cfg.kv_chunk, sk)
    if sq % qc or sk % kc:                     # ragged: the naive path
        return _sdpa(cfg, q, k, v, causal_mask(sq, sk, q.device, cfg.window)
                     if causal else None)
    nq, nk = sq // qc, sk // kc
    qr = q.reshape(b, nq, qc, kvh, groups, d).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, nk, kc, kvh, d).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, nk, kc, kvh, d).permute(1, 0, 3, 2, 4)
    # qr [nq, B, KV, G, qc, D]; kr, vr [nk, B, KV, kc, D]
    step = max(1, CHUNK_STEP_ELEMS // (b * h * qc * kc))
    q_pos = q_offset + torch.arange(sq, device=q.device).reshape(nq, qc)
    outs = []
    for lo in range(0, nq, step):
        hi = min(nq, lo + step)
        qb, qp = qr[lo:hi], q_pos[lo:hi, :, None]
        m = torch.full((hi - lo, b, kvh, groups, qc), NEG_INF,
                       dtype=F32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (d,), dtype=F32, device=q.device)
        blocks = (_live_blocks(qc, kc, nk, lo, hi, q_offset, causal,
                               cfg.window) if skip_masked else range(nk))
        for ki in blocks:
            s = torch.einsum("nbkgqd,bkcd->nbkgqc", qb, kr[ki]).to(F32)
            s = softcap(s, cfg.logit_softcap)
            kp = ki * kc + torch.arange(kc, device=q.device)
            ok = torch.ones((hi - lo, qc, kc), dtype=torch.bool,
                            device=q.device)
            if causal:
                ok &= kp <= qp
            if cfg.window is not None:
                ok &= (qp - kp) < cfg.window
            s = torch.where(ok[:, None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "nbkgqc,bkcd->nbkgqd", p.to(vr.dtype), vr[ki]).to(F32)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    # [nq, B, KV, G, qc, D] -> [B, Sq, H, D]
    out = torch.cat(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, d)
    return out.to(q.dtype)


def _sdpa_dispatch(cfg: AttnConfig, q, k, v, *, causal: bool,
                   q_offset: int = 0):
    """``impl``'s attention: chunked, or naive with the causal (and
    window) mask, or none when not causal. The naive path ignores
    ``q_offset``, as in JAX."""
    if cfg.impl == "chunked":
        return _sdpa_chunked(cfg, q, k, v, causal=causal, q_offset=q_offset)
    sq, sk = q.shape[1], k.shape[1]
    return _sdpa(cfg, q, k, v, causal_mask(sq, sk, q.device, cfg.window)
                 if causal else None)


def _rope_at(cfg: AttnConfig, q, k, positions: torch.Tensor):
    sin, cos = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos)


def attention_train(p: dict, cfg: AttnConfig, x: torch.Tensor, *,
                    kv_x: torch.Tensor | None = None,
                    causal: bool = True, split=None,
                    model_axis=None) -> torch.Tensor:
    """Full-sequence attention on x [B, S, d] (train, encoder): self-
    attention with RoPE at positions ``0 .. S-1``, or with ``kv_x`` [B, T,
    d] cross-attention to it, without RoPE; causal (and windowed) or, with
    ``causal=False``, every key visible. ``p`` holds ``wq``, ``wk``,
    ``wv``, ``wo`` (and with ``use_bias`` the biases). ``split`` (a
    ``tensor_parallel.AttnSplit``) and ``model_axis``: this worker's part
    of a split attention (module docstring)."""
    heads = split is not None and split.mode == "heads"
    p = _gathered(p, split, model_axis)
    s = x.shape[1]
    q, k, v = (_qkv(p, cfg, x, kv_x, split, model_axis) if heads
               else _qkv(p, cfg, x, kv_x))
    if cfg.use_rope and kv_x is None:    # cross-attention carries no rope
        q, k = _rope_at(cfg, q, k, torch.arange(s, device=x.device))
    return _proj_out(p, cfg, _sdpa_dispatch(cfg, q, k, v, causal=causal),
                     model_axis if heads else None)


# ---------------------------------------------------------------------------
# Caching (prefill / decode)
# ---------------------------------------------------------------------------

def init_cache(cfg: AttnConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """k, v [B, S, Hkv, D] zeros: S = ``max_seq``, or with a window
    ``min(max_seq, window)`` (a ring)."""
    s = min(max_seq, cfg.window) if cfg.window is not None else max_seq
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("k", "v")}


def attention_prefill(p: dict, cfg: AttnConfig, x: torch.Tensor,
                      cache: dict) -> torch.Tensor:
    """Causal attention over the prompt x [B, S, d] (``impl``'s path),
    its keys and values written into ``cache`` in place: at slots ``0 ..
    S-1``, or for a window cache of w slots with S >= w the last w,
    rolled so that position t sits in slot ``t % w``."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        q, k = _rope_at(cfg, q, k, torch.arange(s, device=x.device))
    out = _proj_out(p, cfg, _sdpa_dispatch(cfg, q, k, v, causal=True))
    w = cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        if cfg.window is not None and s >= w:    # keep the last w entries
            cache[name].copy_(torch.roll(new[:, s - w:], (s - w) % w, 1))
        else:
            cache[name][:, :s].copy_(new)
    return out


def attention_decode(p: dict, cfg: AttnConfig, x: torch.Tensor,
                     cache: dict, pos: int) -> torch.Tensor:
    """One token x [B, 1, d] at position ``pos``: its key and value
    written into ``cache`` in place (slot ``pos``, or ``pos % w`` in a
    window ring), then attention over the cached positions: ``<= pos``,
    or in a ring each slot's position ``pos - ((pos - slot) % w)`` when it
    is >= 0 (floor modulo, as ``jnp``'s)."""
    q, k, v = _qkv(p, cfg, x)                          # [B, 1, H, D]
    if cfg.use_rope:
        q, k = _rope_at(cfg, q, k, torch.full((1,), pos, device=x.device))
    s_cache = cache["k"].shape[1]
    slot = pos % s_cache if cfg.window is not None else pos
    cache["k"][:, slot].copy_(k[:, 0])
    cache["v"][:, slot].copy_(v[:, 0])
    idx = torch.arange(s_cache, device=x.device)
    if cfg.window is not None:
        mask = (pos - ((pos - idx) % s_cache)) >= 0
    else:
        mask = idx <= pos
    out = _sdpa(cfg, q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                mask[None, None, :])
    return _proj_out(p, cfg, out)


# ---------------------------------------------------------------------------
# Cross attention (enc-dec)
# ---------------------------------------------------------------------------

def init_cross_cache(cfg: AttnConfig, p: dict, enc_out: torch.Tensor,
                     dtype=torch.bfloat16) -> dict:
    """The encoder-side k, v [B, F, Hkv, D], once a request."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    if cfg.use_bias:
        k, v = k + p["bk"], v + p["bv"]
    return {"k": k.to(dtype), "v": v.to(dtype)}


def cross_attention_step(p: dict, cfg: AttnConfig, x: torch.Tensor,
                         cross_cache: dict) -> torch.Tensor:
    """Decoder queries x [B, Sq, d] over the fixed encoder k, v, every
    key visible. The query is scaled before its bias is added, as in
    JAX's step (``_qkv`` adds the bias first)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"]) * scalar(
        cfg.scale, x.dtype, x.device)
    if cfg.use_bias:
        q = q + p["bq"]
    k, v = cross_cache["k"].to(q.dtype), cross_cache["v"].to(q.dtype)
    return _proj_out(p, cfg, _sdpa(cfg, q, k, v, None))


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


# the logical axes of each leaf (``repro.models.attention``'s
# ``init_attention`` and ``init_mla``)
ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
             "wk": ("embed", "kv_heads", "head_dim"),
             "wv": ("embed", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed"),
             "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
             "bv": ("kv_heads", "head_dim"), "bo": ("embed",)}
MLA_AXES = {"q_down": ("embed", "kv_lora"),
            "q_up": ("kv_lora", "heads", "head_dim"),
            "kv_down": ("embed", "kv_lora"), "k_rope": ("embed", "qk_rope"),
            "k_up": ("kv_lora", "heads", "head_dim"),
            "v_up": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


def mla_shapes(cfg: MLAConfig) -> dict[str, tuple[int, ...]]:
    """MLA's leaves (under ``attn/``) and their shapes, in the JAX order."""
    d, h = cfg.d_model, cfg.num_heads
    return {"q_down": (d, cfg.q_lora),
            "q_up": (cfg.q_lora, h, cfg.qk_nope + cfg.qk_rope),
            "kv_down": (d, cfg.kv_lora), "k_rope": (d, cfg.qk_rope),
            "k_up": (cfg.kv_lora, h, cfg.qk_nope),
            "v_up": (cfg.kv_lora, h, cfg.v_dim), "wo": (h, cfg.v_dim, d)}


def init_mla(ini, cfg: MLAConfig, layers: int | None = None,
             keep=lambda name, t: t) -> dict[str, torch.Tensor]:
    """N(0, 1/fan-in) on axis 0, ``wo``'s on axis 1 (the JAX package's);
    ``layers`` stacks that many copies on a leading axis; ``keep(name,
    leaf)`` takes each leaf as it is drawn (a split model's shard)."""
    return {name: keep(name, ini.fan_in(shape, 1 if name == "wo" else 0,
                                        layers=layers))
            for name, shape in mla_shapes(cfg).items()}


def _mla_qc(p: dict, cfg: MLAConfig, x: torch.Tensor,
            positions: torch.Tensor, model_axis=None):
    """Queries and the latent (c_kv, k_rope) for a block of tokens; with
    ``model_axis`` the three latents are copied into the split before the
    up projections (this worker's heads of ``q_up``)."""
    q_lat = torch.einsum("bsd,dl->bsl", x, p["q_down"])
    c_kv = torch.einsum("bsd,dl->bsl", x, p["kv_down"])
    k_rope = torch.einsum("bsd,dr->bsr", x, p["k_rope"])
    sin, cos = rope_table(positions, cfg.qk_rope, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]
    if model_axis is not None:
        q_lat, c_kv, k_rope = (tp.copy_to(t, model_axis)
                               for t in (q_lat, c_kv, k_rope))
    q = torch.einsum("bsl,lhk->bshk", q_lat, p["q_up"])
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    q_rope = apply_rope(q_rope, sin, cos)
    return q_nope, q_rope, c_kv, k_rope


def mla_train(p: dict, cfg: MLAConfig, x: torch.Tensor, split=None,
              model_axis=None) -> torch.Tensor:
    """Training-time MLA on x [B, S, d]: per-head keys and values
    materialized from the latent, causal. ``p`` holds ``q_down``, ``q_up``,
    ``kv_down``, ``k_rope``, ``k_up``, ``v_up`` and ``wo``. ``split`` (an
    ``AttnSplit``, ``mla`` or ``gather``) and ``model_axis``: this
    worker's part of a split attention (module docstring)."""
    heads = split is not None and split.mode == "mla"
    return _mla_full(_gathered(p, split, model_axis), cfg, x,
                     model_axis if heads else None)[0]


def _mla_full(p: dict, cfg: MLAConfig, x: torch.Tensor, model_axis=None):
    """``mla_train``'s output and the latent (c_kv, k_rope) it read; with
    ``model_axis``, over this worker's heads, ``wo``'s product summed over
    the model workers."""
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qc(
        p, cfg, x, torch.arange(s, device=x.device), model_axis)
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["k_up"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, p["v_up"])
    scores = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope))
    scale = scalar(cfg.scale, scores.dtype, x.device)
    scores = softcap((scores * scale).to(torch.float32), cfg.logit_softcap)
    mask = causal_mask(s, s, x.device)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthk->bshk", probs, v)
    y = (torch.einsum("bshk,hkd->bsd", out, p["wo"]) if model_axis is None
         else tp.row(out, p["wo"], model_axis))
    return y, c_kv, k_rope


def init_mla_cache(cfg: MLAConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16, device="cpu") -> dict:
    """c_kv [B, S, kv_lora] and k_rope [B, S, qk_rope] zeros."""
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope),
                                  dtype=dtype, device=device)}


def mla_prefill(p: dict, cfg: MLAConfig, x: torch.Tensor,
                cache: dict) -> torch.Tensor:
    """``mla_train`` over the prompt, its latent written into ``cache``
    in place at slots ``0 .. S-1``."""
    out, c_kv, k_rope = _mla_full(p, cfg, x)
    s = x.shape[1]
    cache["c_kv"][:, :s].copy_(c_kv)
    cache["k_rope"][:, :s].copy_(k_rope)
    return out


def mla_decode(p: dict, cfg: MLAConfig, x: torch.Tensor, cache: dict,
               pos: int) -> torch.Tensor:
    """Absorbed-projection decode of x [B, 1, d] at ``pos``: the token's
    latent written into ``cache`` in place, the query absorbed into the
    latent space through ``k_up`` (``score_h(t) = (k_up_h^T q_nope_h)^T
    c_t + q_rope_h^T k_rope_t``), attention over positions ``<= pos`` in
    that space, then ``v_up`` and ``wo``; JAX's contraction order."""
    q_nope, q_rope, c_kv, k_rope = _mla_qc(
        p, cfg, x, torch.full((1,), pos, device=x.device))
    cache["c_kv"][:, pos].copy_(c_kv[:, 0])
    cache["k_rope"][:, pos].copy_(k_rope[:, 0])
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, p["k_up"])
    scores = (torch.einsum("bshl,btl->bhst", q_lat, c_cache.to(q_lat.dtype))
              + torch.einsum("bshk,btk->bhst", q_rope,
                             r_cache.to(q_rope.dtype)))
    scale = scalar(cfg.scale, scores.dtype, x.device)
    scores = softcap((scores * scale).to(torch.float32), cfg.logit_softcap)
    mask = torch.arange(c_cache.shape[1], device=x.device) <= pos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhst,btl->bshl", probs, c_cache.to(x.dtype))
    out = torch.einsum("bshl,lhk->bshk", out_lat, p["v_up"])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
