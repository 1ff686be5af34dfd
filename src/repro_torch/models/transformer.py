"""The model (port of ``repro.models.transformer`` for periods of
``attn_full``, ``attn_sw``, ``mla``, ``mla_dense``, ``rwkv``, ``mamba`` and
``shared_attn`` blocks, an unscanned ``prelude``, MoE FFNs, a prefix of
stub embeddings and an encoder with cross-attention: ``ModelConfig``,
``init_model``, ``encode`` and ``forward_train``; serving:
``init_block_cache``, ``init_model_cache``, ``forward_prefill`` and
``forward_decode``).

Parameters keep the JAX layout and names: block ``j`` of kind ``kind`` in
the period keeps its leaves under ``blocks/b{j}_{kind}/...``, each stacked
over the ``num_periods`` periods on a leading axis, so compression sees one
row per layer (paper section 5.2), and prelude block ``j`` keeps its own,
unstacked, under ``prelude/p{j}_{kind}/...``; zamba2's shared block keeps
its leaves once, unstacked, under ``shared/...``. The leaves, walked in
the JAX flatten order, group exactly as the JAX plan groups them.

An attention block is a norm, the attention (GQA for ``attn_*``, MLA for
``mla*``), with ``post_norm`` a norm of the branch's output (gemma2's
sandwich norms, ``post_ln1``/``post_ln2``), the residual add, then the
same around the FFN: gated (GeGLU/SwiGLU), ``dense`` (a plain MLP with
biases), the MoE FFN where ``moe`` is set, and for ``mla_dense`` always a
gated MLP of width ``first_dense_ff`` (deepseek-v2's first layer). An
``rwkv`` block adds RWKV-6's time mix and channel mix, each after its
norm; a ``mamba`` block adds the Mamba-2 mixer after its norm (``models.
ssm``), both with plain residuals. A ``shared_attn`` site (zamba2) feeds
the hidden state concatenated with the embedded tokens through the shared
block, its input projection plus the site's LoRA ``lora_a @ lora_b``,
and adds the block's output projection; its own ``ln1`` is drawn, as in
JAX, but never read, so its gradient is exact zeros. Norms are RMSNorm
(``scale``) or LayerNorm (``scale``, ``bias``). ``forward_train`` returns
the MoE auxiliary loss beside the logits, summed over the blocks in the
JAX order (prelude, then the periods).

A vision model (paligemma, ``modality="vision"``) takes ``prefix`` [B, P,
d], stub patch embeddings cast to the model dtype and put before the
token embeddings (which alone take ``embed_scale``); the whole ``P + S``
sequence runs causal with RoPE positions ``0 .. P+S-1``, as the JAX
package runs it, and the prefix is sliced off after ``final_ln``, before
the unembedding. An encoder-decoder (seamless, ``encoder_periods > 0``)
takes ``enc_embeds`` [B, F, d], stub frame embeddings cast to the model
dtype, through ``encode``: ``encoder_periods`` non-causal ``attn_full``
blocks (the FFN ``mlp_kind``'s, never MoE; leaves under
``encoder/blk/...``, stacked) and ``enc_final_ln``; each decoder block is
then followed by a cross-attention sublayer, a norm and non-causal
attention to the encoder's output without RoPE, added to the residual
(leaves under ``cross/x{j}/{ln, attn}/...``, stacked over the periods).
``remat`` and ``unroll``, the JAX scan's execution options, have no
counterpart: the port keeps the activations.

Serving runs every layer in ``prefill`` or ``decode`` mode against its
slice of the decode cache (``init_model_cache``: flat, keyed by the JAX
cache tree's paths, the periods' caches stacked on a leading axis), which
each block reads and writes in place: an attention block's KV (a window
ring for ``attn_sw``), MLA's latent, RWKV-6's and Mamba-2's states, a
shared site's own KV, and an encoder-decoder's cross cache, which prefill
fills from the encoder's output and decode reads. A vision prefix runs
in prefill only; decode positions continue after it.

Past one model worker every arch splits its compute over the model
workers (``dist.tensor_parallel``: ``forward_train``'s ``tp``): its
``Transformer`` holds this worker's shards only (``init_model``'s
``keep`` draws each leaf whole, in order, and keeps its slice), the
prelude's, the periods', the encoder's and the cross sublayers' blocks
run the split attention (GQA or MLA), MLP and experts, the ``rwkv`` and
``mamba`` blocks their mixers over heads (``models.ssm``) and RWKV-6's
channel mix over its hidden width, zamba2's shared block its attention
and MLP (its projections and the sites' LoRA whole), the embedding and
the logits the worker's rows of the vocabulary where the table splits
(else the whole table on every worker). Serving runs on whole models
only.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.common import Initializer, leaf_order
from repro_torch.models import layers
from repro_torch.models.layers import (dense_mlp, embed, gated_mlp,
                                       layernorm, rmsnorm, softcap, unembed)

KINDS = ("attn_full", "attn_sw", "mla", "mla_dense", "rwkv", "mamba",
         "shared_attn")
ATTN_KINDS = ("attn_full", "attn_sw")
MLA_KINDS = ("mla", "mla_dense")
SSM_KINDS = ("rwkv", "mamba", "shared_attn")  # the SSM and hybrid blocks
MODALITIES = ("text", "vision", "audio")
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    pattern: tuple[str, ...]            # one period of block kinds
    num_periods: int                    # layers = prelude + pattern * periods
    prelude: tuple[str, ...] = ()       # unscanned leading blocks (deepseek)
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10000.0
    window: int | None = None           # for attn_sw blocks
    attn_softcap: float | None = None
    query_scale: float | None = None
    use_bias: bool = False
    use_rope: bool = True
    d_ff: int = 0
    mlp_kind: str = "gated"             # gated | dense
    act: str = "gelu"
    norm: str = "rms"                   # rms | layer
    post_norm: bool = False             # gemma2 sandwich norms
    embed_scale: bool = False
    final_softcap: float | None = None
    tie_embeddings: bool = True
    moe: moe_lib.MoEConfig | None = None
    first_dense_ff: int = 0             # mla_dense's gated MLP width
    mla_kv_lora: int = 512              # MLA dims (deepseek-v2 defaults)
    mla_q_lora: int = 1536
    mla_qk_nope: int = 128
    mla_qk_rope: int = 64
    mla_v: int = 128
    rwkv: ssm.RWKV6Config | None = None
    mamba: ssm.Mamba2Config | None = None
    shared_lora_rank: int = 64          # zamba2 per-site adapters
    encoder_periods: int = 0            # seamless: non-causal encoder
    prefix_len: int = 0                 # image patches / audio frames
    modality: str = "text"              # text | vision | audio
    attn_impl: str = "naive"            # naive | chunked (flash-style)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        kinds = set(self.pattern) | set(self.prelude)
        if not self.tie_embeddings:
            raise NotImplementedError(
                "tie_embeddings=False: the JAX package declares the field "
                "but never reads it (its unembedding is always the tied "
                "table), so there is no untied model to port")
        if self.modality not in MODALITIES:
            raise ValueError(f"modality={self.modality!r}: want one of "
                             f"{MODALITIES}")
        if kinds - set(KINDS):
            raise ValueError(f"unknown block kinds "
                             f"{sorted(kinds - set(KINDS))}")
        for kind, sub in (("rwkv", self.rwkv), ("mamba", self.mamba)):
            if kind in kinds and sub is None:
                raise ValueError(f"{kind} blocks need cfg.{kind}")
        if "shared_attn" in kinds and "shared_attn" not in self.pattern:
            raise ValueError("the shared block is made for a pattern that "
                             "holds shared_attn")
        if self.mlp_kind not in ("gated", "dense") or self.norm not in (
                "rms", "layer"):
            raise ValueError(f"mlp_kind={self.mlp_kind!r}, "
                             f"norm={self.norm!r}")
        for kind in kinds & {*ATTN_KINDS, "shared_attn"}:
            self.attn_cfg(kind)               # refuses an unported impl

    @property
    def num_layers(self) -> int:
        return len(self.prelude) + len(self.pattern) * self.num_periods

    def attn_cfg(self, kind: str) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            window=self.window if kind == "attn_sw" else None,
            logit_softcap=self.attn_softcap, query_scale=self.query_scale,
            use_bias=self.use_bias, use_rope=self.use_rope,
            impl=self.attn_impl, q_chunk=self.attn_q_chunk,
            kv_chunk=self.attn_kv_chunk)

    def mla_cfg(self) -> attn.MLAConfig:
        return attn.MLAConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            kv_lora=self.mla_kv_lora, q_lora=self.mla_q_lora,
            qk_nope=self.mla_qk_nope, qk_rope=self.mla_qk_rope,
            v_dim=self.mla_v, rope_theta=self.rope_theta)

    def blocks(self) -> list[tuple[str, str]]:
        """``(prefix, kind)`` of each block of a period, in period order."""
        return [(f"blocks/b{j}_{kind}", kind)
                for j, kind in enumerate(self.pattern)]

    def prelude_blocks(self) -> list[tuple[str, str]]:
        """``(prefix, kind)`` of each prelude block, in order."""
        return [(f"prelude/p{j}_{kind}", kind)
                for j, kind in enumerate(self.prelude)]

    def encoder_cfg(self) -> "ModelConfig":
        """The config of the encoder's blocks: this one without MoE."""
        return dataclasses.replace(self, moe=None)

    def cross_blocks(self) -> list[str]:
        """The prefix of each block's cross-attention sublayer, in period
        order (an encoder-decoder's)."""
        return [f"cross/x{j}" for j in range(len(self.pattern))]


def _ffn_kind(cfg: ModelConfig, kind: str) -> str:
    """The FFN of a block: ``mla_dense`` forces a gated MLP (deepseek's
    layer 0), ``moe`` replaces it elsewhere, else ``mlp_kind``."""
    if kind == "mla_dense":
        return "gated"
    return "moe" if cfg.moe is not None else cfg.mlp_kind


def _norm_shapes(cfg: ModelConfig, name: str) -> dict:
    d = (cfg.d_model,)
    if cfg.norm == "layer":
        return {f"{name}/scale": d, f"{name}/bias": d}
    return {f"{name}/scale": d}


def _attn_shapes(cfg: ModelConfig, kind: str) -> dict:
    if kind in MLA_KINDS:
        return {f"attn/{k}": s
                for k, s in attn.mla_shapes(cfg.mla_cfg()).items()}
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"attn/wq": (d, h, hd), "attn/wk": (d, kv, hd),
           "attn/wv": (d, kv, hd), "attn/wo": (h, hd, d)}
    if cfg.use_bias:
        out.update({"attn/bq": (h, hd), "attn/bk": (kv, hd),
                    "attn/bv": (kv, hd), "attn/bo": (d,)})
    return out


def _ffn_shapes(cfg: ModelConfig, kind: str) -> dict:
    fk, d = _ffn_kind(cfg, kind), cfg.d_model
    if fk == "moe":
        return {f"ffn/{k}": s for k, s in moe_lib.moe_shapes(cfg.moe).items()}
    if fk == "gated":
        ff = (cfg.first_dense_ff if kind == "mla_dense" else 0) or cfg.d_ff
        return {"ffn/gate": (d, ff), "ffn/up": (d, ff), "ffn/down": (ff, d)}
    ff = cfg.d_ff
    return {"ffn/up": (d, ff), "ffn/up_b": (ff,), "ffn/down": (ff, d),
            "ffn/down_b": (d,)}


def _norm_names(cfg: ModelConfig, kind: str) -> tuple[str, ...]:
    """The norms of a block: an attention block's two (and gemma2's
    sandwich pair), rwkv's two, one before a mamba mixer or a shared
    site (zamba2's ``ln1``, drawn but never read)."""
    if kind in ("mamba", "shared_attn"):
        return ("ln1",)
    if kind == "rwkv" or not cfg.post_norm:
        return ("ln1", "ln2")
    return ("ln1", "ln2", "post_ln1", "post_ln2")


def _ssm_shapes(cfg: ModelConfig, kind: str) -> dict[str, tuple[int, ...]]:
    """The leaves of an ``rwkv``, ``mamba`` or ``shared_attn`` block past
    its norms, and their shapes."""
    if kind == "rwkv":
        return {**{f"tm/{k}": s for k, s in
                   ssm.rwkv6_time_mix_shapes(cfg.rwkv).items()},
                **{f"cm/{k}": s for k, s in
                   ssm.rwkv6_channel_mix_shapes(cfg.rwkv).items()}}
    if kind == "mamba":
        return {f"mix/{k}": s for k, s in ssm.mamba2_shapes(cfg.mamba).items()}
    d, r = cfg.d_model, cfg.shared_lora_rank
    return {"lora_a": (2 * d, r), "lora_b": (r, d)}


def _init_ssm(ini: Initializer, cfg: ModelConfig, kind: str,
              layers: int | None, keep) -> dict[str, torch.Tensor]:
    """``_ssm_shapes``' leaves with the distributions of ``models.ssm``; a
    shared site's LoRA N(0, 0.01); each kept as ``keep`` returns it."""
    def under(part):
        return lambda n, t: keep(f"{part}/{n}", t)

    if kind == "rwkv":
        return {**{f"tm/{k}": v for k, v in ssm.init_rwkv6_time_mix(
                    ini, cfg.rwkv, layers, under("tm")).items()},
                **{f"cm/{k}": v for k, v in ssm.init_rwkv6_channel_mix(
                    ini, cfg.rwkv, layers, under("cm")).items()}}
    if kind == "mamba":
        return {f"mix/{k}": v for k, v in ssm.init_mamba2(
            ini, cfg.mamba, layers, under("mix")).items()}
    return {name: keep(name, ini.normal(
                shape if layers is None else (layers,) + shape, stddev=0.01))
            for name, shape in _ssm_shapes(cfg, kind).items()}


def _block_shapes(cfg: ModelConfig, kind: str) -> dict[str, tuple[int, ...]]:
    """One layer's leaves of a block of ``kind``, unstacked."""
    norms = {}
    for n in _norm_names(cfg, kind):
        norms.update(_norm_shapes(cfg, n))
    if kind in SSM_KINDS:
        return {**_ssm_shapes(cfg, kind), **norms}
    return {**_attn_shapes(cfg, kind), **_ffn_shapes(cfg, kind), **norms}


def _cross_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One cross-attention sublayer: its norm and an ``attn_full``
    block's attention."""
    return {**_norm_shapes(cfg, "ln"), **_attn_shapes(cfg, "attn_full")}


def _shared_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """zamba2's shared block: the input projection from [x, emb0] (2d ->
    d), full attention, a gated MLP and the output projection."""
    d, ff = cfg.d_model, cfg.d_ff
    return {"in_proj": (2 * d, d), **_norm_shapes(cfg, "ln1"),
            **_attn_shapes(cfg, "attn_full"), **_norm_shapes(cfg, "ln2"),
            "ffn/gate": (d, ff), "ffn/up": (d, ff), "ffn/down": (ff, d),
            "out_proj": (d, d)}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], bool]]:
    """Path -> (shape, stacked) for every parameter."""
    out = {}
    for prefix, kind in cfg.blocks():
        out.update({f"{prefix}/{k}": ((cfg.num_periods,) + s, True)
                    for k, s in _block_shapes(cfg, kind).items()})
    out["embed/table"] = ((cfg.vocab, cfg.d_model), False)
    out.update({k: (s, False)
                for k, s in _norm_shapes(cfg, "final_ln").items()})
    for prefix, kind in cfg.prelude_blocks():
        out.update({f"{prefix}/{k}": (s, False)
                    for k, s in _block_shapes(cfg, kind).items()})
    if "shared_attn" in cfg.pattern:
        out.update({f"shared/{k}": (s, False)
                    for k, s in _shared_shapes(cfg).items()})
    if cfg.encoder_periods:
        out.update({f"encoder/blk/{k}": ((cfg.encoder_periods,) + s, True)
                    for k, s in _block_shapes(cfg.encoder_cfg(),
                                              "attn_full").items()})
        out.update({k: (s, False)
                    for k, s in _norm_shapes(cfg, "enc_final_ln").items()})
        for prefix in cfg.cross_blocks():
            out.update({f"{prefix}/{k}": ((cfg.num_periods,) + s, True)
                        for k, s in _cross_shapes(cfg).items()})
    return out


def _leaf_axes(cfg: ModelConfig, kind: str, name: str) -> tuple:
    """The logical axes of one leaf of a block of ``kind`` (its name in
    ``_block_shapes``, unstacked): the axes the JAX ``init_*`` functions
    attach to it."""
    part, _, leaf = name.partition("/")
    if part in ("ln1", "ln2", "post_ln1", "post_ln2", "ln"):
        return layers.NORM_AXES[leaf]
    if part == "attn":
        return (attn.MLA_AXES if kind in MLA_KINDS else attn.ATTN_AXES)[leaf]
    if part == "ffn":
        fk = _ffn_kind(cfg, kind)
        return (moe_lib.MOE_AXES if fk == "moe" else layers.GATED_MLP_AXES
                if fk == "gated" else layers.DENSE_MLP_AXES)[leaf]
    if part in ("tm", "cm", "mix"):
        return {"tm": ssm.RWKV6_TIME_MIX_AXES,
                "cm": ssm.RWKV6_CHANNEL_MIX_AXES,
                "mix": ssm.MAMBA2_AXES}[part][leaf]
    return {"lora_a": ("embed", None), "lora_b": (None, "embed")}[name]


def _shared_axes(name: str) -> tuple:
    """The logical axes of one leaf of zamba2's shared block."""
    part, _, leaf = name.partition("/")
    if part in ("in_proj", "out_proj"):
        return ("embed", "embed")
    if part in ("ln1", "ln2"):
        return layers.NORM_AXES[leaf]
    if part == "attn":
        return attn.ATTN_AXES[leaf]
    return layers.GATED_MLP_AXES[leaf]


NORMS = ("ln", "ln1", "ln2", "post_ln1", "post_ln2", "final_ln",
         "enc_final_ln")


def norm_leaves(cfg: ModelConfig) -> set[str]:
    """The leaves ``_norm`` reads (a norm's scale and bias): ``rmsnorm``
    and ``layernorm`` widen them to float32 before any use."""
    return {n for n in param_shapes(cfg)
            if "/" in n and n.split("/")[-2] in NORMS}


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """Path -> logical axes for every parameter (``param_shapes``' paths):
    the axes of the JAX package's ``split_params``, ``"layers"`` leading
    on the stacked leaves. The sharding rules (``dist.sharding``) read
    them."""
    shapes = param_shapes(cfg)
    out = {}
    for prefix, kind in cfg.blocks():
        out.update({f"{prefix}/{k}": _leaf_axes(cfg, kind, k)
                    for k in _block_shapes(cfg, kind)})
    for prefix, kind in cfg.prelude_blocks():
        out.update({f"{prefix}/{k}": _leaf_axes(cfg, kind, k)
                    for k in _block_shapes(cfg, kind)})
    if "shared_attn" in cfg.pattern:
        out.update({f"shared/{k}": _shared_axes(k)
                    for k in _shared_shapes(cfg)})
    if cfg.encoder_periods:
        enc = cfg.encoder_cfg()
        out.update({f"encoder/blk/{k}": _leaf_axes(enc, "attn_full", k)
                    for k in _block_shapes(enc, "attn_full")})
        for prefix in cfg.cross_blocks():
            out.update({f"{prefix}/{k}": _leaf_axes(cfg, "attn_full", k)
                        for k in _cross_shapes(cfg)})
    out["embed/table"] = layers.EMBED_AXES["table"]
    for name in ("final_ln", "enc_final_ln"):
        out.update({k: layers.NORM_AXES[k.rpartition("/")[2]]
                    for k in shapes if k.startswith(name + "/")})
    return {k: (("layers",) + out[k]) if shapes[k][1] else out[k]
            for k in shapes}


_ZEROS = ("/bias", "/bq", "/bk", "/bv", "/bo", "/up_b", "/down_b")


def _init_constant(ini: Initializer, cfg: ModelConfig, name: str, shape):
    """A norm's scale or a bias: RMSNorm scales 0 (it scales by 1 +
    scale), LayerNorm scales 1, biases 0."""
    if name.endswith("/scale") and cfg.norm == "layer":
        return ini.ones(shape)
    return ini.zeros(shape)


def _whole(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


def _init_attn(ini: Initializer, cfg: ModelConfig, kind: str,
               layers: int | None, keep=_whole) -> dict[str, torch.Tensor]:
    if kind in MLA_KINDS:
        return {f"attn/{k}": v for k, v in attn.init_mla(
            ini, cfg.mla_cfg(), layers,
            lambda n, t: keep(f"attn/{n}", t)).items()}
    return {name: keep(name, ini.zeros(shape if layers is None
                                       else (layers,) + shape)
                       if name.endswith(_ZEROS)
                       else ini.fan_in(shape, 1 if name == "attn/wo" else 0,
                                       layers=layers))
            for name, shape in _attn_shapes(cfg, kind).items()}


def _init_block(ini: Initializer, cfg: ModelConfig, kind: str,
                layers: int | None, keep=_whole) -> dict[str, torch.Tensor]:
    """One block's leaves: the attention, FFN or recurrent leaves, then
    the norms; ``layers`` stacks that many layers on a leading axis.
    ``keep(name, leaf)`` takes each leaf as it is drawn (the split
    model's shard of it)."""
    def full(shape):
        return shape if layers is None else (layers,) + tuple(shape)

    out = {}
    if kind in SSM_KINDS:
        out.update(_init_ssm(ini, cfg, kind, layers, keep))
    else:
        out.update(_init_attn(ini, cfg, kind, layers, keep))
        if _ffn_kind(cfg, kind) == "moe":
            out.update({f"ffn/{k}": v for k, v in moe_lib.init_moe(
                ini, cfg.moe, layers,
                lambda n, t: keep(f"ffn/{n}", t)).items()})
        else:
            for name, shape in _ffn_shapes(cfg, kind).items():
                out[name] = keep(name, ini.zeros(full(shape))
                                 if name.endswith(_ZEROS)
                                 else ini.fan_in(shape, 0, layers=layers))
    for n in _norm_names(cfg, kind):
        for name, shape in _norm_shapes(cfg, n).items():
            out[name] = keep(name, _init_constant(ini, cfg, name,
                                                  full(shape)))
    return out


def _init_shared(ini: Initializer, cfg: ModelConfig, keep=_whole
                 ) -> dict[str, torch.Tensor]:
    """zamba2's shared block, unstacked: N(0, 1/fan-in) projections, the
    attention as an ``attn_full`` block's, the norms' constants; each
    kept as ``keep`` returns it."""
    out = _init_attn(ini, cfg, "attn_full", None, keep)
    for name, shape in _shared_shapes(cfg).items():
        if name.startswith("attn/"):
            continue
        out[name] = keep(name, _init_constant(ini, cfg, name, shape)
                         if name.startswith("ln") else ini.fan_in(shape, 0))
    return out


def _init_cross(ini: Initializer, cfg: ModelConfig, keep=_whole
                ) -> dict[str, torch.Tensor]:
    """One cross-attention sublayer stacked over the periods: the norm's
    constants and an ``attn_full`` block's attention."""
    out = {name: keep(name, _init_constant(ini, cfg, name,
                                           (cfg.num_periods,) + shape))
           for name, shape in _norm_shapes(cfg, "ln").items()}
    out.update(_init_attn(ini, cfg, "attn_full", cfg.num_periods, keep))
    return out


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None, keep=None) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX package's distributions: the
    embedding N(0, 1), projections N(0, 1/fan_in), the MoE router N(0,
    1/d_model), biases 0, RMSNorm scales 0 (it scales by 1 + scale),
    LayerNorm scales 1, and the recurrent blocks' leaves as in
    ``models.ssm``. Drawn block by block (the periods' blocks, the
    embedding, the prelude, the shared block, then the encoder and the
    cross-attention sublayers). ``keep(path, leaf)``: each leaf as drawn,
    kept as it returns it (``tensor_parallel.TensorParallel.keep``: this
    worker's shard; the whole leaf is then freed before the next is
    drawn)."""
    dev = resolve_device(device)
    ini = Initializer(generator, cfg.dtype, dev)
    keep = keep or _whole

    def under(prefix):
        return lambda n, t: keep(f"{prefix}/{n}", t)

    params = {}
    for prefix, kind in cfg.blocks():
        params.update({f"{prefix}/{k}": v for k, v in _init_block(
            ini, cfg, kind, cfg.num_periods, under(prefix)).items()})
    params["embed/table"] = keep("embed/table", ini.normal(
        (cfg.vocab, cfg.d_model), stddev=1.0))
    for name, shape in _norm_shapes(cfg, "final_ln").items():
        params[name] = keep(name, _init_constant(ini, cfg, name, shape))
    for prefix, kind in cfg.prelude_blocks():
        params.update({f"{prefix}/{k}": v for k, v in _init_block(
            ini, cfg, kind, None, under(prefix)).items()})
    if "shared_attn" in cfg.pattern:
        params.update({f"shared/{k}": v for k, v in _init_shared(
            ini, cfg, under("shared")).items()})
    if cfg.encoder_periods:
        params.update({f"encoder/blk/{k}": v for k, v in _init_block(
            ini, cfg.encoder_cfg(), "attn_full", cfg.encoder_periods,
            under("encoder/blk")).items()})
        for name, shape in _norm_shapes(cfg, "enc_final_ln").items():
            params[name] = keep(name, _init_constant(ini, cfg, name, shape))
        for prefix in cfg.cross_blocks():
            params.update({f"{prefix}/{k}": v for k, v in _init_cross(
                ini, cfg, under(prefix)).items()})
    return params


def _norm(cfg: ModelConfig, p: dict, name: str, x: torch.Tensor):
    if cfg.norm == "layer":
        return layernorm(p[f"{name}/scale"], p[f"{name}/bias"], x)
    return rmsnorm(p[f"{name}/scale"], x)


def _residual(cfg: ModelConfig, p: dict, x, delta, post: str):
    if cfg.post_norm:
        delta = _norm(cfg, p, post, delta)
    return x + delta


def _sub(p: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: p[k] for k in p if k.startswith(prefix)}


def _ffn(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor,
         balance_group, tp=None, path: str | None = None):
    """The block's FFN on h: ``(y, aux)``, aux None for a dense FFN (the
    JAX package adds an exact 0.0 there); ``tp``: a split model's, the
    parts ``tp.ffn[path]`` names split over the model workers."""
    def axis(part):
        return None if tp is None else tp.ffn_axis(path, part)

    fk = _ffn_kind(cfg, kind)
    if fk == "moe":
        return moe_lib.moe_ffn(_sub(p, "ffn/"), cfg.moe, h, balance_group,
                               axis("experts"), axis("shared"))
    if fk == "gated":
        return gated_mlp(p["ffn/gate"], p["ffn/up"], p["ffn/down"], h,
                         cfg.act, axis("mlp")), None
    return dense_mlp(p["ffn/up"], p["ffn/up_b"], p["ffn/down"],
                     p["ffn/down_b"], h, cfg.act, axis("mlp")), None


def _store(cache: dict | None, new: dict) -> None:
    """Write a recurrent block's new state into its cache in place."""
    if cache is not None:
        for name, value in new.items():
            cache[name].copy_(value)


def _attend(p: dict, acfg: attn.AttnConfig, h: torch.Tensor, mode: str,
            cache: dict | None, pos, causal: bool = True, split=None,
            model_axis=None) -> torch.Tensor:
    """GQA attention in ``mode``: train (or an encoder's, ``causal``),
    prefill or decode, the last two writing ``cache`` in place; ``split``
    and ``model_axis``: a split model's (train only)."""
    if mode == "train":
        return attn.attention_train(p, acfg, h, causal=causal, split=split,
                                    model_axis=model_axis)
    if mode == "prefill":
        return attn.attention_prefill(p, acfg, h, cache)
    return attn.attention_decode(p, acfg, h, cache, pos)


def _attend_mla(p: dict, cfg: ModelConfig, h: torch.Tensor, mode: str,
                cache: dict | None, pos, split=None,
                model_axis=None) -> torch.Tensor:
    if mode == "train":
        return attn.mla_train(p, cfg.mla_cfg(), h, split, model_axis)
    if mode == "prefill":
        return attn.mla_prefill(p, cfg.mla_cfg(), h, cache)
    return attn.mla_decode(p, cfg.mla_cfg(), h, cache, pos)


def _shared_site(cfg: ModelConfig, p: dict, shared: dict, x: torch.Tensor,
                 emb0: torch.Tensor, mode: str = "train",
                 cache: dict | None = None, pos=None, tp=None
                 ) -> torch.Tensor:
    """A ``shared_attn`` site: [x, emb0] through the shared block, its
    input projection plus the site's LoRA (formed in the parameter
    dtype), then the residual add of its output projection; in serving
    the shared attention keeps a cache per site. ``tp``: a split model's
    (the shared attention and MLP split at path ``shared``, the
    projections and the LoRA whole)."""
    split = ma = mlp = None
    if tp is not None:
        split, ma = tp.attn["shared"], tp.axis
        mlp = tp.ffn_axis("shared", "mlp")
    cat = torch.cat([x, emb0.to(x.dtype)], dim=-1)
    h = cat @ (shared["in_proj"] + p["lora_a"] @ p["lora_b"])
    h = h + _attend(_sub(shared, "attn/"), cfg.attn_cfg("attn_full"),
                    _norm(cfg, shared, "ln1", h), mode, cache, pos,
                    split=split, model_axis=ma)
    h = h + gated_mlp(shared["ffn/gate"], shared["ffn/up"],
                      shared["ffn/down"], _norm(cfg, shared, "ln2", h),
                      cfg.act, mlp)
    return x + h @ shared["out_proj"]


def _block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
           balance_group=None, shared: dict | None = None,
           emb0: torch.Tensor | None = None, causal: bool = True,
           mode: str = "train", cache: dict | None = None, pos=None,
           tp=None, path: str | None = None):
    """One block on x [B, S, d]; ``p`` maps the block's leaf names
    (``"attn/wq"``) to this layer's slices, ``shared`` zamba2's shared
    leaves and ``emb0`` the embedded tokens (for ``shared_attn``);
    ``causal=False`` for an encoder's ``attn_full`` block. ``mode``:
    train, prefill or decode (x [B, 1, d] at position ``pos``); serving
    reads and writes this layer's ``cache`` in place. ``tp``: a split
    model's ``TensorParallel`` (``p`` then holds this worker's shards of
    the block at ``path``). Returns ``(x, aux)``."""
    split = ma = None
    if tp is not None:
        split, ma = (tp.ssm if kind in ("rwkv", "mamba")
                     else tp.attn).get(path), tp.axis
    if kind == "rwkv":
        h = _norm(cfg, p, "ln1", x)
        if mode == "decode":
            a, tm = ssm.rwkv6_time_mix_step(_sub(p, "tm/"), cfg.rwkv, h,
                                            cache)
        else:
            a, tm = ssm.rwkv6_time_mix(_sub(p, "tm/"), cfg.rwkv, h, cache,
                                       split, ma)
        x = x + a
        c, cm = ssm.rwkv6_channel_mix(
            _sub(p, "cm/"), _norm(cfg, p, "ln2", x), cache,
            None if tp is None else tp.ffn_axis(path, "mlp"))
        _store(cache, {**tm, **cm})
        return x + c, None
    if kind == "mamba":
        a, st = ssm.mamba2_mix(_sub(p, "mix/"), cfg.mamba,
                               _norm(cfg, p, "ln1", x), cache, split, ma)
        _store(cache, st)
        return x + a, None
    if kind == "shared_attn":
        return _shared_site(cfg, p, shared, x, emb0, mode, cache, pos,
                            tp), None
    h = _norm(cfg, p, "ln1", x)
    if kind in MLA_KINDS:
        a = _attend_mla(_sub(p, "attn/"), cfg, h, mode, cache, pos, split,
                        ma)
    else:
        a = _attend(_sub(p, "attn/"), cfg.attn_cfg(kind), h, mode, cache,
                    pos, causal, split, ma)
    x = _residual(cfg, p, x, a, "post_ln1")
    f, aux = _ffn(cfg, kind, p, _norm(cfg, p, "ln2", x), balance_group,
                  tp, path)
    return _residual(cfg, p, x, f, "post_ln2"), aux


def _layers(params: dict, prefix: str) -> dict:
    """The stacked leaves under ``prefix``, each as its layers' slices.
    One unbind per stacked leaf: its backward stacks the layer gradients
    once, where indexing layer by layer would add a zero-filled copy of
    the whole leaf per layer into its gradient. Parameters with a
    ``layers`` method (``dist.fsdp.Gathered``) give their own, each layer
    gathered when taken."""
    n = len(prefix)
    if hasattr(params, "layers"):
        return {k[n:]: params.layers(k) for k in params
                if k.startswith(prefix)}
    return {k: v.unbind(0) for k, v in _sub(params, prefix).items()}


def encode(params: dict[str, torch.Tensor], cfg: ModelConfig,
           enc_embeds: torch.Tensor, tp=None) -> torch.Tensor:
    """The encoder over stub frame embeddings [B, F, d] (cast to the
    model dtype): ``encoder_periods`` non-causal ``attn_full`` blocks,
    then ``enc_final_ln``; ``tp``: a split model's."""
    enc_cfg = cfg.encoder_cfg()
    x = enc_embeds.to(cfg.dtype)
    layers = _layers(params, "encoder/blk/")
    for i in range(cfg.encoder_periods):
        x, _ = _block(enc_cfg, "attn_full", {k: v[i] for k, v in
                                             layers.items()}, x,
                      causal=False, tp=tp, path="encoder/blk")
    return _norm(cfg, params, "enc_final_ln", x)


def _cross(cfg: ModelConfig, p: dict, x: torch.Tensor, mode: str,
           enc_out: torch.Tensor | None, cache: dict | None, tp=None,
           path: str | None = None) -> torch.Tensor:
    """A decoder block's cross-attention sublayer (JAX's
    ``_cross_apply``): x plus non-causal attention from ``ln(x)`` to the
    encoder's output, without RoPE; prefill also writes the encoder's
    keys and values into this period's ``cache``, which decode reads
    (``attention.cross_attention_step``). ``tp``: a split model's (the
    sublayer at ``path``)."""
    acfg, pa = cfg.attn_cfg("attn_full"), _sub(p, "attn/")
    h = _norm(cfg, p, "ln", x)
    if mode == "decode":
        return x + attn.cross_attention_step(pa, acfg, h, cache)
    if mode == "prefill":
        _store(cache, attn.init_cross_cache(acfg, pa, enc_out, cfg.dtype))
    split = ma = None
    if tp is not None:
        split, ma = tp.attn[path], tp.axis
    return x + attn.attention_train(pa, acfg, h, kv_x=enc_out, causal=False,
                                    split=split, model_axis=ma)


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           prefix: torch.Tensor | None, tp=None) -> tuple[torch.Tensor, int]:
    """The embedded tokens in the model dtype, a vision model's
    ``prefix`` before them (where ``cfg.prefix_len`` is set, as in JAX),
    and the prefix's length; ``tp``: a split model's, whose table may hold
    this worker's rows only."""
    x = embed(params["embed/table"], tokens, cfg.embed_scale,
              None if tp is None else tp.vocab_axis()).to(cfg.dtype)
    n_prefix = (prefix.shape[1] if cfg.prefix_len and prefix is not None
                else 0)
    if n_prefix:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x, n_prefix


def _encoded(params: dict, cfg: ModelConfig,
             enc_embeds: torch.Tensor | None, tp=None
             ) -> torch.Tensor | None:
    if not cfg.encoder_periods:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                         "enc_embeds [B, F, d_model]")
    return encode(params, cfg, enc_embeds, tp)


def _per_layer(caches: dict | None, prefix: str) -> dict | None:
    return None if caches is None else _sub(caches, prefix)


def _stack(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
           mode: str = "train", caches: dict | None = None, pos=None,
           enc_out: torch.Tensor | None = None, balance_group=None,
           tp=None):
    """The prelude, then the periods (each block, then in an
    encoder-decoder its cross-attention sublayer) on x, ``emb0`` = x; in
    serving each layer reads and writes its slice of ``caches`` in place;
    ``tp``: a split model's. Returns ``(x, aux)``, the MoE auxiliary losses
    summed in order."""
    site = dict(balance_group=balance_group, shared=_sub(params, "shared/"),
                emb0=x, mode=mode, pos=pos, tp=tp)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for path, kind in cfg.prelude_blocks():
        x, a = _block(cfg, kind, _sub(params, path + "/"), x,
                      cache=_per_layer(caches, path + "/"), path=path,
                      **site)
        if a is not None:
            aux = aux + a
    layers = [(kind, _layers(params, path + "/"),
               _per_layer(caches, path + "/"), path)
              for path, kind in cfg.blocks()]
    cross = ([(_layers(params, path + "/"), path)
              for path in cfg.cross_blocks()]
             if cfg.encoder_periods else [])
    cross_cache = _per_layer(caches, "cross/")
    for i in range(cfg.num_periods):
        for j, (kind, p, c, path) in enumerate(layers):
            x, a = _block(cfg, kind, {k: v[i] for k, v in p.items()}, x,
                          cache=None if c is None else
                          {k: v[i] for k, v in c.items()}, path=path,
                          **site)
            if a is not None:
                aux = aux + a
            if cross:
                cp, cpath = cross[j]
                x = _cross(cfg, {k: v[i] for k, v in cp.items()}, x,
                           mode, enc_out, None if cross_cache is None else
                           {k: v[i] for k, v in cross_cache.items()}, tp,
                           cpath)
    return x, aux


def forward_train(params: dict[str, torch.Tensor], cfg: ModelConfig,
                  tokens: torch.Tensor, balance_group=None, *,
                  prefix: torch.Tensor | None = None,
                  enc_embeds: torch.Tensor | None = None, tp=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab] in the parameter dtype, the
    MoE auxiliary loss: a 0-d float32, summed over the blocks in order,
    0.0 without MoE). ``balance_group``: the process group whose workers'
    batches the load-balance term spans (``moe.moe_ffn``); None for this
    worker's batch alone. ``prefix`` [B, P, d]: a vision model's patch
    embeddings (read where ``cfg.prefix_len`` is set, as in JAX);
    ``enc_embeds`` [B, F, d]: an encoder-decoder's frame embeddings.
    ``tp``: a split model's ``TensorParallel`` (``params`` its shards):
    the logits are then this worker's vocab shard where the table is
    split (``tp.vocab``)."""
    x, n_prefix = _embed(params, cfg, tokens, prefix, tp)
    x, aux = _stack(params, cfg, x, enc_out=_encoded(params, cfg,
                                                     enc_embeds, tp),
                    balance_group=balance_group, tp=tp)
    x = _norm(cfg, params, "final_ln", x)
    if n_prefix:
        x = x[:, n_prefix:]
    vocab_ma = None if tp is None or tp.vocab is None else tp.axis
    return softcap(unembed(params["embed/table"], x, vocab_ma),
                   cfg.final_softcap), aux


# ---------------------------------------------------------------------------
# Serving: the caches, prefill and decode
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype=None, device="cpu") -> dict:
    """One layer's cache: GQA's k, v (a ``shared_attn`` site's as
    ``attn_full``'s), MLA's latent, or RWKV-6's or Mamba-2's state."""
    dtype = dtype if dtype is not None else cfg.dtype
    if kind in (*ATTN_KINDS, "shared_attn"):
        return attn.init_cache(cfg.attn_cfg(
            "attn_full" if kind == "shared_attn" else kind), batch, max_seq,
            dtype, device)
    if kind in MLA_KINDS:
        return attn.init_mla_cache(cfg.mla_cfg(), batch, max_seq, dtype,
                                   device)
    if kind == "rwkv":
        return ssm.init_rwkv6_state(cfg.rwkv, batch, dtype, device)
    return ssm.init_mamba2_state(cfg.mamba, batch, dtype, device)


def init_model_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     device=None) -> dict[str, torch.Tensor]:
    """The whole decode cache, flat and keyed by the JAX cache tree's
    paths: ``prelude/p{j}_{kind}/<leaf>`` unstacked,
    ``blocks/b{j}_{kind}/<leaf>`` stacked over the periods on a leading
    axis, and an encoder-decoder's ``cross/k``, ``cross/v`` [periods, B,
    prefix_len, Hkv, D] in the model dtype. Zeros on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    out = {}
    for path, kind in cfg.prelude_blocks():
        out.update({f"{path}/{k}": v for k, v in init_block_cache(
            cfg, kind, batch, max_seq, device=dev).items()})
    for path, kind in cfg.blocks():
        out.update({f"{path}/{k}": v.expand(
            (cfg.num_periods,) + v.shape).contiguous()
            for k, v in init_block_cache(cfg, kind, batch, max_seq,
                                         device=dev).items()})
    if cfg.encoder_periods:
        shape = (cfg.num_periods, batch, cfg.prefix_len, cfg.num_kv_heads,
                 cfg.head_dim)
        out.update({f"cross/{k}": torch.zeros(shape, dtype=cfg.dtype,
                                              device=dev)
                    for k in ("k", "v")})
    return out


def cache_bytes(caches: dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in caches.values())


@torch.no_grad()
def forward_prefill(params: dict[str, torch.Tensor], cfg: ModelConfig,
                    batch: dict[str, torch.Tensor],
                    caches: dict[str, torch.Tensor]) -> torch.Tensor:
    """The prompt pass: ``batch["tokens"]`` [B, S] (a vision model's
    ``prefix`` before them, an encoder-decoder's ``enc_embeds`` through
    the encoder), every layer's cache filled in place -> the last
    position's logits [B, 1, vocab]."""
    x, _ = _embed(params, cfg, batch["tokens"], batch.get("prefix"))
    x, _ = _stack(params, cfg, x, mode="prefill", caches=caches,
                  enc_out=_encoded(params, cfg, batch.get("enc_embeds")))
    x = _norm(cfg, params, "final_ln", x[:, -1:])
    return softcap(unembed(params["embed/table"], x), cfg.final_softcap)


@torch.no_grad()
def forward_decode(params: dict[str, torch.Tensor], cfg: ModelConfig,
                   tokens: torch.Tensor, caches: dict[str, torch.Tensor],
                   pos: int) -> torch.Tensor:
    """One token a sequence, tokens [B, 1] at position ``pos`` (a vision
    model's first decode position is ``P + S``), against ``caches``,
    which it updates in place -> logits [B, 1, vocab]."""
    x = embed(params["embed/table"], tokens, cfg.embed_scale).to(cfg.dtype)
    x, _ = _stack(params, cfg, x, mode="decode", caches=caches,
                  pos=int(pos))
    x = _norm(cfg, params, "final_ln", x)
    return softcap(unembed(params["embed/table"], x), cfg.final_softcap)


class Transformer(nn.Module):
    """The model as an ``nn.Module``: one ``nn.Parameter`` per JAX leaf.
    ``leaves()`` lists them in the JAX flatten order and ``stacked`` flags
    the layer-stacked ones — what the compressed train step hands to the
    sync. With ``tp`` (a ``dist.tensor_parallel.TensorParallel``) the
    parameters are this worker's shards and the forward is split over the
    model workers; None: the whole model."""

    def __init__(self, cfg: ModelConfig,
                 params: dict[str, torch.Tensor], tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params.items()})
        shapes = param_shapes(cfg)
        self.leaf_names = leaf_order(self.params.keys())
        self.stacked = [shapes[n][1] for n in self.leaf_names]

    def leaves(self) -> list[nn.Parameter]:
        return [self.params[n] for n in self.leaf_names]

    def forward(self, tokens: torch.Tensor,
                prefix: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits, aux): ``forward_train`` (a split model's logits: this
        worker's vocab shard)."""
        return forward_train(dict(self.params), self.cfg, tokens,
                             prefix=prefix, enc_embeds=enc_embeds,
                             tp=self.tp)

    def _whole_only(self, what: str) -> None:
        if self.tp is not None:
            raise NotImplementedError(
                f"{what} on a split model: serving at a mesh is not ported "
                "yet (ROADMAP.md queue A item 10d)")

    def prefill(self, batch: dict, caches: dict) -> torch.Tensor:
        """``forward_prefill``: the last position's logits."""
        self._whole_only("prefill")
        return forward_prefill(dict(self.params), self.cfg, batch, caches)

    def decode(self, tokens: torch.Tensor, caches: dict,
               pos: int) -> torch.Tensor:
        """``forward_decode``: the logits of one token a sequence."""
        self._whole_only("decode")
        return forward_decode(dict(self.params), self.cfg, tokens, caches,
                              pos)
