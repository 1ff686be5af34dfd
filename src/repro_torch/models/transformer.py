"""Dense decoder-only transformer (port of ``repro.models.transformer`` for
periods of ``attn_full`` and ``attn_sw`` blocks: ``ModelConfig``,
``init_model`` and ``forward_train``).

Parameters keep the JAX layout and names: block ``j`` of kind ``kind`` in
the period keeps its leaves under ``blocks/b{j}_{kind}/...``, each stacked
over the ``num_periods`` periods on a leading axis, so compression sees one
row per layer (paper section 5.2) and the leaves, walked in the JAX flatten
order, group exactly as the JAX plan groups them. A block is a norm, the
attention, with ``post_norm`` a norm of the branch's output (gemma2's
sandwich norms, ``post_ln1``/``post_ln2``), the residual add, then the
same around the FFN: gated (GeGLU/SwiGLU) or ``dense`` (a plain MLP with
biases). Norms are RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``).

The MoE, MLA, SSM, hybrid, encoder-decoder and prefix blocks are
ROADMAP.md queue A item 10. ``remat`` and ``unroll``, the JAX scan's
execution options, have no counterpart: the port keeps the activations.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import Initializer, leaf_order
from repro_torch.models.layers import (dense_mlp, embed, gated_mlp,
                                       layernorm, rmsnorm, softcap, unembed)

KINDS = ("attn_full", "attn_sw")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    pattern: tuple[str, ...]            # one period of block kinds
    num_periods: int                    # layers = len(pattern) * periods
    prelude: tuple[str, ...] = ()
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
    moe: Any = None
    rwkv: Any = None
    mamba: Any = None
    encoder_periods: int = 0
    prefix_len: int = 0
    attn_impl: str = "naive"            # naive | chunked (queue A item 13)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if (set(self.pattern) - set(KINDS) or self.prelude
                or self.moe is not None or self.rwkv is not None
                or self.mamba is not None or self.encoder_periods
                or self.prefix_len or not self.tie_embeddings):
            raise NotImplementedError(
                "only periods of attn_full and attn_sw blocks with tied "
                "embeddings are ported; MoE, MLA, SSM, hybrid, "
                "encoder-decoder and prefix models are ROADMAP.md queue A "
                "item 10")
        if self.mlp_kind not in ("gated", "dense") or self.norm not in (
                "rms", "layer"):
            raise ValueError(f"mlp_kind={self.mlp_kind!r}, "
                             f"norm={self.norm!r}")
        self.attn_cfg(self.pattern[0])        # refuses a chunked impl

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.num_periods

    def attn_cfg(self, kind: str) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            window=self.window if kind == "attn_sw" else None,
            logit_softcap=self.attn_softcap, query_scale=self.query_scale,
            use_bias=self.use_bias, use_rope=self.use_rope,
            impl=self.attn_impl)

    def blocks(self) -> list[tuple[str, str]]:
        """``(prefix, kind)`` of each block of a period, in period order."""
        return [(f"blocks/b{j}_{kind}", kind)
                for j, kind in enumerate(self.pattern)]


def _norm_shapes(cfg: ModelConfig, name: str) -> dict:
    d = (cfg.d_model,)
    if cfg.norm == "layer":
        return {f"{name}/scale": d, f"{name}/bias": d}
    return {f"{name}/scale": d}


def _block_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """One layer's leaves (the same for both kinds), unstacked."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    out = {"attn/wq": (d, h, hd), "attn/wk": (d, kv, hd),
           "attn/wv": (d, kv, hd), "attn/wo": (h, hd, d)}
    if cfg.use_bias:
        out.update({"attn/bq": (h, hd), "attn/bk": (kv, hd),
                    "attn/bv": (kv, hd), "attn/bo": (d,)})
    if cfg.mlp_kind == "gated":
        out.update({"ffn/gate": (d, ff), "ffn/up": (d, ff),
                    "ffn/down": (ff, d)})
    else:
        out.update({"ffn/up": (d, ff), "ffn/up_b": (ff,),
                    "ffn/down": (ff, d), "ffn/down_b": (d,)})
    norms = ("ln1", "ln2") + (("post_ln1", "post_ln2") if cfg.post_norm
                              else ())
    for n in norms:
        out.update(_norm_shapes(cfg, n))
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], bool]]:
    """Path -> (shape, stacked) for every parameter."""
    out = {}
    for prefix, _ in cfg.blocks():
        out.update({f"{prefix}/{k}": ((cfg.num_periods,) + s, True)
                    for k, s in _block_shapes(cfg).items()})
    out["embed/table"] = ((cfg.vocab, cfg.d_model), False)
    out.update({k: (s, False)
                for k, s in _norm_shapes(cfg, "final_ln").items()})
    return out


_FAN_IN_DIM = {"attn/wo": 1}
_ZEROS = ("/bias", "/bq", "/bk", "/bv", "/bo", "/up_b", "/down_b")


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX package's distributions: the
    embedding N(0, 1), projections N(0, 1/fan_in), biases 0, RMSNorm
    scales 0 (it scales by 1 + scale), LayerNorm scales 1."""
    dev = resolve_device(device)
    ini = Initializer(generator, cfg.dtype, dev)
    params = {}
    for name, (shape, stacked) in param_shapes(cfg).items():
        if name.endswith(_ZEROS):
            params[name] = ini.zeros(shape)
        elif name.endswith("/scale"):
            params[name] = (ini.ones(shape) if cfg.norm == "layer"
                            else ini.zeros(shape))
        elif name == "embed/table":
            params[name] = ini.normal(shape, stddev=1.0)
        else:
            short = name.split("/", 2)[2]
            params[name] = ini.fan_in(shape[1:], _FAN_IN_DIM.get(short, 0),
                                      layers=shape[0])
    return params


def _norm(cfg: ModelConfig, p: dict, name: str, x: torch.Tensor):
    if cfg.norm == "layer":
        return layernorm(p[f"{name}/scale"], p[f"{name}/bias"], x)
    return rmsnorm(p[f"{name}/scale"], x)


def _residual(cfg: ModelConfig, p: dict, x, delta, post: str):
    if cfg.post_norm:
        delta = _norm(cfg, p, post, delta)
    return x + delta


def _block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor):
    """One attention block on x [B, S, d]; ``p`` maps the block's leaf
    names (``"attn/wq"``) to this layer's slices."""
    h = _norm(cfg, p, "ln1", x)
    a = attn.attention_train({k[5:]: v for k, v in p.items()
                              if k.startswith("attn/")},
                             cfg.attn_cfg(kind), h)
    x = _residual(cfg, p, x, a, "post_ln1")
    h = _norm(cfg, p, "ln2", x)
    if cfg.mlp_kind == "gated":
        f = gated_mlp(p["ffn/gate"], p["ffn/up"], p["ffn/down"], h, cfg.act)
    else:
        f = dense_mlp(p["ffn/up"], p["ffn/up_b"], p["ffn/down"],
                      p["ffn/down_b"], h, cfg.act)
    return _residual(cfg, p, x, f, "post_ln2")


def forward_train(params: dict[str, torch.Tensor], cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (the parameter dtype)."""
    x = embed(params["embed/table"], tokens, cfg.embed_scale).to(cfg.dtype)
    # one unbind per stacked leaf: its backward stacks the layer gradients
    # once, where indexing layer by layer would add a zero-filled copy of
    # the whole leaf per layer into its gradient
    layers = []
    for prefix, kind in cfg.blocks():
        n = len(prefix) + 1
        layers.append((kind, {k[n:]: v.unbind(0) for k, v in params.items()
                              if k.startswith(prefix + "/")}))
    for i in range(cfg.num_periods):
        for kind, p in layers:
            x = _block(cfg, kind, {k: v[i] for k, v in p.items()}, x)
    x = _norm(cfg, params, "final_ln", x)
    return softcap(unembed(params["embed/table"], x), cfg.final_softcap)


class Transformer(nn.Module):
    """The model as an ``nn.Module``: one ``nn.Parameter`` per JAX leaf.
    ``leaves()`` lists them in the JAX flatten order and ``stacked`` flags
    the layer-stacked ones — what the compressed train step hands to the
    sync."""

    def __init__(self, cfg: ModelConfig,
                 params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params.items()})
        shapes = param_shapes(cfg)
        self.leaf_names = leaf_order(self.params.keys())
        self.stacked = [shapes[n][1] for n in self.leaf_names]

    def leaves(self) -> list[nn.Parameter]:
        return [self.params[n] for n in self.leaf_names]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward_train(dict(self.params), self.cfg, tokens)
