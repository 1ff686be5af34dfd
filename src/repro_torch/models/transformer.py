"""Dense decoder-only transformer (port of ``repro.models.transformer`` for
the ``attn_full`` block with a gated FFN: ``ModelConfig``, ``init_model``
and ``forward_train``).

Parameters keep the JAX layout and names: the per-layer block parameters of
all ``num_periods`` layers are stacked on a leading axis, one tensor each,
so compression sees one row per layer (paper section 5.2) and the leaves,
walked in the JAX flatten order, group exactly as the JAX plan groups them.
The MoE, MLA, SSM, hybrid, encoder-decoder and multimodal blocks, the
sandwich norms and softcaps are ROADMAP.md queue A item 10.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import Initializer, leaf_order
from repro_torch.models.layers import embed, gated_mlp, rmsnorm, unembed

BLOCK = "blocks/b0_attn_full"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    pattern: tuple[str, ...]            # one period of block kinds
    num_periods: int                    # layers (one block per period)
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 10000.0
    d_ff: int = 0
    mlp_kind: str = "gated"
    act: str = "gelu"
    norm: str = "rms"
    embed_scale: bool = False
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if (self.pattern != ("attn_full",) or self.mlp_kind != "gated"
                or self.norm != "rms" or not self.tie_embeddings):
            raise NotImplementedError(
                "only the dense attn_full block with a gated MLP, RMSNorm "
                "and tied embeddings is ported (ROADMAP.md queue A item 10)")

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.num_periods

    def attn_cfg(self) -> attn.AttnConfig:
        return attn.AttnConfig(d_model=self.d_model, num_heads=self.num_heads,
                               num_kv_heads=self.num_kv_heads,
                               head_dim=self.head_dim,
                               rope_theta=self.rope_theta)


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], bool]]:
    """Path -> (shape, stacked) for every parameter."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    per_layer = {
        "attn/wq": (d, h, hd), "attn/wk": (d, kv, hd),
        "attn/wv": (d, kv, hd), "attn/wo": (h, hd, d),
        "ffn/gate": (d, ff), "ffn/up": (d, ff), "ffn/down": (ff, d),
        "ln1/scale": (d,), "ln2/scale": (d,),
    }
    out = {f"{BLOCK}/{k}": ((cfg.num_periods,) + s, True)
           for k, s in per_layer.items()}
    out["embed/table"] = ((cfg.vocab, d), False)
    out["final_ln/scale"] = ((d,), False)
    return out


_FAN_IN_DIM = {"attn/wo": 1}


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX package's distributions: the
    embedding N(0, 1), projections N(0, 1/fan_in), norm scales 0."""
    dev = resolve_device(device)
    ini = Initializer(generator, cfg.dtype, dev)
    params = {}
    for name, (shape, stacked) in param_shapes(cfg).items():
        if name.endswith("/scale"):
            params[name] = ini.zeros(shape)
        elif name == "embed/table":
            params[name] = ini.normal(shape, stddev=1.0)
        else:
            short = name[len(BLOCK) + 1:]
            params[name] = ini.fan_in(shape[1:], _FAN_IN_DIM.get(short, 0),
                                      layers=shape[0])
    return params


def forward_train(params: dict[str, torch.Tensor], cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (the parameter dtype)."""
    acfg = cfg.attn_cfg()
    x = embed(params["embed/table"], tokens, cfg.embed_scale).to(cfg.dtype)
    # one unbind per stacked leaf: its backward stacks the layer gradients
    # once, where indexing layer by layer would add a zero-filled copy of
    # the whole leaf per layer into its gradient
    p = {k[len(BLOCK) + 1:]: v.unbind(0) for k, v in params.items()
         if k.startswith(BLOCK)}
    for i in range(cfg.num_periods):
        h = rmsnorm(p["ln1/scale"][i], x)
        x = x + attn.attention_train(p["attn/wq"][i], p["attn/wk"][i],
                                     p["attn/wv"][i], p["attn/wo"][i],
                                     acfg, h)
        h = rmsnorm(p["ln2/scale"][i], x)
        x = x + gated_mlp(p["ffn/gate"][i], p["ffn/up"][i],
                          p["ffn/down"][i], h, cfg.act)
    x = rmsnorm(params["final_ln/scale"], x)
    return unembed(params["embed/table"], x)


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
