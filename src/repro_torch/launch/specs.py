"""The train batch of each architecture (port of the train-input part of
``repro.launch.specs``: ``arch_model_for_shape``'s frame rule and
``train_batch_structs``' shapes), and the launcher's batches built from
them.

Besides ``tokens`` [B, S] int32, a vision model (``modality ==
"vision"``) takes ``prefix``, its stub patch embeddings, and an
encoder-decoder (``encoder_periods > 0``) ``enc_embeds``, its stub frame
embeddings, both bfloat16 [B, prefix_len, d_model]. An audio model's frame
count follows the sequence (``frames_for``); the JAX package applies that
rule to the full config only, so a smoke config keeps its own.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.seamless_m4t_large_v2 import frames_for
from repro_torch.data.synthetic import stub_embeddings, token_batch
from repro_torch.models.transformer import ModelConfig

STUB_DTYPE = torch.bfloat16


def model_for_seq(cfg: ModelConfig, seq: int) -> ModelConfig:
    """The full config at sequence length ``seq``: an audio model's frames
    follow it (``frames_for``: 64 at 128 tokens, 1,024 at 4,096)."""
    if cfg.modality == "audio":
        cfg = dataclasses.replace(cfg, prefix_len=frames_for(seq))
    return cfg


def stub_inputs(cfg: ModelConfig, batch: int
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Name -> (shape, dtype) of the inputs past the tokens, in the order
    the batch draws them."""
    shape = (batch, cfg.prefix_len, cfg.d_model)
    out = {}
    if cfg.modality == "vision" and cfg.prefix_len:
        out["prefix"] = (shape, STUB_DTYPE)
    if cfg.encoder_periods:
        out["enc_embeds"] = (shape, STUB_DTYPE)
    return out


def train_batch(generator: torch.Generator, cfg: ModelConfig, batch: int,
                seq: int) -> dict[str, torch.Tensor]:
    """One train batch on the generator's device: ``token_batch``'s tokens,
    then the stub inputs drawn after them from the same generator, so a
    seed fixes both."""
    out = token_batch(generator, cfg.vocab, batch, seq)
    for name, (shape, dtype) in stub_inputs(cfg, batch).items():
        out[name] = stub_embeddings(generator, shape, dtype)
    return out
