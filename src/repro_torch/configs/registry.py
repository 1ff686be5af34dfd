"""Architecture registry (port of ``repro.configs.registry``): every
architecture of the JAX registry. The dense attention architectures
gemma-2b, gemma2-9b, gemma2-27b and starcoder2-7b, the MoE
phi3.5-moe-42b-a6.6b, the MLA + MoE deepseek-v2-236b, the SSM rwkv6-1.6b,
the hybrid zamba2-2.7b, the vision-prefix paligemma-3b and the
encoder-decoder seamless-m4t-large-v2. ``SHAPES`` and each spec's
``shapes``, ``skip_notes`` and ``rules_overrides`` (the sharding rules an
arch changes, ``dist.sharding``) are the JAX registry's."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from repro_torch.models.transformer import ModelConfig

# the input shapes of the paper's runs: (seq_len, global_batch, kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

ID_TO_MODULE = {"gemma-2b": "gemma_2b", "gemma2-9b": "gemma2_9b",
                "gemma2-27b": "gemma2_27b", "starcoder2-7b": "starcoder2_7b",
                "phi3.5-moe-42b-a6.6b": "phi35_moe",
                "deepseek-v2-236b": "deepseek_v2",
                "rwkv6-1.6b": "rwkv6_1b6", "zamba2-2.7b": "zamba2_2b7",
                "paligemma-3b": "paligemma_3b",
                "seamless-m4t-large-v2": "seamless_m4t_large_v2"}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str             # canonical id
    source: str              # paper / model-card citation
    model: ModelConfig       # full-size config
    smoke: ModelConfig       # reduced variant for the CPU
    shapes: tuple[str, ...]  # the input shapes (``SHAPES``) it runs
    skip_notes: dict[str, str]   # shape -> why skipped
    train_mode: str = "compressed"   # compressed (Alg. 1) | fsdp (+ step 7)
    rules_overrides: dict[str, Any] = dataclasses.field(default_factory=dict)


def get(arch: str) -> ArchSpec:
    if arch not in ID_TO_MODULE:
        raise KeyError(f"unknown arch {arch!r}; have {tuple(ID_TO_MODULE)}")
    return importlib.import_module(
        f"repro_torch.configs.{ID_TO_MODULE[arch]}").spec()
