"""Architecture registry (port of ``repro.configs.registry``): the dense
attention architectures gemma-2b, gemma2-9b, gemma2-27b and starcoder2-7b.
The other six (MoE, MLA, SSM, hybrid, encoder-decoder, vision prefix) are
ROADMAP.md queue A item 10."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer import ModelConfig

ID_TO_MODULE = {"gemma-2b": "gemma_2b", "gemma2-9b": "gemma2_9b",
                "gemma2-27b": "gemma2_27b", "starcoder2-7b": "starcoder2_7b"}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str             # canonical id
    source: str              # paper / model-card citation
    model: ModelConfig       # full-size config
    smoke: ModelConfig       # reduced variant for the CPU


def get(arch: str) -> ArchSpec:
    if arch not in ID_TO_MODULE:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP.md queue A item 10); "
            f"have {tuple(ID_TO_MODULE)}")
    return importlib.import_module(
        f"repro_torch.configs.{ID_TO_MODULE[arch]}").spec()
