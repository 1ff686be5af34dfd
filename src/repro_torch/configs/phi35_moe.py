"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) head_dim=128,
16 experts (d_expert=6400) top-2 routing, vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct] (port of ``repro.configs.phi35_moe``)

Routing: standard top-2 softmax gating + switch load-balance aux (the released
model trains with SparseMixer; top-2 softmax is the inference-equivalent
standard formulation — documented adaptation)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe", vocab=32_064, d_model=4096,
    pattern=("attn_full",), num_periods=32,
    num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=10_000.0, norm="layer",
    moe=MoEConfig(d_model=4096, d_expert=6400, num_experts=16, top_k=2,
                  capacity_factor=1.25, act="silu"),
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", vocab=512, d_model=256,
    pattern=("attn_full",), num_periods=2,
    num_heads=8, num_kv_heads=2, head_dim=32,
    norm="layer",
    moe=MoEConfig(d_model=256, d_expert=128, num_experts=4, top_k=2,
                  capacity_factor=2.0, act="silu"),
    dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIP_NOTES = {"long_500k": (
                 "full global attention; no sub-quadratic variant in the "
                 "source model.")}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="phi3.5-moe-42b-a6.6b",
                    source="hf:microsoft/Phi-3.5-MoE-instruct",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES)
