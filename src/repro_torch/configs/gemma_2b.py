"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) head_dim=256 d_ff=16384
vocab=256000 — GeGLU, embed scaling, full global attention, bf16.
[arXiv:2403.08295] (port of ``repro.configs.gemma_2b``)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="gemma-2b", vocab=256_000, d_model=2048,
    pattern=("attn_full",), num_periods=18,
    num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, rope_theta=10_000.0,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke", vocab=512, d_model=256,
    pattern=("attn_full",), num_periods=2,
    num_heads=4, num_kv_heads=1, head_dim=64,
    d_ff=512, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIP_NOTES = {"long_500k": (
                 "gemma-1 has full global attention only; no sliding-"
                 "window/sub-quadratic variant exists in the source model.")}

# sharding-rule overrides (the JAX config's RULES)
RULES = {"heads": None, "kv_heads": None, "head_dim": "model"}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="gemma-2b", source="arXiv:2403.08295",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES,
                    rules_overrides=RULES)
