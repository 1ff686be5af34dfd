"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) head_dim=128
d_ff=18432 vocab=49152 — sliding-window-4096 attention, RoPE (base 1e5),
LayerNorm, plain GELU MLP with biases. [arXiv:2402.19173] (port of
``repro.configs.starcoder2_7b``)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="starcoder2-7b", vocab=49_152, d_model=4608,
    pattern=("attn_sw",), num_periods=32,
    num_heads=36, num_kv_heads=4, head_dim=128, window=4096,
    rope_theta=100_000.0, use_bias=True,
    d_ff=18432, mlp_kind="dense", act="gelu",
    norm="layer", dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", vocab=512, d_model=252,   # 36 heads need d%36
    pattern=("attn_sw",), num_periods=2,
    num_heads=6, num_kv_heads=2, head_dim=42, window=8,
    rope_theta=100_000.0, use_bias=True,
    d_ff=512, mlp_kind="dense", act="gelu",
    norm="layer", dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIP_NOTES: dict[str, str] = {}

# sharding-rule overrides (the JAX config's RULES)
RULES = {"heads": None, "kv_heads": None, "head_dim": "model"}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="starcoder2-7b", source="arXiv:2402.19173",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES,
                    rules_overrides=RULES)
