"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 (d_state=64) + shared
attention blocks (32H kv=32, d_ff=10240) applied every 6 mamba layers with
per-site LoRA adapters. [arXiv:2411.15242] (port of
``repro.configs.zamba2_2b7``)

Structure here: 9 periods of [shared_attn, mamba x6] (the shared block's
weights are stored once; each site adds a rank-64 LoRA on its input
projection — faithful to zamba2's weight-shared design). The JAX spec's
sharding rule (``RULES``) waits for the port's sharding (ROADMAP.md queue
A item 10)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.ssm import Mamba2Config
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", vocab=32_000, d_model=2560,
    pattern=("shared_attn", "mamba", "mamba", "mamba", "mamba", "mamba",
             "mamba"),
    num_periods=9,                                   # 54 mamba + 9 shared sites
    num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, mlp_kind="gated", act="gelu",
    mamba=Mamba2Config(d_model=2560, d_state=64, head_dim=64, expand=2,
                       conv_width=4, chunk=64),
    shared_lora_rank=64,
    norm="rms", dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", vocab=512, d_model=128,
    pattern=("shared_attn", "mamba", "mamba"),
    num_periods=1,
    num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=256, mlp_kind="gated", act="gelu",
    mamba=Mamba2Config(d_model=128, d_state=16, head_dim=16, chunk=8),
    shared_lora_rank=8,
    norm="rms", dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIP_NOTES: dict[str, str] = {}

# sharding-rule overrides (the JAX config's RULES)
RULES = {"head_dim": None}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="zamba2-2.7b", source="arXiv:2411.15242",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES,
                    rules_overrides=RULES)
