"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free, head_size=64 -> 32
heads) d_ff=7168 vocab=65536 — Finch: data-dependent per-channel decay via
low-rank projections, token-shift mixing. [arXiv:2404.05892]
(port of ``repro.configs.rwkv6_1b6``)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.ssm import RWKV6Config
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="rwkv6-1.6b", vocab=65_536, d_model=2048,
    pattern=("rwkv",), num_periods=24,
    rwkv=RWKV6Config(d_model=2048, head_dim=64, d_ff=7168,
                     tm_lora=32, w_lora=64, chunk=64),
    norm="layer", dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", vocab=512, d_model=128,
    pattern=("rwkv",), num_periods=2,
    rwkv=RWKV6Config(d_model=128, head_dim=32, d_ff=448,
                     tm_lora=8, w_lora=16, chunk=8),
    norm="layer", dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIP_NOTES: dict[str, str] = {}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="rwkv6-1.6b", source="arXiv:2404.05892",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES)
