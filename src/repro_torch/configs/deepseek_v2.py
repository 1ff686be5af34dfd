"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512, q_lora=1536,
qk_nope=128, qk_rope=64, v=128), layer 0 dense FFN (12288), layers 1-59 MoE:
160 routed experts (d_expert=1536) top-6 + 2 shared experts, vocab=102400.
[arXiv:2405.04434] (port of ``repro.configs.deepseek_v2``)

Trains in fsdp mode (+ Algorithm-1 step-7 compression): a 472 GB bf16
replica per model shard does not fit a v5e chip, so data-axis replication
(required by the per-worker Q(g) path) is infeasible — documented in
DESIGN.md section Arch-applicability. Optimizer moments in bf16. (The port
keeps the mode: past one worker each holds its blocks under FSDP_RULES;
on one 80 GB card the depth is cut.)"""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b", vocab=102_400, d_model=5120,
    prelude=("mla_dense",), pattern=("mla",), num_periods=59,   # 60 layers
    num_heads=128, first_dense_ff=12288,
    rope_theta=10_000.0, norm="rms",
    moe=MoEConfig(d_model=5120, d_expert=1536, num_experts=160, top_k=6,
                  num_shared=2, capacity_factor=1.25, act="silu"),
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke", vocab=512, d_model=128,
    prelude=("mla_dense",), pattern=("mla",), num_periods=1,    # 2 layers
    num_heads=4, first_dense_ff=256,
    mla_kv_lora=32, mla_q_lora=48, mla_qk_nope=16, mla_qk_rope=8, mla_v=16,
    norm="rms",
    moe=MoEConfig(d_model=128, d_expert=64, num_experts=4, top_k=2,
                  num_shared=1, capacity_factor=2.0, act="silu"),
    dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIP_NOTES = {"long_500k": (
                 "full attention (MLA compresses the cache but attention stays"
                 " global/quadratic in prefill; 500k decode cache exceeds "
                 "budget at batch=1 x 60L even compressed).")}

# sharding-rule overrides (the JAX config's RULES)
RULES = {"kv_lora": None, "qk_rope": None}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="deepseek-v2-236b", source="arXiv:2405.04434",
                    model=FULL, smoke=SMOKE, train_mode="fsdp",
                    shapes=SHAPES, skip_notes=SKIP_NOTES,
                    rules_overrides=RULES)
