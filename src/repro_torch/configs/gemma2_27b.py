"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) head_dim=128
d_ff=36864 vocab=256000 — local/global alternation, logit softcaps; the 27b
variant scales queries by (d_model/num_heads)^-0.5 = 144^-0.5.
[arXiv:2408.00118] (port of ``repro.configs.gemma2_27b``)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="gemma2-27b", vocab=256_000, d_model=4608,
    pattern=("attn_sw", "attn_full"), num_periods=23,          # 46 layers
    num_heads=32, num_kv_heads=16, head_dim=128, window=4096,
    query_scale=(4608 / 32) ** -0.5,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    d_ff=36864, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, rope_theta=10_000.0,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke", vocab=512, d_model=256,
    pattern=("attn_sw", "attn_full"), num_periods=1,
    num_heads=8, num_kv_heads=4, head_dim=32, window=8,
    query_scale=(256 / 8) ** -0.5,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    d_ff=512, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIP_NOTES: dict[str, str] = {}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="gemma2-27b", source="arXiv:2408.00118",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES)
