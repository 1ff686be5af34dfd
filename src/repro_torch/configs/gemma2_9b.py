"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000 — alternating local(4096)/global attention, logit
softcaps, GeGLU, sandwich norms, embed scaling. [arXiv:2408.00118]
(port of ``repro.configs.gemma2_9b``)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="gemma2-9b", vocab=256_000, d_model=3584,
    pattern=("attn_sw", "attn_full"), num_periods=21,          # 42 layers
    num_heads=16, num_kv_heads=8, head_dim=256, window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    d_ff=14336, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, rope_theta=10_000.0,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke", vocab=512, d_model=256,
    pattern=("attn_sw", "attn_full"), num_periods=1,           # 2 layers
    num_heads=4, num_kv_heads=2, head_dim=32, window=8,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    d_ff=512, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIP_NOTES: dict[str, str] = {}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="gemma2-9b", source="arXiv:2408.00118",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES)
