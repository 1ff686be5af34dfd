"""paligemma-3b [vlm]: gemma-2b language backbone (18L d_model=2048 8H kv=1
d_ff=16384) + SigLIP vision frontend, vocab=257216. [arXiv:2407.07726]
(port of ``repro.configs.paligemma_3b``)

The SigLIP encoder and projector are a stub, as in the JAX package: the
batch carries 256 precomputed patch embeddings [B, 256, 2048]
(``launch.specs``), put before the text tokens. The JAX spec's sharding
rule (``RULES``) waits for the port's sharding (ROADMAP.md queue A item
10d)."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import ModelConfig

NUM_PATCHES = 256

FULL = ModelConfig(
    name="paligemma-3b", vocab=257_216, d_model=2048,
    pattern=("attn_full",), num_periods=18,
    num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, rope_theta=10_000.0,
    prefix_len=NUM_PATCHES, modality="vision",
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke", vocab=512, d_model=256,
    pattern=("attn_full",), num_periods=2,
    num_heads=4, num_kv_heads=1, head_dim=64,
    d_ff=512, mlp_kind="gated", act="gelu",
    norm="rms", embed_scale=True, prefix_len=8, modality="vision",
    dtype=torch.float32,
)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIP_NOTES = {"long_500k": (
                 "gemma-1 backbone: full global attention only.")}

# sharding-rule overrides (the JAX config's RULES)
RULES = {"heads": None, "kv_heads": None, "head_dim": "model"}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="paligemma-3b", source="arXiv:2407.07726",
                    model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES,
                    rules_overrides=RULES)
