"""seamless-m4t-large-v2 [audio]: enc-dec transformer backbone, 24L encoder +
24L decoder, d_model=1024 16H (kv=16) d_ff=8192, vocab=256206.
[arXiv:2308.11596] (port of ``repro.configs.seamless_m4t_large_v2``)

The speech frontend (mel + conformer feature extractor) is a stub, as in
the JAX package: the batch carries frame embeddings [B, frames, 1024] with
frames = ``frames_for(seq_len)`` (``launch.specs``). RoPE replaces the
original sinusoidal positions, as in the JAX package."""
import torch

from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import ModelConfig


def _cfg(seq_frames: int, smoke=False):
    if smoke:
        return ModelConfig(
            name="seamless-m4t-smoke", vocab=512, d_model=128,
            pattern=("attn_full",), num_periods=2, encoder_periods=2,
            num_heads=4, num_kv_heads=4, head_dim=32,
            d_ff=256, mlp_kind="dense", act="gelu", use_bias=True,
            norm="layer", prefix_len=seq_frames, modality="audio",
            dtype=torch.float32)
    return ModelConfig(
        name="seamless-m4t-large-v2", vocab=256_206, d_model=1024,
        pattern=("attn_full",), num_periods=24, encoder_periods=24,
        num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=8192, mlp_kind="dense", act="gelu", use_bias=True,
        norm="layer", prefix_len=seq_frames, modality="audio",
        dtype=torch.bfloat16)


FULL = _cfg(1024)            # frames follow the sequence via frames_for()
SMOKE = _cfg(8, smoke=True)


def frames_for(seq_len: int) -> int:
    """Stub frames for ``seq_len`` tokens: a quarter (the w2v-BERT 8 -> 2
    downsampling's stand-in), at least 64."""
    return max(64, seq_len // 4)


# the input shapes the arch runs and why it skips the others (the JAX
# spec's)
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIP_NOTES = {"long_500k": (
                 "enc-dec translation model; a 500k-token decoder target is "
                 "outside its operating envelope and attention is full "
                 "(quadratic prefill).")}


def spec() -> ArchSpec:
    return ArchSpec(arch_id="seamless-m4t-large-v2",
                    source="arXiv:2308.11596", model=FULL, smoke=SMOKE,
                    shapes=SHAPES, skip_notes=SKIP_NOTES)
