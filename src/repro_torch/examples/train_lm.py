"""End-to-end example (port of ``examples/train_lm.py``): train a
transformer LM with Algorithm-1 compressed data-parallel gradient sync,
then save and restore a checkpoint.

Demo (a ~10M-parameter gemma2-family model, gspar on the dense wire):
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 120
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

Production shape (the launcher, full width cut by depth to one card):
    python -m repro_torch.launch.train --arch gemma2-9b --num-periods 4 \\
        --compressor gspar --rho 0.01 --wire gather
"""
import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.core.api import CompressionConfig
from repro_torch.data.synthetic import token_batch
from repro_torch.devices import resolve_device
from repro_torch.launch.train import init_process_group
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import adam
from repro_torch.train import step as step_lib


def main(argv=None) -> float:
    """Returns the checkpoint round trip's largest difference."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = tf.ModelConfig(
        name="demo-lm", vocab=2048, d_model=args.d_model,
        pattern=("attn_sw", "attn_full"), num_periods=args.layers // 2,
        num_heads=8, num_kv_heads=4, head_dim=32, window=64,
        attn_softcap=50.0, final_softcap=30.0, post_norm=True,
        d_ff=args.d_model * 4, act="gelu", norm="rms", embed_scale=True,
        dtype=torch.float32)
    device = resolve_device(args.device)
    own_group = init_process_group(device)
    try:
        model = tf.Transformer(cfg, tf.init_model(
            cfg, torch.Generator(device=device).manual_seed(0), device))
        n = sum(p.numel() for p in model.leaves())
        print(f"model: {n / 1e6:.1f}M params")
        opt = adam(1e-3)
        opt_state = opt.init(model.leaves())
        comp = CompressionConfig(name="gspar", rho=args.rho, wire="dense",
                                 min_leaf_size=512)
        step = step_lib.make_compressed_train_step(model, comp, opt)
        data = torch.Generator(device=device).manual_seed(1)
        comp_gen = torch.Generator(device=device).manual_seed(2)
        first = last = None
        for i in range(args.steps):
            batch = token_batch(data, cfg.vocab, 8, 128)
            opt_state, m = step(opt_state, batch, comp_gen)
            last = float(m["loss"])
            first = last if first is None else first
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:>4} loss {last:.4f} "
                      f"density {float(m['density']):.4f} "
                      f"var x{float(m['var_ratio']):.2f} bits saved "
                      f"{float(m['dense_bits']) / max(float(m['bits']), 1):.1f}x",
                      flush=True)
        assert last < first, "loss did not improve"

        path = os.path.join(tempfile.mkdtemp(), "demo_ckpt.npz")
        checkpoint.save(path, model)
        restored = tf.Transformer(cfg, tf.init_model(
            cfg, torch.Generator(device=device).manual_seed(3), device))
        checkpoint.restore(path, restored)
        diff = max(float((a - b).detach().abs().max())
                   for a, b in zip(restored.leaves(), model.leaves()))
        print(f"checkpoint roundtrip max diff: {diff} -> {path}")
        print("OK")
        return diff
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
