"""Serving demo (port of ``examples/serve_decode.py``): prefill a batch of
prompts, then decode greedily against the caches, which both steps update
in place.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch gemma2-9b --batch 2 --prompt-len 32768 --tokens 33 \\
        --max-seq 32800 --attn-impl chunked

The first runs the arch's smoke config on the CPU; the second gemma2-9b
at full width and depth on the card (random weights from ``--seed``),
prefilling a 32,768-token prompt with chunked attention. ``--num-periods``
cuts the depth. A vision model's stub patches go before the prompt (its
first decode position is ``P + S``), an encoder-decoder's stub frames
through the encoder (``launch.specs``).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import registry
from repro_torch.devices import resolve_device
from repro_torch.launch import specs
from repro_torch.models import transformer as tf
from repro_torch.train.step import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params: dict, cfg: tf.ModelConfig, batch: dict, steps: int,
          max_seq: int | None = None) -> dict:
    """Prefill ``batch`` into fresh caches, take each sequence's argmax
    token, then ``steps`` greedy decode steps. Returns the generated
    tokens [B, steps + 1], the prefill's and the decode loop's seconds
    (host clock, synchronized), the caches and their bytes."""
    dev = batch["tokens"].device
    b, s = batch["tokens"].shape
    offset = s + (cfg.prefix_len if cfg.modality == "vision"
                  and "prefix" in batch else 0)
    caches = tf.init_model_cache(cfg, b, max_seq or offset + steps, dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits = prefill(params, batch, caches)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(steps):
        logits = decode(params, caches, tok, offset + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.cat(out, 1), "prefill_s": t1 - t0,
            "decode_s": time.perf_counter() - t1, "caches": caches,
            "cache_bytes": tf.cache_bytes(caches)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--num-periods", type=int, default=None,
                    help="cut the depth to this many periods")
    ap.add_argument("--attn-impl", choices=("naive", "chunked"),
                    default=None, help="default: the config's")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24,
                    help="tokens generated a sequence (the prefill's "
                         "first, then decode steps)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache positions (default: prefix + prompt + "
                         "tokens)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = registry.get(args.arch)
    cfg = (spec.smoke if args.smoke
           else specs.model_for_seq(spec.model, args.prompt_len))
    if args.num_periods is not None:
        cfg = dataclasses.replace(cfg, num_periods=args.num_periods)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    params = tf.init_model(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    batch = specs.train_batch(torch.Generator(device=dev).manual_seed(
        args.seed + 1), cfg, args.batch, args.prompt_len)
    out = serve(params, cfg, batch, args.tokens - 1, args.max_seq)
    b, s, steps = args.batch, args.prompt_len, args.tokens - 1
    n_params = sum(t.numel() for t in params.values())
    print(f"{cfg.name}: {n_params:,} parameters, "
          f"{cfg.num_layers} layers, attention {cfg.attn_impl}, cache "
          f"{out['cache_bytes']:,} B")
    print(f"prefill[{b}x{s}] in {out['prefill_s']:.2f}s "
          f"({b * s / out['prefill_s']:.1f} tok/s)")
    if steps:
        print(f"decoded {steps} tokens/seq x{b} in {out['decode_s']:.2f}s "
              f"({1e3 * out['decode_s'] / steps:.2f} ms a step, "
              f"{b * steps / out['decode_s']:.1f} tok/s)")
    print("sample token ids:", out["tokens"][0, :12].tolist())
    print("OK")
    return {k: v for k, v in out.items() if k != "caches"}


if __name__ == "__main__":
    main()
