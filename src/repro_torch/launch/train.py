"""Training launcher (port of ``repro.launch.train`` for the compressed mode).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --steps 3 --compressor gspar --rho 0.05 --error-feedback

``--wire`` defaults to ``dense``, as in the JAX launcher: each worker's
Q(g) in dense layout, averaged in worker order (an ordered reduce-scatter
and all-gather per leaf dtype). There ``--compressor`` takes every
selector (``gspar``, ``agspar``, ``unisp``, ``topk``, ``bernoulli``,
``identity``) with every codec (``gspar+qsgd8``, ``topk+ternary``, or
``--codec``) and the aliases ``qsgd``, ``terngrad`` and ``none``.
``--wire gather`` sends the sparse compact buffers instead, for every
selector but agspar and identity (with ``qsgd`` and ``none``), which the
JAX package runs on its reference backend (ROADMAP.md queue A item 4).

Runs on the card unless ``--device cpu`` is given. With no process group
initialized it starts a one-worker group itself (NCCL on the card, gloo on
the CPU), so the exchange goes through ``torch.distributed`` either way;
under ``torchrun`` (``WORLD_SIZE`` in the environment) each process is one
data-parallel worker. ``--num-periods`` cuts the depth; widths are never
narrowed. On the gather wire ``--wire-layout`` defaults to ``auto``, as in
the JAX launcher: each shape group takes the layout with the fewest wire
bytes (RICE on every gemma-2b group at rho 0.05), printed once per group
after the first step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core.api import CompressionConfig
from repro_torch.data.synthetic import token_batch
from repro_torch.devices import resolve_device
from repro_torch.models.transformer import Transformer, init_model
from repro_torch.optim.optimizers import adam, init_feedback, sgd
from repro_torch.train import step as step_lib


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device: torch.device) -> bool:
    """Start the default process group if none is running. Returns True
    when this call started it (and the caller should destroy it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    return True


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--num-periods", type=int, default=None,
                    help="cut the depth (layers); widths stay as published")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="sequences per worker")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--compressor", default="gspar",
                    help="selector[+codec] composition (gspar, agspar, "
                         "unisp, topk, bernoulli, identity; e.g. "
                         "'gspar+qsgd8', 'topk+ternary') or a legacy alias "
                         "(qsgd, terngrad, none); agspar and identity run "
                         "on the dense wire only (the gather wire's are "
                         "ROADMAP.md queue A item 4)")
    ap.add_argument("--codec", default=None,
                    choices=[None, "f32", "bf16", "qsgd4", "qsgd8",
                             "ternary"],
                    help="value codec for the kept coordinates (default: "
                         "from --compressor, else f32)")
    ap.add_argument("--qsgd-bits", type=int, default=4,
                    help="levels exponent for the legacy 'qsgd' alias")
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--wire", default="dense",
                    choices=["dense", "gather", "packed"])
    ap.add_argument("--wire-layout", default="auto",
                    choices=["auto", "coo", "bitmap", "dense", "rice"])
    ap.add_argument("--exchange", default="sync", choices=["sync", "overlap"])
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--min-leaf-size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the launcher; returns a summary: ``metrics`` (a dict of floats
    per step), ``step_seconds``, ``params``, ``layouts`` (``(rows, d, k_cap,
    layout)`` per sparse group) and, on the card, ``max_memory_allocated``."""
    args = parse_args(argv)
    spec = registry.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    if args.num_periods is not None:
        cfg = dataclasses.replace(cfg, num_periods=args.num_periods)
    comp = CompressionConfig(name=args.compressor, codec=args.codec,
                             qsgd_bits=args.qsgd_bits, rho=args.rho,
                             wire=args.wire,
                             wire_layout=args.wire_layout,
                             exchange=args.exchange,
                             error_feedback=args.error_feedback,
                             min_leaf_size=args.min_leaf_size)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    own_group = init_process_group(device)
    try:
        return _train(args, cfg, comp, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, cfg, comp, device) -> dict:
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        print(f"arch={cfg.name} layers={cfg.num_layers} "
              f"d_model={cfg.d_model} workers={world} device={device}")
        print(f"compression: {comp.describe()}")
    init_gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Transformer(cfg, init_model(cfg, init_gen, device))
    n_params = sum(p.numel() for p in model.leaves())
    if rank == 0:
        print(f"params: {n_params}")
    opt = adam(args.lr) if args.optimizer == "adam" else sgd(args.lr)
    opt_state = opt.init(model.leaves())
    ef_state = init_feedback(model.leaves()) if comp.error_feedback else None
    train_step = step_lib.make_compressed_train_step(model, comp, opt)
    # one data stream and one compression stream per worker
    data_gen = torch.Generator(device=device).manual_seed(
        1_000_003 * (args.seed + 1) + rank)
    comp_gen = torch.Generator(device=device).manual_seed(
        2_000_003 * (args.seed + 1) + rank)

    history, step_seconds = [], []
    for step_i in range(args.steps):
        t0 = time.perf_counter()
        batch = token_batch(data_gen, cfg.vocab, args.batch, args.seq)
        if ef_state is not None:
            opt_state, ef_state, metrics = train_step(opt_state, ef_state,
                                                      batch, comp_gen)
        else:
            opt_state, metrics = train_step(opt_state, batch, comp_gen)
        m = {k: float(v) for k, v in metrics.items()}    # waits for the step
        step_seconds.append(time.perf_counter() - t0)
        history.append(m)
        if rank == 0 and step_i == 0:
            for rows, d, k_cap, layout in train_step.layouts:
                print(f"group [{rows}, {d}] k_cap {k_cap}: layout {layout}")
        if rank == 0 and (step_i % args.log_every == 0
                          or step_i == args.steps - 1):
            print(f"step {step_i:>5} loss {m['loss']:.4f} "
                  f"density {m['density']:.5f} var x{m['var_ratio']:.2f} "
                  f"msg_bits {m['bits']:.4g} wire_bytes {m['wire_bytes']:.0f} "
                  f"overflow {m['overflow']:.0f} "
                  f"({step_seconds[-1]:.3f} s)", flush=True)
    summary = {"metrics": history, "step_seconds": step_seconds,
               "params": n_params, "layouts": list(train_step.layouts)}
    if device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
