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
composition (agspar and identity, with ``qsgd`` and ``none``, on the
reference backend, as the JAX package runs them; ``--backend reference``
puts every composition there); ``--wire packed`` is gather with bf16 values
where the composition names no codec. ``--exchange overlap`` issues the
sparse wire's buckets (``--overlap-bucket-bytes``) before it waits on any.
``--adaptive`` (with ``--error-feedback``) runs the adaptive control loop:
delta coding (``--delta-beta``), skipping (``--skip-tau``, ``--bound-decay``);
``--rice-fitted`` ships the data-fitted Golomb-Rice parameter (wire-format
v4) on the RICE groups. Each logged step then prints ``skipped``.

Runs on the card unless ``--device cpu`` is given. With no process group
initialized it starts a one-worker group itself (NCCL on the card, gloo on
the CPU), so the exchange goes through ``torch.distributed`` either way;
under ``torchrun`` (``WORLD_SIZE`` in the environment) each process is one
worker. ``--mesh PxDxM`` lays the workers out as P pods of D data workers
of M model workers each (ranks model-minor, ``rank = (p * D + d) * M +
m``: the device order of the JAX launcher's (pod, data, model) mesh), and
the exchange is the pod hierarchy: the data groups, then the pod stage
across the pods (``--resparsify-pods``: Algorithm 1's step 7, with
``--error-feedback`` on the pod's own residual). ``--mesh 1x1x1`` runs the
pod stage over groups of one. ``--mesh DxM`` is (data, model). A model
axis (M > 1) splits every leaf the JAX launcher's rules split
(``dist.sharding``, ``leaf_specs``): each worker compresses and exchanges
its own shard (``train.step``'s ``ModelAxis``), the model workers of a
data index take the same batch, and the optimizer's moments, the residual
and the control state hold the shard. Every arch takes the split step
there: a worker holds only its shards of the parameters and runs the
forward and backward on them (``dist.tensor_parallel``). The first line
names it (``step=split``); there is no flag, as the JAX launcher has none
(GSPMD always splits), and a split the step cannot run raises (the
gathered step of ``train.step``, the gradient computed whole on gathered
parameters, is the tests' yardstick and no launcher path). Every run
takes the one step: a model axis of one (no ``--mesh``, or M = 1)
gathers, broadcasts and reduces nothing. Under ``--device cpu`` the ranks take gloo, on the card NCCL (one
process a rank: ``torchrun --nproc-per-node N``).

``--mode`` is ``compressed`` (Algorithm 1: each worker's gradient
compressed and exchanged) or ``fsdp`` (``step.make_fsdp_train_step``: the
gradient averaged over every worker, then Q applied once to the average,
Algorithm 1's step 7, with ``--error-feedback`` on a params-shaped
residual); its default is the architecture's ``train_mode``, as in the
JAX launcher (fsdp for deepseek-v2-236b). Past one worker the fsdp mode
shards as the JAX launcher's ``FSDP_RULES`` do, over the data axis (every
worker without ``--mesh``, as in JAX) and at ``--mesh DxM`` or ``PxDxM``
over the model axis too (``fsdp_layout``): each worker holds its blocks of
the parameters, the optimizer's state and the residual, gathers a leaf
over the data workers just before use and scatters its gradient back
averaged (``dist.fsdp``), runs the split step over the model workers, and
applies Q once, each row's lambda formed over its shards and every shard
of a block drawing the same uniforms. In fsdp mode ``--wire``,
``--exchange`` and the layouts do not act, and ``--adaptive`` exits, as
in JAX; past one worker its compressor is gspar with a float codec (f32,
bf16) or ``none``. Still refused with NotImplementedError: ``--xla-preset``
other than ``none`` (the JAX launcher's default; the XLA presets are
ROADMAP.md queue A item 13).
``--checkpoint PATH`` writes the trained state after the last step in the
JAX launcher's file format (``repro_torch.checkpoint``): the parameters,
the optimizer's state, with ``--error-feedback`` the residual (stacked over
the workers in compressed mode, params-shaped in fsdp mode, gathered from
the workers' blocks) and with
``--adaptive`` the control state, and ``arch``, ``mode``, ``steps``,
``error_feedback`` and ``adaptive`` in ``PATH.meta.json``. ``--arch``
takes every architecture of the JAX registry: gemma-2b, gemma2-9b,
gemma2-27b, starcoder2-7b, phi3.5-moe-42b-a6.6b, deepseek-v2-236b,
rwkv6-1.6b, zamba2-2.7b, paligemma-3b and seamless-m4t-large-v2.
``--num-periods`` cuts the depth (without it a run is full depth); widths
are never narrowed. Each step's batch is ``launch.specs.train_batch``:
the tokens, and for paligemma its 256 stub patch embeddings (``prefix``),
for seamless its stub frame embeddings (``enc_embeds``, ``frames_for
(--seq)`` of them: 64 at 128 tokens), both bfloat16 and drawn from the
data generator after the step's tokens, their shapes printed once. The
JAX launcher feeds tokens alone, so it cannot train seamless and trains
paligemma text-only (ROADMAP.md queue C). On the gather wire
``--wire-layout`` defaults to ``auto``, as in the JAX launcher: each shape
group takes the layout with the fewest wire bytes (RICE on every gemma-2b
group at rho 0.05), printed once per group after the first step.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint
from repro_torch.configs import registry
from repro_torch.core.api import CompressionConfig
from repro_torch.devices import resolve_device
from repro_torch.dist import sharding, tensor_parallel
from repro_torch.launch import specs
from repro_torch.models.common import leaf_order
from repro_torch.models.transformer import (Transformer, init_model,
                                            param_axes, param_shapes)
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
                         "(qsgd, terngrad, none)")
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
    ap.add_argument("--exchange", default="sync", choices=["sync", "overlap"],
                    help="sparse collective structure: end-of-step barrier "
                         "or overlapped per-bucket exchange")
    ap.add_argument("--overlap-bucket-bytes", type=int, default=1 << 20,
                    help="payload cap per overlapped bucket")
    ap.add_argument("--resparsify-pods", action="store_true",
                    help="re-sparsify the pod stage (Algorithm 1 step 7) "
                         "on a --mesh with a pod axis; with "
                         "--error-feedback the pod stage carries its own "
                         "residual")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "pallas"],
                    help="compression backend (auto and pallas: the CUDA "
                         "kernels; reference: dense apply + compaction)")
    ap.add_argument("--mesh", default=None,
                    help="PxDxM => (pod=P, data=D, model=M), or DxM; "
                         "default: every worker on the data axis")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive compression control loop (compressed "
                         "mode, requires --error-feedback): per-step delta "
                         "transmission against the last-sent state, "
                         "LASG-style communication skipping, per-leaf EMA "
                         "energy bounds")
    ap.add_argument("--delta-beta", type=float, default=1.0,
                    help="fraction of the last-sent EMA subtracted before "
                         "compression (0 disables delta coding)")
    ap.add_argument("--skip-tau", type=float, default=0.0,
                    help="skip a leaf's exchange when its delta energy is "
                         "<= tau * EMA bound (0 disables skipping)")
    ap.add_argument("--bound-decay", type=float, default=0.9,
                    help="EMA decay of the per-leaf skip bound")
    ap.add_argument("--rice-fitted", action="store_true",
                    help="data-fitted Golomb-Rice parameter per leaf, "
                         "shipped in the counts-header word (rice layout)")
    ap.add_argument("--xla-preset", default="none",
                    help="the JAX launcher's XLA flag preset: none only "
                         "(the XLA presets are ROADMAP.md queue A item 13)")
    ap.add_argument("--checkpoint", default=None,
                    help="write the trained state here after the last "
                         "step (.npz, the JAX launcher's format)")
    ap.add_argument("--min-leaf-size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mode", default=None, choices=[None, "compressed",
                                                     "fsdp"],
                    help="compressed (Algorithm 1) or fsdp (Q on the "
                         "averaged gradient); default: the arch's "
                         "train_mode")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the launcher; returns a summary: ``metrics`` (a dict of floats
    per step), ``step_seconds``, ``params`` (the whole model's),
    ``param_bytes`` (this worker's: its shards' in the split step),
    ``mode``, ``step`` (``split``, or ``whole`` at one model worker),
    ``layouts`` (``(rows, d, k_cap, layout)`` per sparse group;
    none in fsdp mode) and, on the card, ``max_memory_allocated``."""
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.xla_preset != "none":
        raise NotImplementedError(
            f"--xla-preset {args.xla_preset}: the XLA flag presets are not "
            "ported (ROADMAP.md queue A item 13); the port takes none")
    spec = registry.get(args.arch)
    cfg = spec.smoke if args.smoke else specs.model_for_seq(spec.model,
                                                             args.seq)
    if args.num_periods is not None:
        cfg = dataclasses.replace(cfg, num_periods=args.num_periods)
    mode = args.mode or spec.train_mode
    comp = CompressionConfig(name=args.compressor, codec=args.codec,
                             qsgd_bits=args.qsgd_bits, rho=args.rho,
                             wire=args.wire,
                             wire_layout=args.wire_layout,
                             exchange=args.exchange,
                             error_feedback=args.error_feedback,
                             min_leaf_size=args.min_leaf_size,
                             adaptive=args.adaptive,
                             delta_beta=args.delta_beta,
                             skip_tau=args.skip_tau,
                             bound_decay=args.bound_decay,
                             rice_fitted=args.rice_fitted,
                             resparsify_pods=args.resparsify_pods,
                             overlap_bucket_bytes=args.overlap_bucket_bytes,
                             backend=args.backend)
    if comp.adaptive and mode != "compressed":
        raise SystemExit("--adaptive requires the compressed train mode")
    mesh = parse_mesh(args.mesh)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    own_group = init_process_group(device)
    try:
        return _train(args, cfg, comp, device, mesh, mode,
                      spec.rules_overrides)
    finally:
        if own_group:
            dist.destroy_process_group()


def parse_mesh(text: str | None) -> tuple | None:
    """``--mesh``: ``"PxDxM"`` (pod, data, model) or ``"DxM"`` (data,
    model) -> ``(pods, data, model)``, ``pods`` None for a mesh with no pod
    axis; None without ``--mesh``."""
    if text is None:
        return None
    shape = tuple(int(x) for x in text.split("x"))
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: want PxDxM or DxM")
    return shape if len(shape) == 3 else (None,) + shape


def mesh_groups(mesh):
    """This worker's data group and pod group under ``mesh``
    (``parse_mesh``'s ``(pods, data, model)``, ``pods`` None for no pod
    axis; ranks model-minor, ``rank = (p * D + d) * M + m``, the
    device order of ``jax.make_mesh`` for (pod, data, model)), each from
    ``dist.new_group`` (every rank creates every group, in one order: the
    data groups, one per (pod, model) index, then the pod groups, one per
    (data, model) index), and its pod index; ``(None, None, 0)`` without a
    mesh (every worker on the data axis of the default group).
    ``model_groups`` builds the model axis's groups after these."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh is None:
        return None, None, 0
    pods, data, model = mesh
    if (pods or 1) * data * model != world:
        raise ValueError(f"--mesh of {pods or 1} pods x {data} data x "
                         f"{model} model workers needs "
                         f"{(pods or 1) * data * model} processes, have "
                         f"{world}")
    (p, d), m = divmod(rank // model, data), rank % model
    data_group = pod_group = None
    for q in range(pods or 1):
        for k in range(model):
            grp = dist.new_group([(q * data + j) * model + k
                                  for j in range(data)])
            if (q, k) == (p, m):
                data_group = grp
    if pods is not None:
        for j in range(data):
            for k in range(model):
                grp = dist.new_group([(q * data + j) * model + k
                                      for q in range(pods)])
                if (j, k) == (d, m):
                    pod_group = grp
    return data_group, pod_group, p


def model_groups(mesh) -> tuple:
    """The model axis of ``parse_mesh``'s ``mesh`` for this worker: its
    model group (the M workers of its pod and data index; None at M = 1,
    where no collective crosses it), its model index, their global ranks
    and, with pods past a model axis of one, its worker group (every (pod,
    data) worker of its model index: the metrics' mean), None otherwise.
    Call after ``mesh_groups``, on every rank."""
    pods, data, model = mesh
    rank = dist.get_rank()
    w, m = divmod(rank, model)
    if model == 1:
        return None, 0, (rank,), None
    model_group = ranks = None
    for v in range((pods or 1) * data):
        rs = tuple(v * model + k for k in range(model))
        grp = dist.new_group(list(rs))
        if v == w:
            model_group, ranks = grp, rs
    worker_group = None
    if pods is not None and model > 1:
        for k in range(model):
            grp = dist.new_group([v * model + k
                                  for v in range(pods * data)])
            if k == m:
                worker_group = grp
    return model_group, m, ranks, worker_group


def leaf_specs(cfg, names: list, overrides: dict, mesh) -> tuple:
    """Each leaf's spec on the model axis of the compressed step (leaf
    order ``names``): the JAX launcher's rules (``sharding.launcher_rules``
    of the compressed mode) with the manual axes (data, and pod with pods)
    stripped, resolved on the sizes of ``mesh`` (``(pods, data,
    model)``)."""
    pods, data, model = mesh
    rules = sharding.strip_manual(
        sharding.launcher_rules("compressed", overrides, pods is not None),
        ("pod", "data") if pods is not None else ("data",))
    sizes = {"data": data, "model": model}
    if pods is not None:
        sizes["pod"] = pods
    shapes, axes = param_shapes(cfg), param_axes(cfg)
    return tuple(sharding.resolve_spec(shapes[n][0], axes[n], rules, sizes)
                 for n in names)


def pod_stream_seed(seed: int, mesh, rank: int) -> int:
    """The seed of the pod stage's stream on the worker of ``rank`` under
    ``mesh`` (``(pods, data, model)``): one per (pod, model) index, the
    same on a pod's data workers and apart across its model shards (the
    JAX package's ``_pod_key``)."""
    _, data, model = mesh
    pod, m = rank // (data * model), rank % model
    return 3_000_017 * (seed + 1) + pod * model + m


def _mesh_text(mesh) -> str:
    pods, data, model = mesh
    return (f" mesh=({'' if pods is None else f'pod={pods}, '}"
            f"data={data}, model={model})")


def fsdp_layout(cfg, names: list, overrides: dict, mesh, data_group,
                worker_group, model_axis) -> sharding.FsdpLayout:
    """This worker's ``FsdpLayout`` under ``mesh`` (``(pods, data,
    model)``; without ``--mesh`` every worker on the data axis, as the JAX
    launcher's fsdp mode): the JAX launcher's fsdp rules, the data side's
    group the data group (``mesh_groups``) or under pods every (pod, data)
    worker of this model index (``model_groups``' worker group; the whole
    world at one model worker), ``model_axis`` its model axis."""
    pods, data, model = mesh
    rank = dist.get_rank()
    if pods is None:
        group = data_group if data_group is not None else dist.group.WORLD
        names_d = ("data",)
        coords = {"data": rank // model, "model": rank % model}
    else:
        group = worker_group if model > 1 else dist.group.WORLD
        names_d = ("pod", "data")
        coords = {"pod": rank // (data * model),
                  "data": rank // model % data, "model": rank % model}
    shapes, axes = param_shapes(cfg), param_axes(cfg)
    data_axis = sharding.DataAxis(names=names_d, size=(pods or 1) * data,
                                  index=rank // model, group=group)
    return sharding.fsdp_layout([shapes[n][0] for n in names],
                                [axes[n] for n in names], names, overrides,
                                mesh, coords, data_axis, model_axis)


def step_kind(model_workers: int) -> str:
    """The compressed step at ``model_workers``: ``whole`` at one, past it
    ``split`` (every arch)."""
    return "whole" if model_workers == 1 else "split"


def _train(args, cfg, comp, device, mesh, mode: str, overrides: dict
           ) -> dict:
    rank, world = dist.get_rank(), dist.get_world_size()
    data_group, pod_group, _ = mesh_groups(mesh)
    fsdp = mode == "fsdp"
    # the model axis: this worker's shard of every leaf (one model worker
    # without a mesh)
    axes = mesh or (None, world, 1)
    model_group, m_index, ranks, worker_group = model_groups(axes)
    names = leaf_order(param_shapes(cfg))
    ma = sharding.ModelAxis(
        size=axes[2], index=m_index, group=model_group, ranks=ranks,
        specs=leaf_specs(cfg, names, overrides, axes))
    # the fsdp mode past one worker: this worker's blocks under FSDP_RULES
    # (at one worker every leaf whole, the step without a layout)
    layout = (fsdp_layout(cfg, names, overrides, axes, data_group,
                          worker_group, ma) if fsdp and world > 1 else None)
    if layout is not None:
        ma = layout.model
    kind = step_kind(ma.size)
    if rank == 0:
        print(f"arch={cfg.name} layers={cfg.num_layers} "
              f"d_model={cfg.d_model} workers={world} device={device}"
              + (_mesh_text(mesh) if mesh else "")
              + (f" step={kind}" if kind != "whole" else "")
              + f" mode={mode}")
        print(f"compression: {comp.describe()}")
        for name, (shape, dtype) in specs.stub_inputs(cfg,
                                                      args.batch).items():
            print(f"input {name}: {list(shape)} "
                  f"{str(dtype).removeprefix('torch.')}")
    init_gen = torch.Generator(device=device).manual_seed(args.seed)
    tp = None
    if kind == "split":     # this worker's shards only, drawn leaf by leaf
        tp = tensor_parallel.plan_split(cfg, names, ma)
        ma = tp.axis
        if layout is not None:
            layout = dataclasses.replace(layout, model=ma)
    keep = (layout.keep if layout is not None
            else None if tp is None else tp.keep)
    model = Transformer(cfg, init_model(cfg, init_gen, device, keep), tp=tp)
    n_params = sum(math.prod(shape) for shape, _ in
                   param_shapes(cfg).values())
    param_bytes = sum(p.numel() * p.element_size() for p in model.leaves())
    if rank == 0:
        print(f"params: {n_params}"
              + (f" (this worker's shards: {param_bytes} B)"
                 if tp or layout else ""))
    opt = adam(args.lr) if args.optimizer == "adam" else sgd(args.lr)
    opt_state = opt.init(step_lib.worker_leaves(model, ma))
    hier = comp.resparsify_pods and pod_group is not None
    if fsdp:
        # the residual of the averaged gradient: params-shaped (this
        # worker's blocks of it past one worker), one a run
        ef_state = (init_feedback(model.leaves())
                    if comp.error_feedback and comp.name != "none" else None)
        train_step = step_lib.make_fsdp_train_step(model, comp, opt,
                                                   layout=layout)
    else:
        ef_state = (init_feedback(step_lib.worker_leaves(model, ma),
                                  pod=hier)
                    if comp.error_feedback else None)
        pod_gen = (torch.Generator(device=device).manual_seed(
            pod_stream_seed(args.seed, axes, rank)) if hier else None)
        train_step = step_lib.make_compressed_train_step(
            model, comp, opt, group=data_group, pod_group=pod_group,
            pod_generator=pod_gen, model_axis=ma, worker_group=worker_group)
    ctl_state = (step_lib.init_compressed_control(model, comp, ma)
                 if comp.adaptive else None)
    # one data stream per data worker (its model workers take the same
    # batch); one compression stream per worker, or in fsdp mode one for
    # all (Q of the averaged gradient, alike everywhere)
    data_gen = torch.Generator(device=device).manual_seed(
        1_000_003 * (args.seed + 1) + rank // ma.size)
    comp_gen = torch.Generator(device=device).manual_seed(
        2_000_003 * (args.seed + 1) + (0 if fsdp else rank))

    history, step_seconds = [], []
    for step_i in range(args.steps):
        t0 = time.perf_counter()
        batch = specs.train_batch(data_gen, cfg, args.batch, args.seq)
        if ctl_state is not None:
            opt_state, ef_state, ctl_state, metrics = train_step(
                opt_state, ef_state, ctl_state, batch, comp_gen)
        elif ef_state is not None:
            opt_state, ef_state, metrics = train_step(opt_state, ef_state,
                                                      batch, comp_gen)
        else:
            opt_state, metrics = train_step(opt_state, batch, comp_gen)
        m = {k: float(v) for k, v in metrics.items()}    # waits for the step
        step_seconds.append(time.perf_counter() - t0)
        history.append(m)
        if rank == 0 and step_i == 0 and not fsdp:
            for rows, d, k_cap, layout in train_step.layouts:
                print(f"group [{rows}, {d}] k_cap {k_cap}: layout {layout}")
        if rank == 0 and (step_i % args.log_every == 0
                          or step_i == args.steps - 1):
            print(f"step {step_i:>5} loss {m['loss']:.4f} "
                  + (f"density {m['density']:.5f} var x{m['var_ratio']:.2f} "
                     f"msg_bits {m['bits']:.4g} " if "density" in m else "")
                  + (f"wire_bytes {m['wire_bytes']:.0f} " if not fsdp else "")
                  + (f"(intra {m['wire_bytes_intra']:.0f} inter "
                     f"{m['wire_bytes_inter']:.0f}) " if pod_group is not None
                     and not fsdp
                     else "")
                  + (f"overflow {m['overflow']:.0f} " if not fsdp else "")
                  + (f"skipped {m['skipped']:.1f} " if comp.adaptive else "")
                  + f"({step_seconds[-1]:.3f} s)", flush=True)
    if args.checkpoint:
        checkpoint.save(args.checkpoint, model, opt_state, ef_state,
                        ctl_state, mesh=mesh, mode=mode,
                        model_axis=layout if layout is not None else ma,
                        extra={"arch": args.arch, "mode": mode,
                               "steps": args.steps,
                               "error_feedback": ef_state is not None,
                               "adaptive": ctl_state is not None})
        if rank == 0:
            print(f"checkpoint -> {args.checkpoint}")
    summary = {"metrics": history, "step_seconds": step_seconds,
               "params": n_params, "param_bytes": param_bytes,
               "mode": mode, "step": kind,
               "layouts": [] if fsdp else list(train_step.layouts)}
    if device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
