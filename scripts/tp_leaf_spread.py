"""The spread of the split check's leaf shares over seeds, on one GPU.

    python3 scripts/tp_leaf_spread.py [--arch zamba2-2.7b] [--seeds 4]
        [--chunk 32] [--split] [--out chiprun_out/tp_leaf_spread.json]

``chip_smoke.py``'s tensor-parallel phase holds each leaf of a split
model's step-1 gradient, on each model worker's slice, to at most
``TP_LEAF_FACTOR`` times the whole bf16 model's distance from the float32
gradient plus a floor (``_leaf_share`` at most 1), on one init and batch;
the shares here are against TP_LEAF_FACTOR, whatever ``TP_LEAF_FACTORS``
names.
This script measures how far that share spreads over seeds, for two
gradients: a witness, another whole-model bf16 computation of the same
function (the Mamba-2 or RWKV-6 scan chunked at ``--chunk`` tokens
instead of the config's: the same sums in float32, in another order),
and with ``--split`` the split step's own (``chip_smoke.tp_held_grads``
on ``TP_M`` gloo worker processes on the one card, as the phase runs
them). For each seed (the init from the seed, the batch from ``1_000_003
+ seed``: the launcher's ``--seed 0`` and data worker 0's at seed 0) it
computes the whole model's gradient in bf16, the witness's, and in
float32 (the bf16 weights upcast), at the launcher's shape (8 x 128
tokens) and the arch's ``TP_RUNS`` depth, and for each leaf and each
worker's slice under the launcher's specs the shares. Prints per seed the
tree distances and the largest shares, then one JSON line: per leaf kind
(the last part of the name) the largest share, the count past 1 and the
geometric mean of the distance ratio (a systematic excess shows there),
for the witness and the split; writes every share to ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses as dc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _grads(cfg, params, batch) -> list:
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import step as step_lib
    model = Transformer(cfg, params)
    return [g.detach() for g in step_lib._local_grads(
        model, model.leaves(), step_lib.make_loss_fn(cfg), batch)[1]]


def _run_of(arch: str) -> str:
    return next(r for r, (a, _) in cs.TP_RUNS.items() if a == arch)


def worker(arch: str, rank: int, port: int, seeds: int, tmp: Path) -> None:
    """One of the TP_M model workers: the split step's step-1 gradient
    shards for each seed, saved to ``tmp``."""
    import datetime
    import torch.distributed as dist
    os.environ["LOCAL_RANK"] = "0"
    torch.cuda.set_per_process_memory_fraction(cs.TP_MEM_FRACTION)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=cs.TP_M,
        timeout=datetime.timedelta(seconds=cs.TP_TIMEOUT))
    for seed in range(seeds):
        torch.save(cs.tp_held_grads(_run_of(arch), torch.device("cuda", 0),
                                    seed=seed),
                   tmp / f"split{seed}_{rank}.pt")
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()


def _split_grads(arch: str, seeds: int, tmp: Path) -> None:
    """The TP_M workers, all at once; raises if one fails."""
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(rank), str(port), str(tmp), "--arch", arch, "--seeds",
         str(seeds)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(cs.TP_M)]
    logs = [p.communicate(timeout=cs.TP_TIMEOUT)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(log[-4000:] for log in logs))


def _shares(names, ma, grads, gb, g32) -> dict:
    """Each leaf's share of its bound (``chip_smoke._leaf_share``) and
    its distance ratio, for ``grads`` (this worker's shards) against the
    whole bf16 gradient ``gb`` and the float32 one ``g32``."""
    parts = []
    for i, w in enumerate(grads):
        b, f = ma.shard(gb[i], i), ma.shard(g32[i], i)
        parts.append((cs._sq_dist(w.to(f.device), f)[0], *cs._sq_dist(b, f),
                      f.numel()))
    rms = math.sqrt(sum(p[2] for p in parts) / sum(p[3] for p in parts))
    return {n: (cs._leaf_share((math.sqrt(p[0]), math.sqrt(p[1]),
                                cs.TP_LEAF_ATOL * rms * math.sqrt(p[3]),
                                0.0, cs.TP_LEAF_FACTOR)),
                math.sqrt(p[0] / p[1]) if p[1] else 1.0)
            for n, p in zip(names, parts)}


def spread(arch: str, seeds: int, chunk: int, split: bool) -> dict:
    from repro_torch.configs import registry
    from repro_torch.dist.sharding import ModelAxis
    from repro_torch.launch import specs, train
    from repro_torch.models.common import leaf_order
    from repro_torch.models.transformer import init_model, param_shapes
    cfg = cs.tp_cfg(arch, cs.TP_RUNS[_run_of(arch)][1],
                    cs.TP_GRAD_PERIODS.get(_run_of(arch)))
    mixer = "mamba" if cfg.mamba is not None else "rwkv"
    witness = dc.replace(cfg, **{mixer: dc.replace(getattr(cfg, mixer),
                                                   chunk=chunk)})
    cfg32 = dc.replace(cfg, dtype=torch.float32)
    names = leaf_order(param_shapes(cfg))
    axes = [ModelAxis(size=cs.TP_M, index=m, specs=train.leaf_specs(
        cfg, names, registry.get(arch).rules_overrides, (None, 1, cs.TP_M)))
        for m in range(cs.TP_M)]
    dev = torch.device("cuda", 0)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build")) if split else None
    t0 = time.perf_counter()
    if split:
        _split_grads(arch, seeds, tmp)
    out = {"arch": arch, "periods": cfg.num_periods, "chunk":
           getattr(cfg, mixer).chunk, "witness_chunk": chunk,
           "leaf_factor": cs.TP_LEAF_FACTOR,
           "split_seconds": time.perf_counter() - t0, "seeds": []}
    shares = {k: collections.defaultdict(list) for k in ("witness", "split")}
    for seed in range(seeds):
        t0 = time.perf_counter()
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(
            seed), dev)
        batch = specs.train_batch(torch.Generator(device=dev).manual_seed(
            1_000_003 + seed), cfg, 8, 128)
        gb = _grads(cfg, params, batch)
        gw = _grads(witness, params, batch)
        g32 = _grads(cfg32, {k: v.float() for k, v in params.items()},
                     batch)
        del params
        rec = {"seed": seed, "bf16_floor": cs._rel_tree(gb, g32),
               "witness_f32": cs._rel_tree(gw, g32),
               "witness_bf16": cs._rel_tree(gw, gb)}
        for kind in ("witness", "split") if split else ("witness",):
            rec[kind] = []
            for ma in axes:
                mine = ([ma.shard(g, i) for i, g in enumerate(gw)]
                        if kind == "witness" else
                        torch.load(tmp / f"split{seed}_{ma.index}.pt"))
                leaf = _shares(names, ma, mine, gb, g32)
                for n, x in leaf.items():
                    shares[kind][n].append(x)
                rec[kind].append({
                    "f32": cs._rel_tree([x.to(dev) for x in mine],
                                        [ma.shard(g, i)
                                         for i, g in enumerate(g32)]),
                    "over_1": sum(x[0] > 1 for x in leaf.values()),
                    "top": sorted(((n, x[0]) for n, x in leaf.items()),
                                  key=lambda kv: -kv[1])[:3]})
        rec["seconds"] = time.perf_counter() - t0
        out["seeds"].append(rec)
        print(json.dumps(rec), flush=True)
        del gb, gw, g32
        torch.cuda.empty_cache()
    out["by_kind"] = {}
    for kind, per_leaf in shares.items():
        kinds = collections.defaultdict(list)
        for n, xs in per_leaf.items():
            kinds[n.rsplit("/", 1)[-1]].extend(xs)
        out["by_kind"][kind] = {
            k: {"max": max(x[0] for x in xs), "n": len(xs),
                "over_1": sum(x[0] > 1 for x in xs),
                "geo_mean_ratio": math.exp(sum(math.log(max(x[1], 1e-30))
                                               for x in xs) / len(xs))}
            for k, xs in sorted(kinds.items())}
    out["shares"] = {k: dict(v) for k, v in shares.items()}
    if tmp is not None:
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "PORT", "DIR"))
    ap.add_argument("--out", default="chiprun_out/tp_leaf_spread.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        rank, port, tmp = args.worker
        worker(args.arch, int(rank), int(port), args.seeds, Path(tmp))
        return 0
    (ROOT / "build").mkdir(exist_ok=True)
    res = spread(args.arch, args.seeds, args.chunk, args.split)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res))
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("shares", "seeds")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
