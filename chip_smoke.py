"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the shapes of the
main path (gemma-2b at full width: one launch per shape group), checks the
whole emit pipeline against the CPU path on a small input, then drives the
main path through the launcher — ``repro_torch.launch.train --arch gemma-2b
--steps 3 --compressor gspar --rho 0.05 --wire gather --wire-layout coo
--error-feedback`` on a one-worker NCCL group — and checks its output:
finite loss, the exact wire bytes of the COO gather wire, no overflow, the
density inside the capacity slack, and every kernel launched.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when there is no CUDA device or any phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
RHO = 0.05
TRAIN_ARGS = ["--arch", "gemma-2b", "--steps", "3", "--compressor", "gspar",
              "--rho", str(RHO), "--wire", "gather", "--wire-layout", "coo",
              "--error-feedback", "--log-every", "1"]
WIRE_BYTES = 939_814_656         # 156,635,776 COO slots x (2 B bf16 + 4 B)
SUM_RTOL = 1e-6                  # f64 sums rounded once to f32, both sides
REPS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Check:
    """Agreement of one kernel with its plain version over all groups."""

    def __init__(self):
        self.max_abs = 0.0
        self.max_rel = 0.0

    def equal(self, what: str, got: torch.Tensor, want: torch.Tensor):
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: kernel != plain at {bad}")

    def close(self, what: str, got: torch.Tensor, want: torch.Tensor,
              rtol: float = SUM_RTOL):
        diff = (got.double() - want.double()).abs()
        rel = diff / want.double().abs().clamp_min(1e-30)
        self.max_abs = max(self.max_abs, diff.max().item())
        self.max_rel = max(self.max_rel, rel.max().item())
        if rel.max().item() > rtol:
            raise AssertionError(f"{what}: relative error {rel.max().item()}"
                                 f" > {rtol}")


def heavy_tailed(rows: int, d: int, gen: torch.Generator) -> torch.Tensor:
    """A gradient-like group: normal times lognormal magnitudes, bf16."""
    g = torch.empty((rows, d), dtype=torch.bfloat16, device="cuda")
    for r in range(rows):       # row by row: no float32 copy of the group
        x = torch.randn(d, generator=gen, device="cuda")
        x.mul_(torch.randn(d, generator=gen, device="cuda").exp_())
        g[r] = x
    return g


def main_path_groups():
    """The shape groups of gemma-2b's gradient tree under the launcher's
    config, from the port's own plan (no allocation: meta tensors)."""
    from repro_torch.configs.gemma_2b import FULL
    from repro_torch.core.api import CompressionConfig
    from repro_torch.core.grouping import plan_tree
    from repro_torch.models.transformer import param_shapes
    from repro_torch.models.common import leaf_order
    shapes = param_shapes(FULL)
    names = leaf_order(shapes)
    leaves = [torch.empty(shapes[n][0], dtype=FULL.dtype, device="meta")
              for n in names]
    comp = CompressionConfig(name="gspar", rho=RHO, wire_layout="coo",
                             error_feedback=True, min_leaf_size=1024)
    plan = plan_tree(comp, leaves, [shapes[n][1] for n in names])
    if any(g.kind != "sparse" for g in plan.groups):
        raise AssertionError("gemma-2b has no dense-passthrough leaf")
    return [(g.rows, g.d, g.k_cap) for g in plan.groups]


def kernel_phase(groups) -> dict:
    """Each kernel against its plain version on every main-path group, with
    the same inputs and the same per-row scalars; times per step (one launch
    per group; tail_stats per solver pass)."""
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = K.KERNELS
    chk = {n: Check() for n in names}
    ms = dict.fromkeys(names, 0.0)
    plain_ms = dict.fromkeys(names, 0.0)
    bound_bytes = dict.fromkeys(names, 0.0)
    library_ms = 0.0
    ms_no_ef = 0.0
    for rows, d, k_cap in groups:
        g = heavy_tailed(rows, d, gen)
        u = torch.rand((rows, d), generator=gen, device="cuda")
        gb, n = g.element_size(), rows * d

        l1, mx = K.stats_l1max(g)
        rl1, rmx = ref.stats_l1max_ref(g)
        chk["stats_l1max"].close("stats_l1max l1", l1, rl1)
        chk["stats_l1max"].equal("stats_l1max max", mx, rmx)
        ms["stats_l1max"] += cuda_ms(lambda: K.stats_l1max(g))
        plain_ms["stats_l1max"] += cuda_ms(lambda: ref.stats_l1max_ref(g), 1)
        library_ms += cuda_ms(lambda: (
            torch.linalg.vector_norm(g, 1, -1, dtype=torch.float32),
            torch.linalg.vector_norm(g, math.inf, -1)))
        bound_bytes["stats_l1max"] += n * gb + rows * 8

        lam0 = ops.greedy_lambda(l1, mx, RHO, d)
        gate = lam0 * mx > 1.0
        thresh = ops._safe_div(1.0, lam0)
        cnt, tl1 = K.tail_stats(g, thresh, gate)
        rcnt, rtl1 = ref.tail_stats_ref(g, thresh, gate)
        chk["tail_stats"].equal("tail_stats count", cnt, rcnt)
        chk["tail_stats"].close("tail_stats l1", tl1, rtl1)
        ms["tail_stats"] += cuda_ms(lambda: K.tail_stats(g, thresh, gate))
        plain_ms["tail_stats"] += cuda_ms(
            lambda: ref.tail_stats_ref(g, thresh, gate), 1)
        bound_bytes["tail_stats"] += int(gate.sum()) * d * gb + rows * 12

        lam = ops.greedy_lambda(l1, mx, RHO, d,
                                tail_fn=ops._kernel_tail_fn(g))
        st = K.select_stats(g, u, lam, k_cap)
        rst = ref.select_stats_ref(g, u, lam, k_cap, K.TILE)
        for f in ("nnz", "nonzeros", "base", "max_abs"):
            chk["select_stats"].equal(f"select_stats {f}", getattr(st, f),
                                      getattr(rst, f))
        for f in ("p_sum", "den", "sum_sq"):
            chk["select_stats"].close(f"select_stats {f}", getattr(st, f),
                                      getattr(rst, f))
        ms["select_stats"] += cuda_ms(lambda: K.select_stats(g, u, lam,
                                                             k_cap))
        plain_ms["select_stats"] += cuda_ms(
            lambda: ref.select_stats_ref(g, u, lam, k_cap, K.TILE), 1)
        bound_bytes["select_stats"] += n * (gb + 4) + st.base.numel() * 4

        # the f32 codec (leaf dtype on the wire) with and without EF, and
        # the bf16 codec, whose residual subtracts the wire-rounded value
        for ef, rr in ((False, False), (True, False), (True, True)):
            out = K.compact_emit(g, u, lam, st.base, k_cap=k_cap,
                                 wire_dtype=g.dtype, ef=ef, round_residual=rr)
            want = ref.compact_emit_ref(g, u, lam, k_cap, g.dtype, ef, rr)
            for what, a, b in zip(("values", "idx", "residual"), out, want):
                if a is not None:
                    chk["compact_emit"].equal(
                        f"compact_emit ef={ef} round_residual={rr} {what}",
                        a, b)
            del out, want
            if rr:                  # checked only; timed as the f32 codec
                continue
            t = cuda_ms(lambda: K.compact_emit(
                g, u, lam, st.base, k_cap=k_cap, wire_dtype=g.dtype, ef=ef))
            if ef:                  # the main path runs with error feedback
                ms["compact_emit"] += t
                plain_ms["compact_emit"] += cuda_ms(
                    lambda: ref.compact_emit_ref(g, u, lam, k_cap, g.dtype,
                                                 True), 1)
            else:
                ms_no_ef += t
        bound_bytes["compact_emit"] += (n * (2 * gb + 4)
                                        + rows * k_cap * (gb + 4))
        print(f"group [{rows}, {d}] k_cap {k_cap}: kernels agree with their "
              f"plain versions (nnz {int(st.nnz.sum())}, "
              f"gated rows {int(gate.sum())})", flush=True)
        del g, u, st, rst
        torch.cuda.empty_cache()
    return {"check": chk, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": {k: 1e3 * v / HBM_BYTES_PER_S
                         for k, v in bound_bytes.items()},
            "library_ms": library_ms, "ms_no_ef": ms_no_ef}


def reference_phase():
    """The whole emit pipeline on the card against the same pipeline on the
    CPU (plain versions, held to the JAX package by the CPU tests) on a
    small input: lambda within rtol 1e-6, the same kept coordinates except
    draws within 1e-6 of their keep probability."""
    from repro_torch.core.codecs import FloatCodec
    from repro_torch.kernels.sparsify import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, d, k_cap = 3, 100_003, 8192
    g = heavy_tailed(rows, d, gen)
    u = torch.rand((rows, d), generator=gen, device="cuda")
    kw = dict(k_cap=k_cap, rho=RHO, codec=FloatCodec(), ef=True)
    er, lam = ops.gspar_emit(g, u, **kw)
    er_c, lam_c = ops.gspar_emit(g.cpu(), u.cpu(), **kw)
    rel = ((lam.cpu().double() - lam_c.double()).abs()
           / lam_c.double().abs()).max().item()
    if rel > 1e-6:
        raise AssertionError(f"lambda: card vs CPU relative error {rel}")
    for r in range(rows):
        kept = set(er.idx[r, :int(er.nnz[r])].tolist())
        kept_c = set(er_c.idx[r, :int(er_c.nnz[r])].tolist())
        p = torch.clamp_max(lam_c[r] * g[r].cpu().float().abs(), 1.0)
        for i in kept ^ kept_c:
            if abs(float(u[r, i]) - float(p[i])) >= 1e-6:
                raise AssertionError(f"row {r} coordinate {i}: kept sets "
                                     "differ away from the threshold")
    print(f"reference: card vs CPU lambda rel err {rel:.2e}, kept sets "
          "agree", flush=True)


def train_phase() -> dict:
    from repro_torch.kernels.sparsify import kernel as K
    from repro_torch.launch import train
    K.reset_launches()
    summary = train.main(TRAIN_ARGS)
    launches = dict(K.LAUNCHES)
    for step, m in enumerate(summary["metrics"]):
        if not math.isfinite(m["loss"]):
            raise AssertionError(f"step {step}: loss {m['loss']}")
        if m["wire_bytes"] != WIRE_BYTES:
            raise AssertionError(f"step {step}: wire_bytes "
                                 f"{m['wire_bytes']} != {WIRE_BYTES}")
        if m["overflow"] != 0:
            raise AssertionError(f"step {step}: overflow {m['overflow']}")
        if not 0.0 < m["density"] <= 1.25 * RHO:
            raise AssertionError(f"step {step}: density {m['density']}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    print("train: steps " + ", ".join(
        f"{s:.3f} s" for s in summary["step_seconds"])
        + f"; density " + ", ".join(
            f"{m['density']:.6f}" for m in summary["metrics"])
        + f"; loss " + ", ".join(f"{m['loss']:.4f}"
                                 for m in summary["metrics"])
        + f"; max_memory_allocated {summary['max_memory_allocated']} B",
        flush=True)
    summary["launches"] = launches
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.sparsify import kernel as K
    t0 = time.perf_counter()
    path, log = K.build()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if log:
        print("\n".join(line for line in log.splitlines()
                        if "registers" in line or "spill" in line))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    groups = main_path_groups()
    kp = kernel_phase(groups)
    reference_phase()
    torch.cuda.empty_cache()
    tr = train_phase()

    replaces = {"stats_l1max": 275, "tail_stats": 195, "select_stats": 384,
                "compact_emit": 559}
    kernels = []
    for name in K.KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparsify.cu",
            "replaces": f"src/repro/kernels/sparsify/kernel.py:"
                        f"{replaces[name]}",
            "launches": tr["launches"][name],
            "max_abs_err": kp["check"][name].max_abs,
            "max_rel_err": kp["check"][name].max_rel,
            "ms": kp["ms"][name], "plain_ms": kp["plain_ms"][name],
            "bound_ms": kp["bound_ms"][name], "bound_by": "bytes",
            "library_ms": (kp["library_ms"] if name == "stats_l1max"
                           else None),
        })
    kernels[K.KERNELS.index("compact_emit")]["ms_no_ef"] = kp["ms_no_ef"]
    print(json.dumps({"train": {
        "step_seconds": tr["step_seconds"],
        "max_memory_allocated": tr["max_memory_allocated"],
        "wire_bytes": [m["wire_bytes"] for m in tr["metrics"]],
        "density": [m["density"] for m in tr["metrics"]],
        "loss": [m["loss"] for m in tr["metrics"]]}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
