"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel and each variant (selector kind x codec) against its plain PyTorch
version on the card at the shapes of the main paths (gemma-2b at full
width: one launch per shape group) and on a small sweep of every variant,
holds topk's threshold kernel (``topk_threshold``) to its plain version and
to ``torch.topk``'s answer, bit for bit, and times ``torch.topk`` beside
it (the library call), times the receiver's decode of each group, checks
the emit pipelines against the CPU path on a small input, then drives the
paths through the launcher ``repro_torch.launch.train --arch gemma-2b
--steps 3 --rho 0.05 --wire gather --error-feedback --compressor C`` on a
one-worker NCCL group, each with the kernel launch counts set to 0 just
before it and read just after:

- ``gspar`` on the gather wire's default ``--wire-layout auto``: every group
  must be stamped ``rice``; each step must charge exactly the values, the
  phase-one counts and 4 bytes per realized Golomb-Rice word, recomputed on
  the host with numpy from the step's compact buffers (each row's live
  indices must ascend), and no more than the static capacity; the synced
  gradient must be bit-equal to ``compaction.scatter`` of the same compact
  buffers (at one worker that is the whole exchange);
- the same ``gspar`` run again, unchecked: its step times are the main
  path's (the checked run's steps include the checks' host work);
- ``gspar`` on ``--wire-layout coo``: the exact wire bytes of the COO wire;
- the paper's baselines and the integer codecs at full width, checked like
  the first run but with the Golomb-Rice words recomputed on the card with
  torch ops from each row's live gaps (independently of ``rice_pack``) and
  the synced gradient held to the codec-decoded scatter: ``unisp``,
  ``topk+ternary`` and ``gspar+qsgd8`` (``rice``: values + counts + scales
  + 4 x words), ``terngrad`` (``dense``: exactly 2,506,173,072 B); topk
  keeps exactly k_target coordinates on every row that has that many
  nonzeros;
- ``topk`` and ``bernoulli`` with the f32 codec, cut to two layers, for the
  float codec's variants of pass 2 on those selectors;
- Algorithm 2 (gspar, ``algo="closed"``) on the gather wire's ``auto``,
  through ``make_compressed_train_step`` as the launcher's loop drives it
  (the launcher has no flag for algo or eps), at eps 40: the capacity is
  sized from rho, and at the JAX default eps 1.0 the rows would overflow
  it;
- the dense wire, ``gspar`` with ``--wire dense --error-feedback``
  (checked: exactly 5,012,344,832 wire bytes a step, the gemma-2b bf16
  gradient, and each group's Q bit-equal to the decode of
  ``ops.gspar_emit``'s compact buffers on the same target, uniforms and
  lambda, at zero overflow), and without EF on the launcher's default wire
  (unchecked: its step times); then with EF ``unisp``, ``topk``,
  ``terngrad``, ``gspar+qsgd8``, ``qsgd``, ``agspar`` and Algorithm 2 (at
  the JAX default eps 1.0, as on the gather wire), and ``none`` without:
  each exactly 5,012,344,832 B a step, overflow 0, every kernel variant of
  the path launched and none of the gather wire's (nor the other EF
  variant of the dense emit).

The dense wire's kernels (stats, sparsify and sparsify_ef for every
selector kind and codec, with the integer codecs' scale pass, select_stats
with ``round_v``) and kernel 8 (sparsify_prng) are held to their plain
versions in the kernel phase (the paths' variants at every gemma-2b group)
and the sweep (every kind x codec x EF); Algorithm 2's lambda
(``ops.closed_lambda``: the magnitude histogram of topk_threshold's pass,
then the bin solve ``closed_lambda``, held to its plain version on the same
bins) to the float64 sort of each row at both paths' eps;
``ops.gspar_sparsify_prng``, which no launcher path runs, is driven on
every gemma-2b row as a leaf, its kept
count held to 6 standard deviations of sum p, and its generator to
Philox4x32-10's known answers.

Then the step-size options at full width (``var_lr_phase``): gspar on the
dense wire with ``var_adaptive_lr=True``, run A with EF under a warmup
``lr_schedule`` and Adam (kernel 6), run B without EF under SGD with
momentum (kernel 5); each step checked on a sampled leaf, bit for bit: the
residual rescaled by sched(t) / sched(t + 1), the applied step size
sched(t + 1) / max(var, 1) as a float32 quotient, the parameters kept
bfloat16, and exactly 5,012,344,832 wire bytes. Last, the paper's
section-5 experiments at the JAX benchmarks' sizes (``experiments_phase``:
convex SGD in four data cells and SVRG in two, the CNN, the conflict model
and Algorithm 4's simulation), their kernels first held to their plain
versions at the paths' shapes (the convex step's [4, 2048] group in each
method, every CNN shape group, pass 1 at the conflict windows), then the
runs checked against the paper's claims, the committed conflict rows and
the kernels' launches (1, 2, 5 and 7).

Then the adaptive control loop with the data-fitted Golomb-Rice wire
(``adaptive_phase``, wire-format v4): the launcher ``--adaptive
--skip-tau 0.7 --rice-fitted --error-feedback`` at gemma-2b full width
for four steps each, through ``adaptive_check``: (A) gspar on the gather
wire's ``auto`` layout, checked (every row's header r in the window and
its used words the first minimum over the window, recomputed on the card,
never over the static words; the wire exactly values + counts + 4 x used
less the skipped rows' values; every leaf's synced value last_avg plus the
decoded scatter of its buffers; last_sent = g + r_in - r_out on every
leaf); (B) the same with the bound of every other leaf forced to 1e30 at
step 2 (those leaves skipped: zero headers, values and words, residual =
their whole target, synced = last_avg); (C) topk, unchecked; (D) gspar on
the dense wire with (B)'s forced skips (exactly the gradient's bytes).
The kernel phase also holds ``rice_fit`` (with its tile bases) and the
fitted ``rice_pack`` to their plain versions on gspar's compact idx of
every group, times them beside the static ``rice_pack`` and beside their
first route (``rice_fit_legacy``, ``rice_pack_fitted_legacy``), each by
CUDA events around the wrapper and by the profiler's device time
(``device_ms``), times the fitted decode beside the static one, and times
``magnitude_hist`` (Algorithm 2's bins) alone.

Last, the rest of the exchange and the reference backend
(``exchange_phase``, three steps each at gemma-2b full width): (A) gspar
``--wire gather --exchange overlap --error-feedback``, each step's synced
leaves and bytes held bit for bit to ``_bucketed_sync`` on the same items
(its buckets counted), and again under ``--adaptive --skip-tau 0.7
--rice-fitted``; (B) ``--mesh 1x1x1 --wire gather --error-feedback``,
the pod stage over groups of one: at step 0 each group's compaction
(values, idx, nnz, Golomb-Rice words) bit-equal to its plain version on
the pod-average rows and timed there beside ``torch.topk``, every step the
drops equal to the synced leaves less the scatter of what the pod stage
sent and ``wire_bytes_inter`` recomputed from its words on the host (at
one worker: equal to ``wire_bytes_intra``, no drop), and again unchecked
for its times and peak memory; (C) with ``--resparsify-pods`` (the pod
residual carried, the second compression launched); (D) ``--wire
packed`` held to gather ``gspar+bf16`` on the same gradients and
generator state; (E) ``--backend reference``: gspar with EF, each group's
buffers and residual held to the dense wire's on the same uniforms
(``dense_group``), agspar with EF, and ``qsgd`` (identity+qsgd4, k_cap =
d) at two layers. The kernel phase adds ``compaction.compact`` over dense
rows at every group (on bf16 ``compact_bins`` and ``compact_select``,
each held to its plain version; the whole bit-equal to the plain
three-step composition, timed beside it, beside the three kernels it
replaced and beside ``torch.topk(|g|, k_cap)``) and the deterministic
rounding of the integer codecs in ``compact_select`` and pass 2.

Last, the dense-attention architectures (``arch_phase``): one
``attn_sw`` block of gemma2-9b at full width on a 4,608-token sequence
(the config's 4,096 window bites on the last 512 queries) against the
plain masked expression in float64 on the card; a checkpoint resume of
each smoke config in bf16 (three steps against one, ``save``,
``restore`` into fresh state and two more: parameters, moments and
residual bit-equal); then the launcher on gemma2-9b (``--num-periods
4``), gemma2-27b (``1``: its embedding is one row of 1,179,648,000
coordinates) and starcoder2-7b (``10``) at full width, gspar on the
gather wire's ``auto`` with EF, rho 0.05, batch 8 x 128, Adam 3e-4, three
steps each, gemma2-9b's exchange held to its exact bytes and gradient
(``exchange_check`` on the card), each kernel of the path launched once a
group a step (tail_stats up to twice, rice_pack on the RICE groups).

Each run checks finite losses, no overflow and every kernel variant of the
path launched. Prints the card's name and power limit, one JSON line of
per-kernel numbers, and as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
RHO = 0.05
TRAIN_ARGS = ["--arch", "gemma-2b", "--steps", "3", "--rho", str(RHO),
              "--wire", "gather", "--error-feedback", "--log-every", "1"]
SLOTS = 156_635_776              # value slots at k_cap, gemma-2b's 164 rows
COORDS = 2_506_172_416           # gemma-2b's parameters: all in sparse groups
ROW_BYTES = 656                  # 164 rows x one int32 count or f32 scale
RICE_CAP_BYTES = 117_476_832     # the static Golomb-Rice word capacity
WIRE_BYTES = 939_814_656         # 156,635,776 COO slots x (2 B bf16 + 4 B)
DENSE_WIRE_BYTES = 5_012_344_832  # gemma-2b's bf16 gradient, the dense wire
DENSE_ARGS = ["--arch", "gemma-2b", "--steps", "3", "--rho", str(RHO),
              "--log-every", "1"]
PRNG_SEED = 1234
PHILOX_KAT = [       # Random123's kat_vectors, philox4x32 at 10 rounds
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
CHECK_CHUNK = 1 << 24            # coordinates per chunk of the scatter check
SUM_RTOL = 1e-6                  # f64 sums rounded once to f32, both sides
REPS = 5
T0 = time.perf_counter()


class MainPath:
    """One launcher path: its compressor, the layout ``auto`` must stamp,
    its static value and scale bytes per step, and the kernel variants it
    must launch. ``binomial`` marks a selector whose survivor count is a
    plain binomial draw (unisp: p = rho on every coordinate), which can
    pass the capacity on narrow rows (gemma-2b's 2048-wide norm rows:
    Binomial(2048, 0.05) > 128 with probability about 0.5 %); there the
    reported overflow must equal the buffers' own count of dropped
    survivors instead of 0."""

    def __init__(self, compressor, layout, value_bytes, scale_bytes,
                 variants, extra=(), binomial=False, row_bytes=ROW_BYTES,
                 rice_cap_bytes=RICE_CAP_BYTES):
        self.compressor, self.layout = compressor, layout
        self.value_bytes, self.scale_bytes = value_bytes, scale_bytes
        self.variants, self.extra = variants, list(extra)
        self.binomial = binomial
        self.row_bytes, self.rice_cap_bytes = row_bytes, rice_cap_bytes

    @property
    def count_bytes(self) -> int:
        return self.row_bytes if self.layout == "rice" else 0

    @property
    def max_bytes(self) -> int:
        cap = self.rice_cap_bytes if self.layout == "rice" else 0
        return self.value_bytes + self.count_bytes + self.scale_bytes + cap


GSPAR = ("stats_l1max", "tail_stats", "select_stats/lam")
PATHS = {
    "gspar": MainPath("gspar", "rice", 2 * SLOTS, 0,
                      GSPAR + ("compact_emit/lam", "rice_pack")),
    "unisp": MainPath("unisp", "rice", 2 * SLOTS, 0,
                      ("select_stats/rho", "compact_emit/rho", "rice_pack"),
                      binomial=True),
    "topk+ternary": MainPath(
        "topk+ternary", "rice", SLOTS, ROW_BYTES,
        ("topk_threshold", "select_stats/topk", "compact_emit/topk+ternary",
         "rice_pack")),
    "gspar+qsgd8": MainPath(
        "gspar+qsgd8", "rice", 2 * SLOTS, ROW_BYTES,
        GSPAR + ("compact_emit/lam+qsgd8", "rice_pack")),
    "terngrad": MainPath(
        "terngrad", "dense", COORDS, ROW_BYTES,
        ("stats_l1max", "select_stats/bern", "compact_emit/bern+ternary")),
    # the float codec on the topk and bernoulli selectors, two layers deep
    "topk": MainPath("topk", "rice", None, 0,
                     ("topk_threshold", "select_stats/topk",
                      "compact_emit/topk", "rice_pack"),
                     ["--num-periods", "2"]),
    "bernoulli": MainPath("bernoulli", "dense", None, 0,
                          ("stats_l1max", "select_stats/bern",
                           "compact_emit/bern"), ["--num-periods", "2"]),
    # Algorithm 2 (algo="closed", eps CLOSED_GATHER_EPS) through
    # make_compressed_train_step (closed_train): the lambda from the bins
    "closed": MainPath("gspar", "rice", 2 * SLOTS, 0,
                       ("topk_threshold/hist", "closed_lambda",
                        "select_stats/lam", "compact_emit/lam",
                        "rice_pack")),
}
# The dense wire's launcher runs: name -> (compressor, EF, the kernel
# variants the run must launch). "closed_dense" is Algorithm 2 (algo=
# "closed", eps CLOSED_EPS) through make_compressed_train_step.
DENSE_RUNS = {
    "gspar_dense": ("gspar", True, ("stats", "tail_stats",
                                    "sparsify_ef/lam")),
    "gspar_dense_noef": ("gspar", False, ("stats", "tail_stats",
                                          "sparsify/lam")),
    "unisp_dense": ("unisp", True, ("sparsify_ef/rho",)),
    "topk_dense": ("topk", True, ("topk_threshold", "select_stats/topk",
                                  "sparsify_ef/topk")),
    "terngrad_dense": ("terngrad", True, (
        "stats", "select_stats/bern+rounded", "sparsify_ef/bern+ternary")),
    "gspar+qsgd8_dense": ("gspar+qsgd8", True, (
        "stats", "tail_stats", "select_stats/lam+rounded",
        "sparsify_ef/lam+qsgd8")),
    "qsgd_dense": ("qsgd", True, ("stats", "sparsify_ef/one+qsgd4")),
    "agspar_dense": ("agspar", True, ("stats", "tail_stats",
                                      "sparsify_ef/lam")),
    "none_dense": ("none", False, ("sparsify/one",)),
    "closed_dense": ("gspar", True, ("topk_threshold/hist", "closed_lambda",
                                     "sparsify_ef/lam")),
}


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

    def equal(self, what: str, got, want):
        if got is None and want is None:
            return
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


class Tally:
    """Per kernel variant: agreement, one step's kernel and plain times
    (summed over the groups), the bytes of its bound, the library time."""

    def __init__(self):
        self.check: dict = {}
        self.ms: dict = {}
        self.plain_ms: dict = {}
        self.bound_bytes: dict = {}
        self.library_ms: dict = {}

    def add(self, name, ms=0.0, plain_ms=0.0, bound_bytes=0.0):
        self.check.setdefault(name, Check())
        for d, v in ((self.ms, ms), (self.plain_ms, plain_ms),
                     (self.bound_bytes, bound_bytes)):
            d[name] = d.get(name, 0.0) + v
        return self.check[name]


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
    comp = CompressionConfig(name="gspar", rho=RHO, error_feedback=True,
                             min_leaf_size=1024)
    plan = plan_tree(comp, leaves, [shapes[n][1] for n in names])
    if any(g.kind != "sparse" for g in plan.groups):
        raise AssertionError("gemma-2b has no dense-passthrough leaf")
    return [(g.rows, g.d, g.k_cap) for g in plan.groups]


def kind_scalars(g, pkind, l1, mx, k_cap):
    """The scalars the emit pipelines hand passes 1-2 for ``pkind``, the
    uniforms it reads, and its path's capacity (bernoulli's is d)."""
    from repro_torch.kernels.sparsify import ops
    rows, d = g.shape
    if pkind == "lam":
        return dict(s1=ops.greedy_lambda(l1, mx, RHO, d, tail_fn=ops
                                         ._kernel_tail_fn(g))), k_cap
    if pkind == "rho":
        return dict(s1=torch.full((rows,), RHO, device="cuda")), k_cap
    if pkind == "bern":
        return dict(s1=torch.zeros(rows, device="cuda"), s2=mx), d
    t, budget = ops.topk_threshold(g, max(1, round(RHO * d)))
    return dict(s1=t, budget=budget), k_cap


# Coordinates per torch.topk call of topk_library: about 1 GB of float32
# magnitudes (a longer row goes alone), as the port batched it before the
# threshold became a kernel.
TOPK_UNITS = 1 << 28


def topk_library(g: torch.Tensor, k_target: int):
    """topk_threshold's function from torch.topk (the library yardstick,
    used nowhere in the port): per row the k-th largest |g| and the tie
    budget, in row batches of at most TOPK_UNITS coordinates."""
    rows, d = g.shape
    t = torch.empty(rows, dtype=torch.float32, device=g.device)
    budget = torch.empty(rows, dtype=torch.int64, device=g.device)
    step = max(1, TOPK_UNITS // d)
    for a in range(0, rows, step):
        topv = torch.topk(g[a:a + step].abs().to(torch.float32), k_target,
                          sorted=True).values
        t[a:a + step] = topv[:, -1]
        budget[a:a + step] = k_target - (topv > topv[:, -1:]).sum(-1)
        del topv
    return t, budget


def variant_checks(tally: Tally, g, u, l1, mx, k_cap):
    """Passes 1-2 of the baselines' selector kinds (f32 codec with fused
    EF) and the integer-codec variants of the paths, each against its
    plain version at this group's shape and the path's capacity."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ref
    rows, d = g.shape
    gb, n = g.element_size(), rows * d
    f32 = codecs.FloatCodec()
    # topk's threshold: the radix-select kernel against its plain version
    # and against torch.topk over the row magnitudes (the library call),
    # bit for bit, each with its peak memory above the group's inputs
    k_target = max(1, round(RHO * d))
    t, budget = K.topk_threshold(g, k_target)
    rt, rbudget = ref.topk_threshold_ref(g, k_target, K.TOPK_BITS[g.dtype])
    lt, lbudget = topk_library(g, k_target)
    chk = tally.add(
        "topk_threshold", cuda_ms(lambda: K.topk_threshold(g, k_target)),
        cuda_ms(lambda: ref.topk_threshold_ref(g, k_target,
                                               K.TOPK_BITS[g.dtype]), 1),
        n * gb + rows * 12)
    for what, a, b in (("t", t, rt), ("budget", budget, rbudget),
                       ("t vs torch.topk", t, lt),
                       ("budget vs torch.topk", budget, lbudget)):
        chk.equal(f"topk_threshold {what}", a, b)
    del rt, rbudget, lt, lbudget
    tally.library_ms["topk_threshold"] = tally.library_ms.get(
        "topk_threshold", 0.0) + cuda_ms(lambda: topk_library(g, k_target))
    for key, fn in (("topk_peak_bytes", K.topk_threshold),
                    ("library_peak_bytes", topk_library)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(g, k_target)
        torch.cuda.synchronize()
        tally.library_ms[key] = max(tally.library_ms.get(key, 0),
                                    torch.cuda.max_memory_allocated()
                                    - before)
    for pkind, cname in (("rho", "f32"), ("bern", "f32"), ("topk", "f32"),
                         ("lam", "qsgd8"), ("topk", "ternary"),
                         ("bern", "ternary")):
        codec = codecs.get(cname)
        kw, kc = kind_scalars(g, pkind, l1, mx, k_cap)
        s1 = kw.pop("s1")
        uu = None if pkind == "topk" else u
        ub = 0 if pkind == "topk" else 4
        st = K.select_stats(g, uu, s1, kc, pkind=pkind, **kw)
        if cname == "f32":                  # pass 1 once per kind
            name = f"select_stats/{pkind}"
            rst = ref.select_stats_ref(g, uu, s1, kc, K.TILE, pkind=pkind,
                                       **kw)
            chk = tally.add(
                name, cuda_ms(lambda: K.select_stats(g, uu, s1, kc,
                                                     pkind=pkind, **kw)),
                cuda_ms(lambda: ref.select_stats_ref(
                    g, uu, s1, kc, K.TILE, pkind=pkind, **kw), 1),
                n * (gb + ub) + st.base.numel() * 4
                * (2 if pkind == "topk" else 1) + rows * 12)
            for f in ("nnz", "nonzeros", "base", "tie_base", "max_abs"):
                chk.equal(f"{name} {f}", getattr(st, f), getattr(rst, f))
            for f in ("p_sum", "den", "sum_sq"):
                chk.close(f"{name} {f}", getattr(st, f), getattr(rst, f))
            if pkind == "topk" and not bool((st.nnz == k_target).all()):
                raise AssertionError(f"topk kept {st.nnz.tolist()}, not "
                                     f"{k_target}")
            del rst
        scale = codecs.finalize_scale(codec, st.sum_sq, st.max_abs)
        u_cod = (torch.rand((rows, kc), device="cuda")
                 if codec.stochastic else None)
        ef = not codec.integer_coded
        args = dict(k_cap=kc, codec=codec, ef=ef, pkind=pkind, scale=scale,
                    u_cod=u_cod, **kw)
        name = f"compact_emit/{pkind}" + ("" if ef else f"+{cname}")
        out = K.compact_emit(g, uu, s1, st, **args)
        want = ref.compact_emit_ref(g, uu, s1, kc, codec, ef, pkind=pkind,
                                    scale=scale, u_cod=u_cod, **kw)
        n_live = int(torch.clamp_max(st.nnz, kc).sum())
        wb = torch.empty((), dtype=codec.wire_dtype(g.dtype)).element_size()
        # read g (and u), write the compact buffer, the residual with EF;
        # the integer codecs read one codec uniform per live slot
        bound = (n * (gb + ub + (gb if ef else 0)) + rows * kc * (wb + 4)
                 + (0 if ef else n_live * 4 + rows * 4))
        chk = tally.add(name, cuda_ms(lambda: K.compact_emit(
            g, uu, s1, st, **args)), cuda_ms(lambda: ref.compact_emit_ref(
                g, uu, s1, kc, codec, ef, pkind=pkind, scale=scale,
                u_cod=u_cod, **kw), 1), bound)
        for what, a, b in zip(("values", "idx", "residual"), out, want):
            chk.equal(f"{name} {what}", a, b)
        del out, want, st, u_cod
        torch.cuda.empty_cache()


def prng_z(g_row: torch.Tensor, lam, q_row: torch.Tensor) -> float:
    """How many standard deviations a row's kept count lies from its
    expectation sum p, p = min(lam |g|, 1) (float64, in chunks)."""
    mean = var = 0.0
    for a in range(0, g_row.numel(), CHECK_CHUNK):
        p = torch.clamp_max(float(lam) * g_row[a:a + CHECK_CHUNK].double()
                            .abs(), 1.0)
        mean += float(p.sum())
        var += float((p * (1 - p)).sum())
    kept = int(torch.count_nonzero(q_row))
    return abs(kept - mean) / max(math.sqrt(var), 1e-12)


def check_dense(chk: Check, name: str, got, want) -> None:
    """Kernels 5, 6 or 8 against their plain version: Q, the residual and
    the counts bit-equal, sum Q^2 and sum g^2 within rtol 1e-6 (kernel 8
    reduces no sum g^2, nor a pass given it from an earlier one)."""
    for f in ("q", "residual", "nnz", "n_sure"):
        chk.equal(f"{name} {f}", getattr(got, f), getattr(want, f))
    chk.close(f"{name} sum_sq", got.sum_sq, want.sum_sq)
    if got.den is not None or want.den is not None:
        chk.close(f"{name} den", got.den, want.den)


def dense_kind(g, pkind, l1, mx):
    """The dense emit's per-row scalars for selector kind ``pkind`` (topk
    with pass 1's tie bases), as keywords of ``kernel.sparsify``, and its
    plain version's keywords (no tie bases: it ranks the ties itself)."""
    from repro_torch.kernels.sparsify import kernel as K
    d = g.shape[1]
    if pkind == "one":
        return dict(pkind="one"), dict(pkind="one"), None
    kw, _ = kind_scalars(g, pkind, l1, mx, d)
    s1 = kw.pop("s1")
    plain = dict(pkind=pkind, **kw)
    if pkind == "topk":
        kw["tie_base"] = K.select_stats(g, None, s1, d, pkind="topk",
                                        budget=kw["budget"]).tie_base
    return dict(pkind=pkind, **kw), plain, s1


def dense_scale(chk: Check, g, u, s1, codec, kw: dict, l2mx):
    """An integer codec's scale on the dense wire: pass 1 with ``round_v``
    at k_cap = d (held to its plain version: max exact, sum v^2 within
    rtol 1e-6), topk's pass 1 as it is, identity's from the stats kernel."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ref
    d = g.shape[1]
    pkind = kw["pkind"]
    if pkind == "one":
        return codecs.finalize_scale(codec, *l2mx)
    extra = {k: kw[k] for k in ("s2", "budget") if k in kw}
    rnd = pkind != "topk"
    st = K.select_stats(g, u, s1, d, pkind=pkind, round_v=rnd, **extra)
    rst = ref.select_stats_ref(g, u, s1, d, K.TILE, pkind=pkind,
                               round_v=rnd, **extra)
    chk.equal(f"scale {pkind} max_abs", st.max_abs, rst.max_abs)
    chk.close(f"scale {pkind} sum_sq", st.sum_sq, rst.sum_sq)
    return codecs.finalize_scale(codec, st.sum_sq, st.max_abs)


def dense_checks(tally: Tally, g, u, l1, mx, lam, seed: int,
                 prng: dict) -> None:
    """The dense wire's kernels at one main-path group (the f32 codec: Q in
    g's bf16) against their plain versions, and kernel 8 both alone and
    through ``ops.gspar_sparsify_prng`` on every row of the group as a
    leaf, with the launch counts set to 0 just before and read just after
    and each row's kept count held to 6 standard deviations of sum p."""
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    rows, d = g.shape
    gb, n = g.element_size(), rows * d
    l1d, l2d, mxd = K.stats(g)
    rl1, rl2, rmx = ref.stats_ref(g)
    chk = tally.add("stats", cuda_ms(lambda: K.stats(g)),
                    cuda_ms(lambda: ref.stats_ref(g), 1), n * gb + rows * 12)
    chk.close("stats l1", l1d, rl1)
    chk.close("stats l2", l2d, rl2)
    chk.equal("stats max", mxd, rmx)
    chk.equal("stats l1 vs stats_l1max", l1d, l1)
    chk.equal("stats max vs stats_l1max", mxd, mx)
    tally.library_ms["stats"] = tally.library_ms.get("stats", 0.0) + cuda_ms(
        lambda: (torch.linalg.vector_norm(g, 1, -1, dtype=torch.float32),
                 torch.linalg.vector_norm(g, 2, -1, dtype=torch.float32),
                 torch.linalg.vector_norm(g, math.inf, -1)))
    del rl1, rl2, rmx
    for name, kern, plain, res_b in (
            ("sparsify", K.sparsify, ref.sparsify_ref, 0),
            ("sparsify_ef", K.sparsify_ef, ref.sparsify_ef_ref, gb)):
        # sum g^2 from the stats pass, as gspar's dense path passes it
        got, want = kern(g, u, lam, den=l2d), plain(g, u, lam, den=l2d)
        # read g and u, write Q (and the residual), 20 B of counts a row
        chk = tally.add(name, cuda_ms(lambda: kern(g, u, lam, den=l2d)),
                        cuda_ms(lambda: plain(g, u, lam, den=l2d), 1),
                        n * (2 * gb + 4 + res_b) + rows * 20)
        check_dense(chk, name, got, want)
        del got, want
        torch.cuda.empty_cache()
    got = K.sparsify_prng(g, lam, seed)
    want = ref.sparsify_prng_ref(g, lam, seed)
    chk = tally.add("sparsify_prng",
                    cuda_ms(lambda: K.sparsify_prng(g, lam, seed)),
                    cuda_ms(lambda: ref.sparsify_prng_ref(g, lam, seed), 1),
                    n * 2 * gb + rows * 20)
    check_dense(chk, "sparsify_prng", got, want)
    del got, want
    torch.cuda.empty_cache()
    K.reset_launches()
    for r in range(rows):
        q = ops.gspar_sparsify_prng(g[r], seed, rho=RHO)
        z = prng_z(g[r], ops.gspar_lambda(g[r], RHO), q)
        prng["z_max"] = max(prng["z_max"], z)
        if not z < 6.0:
            raise AssertionError(f"gspar_sparsify_prng row {r}: kept count "
                                 f"{z:.2f} sd from sum p")
        del q
    prng["launches"] += K.LAUNCHES["sparsify_prng"]
    prng["rows"] += rows


# The dense emit's variants on the launcher paths past gspar's: (name,
# selector kind, codec, EF), with the path each serves
DENSE_VARIANTS = (
    ("sparsify_ef/rho", "rho", "f32", True),              # unisp
    ("sparsify_ef/topk", "topk", "f32", True),            # topk
    ("sparsify_ef/bern+ternary", "bern", "ternary", True),   # terngrad
    ("sparsify_ef/lam+qsgd8", "lam", "qsgd8", True),      # gspar+qsgd8
    ("sparsify_ef/one+qsgd4", "one", "qsgd4", True),      # qsgd
    ("sparsify/one", "one", "f32", False),                # none
)
CLOSED_EPS = 1.0          # Algorithm 2's budget: the JAX default (dense wire)
CLOSED_GATHER_EPS = 40.0  # on the gather wire, chosen only to keep every
                          # gemma-2b row under its capacity, sized from rho


def dense_variant_checks(tally: Tally, g, u, l1, mx, lam,
                         variants=DENSE_VARIANTS) -> None:
    """The dense emit's ``variants`` (by default the launcher paths') at
    one group, each against its plain version (bit-equal; sums within rtol
    1e-6) and timed with the bytes of its bound, and the integer codecs'
    scale pass (``select_stats`` with ``round_v`` at k_cap = d)."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ref
    rows, d = g.shape
    gb, n = g.element_size(), rows * d
    u_cod = torch.rand((rows, d), generator=torch.Generator(
        device="cuda").manual_seed(d), device="cuda")
    l2mx = K.stats(g)[1:]
    for name, pkind, cname, ef in variants:
        kw, pkw, s1 = dense_kind(g, pkind, l1, mx)
        if pkind == "lam":
            s1 = lam
        uu = u if pkind in ("lam", "rho", "bern") else None
        codec = codecs.get(cname)
        ckw = {}
        if codec.integer_coded:
            scale_name = f"select_stats/{pkind}+rounded"
            if pkind != "one":
                extra = {k: kw[k] for k in ("s2",) if k in kw}
                chk = tally.add(scale_name, cuda_ms(lambda: K.select_stats(
                    g, uu, s1, d, pkind=pkind, round_v=True, **extra)),
                    cuda_ms(lambda: ref.select_stats_ref(
                        g, uu, s1, d, K.TILE, pkind=pkind, round_v=True,
                        **extra), 1),
                    n * (gb + 4) + rows * ref.ntiles(d, K.TILE) * 40)
            else:
                chk = Check()
            ckw = dict(codec=codec, u_cod=u_cod,
                       scale=dense_scale(chk, g, uu, s1, codec, kw, l2mx))
        # sum g^2 from an earlier pass where the path has one (the stats
        # pass's equals pass 1's within rtol 1e-6); unisp and none reduce it
        if pkind not in ("rho", "one") or codec.integer_coded:
            ckw["den"] = l2mx[0]
        kern = K.sparsify_ef if ef else K.sparsify
        plain = ref.sparsify_ef_ref if ef else ref.sparsify_ref
        got = kern(g, uu, s1, g.dtype, **kw, **ckw)
        want = plain(g, uu, s1, g.dtype, **pkw, **ckw)
        # read g (and u, u_cod), write Q (and the residual), 28 B a tile
        moved = n * (2 * gb + (4 if uu is not None else 0)
                     + (4 if codec.integer_coded else 0) + (gb if ef else 0))
        chk = tally.add(name, cuda_ms(lambda: kern(g, uu, s1, g.dtype, **kw,
                                                   **ckw)),
                        cuda_ms(lambda: plain(g, uu, s1, g.dtype, **pkw,
                                              **ckw), 1),
                        moved + rows * ref.ntiles(d, K.TILE) * 28)
        check_dense(chk, name, got, want)
        del got, want
        torch.cuda.empty_cache()
    del u_cod


def closed_checks(tally: Tally, g, closed: dict) -> None:
    """Algorithm 2's lambda on the card (``ops.closed_lambda``: the magnitude
    histogram of ``topk_threshold``'s histogram pass, then the bin solve
    ``kernel.closed_lambda``, one block a row; no sort) against the plain
    float64 solve of each row (one sort, ``closed_form_lambda``), rtol 1e-6,
    at each path's eps; the bin solve against its plain version on the same
    histogram (the same bin on every row, lambda within rtol 1e-6); their
    times (at the dense path's eps) beside the composition it replaced (the
    histogram, then the torch solve over a float64 [rows, 2^15] tensor),
    and the peak scratch."""
    from repro_torch.core import sparsify
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    rows, d = g.shape
    hist = K.magnitude_hist(g)
    chk = tally.add("topk_threshold/hist",
                    cuda_ms(lambda: K.magnitude_hist(g)),
                    cuda_ms(lambda: ref.magnitude_counts(g), 1),
                    rows * d * g.element_size() + rows * ref.KEY_BINS * 4)
    chk.equal("magnitude_hist", hist, ref.magnitude_counts(g))
    chk = tally.add(
        "closed_lambda",
        cuda_ms(lambda: K.closed_lambda(hist, CLOSED_EPS)),
        cuda_ms(lambda: ref.closed_lambda_bins_ref(hist, CLOSED_EPS), 1),
        rows * ref.KEY_BINS * 4 + rows * 8)
    closed["ms_torch_solve"] += cuda_ms(
        lambda: ref.closed_lambda_bins_ref(K.magnitude_hist(g), CLOSED_EPS))
    torch.cuda.empty_cache()
    for eps in (CLOSED_EPS, CLOSED_GATHER_EPS):
        lam_b, b = K.closed_lambda(hist, eps)
        want_lam, want_b = ref.closed_lambda_bins_ref(hist, eps)
        chk.equal(f"closed_lambda bin eps {eps}", b, want_b)
        chk.close(f"closed_lambda eps {eps}", lam_b, want_lam)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lam = ops.closed_lambda(g, eps)
        torch.cuda.synchronize()
        closed["peak_scratch_bytes"] = max(
            closed["peak_scratch_bytes"],
            torch.cuda.max_memory_allocated() - before)
        chk.equal(f"ops.closed_lambda eps {eps}", lam, lam_b)
        if eps == CLOSED_EPS:
            closed["ms"] += cuda_ms(lambda: ops.closed_lambda(g, eps))
        for r in range(g.shape[0]):
            want = sparsify.closed_form_lambda(g[r], eps)[0]
            rel = abs(float(lam[r]) - float(want)) / max(abs(float(want)),
                                                         1e-30)
            closed["max_rel_err"] = max(closed["max_rel_err"], rel)
            if rel > SUM_RTOL:
                raise AssertionError(f"closed_form_lambda_rows row {r} "
                                     f"eps {eps}: relative error {rel}")
            torch.cuda.empty_cache()
    del hist


def philox_check() -> None:
    """Kernel 8's generator on the card against the known answers."""
    from repro_torch.kernels.sparsify import kernel as K
    ctr = torch.tensor([c for c, _, _ in PHILOX_KAT], device="cuda")
    key = torch.tensor([k for _, k, _ in PHILOX_KAT], device="cuda")
    got = K.philox4x32_10(ctr, key).tolist()
    if got != [list(w) for _, _, w in PHILOX_KAT]:
        raise AssertionError(f"Philox4x32-10 on the card: {got}")


def kernel_phase(groups) -> dict:
    """Each kernel against its plain version on every main-path group, with
    the same inputs and the same per-row scalars; times per step (one launch
    per group; tail_stats per solver pass)."""
    from repro_torch.comm import compaction, sync, wire_layout
    from repro_torch.core import codecs, coding
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    tally = Tally()
    library_ms = 0.0
    ms_no_ef = 0.0
    prng = {"launches": 0, "rows": 0, "z_max": 0.0}
    closed = {"ms": 0.0, "ms_torch_solve": 0.0, "peak_scratch_bytes": 0,
              "max_rel_err": 0.0}
    philox_check()
    decode_ms = {"rice": 0.0, "rice_fitted": 0.0, "coo": 0.0}
    fitted = {"r_hist": {}, "used_words": 0, "static_words": 0, "ms": {},
              "device_ms": {}, "device_ops": {}}
    f32, bf16 = codecs.FloatCodec(), codecs.FloatCodec(16, True)
    widest = max(d for _, d, _ in groups)     # gemma-2b: 1 x 524,288,000
    memset_ms = 0.0
    for gi, (rows, d, k_cap) in enumerate(groups):
        g = heavy_tailed(rows, d, gen)
        u = torch.rand((rows, d), generator=gen, device="cuda")
        gb, n = g.element_size(), rows * d

        l1, mx = K.stats_l1max(g)
        rl1, rmx = ref.stats_l1max_ref(g)
        chk = tally.add("stats_l1max", cuda_ms(lambda: K.stats_l1max(g)),
                        cuda_ms(lambda: ref.stats_l1max_ref(g), 1),
                        n * gb + rows * 8)
        chk.close("stats_l1max l1", l1, rl1)
        chk.equal("stats_l1max max", mx, rmx)
        library_ms += cuda_ms(lambda: (
            torch.linalg.vector_norm(g, 1, -1, dtype=torch.float32),
            torch.linalg.vector_norm(g, math.inf, -1)))

        lam0 = ops.greedy_lambda(l1, mx, RHO, d)
        gate = lam0 * mx > 1.0
        thresh = ops._safe_div(1.0, lam0)
        cnt, tl1 = K.tail_stats(g, thresh, gate)
        rcnt, rtl1 = ref.tail_stats_ref(g, thresh, gate)
        chk = tally.add(
            "tail_stats", cuda_ms(lambda: K.tail_stats(g, thresh, gate)),
            cuda_ms(lambda: ref.tail_stats_ref(g, thresh, gate), 1),
            int(gate.sum()) * d * gb + rows * 12)
        chk.equal("tail_stats count", cnt, rcnt)
        chk.close("tail_stats l1", tl1, rtl1)

        lam = ops.greedy_lambda(l1, mx, RHO, d,
                                tail_fn=ops._kernel_tail_fn(g))
        st = K.select_stats(g, u, lam, k_cap)
        rst = ref.select_stats_ref(g, u, lam, k_cap, K.TILE)
        chk = tally.add(
            "select_stats/lam",
            cuda_ms(lambda: K.select_stats(g, u, lam, k_cap)),
            cuda_ms(lambda: ref.select_stats_ref(g, u, lam, k_cap, K.TILE),
                    1),
            n * (gb + 4) + st.base.numel() * 4)
        for f in ("nnz", "nonzeros", "base", "max_abs"):
            chk.equal(f"select_stats {f}", getattr(st, f), getattr(rst, f))
        for f in ("p_sum", "den", "sum_sq"):
            chk.close(f"select_stats {f}", getattr(st, f), getattr(rst, f))

        # the f32 codec (leaf dtype on the wire) with and without EF, and
        # the bf16 codec, whose residual subtracts the wire-rounded value
        chk = tally.add("compact_emit/lam", 0.0, 0.0,
                        n * (2 * gb + 4) + rows * k_cap * (gb + 4))
        for codec, ef in ((f32, False), (f32, True), (bf16, True)):
            out = K.compact_emit(g, u, lam, st, k_cap=k_cap, codec=codec,
                                 ef=ef)
            want = ref.compact_emit_ref(g, u, lam, k_cap, codec, ef)
            for what, a, b in zip(("values", "idx", "residual"), out, want):
                chk.equal(f"compact_emit {codec.name} ef={ef} {what}", a, b)
            del out, want
            if codec is bf16:        # checked only; timed as the f32 codec
                continue
            t = cuda_ms(lambda: K.compact_emit(g, u, lam, st, k_cap=k_cap,
                                               codec=f32, ef=ef))
            if ef:                  # the main path runs with error feedback
                tally.add("compact_emit/lam", t, cuda_ms(
                    lambda: ref.compact_emit_ref(g, u, lam, k_cap, f32,
                                                 True), 1))
            else:
                ms_no_ef += t

        # the memset of the compact buffers, which the kernel's own zeroing
        # of the dead slots replaces (timed alone, for PERF.md)
        memset_ms += cuda_ms(lambda: (
            torch.zeros((rows, k_cap), dtype=g.dtype, device="cuda"),
            torch.zeros((rows, k_cap), dtype=torch.int32, device="cuda")))

        # the RICE stage on the compact buffers compact_emit produced
        vals, idx, _ = K.compact_emit(g, u, lam, st, k_cap=k_cap, codec=f32,
                                      ef=False)
        r = coding.rice_parameter(k_cap, d)
        words, used = K.rice_pack(idx, st.nnz, d=d, r=r)
        want_w, want_u = ref.rice_pack_ref(idx, st.nnz, d, r)
        n_live = torch.clamp_max(st.nnz, k_cap).tolist()
        # what the words depend on: each row's live idx prefix (dead codes
        # are zeros, never read for their value), nnz; written: every word
        # of the capacity (the zero padding ships) and used
        chk = tally.add(
            "rice_pack", cuda_ms(lambda: K.rice_pack(idx, st.nnz, d=d, r=r)),
            cuda_ms(lambda: ref.rice_pack_ref(idx, st.nnz, d, r), 1),
            (sum(n_live) + words.numel() + 2 * rows) * 4)
        chk.equal("rice_pack words", words, want_w)
        chk.equal("rice_pack used", used, want_u)
        del want_w, want_u
        fitted_checks(tally, idx, st.nnz, d, used, n_live, fitted)
        if d == widest:
            overflow_checks(tally, g, u, lam, st)
        for row in range(rows):             # the words decode to idx
            dec = compaction.rice_decode(words[row], k_cap, d, r)
            chk.equal(f"rice_decode row {row}", dec[:n_live[row]],
                      idx[row, :n_live[row]])
        # the receiver's decode and scatter-add at one worker, both layouts
        dense = torch.zeros(n + wire_layout.DROP_SLOTS, dtype=torch.float32,
                            device="cuda")
        lp = wire_layout.LeafPlan("rice", rows, d, k_cap, k_cap,
                                  words.shape[1], r)
        decode_ms["rice"] += cuda_ms(lambda: sync.decode_into(
            dense, lp, vals.reshape(1, -1), words.reshape(1, -1),
            used[None], 0, n))
        window = coding.rice_fit_window(k_cap, d)
        fw, fh = K.rice_fit_pack(idx, st.nnz, d=d, window=window)
        lp = wire_layout.LeafPlan("rice", rows, d, k_cap, k_cap,
                                  fw.shape[1], r, True, window)
        decode_ms["rice_fitted"] += cuda_ms(lambda: sync.decode_into(
            dense, lp, vals.reshape(1, -1), fw.reshape(1, -1), fh[None], 0,
            n))
        del fh, fw
        coo_words = idx + (torch.arange(rows, dtype=torch.int32,
                                        device="cuda") * d)[:, None]
        lp = wire_layout.LeafPlan("coo", rows, d, k_cap, k_cap, k_cap)
        decode_ms["coo"] += cuda_ms(lambda: sync.decode_into(
            dense, lp, vals.reshape(1, -1), coo_words.reshape(1, -1), None,
            0, n))
        del vals, idx, words, used, dense, coo_words, rst
        torch.cuda.empty_cache()
        variant_checks(tally, g, u, l1, mx, k_cap)
        compaction_checks(tally, g, k_cap, first=gi == 0)
        dense_checks(tally, g, u, l1, mx, lam, PRNG_SEED + gi, prng)
        dense_variant_checks(tally, g, u, l1, mx, lam)
        closed_checks(tally, g, closed)
        print(f"group [{rows}, {d}] k_cap {k_cap}: kernels and variants "
              f"agree with their plain versions (nnz {int(st.nnz.sum())}, "
              f"gated rows {int(gate.sum())}; gspar_sparsify_prng within "
              f"{prng['z_max']:.2f} sd of sum p)", flush=True)
        del g, u, st
        torch.cuda.empty_cache()
    tally.library_ms["stats_l1max"] = library_ms
    return {"tally": tally, "ms_no_ef": ms_no_ef, "decode_ms": decode_ms,
            "prng": prng, "memset_ms": memset_ms, "closed": closed,
            "fitted": fitted}


def plain_compact(g, k_cap: int):
    """``compaction.compact``'s plain version: the plain threshold, passes
    1 and 2 of topk with the f32 codec."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ref
    t, budget = ref.topk_threshold_ref(g, k_cap, K.TOPK_BITS[g.dtype])
    st = ref.select_stats_ref(g, None, t, k_cap, K.TILE, pkind="topk",
                              budget=budget)
    vals, idx, _ = ref.compact_emit_ref(g, None, t, k_cap,
                                        codecs.FloatCodec(), False,
                                        pkind="topk", budget=budget)
    return vals, idx, st.nonzeros


def three_kernels(g, k_cap: int):
    """The compaction's earlier route on a bf16 group, and a float32
    group's still: ``topk_threshold`` at k_cap, then passes 1 and 2 of topk
    (the f32 codec)."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ops
    t, budget = ops.topk_threshold(g, k_cap)
    sel = K.select_stats(g, None, t, k_cap, pkind="topk", budget=budget)
    return K.compact_emit(g, None, t, sel, k_cap=k_cap,
                          codec=codecs.FloatCodec(), ef=False, pkind="topk",
                          budget=budget)


def compaction_checks(tally: Tally, g, k_cap: int, first: bool) -> None:
    """``compaction.compact`` (the pod stage's and the reference backend's
    selection: on a bf16 group ``compact_bins``, the magnitude histogram
    and a finish over its bins, then ``compact_select``, one pass with a
    chained scan) on one group of dense heavy-tailed rows, where the
    capacity really cuts: values, idx and nnz bit-equal to the plain
    three-step version, timed beside it, beside the three kernels it
    replaced (``three_kernels``) and beside ``torch.topk(|g|, k_cap)`` (the
    library call); each kernel against its plain version, the row scalars
    equal (sum v^2 within rtol 1e-6); and the deterministic rounding of
    the integer codecs (the pod stage's) bit-equal to the plain version at
    the kernel's scale, qsgd4 on every group and ternary on the first, in
    ``compact_select`` and in pass 2 (``det_round``, a float32 group's)."""
    from repro_torch.comm import compaction
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ref
    rows, d = g.shape
    gb = g.element_size()
    vals, idx, nnz = compaction.compact(g, k_cap)
    want = plain_compact(g, k_cap)
    chk = tally.add(
        "compaction.compact", cuda_ms(lambda: compaction.compact(g, k_cap)),
        cuda_ms(lambda: plain_compact(g, k_cap), 1),
        rows * d * gb + rows * k_cap * (gb + 4) + rows * 4)
    for what, a, b in zip(("values", "idx", "nnz"), (vals, idx, nnz), want):
        chk.equal(f"compact {what}", a, b)
    if not bool((nnz >= k_cap).all()):
        raise AssertionError("the dense rows should overflow the capacity")
    tally.library_ms["compaction.compact"] = tally.library_ms.get(
        "compaction.compact", 0.0) + cuda_ms(lambda: topk_library_k(
            g, k_cap), 3)
    tally.library_ms["compaction_three_kernels"] = tally.library_ms.get(
        "compaction_three_kernels", 0.0) + cuda_ms(
            lambda: three_kernels(g, k_cap))
    del vals, idx, nnz, want
    bins = K.compact_bins(g, k_cap)
    want = ref.compact_bins_ref(g, k_cap)
    chk = tally.add("compact_bins", cuda_ms(lambda: K.compact_bins(g, k_cap)),
                    cuda_ms(lambda: ref.compact_bins_ref(g, k_cap), 1),
                    rows * d * gb + rows * 32)
    for f in ("t", "budget", "nonzeros", "kept", "max_abs"):
        chk.equal(f"compact_bins {f}", getattr(bins, f), getattr(want, f))
    chk.close("compact_bins sum_sq", bins.sum_sq, want.sum_sq)
    f32 = codecs.FloatCodec()
    got = K.compact_select(g, bins, k_cap=k_cap, codec=f32)
    chk = tally.add(
        "compact_select",
        cuda_ms(lambda: K.compact_select(g, bins, k_cap=k_cap, codec=f32)),
        cuda_ms(lambda: ref.compact_emit_ref(
            g, None, bins.t, k_cap, f32, False, pkind="topk",
            budget=bins.budget), 1),
        rows * d * gb + rows * k_cap * (gb + 4) + rows * 16)
    want = ref.compact_emit_ref(g, None, bins.t, k_cap, f32, False,
                                pkind="topk", budget=bins.budget)
    for what, a, b in zip(("values", "idx"), got, want):
        chk.equal(f"compact_select {what}", a, b)
    del got, want
    t, budget = ref.topk_threshold_ref(g, k_cap, K.TOPK_BITS[g.dtype])
    sel = K.select_stats(g, None, t, k_cap, pkind="topk", budget=budget)
    for name in ("qsgd4",) + (("ternary",) if first else ()):
        codec = codecs.get(name)
        scale = codecs.finalize_scale(codec, bins.sum_sq, bins.max_abs)
        got = K.compact_select(g, bins, k_cap=k_cap, codec=codec,
                               scale=scale)
        want = ref.compact_emit_ref(g, None, t, k_cap, codec, False,
                                    pkind="topk", budget=budget, scale=scale,
                                    det_round=True)
        for what, a, b in zip(("values", "idx"), got, want):
            chk.equal(f"compact_select det {name} {what}", a, b)
        got = K.compact_emit(g, None, t, sel, k_cap=k_cap, codec=codec,
                             ef=False, pkind="topk", budget=budget,
                             scale=scale, det_round=True)
        for what, a, b in zip(("values", "idx"), got, want):
            chk.equal(f"compact_emit det {name} {what}", a, b)
        del got, want
    del t, budget, sel, bins
    torch.cuda.empty_cache()


def device_ms(fn, reps: int = REPS) -> tuple[float | None, dict]:
    """The card's own time of one call of ``fn``: the summed durations of
    the kernels and memsets it enqueues (torch.profiler, CUDA activity),
    averaged over ``reps`` calls after one warm-up, without the host's
    share that ``cuda_ms`` includes; and the device operations a call, by
    name. ``None`` when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):                   # a trace that lost its device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        us = sum(e.self_device_time_total for e in events)
        if us > 0:
            return us / reps / 1e3, {e.key[:60]: e.count / reps
                                     for e in events}
    return None, {}


FITTED_ROUTES = ("fit", "pack", "pair", "fit_legacy", "pack_legacy",
                 "static")


def fitted_checks(tally: Tally, idx, nnz, d: int, used, n_live,
                  fitted: dict) -> None:
    """Wire-format v4's two kernels on one group's compact idx (gspar's):
    ``rice_fit`` (r, header and the tile bases: ``rice_fit_tiles``) and
    the fitted ``rice_pack`` from those bases (words and header), and the
    pair from one host call (``rice_fit_pack``, the main path's),
    bit-equal to their plain versions; timed beside the static packing of
    the same idx (``rice_pack``, timed before too) and beside the first
    route of both (``rice_fit_legacy``, ``rice_pack_fitted_legacy``, also
    held bit-equal), each by CUDA events around the wrapper (``cuda_ms``,
    the host's share included; the routes in turns, then in reverse, the
    mean of the two) and by the profiler's device time (``device_ms``); the
    headers' used words never over the static ones, the words decoding at
    each row's r to the kept coordinates; the r histogram."""
    from repro_torch.comm import compaction
    from repro_torch.core import coding
    from repro_torch.kernels.sparsify import kernel as K, ref
    rows, k_cap = idx.shape
    window = coding.rice_fit_window(k_cap, d)
    fit = K.rice_fit_tiles(idx, nnz, d=d, window=window)
    r, header, bases = fit
    want_r, want_h = ref.rice_fit_ref(idx, nnz, d, window)
    # the live idx prefix read once; r, header and the bases written
    chk = tally.add(
        "rice_fit", 0.0,
        cuda_ms(lambda: ref.rice_fit_ref(idx, nnz, d, window), 1),
        (sum(n_live) + rows) * 4 + rows * 8 + bases.numel() * 4)
    chk.equal("rice_fit r", r, want_r)
    chk.equal("rice_fit header", header, want_h)
    chk.equal("rice_fit bases", bases,
              ref.rice_tile_bases_ref(idx, nnz, want_r, d, K.RICE_TILE))
    words, header2 = K.rice_pack_fitted(idx, nnz, r, d=d, window=window,
                                        bases=bases)
    want_w, want_h2 = ref.rice_pack_fitted_ref(idx, nnz, r, d, window)
    chk = tally.add(
        "rice_pack/fitted", 0.0,
        cuda_ms(lambda: ref.rice_pack_fitted_ref(idx, nnz, r, d, window), 1),
        (sum(n_live) + words.numel() + 3 * rows + bases.numel()) * 4)
    chk.equal("rice_pack/fitted words", words, want_w)
    chk.equal("rice_pack/fitted header", header2, want_h2)
    chk.equal("rice_pack/fitted header vs rice_fit", header2, header)
    pair = K.rice_fit_pack(idx, nnz, d=d, window=window)
    chk.equal("rice_fit_pack words", pair[0], want_w)
    chk.equal("rice_fit_pack header", pair[1], want_h2)
    del want_w, want_h2, pair
    old_r, old_h = K.rice_fit_legacy(idx, nnz, d=d, window=window)
    chk.equal("rice_fit_legacy r and header", torch.stack([old_r, old_h]),
              torch.stack([r, header]))
    old = K.rice_pack_fitted_legacy(idx, nnz, r, d=d, window=window)
    chk.equal("rice_pack_fitted_legacy words", old[0], words)
    chk.equal("rice_pack_fitted_legacy header", old[1], header)
    del old, old_r, old_h
    r_static = coding.rice_parameter(k_cap, d)
    calls = {
        "fit": lambda: K.rice_fit_tiles(idx, nnz, d=d, window=window),
        "pack": lambda: K.rice_pack_fitted(idx, nnz, r, d=d, window=window,
                                           bases=bases),
        "pair": lambda: K.rice_fit_pack(idx, nnz, d=d, window=window),
        "fit_legacy": lambda: K.rice_fit_legacy(idx, nnz, d=d,
                                                window=window),
        "pack_legacy": lambda: K.rice_pack_fitted_legacy(
            idx, nnz, r, d=d, window=window),
        "static": lambda: K.rice_pack(idx, nnz, d=d, r=r_static)}
    ms = dict.fromkeys(FITTED_ROUTES, 0.0)
    for key in FITTED_ROUTES + FITTED_ROUTES[::-1]:
        ms[key] += cuda_ms(calls[key]) / 2
    for key in FITTED_ROUTES:
        fitted["ms"][key] = fitted["ms"].get(key, 0.0) + ms[key]
        dev, ops = device_ms(calls[key])
        acc = fitted["device_ms"]
        acc[key] = None if dev is None or (key in acc and acc[key] is None) \
            else acc.get(key, 0.0) + dev
        fitted["device_ops"].setdefault(key, ops)
    # the table's times of the two kernels: as timed here, in turns
    tally.ms["rice_fit"] += ms["fit"]
    tally.ms["rice_pack/fitted"] += ms["pack"]
    fused = header & compaction.RICE_HDR_USED_MASK
    if bool((fused > used).any()):
        raise AssertionError("a fitted row uses more words than the static")
    fitted["used_words"] += int(fused.sum())
    fitted["static_words"] += int(used.sum())
    for x in r.tolist():
        fitted["r_hist"][x] = fitted["r_hist"].get(x, 0) + 1
    dec = compaction.rice_decode_fitted(words, k_cap, d, window, header)
    for row in range(rows):
        chk.equal(f"rice_decode_fitted row {row}", dec[row, :n_live[row]],
                  idx[row, :n_live[row]])
    del dec, words, header, header2, r, bases, fit


def overflow_checks(tally: Tally, g, u, lam, st) -> None:
    """compact_emit/lam (f32 codec, EF) and rice_pack on one group at an
    overflowing capacity, k_cap = nnz // 2 of its emptiest row, so that
    every row is cut inside its tiles: bit-equal to the plain versions
    (checked, not timed)."""
    from repro_torch.core import codecs, coding
    from repro_torch.kernels.sparsify import kernel as K, ref
    d = g.shape[1]
    k_cap = int(st.nnz.min()) // 2
    f32 = codecs.FloatCodec()
    out = K.compact_emit(g, u, lam, st, k_cap=k_cap, codec=f32, ef=True)
    want = ref.compact_emit_ref(g, u, lam, k_cap, f32, True)
    chk = tally.check["compact_emit/lam"]
    for what, a, b in zip(("values", "idx", "residual"), out, want):
        chk.equal(f"compact_emit overflow k_cap={k_cap} {what}", a, b)
    del want
    r = coding.rice_parameter(k_cap, d)
    words, used = K.rice_pack(out[1], st.nnz, d=d, r=r)
    want_w, want_u = ref.rice_pack_ref(out[1], st.nnz, d, r)
    tally.check["rice_pack"].equal("rice_pack overflow words", words, want_w)
    tally.check["rice_pack"].equal("rice_pack overflow used", used, want_u)
    print(f"overflow: compact_emit/lam (f32, EF) and rice_pack (r={r}) at "
          f"k_cap {k_cap} of nnz {st.nnz.tolist()} on [{g.shape[0]}, {d}] "
          "agree with their plain versions", flush=True)
    del out, words, used, want_w, want_u
    torch.cuda.empty_cache()


def variant_sweep():
    """Every selector kind x codec x EF on small ragged groups (f32 and
    bf16 leaves, a configured and an overflowing capacity), each kernel
    output bit-equal to its plain version."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, d = 3, 100_003
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        g = heavy_tailed(rows, d, gen).to(dtype)
        u = torch.rand((rows, d), generator=gen, device="cuda")
        l1, mx = K.stats_l1max(g)
        for pkind in ("lam", "rho", "bern", "topk"):
            for k_cap in (8192, 1024):
                kw, _ = kind_scalars(g, pkind, l1, mx, k_cap)
                s1 = kw.pop("s1")
                uu = None if pkind == "topk" else u
                st = K.select_stats(g, uu, s1, k_cap, pkind=pkind, **kw)
                rst = ref.select_stats_ref(g, uu, s1, k_cap, K.TILE,
                                           pkind=pkind, **kw)
                for f in ("nnz", "nonzeros", "base", "tie_base", "max_abs"):
                    Check().equal(f"sweep {pkind} {f}", getattr(st, f),
                                  getattr(rst, f))
                u_cod = torch.rand((rows, k_cap), generator=gen,
                                   device="cuda")
                for cname in codecs.CODEC_NAMES:
                    codec = codecs.get(cname)
                    scale = codecs.finalize_scale(codec, st.sum_sq,
                                                  st.max_abs)
                    for ef in (False, True):
                        if ef and codec.integer_coded:
                            continue
                        a = dict(k_cap=k_cap, codec=codec, ef=ef,
                                 pkind=pkind, scale=scale, u_cod=u_cod, **kw)
                        out = K.compact_emit(g, uu, s1, st, **a)
                        want = ref.compact_emit_ref(
                            g, uu, s1, k_cap, codec, ef, pkind=pkind,
                            scale=scale, u_cod=u_cod, **kw)
                        for what, x, y in zip(("values", "idx", "res"), out,
                                              want):
                            Check().equal(f"sweep {dtype} {pkind} {cname} "
                                          f"ef={ef} {what}", x, y)
                        n += 1
    print(f"variant sweep: {n} compact_emit variants agree with their plain "
          "versions", flush=True)


def dense_sweep():
    """The dense wire's kernels on small groups, ragged (the scalar path)
    and aligned (16-byte vectors), f32 and bf16 g: every selector kind x
    codec x EF of the dense emit (kernels 5 and 6, with the codec scales
    of pass 1 with ``round_v``), the gspar kind at every float wire dtype,
    and kernel 8, each bit-equal to its plain version."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (100_003, 65_536):
            g = heavy_tailed(3, d, gen).to(dtype)
            u = torch.rand((3, d), generator=gen, device="cuda")
            u_cod = torch.rand((3, d), generator=gen, device="cuda")
            l1, l2, mx = K.stats(g)
            rl1, rl2, rmx = ref.stats_ref(g)
            chk = Check()
            chk.close("sweep stats l1", l1, rl1)
            chk.close("sweep stats l2", l2, rl2)
            chk.equal("sweep stats max", mx, rmx)
            lam = ops.greedy_lambda(l1, mx, RHO, d,
                                    tail_fn=ops._kernel_tail_fn(g))
            for wire in sorted({dtype, torch.bfloat16}, key=str):
                for name, kern, plain in (
                        ("sparsify", K.sparsify, ref.sparsify_ref),
                        ("sparsify_ef", K.sparsify_ef, ref.sparsify_ef_ref)):
                    check_dense(chk, f"sweep {dtype} d={d} {name} {wire}",
                                kern(g, u, lam, wire),
                                plain(g, u, lam, wire))
                    n += 1
            check_dense(chk, f"sweep {dtype} d={d} sparsify_prng",
                        K.sparsify_prng(g, lam, PRNG_SEED),
                        ref.sparsify_prng_ref(g, lam, PRNG_SEED))
            n += 1
            for pkind in K.DENSE_KINDS:
                kw, pkw, s1 = dense_kind(g, pkind, l1, mx)
                uu = u if pkind in ("lam", "rho", "bern") else None
                for cname in codecs.CODEC_NAMES:
                    codec = codecs.get(cname)
                    ckw = {}
                    out_dtype = codec.wire_dtype(dtype)
                    if codec.integer_coded:
                        out_dtype = dtype
                        ckw = dict(codec=codec, u_cod=u_cod,
                                   scale=dense_scale(chk, g, uu, s1, codec,
                                                     kw, (l2, mx)))
                    for name, kern, plain in (
                            ("sparsify", K.sparsify, ref.sparsify_ref),
                            ("sparsify_ef", K.sparsify_ef,
                             ref.sparsify_ef_ref)):
                        check_dense(
                            chk, f"sweep {dtype} d={d} {name}/{pkind}+"
                            f"{cname}",
                            kern(g, uu, s1, out_dtype, **kw, **ckw),
                            plain(g, uu, s1, out_dtype, **pkw, **ckw))
                        n += 1
    print(f"dense sweep: {n} dense-wire kernel variants agree with their "
          "plain versions", flush=True)


def reference_phase():
    """The emit pipelines on the card against the same pipelines on the
    CPU (plain versions, held to the JAX package by the CPU tests) on a
    small input. gspar: lambda within rtol 1e-6, the same kept coordinates
    except draws within 1e-6 of their keep probability. The baselines,
    whose scalars are exact (rho, max|g|, topk's threshold and budget):
    every buffer bit-equal, with the integer codecs too."""
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, d, k_cap = 3, 100_003, 8192
    g = heavy_tailed(rows, d, gen)
    u = torch.rand((rows, d), generator=gen, device="cuda")
    u_cod = torch.rand((rows, k_cap), generator=gen, device="cuda")
    kw = dict(k_cap=k_cap, rho=RHO, codec=codecs.FloatCodec(), ef=True)
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
    dn = ops.gspar_dense(g, u, rho=RHO, ef=True)
    dn_c = ops.gspar_dense(g.cpu(), u.cpu(), rho=RHO, ef=True)
    rel_d = ((dn.lam.cpu().double() - dn_c.lam.double()).abs()
             / dn_c.lam.double().abs()).max().item()
    p = torch.clamp_max(dn_c.lam[:, None] * g.cpu().float().abs(), 1.0)
    flips = (dn.q.cpu() != 0) != (dn_c.q != 0)
    if rel_d > 1e-6 or bool((flips & ((u.cpu() - p).abs() >= 1e-6)).any()):
        raise AssertionError(f"gspar_dense: card vs CPU lambda rel err "
                             f"{rel_d}, or kept sets differ away from p")
    del dn, dn_c, p, flips
    k_target = round(RHO * d)
    pipelines = {
        "unisp": lambda g, u, c: ops.unisp_emit(
            g, u, k_cap=k_cap, rho=RHO, ef=True),
        "unisp+qsgd8": lambda g, u, c: ops.unisp_emit(
            g, u, c, k_cap=k_cap, rho=RHO, codec=codecs.get("qsgd8")),
        "topk+ternary": lambda g, u, c: ops.topk_emit(
            g, c, k_cap=k_cap, k_target=k_target,
            codec=codecs.get("ternary"), rice_r=3),
        "bernoulli+ternary": lambda g, u, c: ops.bern_emit(
            g, u, c, k_cap=k_cap, codec=codecs.get("ternary"))[0],
    }
    for name, fn in pipelines.items():
        a, b = fn(g, u, u_cod), fn(g.cpu(), u.cpu(), u_cod.cpu())
        for f in ("values", "idx", "nnz", "nonzeros", "rice_words",
                  "rice_used", "residual"):
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x.cpu(), y)):
                raise AssertionError(f"{name} {f}: card != CPU")
        torch.testing.assert_close(a.scale.cpu(), b.scale, rtol=1e-6, atol=0)
    print(f"reference: card vs CPU lambda rel err {rel:.2e} (emit), "
          f"{rel_d:.2e} (dense), kept sets agree; {', '.join(pipelines)} "
          "bit-equal card vs CPU", flush=True)


def decoded(values: torch.Tensor, scale: torch.Tensor,
            codec_name: str) -> torch.Tensor:
    """Compact values of one row as the receiver decodes them, from the
    codec's definition: level x (scale / (2^N - 1)) for qsgd<N>, level x
    scale for ternary, the float values as they are."""
    v = values.float()
    if codec_name == "ternary":
        return v * scale
    if codec_name.startswith("qsgd"):
        return v * (scale / float(2 ** int(codec_name[4:]) - 1))
    return v


def rice_words_host(sg, n_live) -> int:
    """Realized Golomb-Rice words of every row, in numpy on the host: the
    live indices must ascend strictly inside [0, d); each row ships
    ceil((k_cap (r + 1) + sum((gap - 1) >> r)) / 32) words."""
    from repro_torch.core import coding
    k_cap, d = sg.k_cap, sg.d
    r = coding.rice_parameter(k_cap, d)
    idx_h = sg.idx.cpu().numpy().astype(np.int64)
    words = 0
    for row, n in enumerate(n_live):
        a = idx_h[row, :n]
        gaps = np.diff(a, prepend=-1)
        if n and not (gaps.min() >= 1 and a[-1] < d):
            raise AssertionError(f"row {row}: live indices do not ascend "
                                 f"inside [0, {d})")
        words += -(-(k_cap * (r + 1) + int(((gaps - 1) >> r).sum())) // 32)
    return words


def rice_words_card(sg, n_live_t) -> int:
    """The same count on the card with torch ops, from each row's live
    gaps (independent of ``rice_pack``)."""
    from repro_torch.core import coding
    k_cap, d = sg.k_cap, sg.d
    r = coding.rice_parameter(k_cap, d)
    idx = sg.idx.long()
    live = torch.arange(k_cap, device=idx.device) < n_live_t[:, None]
    prev = torch.cat([torch.full_like(idx[:, :1], -1), idx[:, :-1]], 1)
    gaps = torch.where(live, idx - prev, 1)
    if not bool(((gaps >= 1) & (~live | (idx < d))).all()):
        raise AssertionError("live indices do not ascend inside [0, d)")
    bits = k_cap * (r + 1) + ((gaps - 1) >> r).sum(-1)
    return int(((bits + 31) // 32).sum())


def exchange_check(real, record: list, path: MainPath, host_words: bool):
    """Wrap ``sync._bucketed_sync``: after each exchange, hold its layouts
    and static bytes to the path's, its charged bytes to the values, the
    counts, the scales and 4 bytes per realized Golomb-Rice word of the
    step's compact buffers (recomputed on the host or on the card), and the
    synced leaves to the scatter of the same buffers, decoded. The checks'
    time and any peak memory they add are recorded, not hidden."""
    from repro_torch.comm import compaction

    def checked(items, leaves, group, cfg):
        out, wire, overflow = real(items, leaves, group, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        codec = cfg.scheme().codec
        values = counts = scales = used_words = dropped = 0
        host_s = 0.0
        layouts = set()
        for kind, sg, members in items:
            if kind != "sparse":
                raise AssertionError("the checked paths have no dense "
                                     "passthrough")
            layouts.add(sg.layout)
            k_cap, d = sg.k_cap, sg.d
            n_live_t = torch.clamp_max(sg.nnz.long(), k_cap)
            n_live = n_live_t.tolist()
            dropped += int(torch.clamp_min(sg.nnz.long() - k_cap, 0).sum())
            values += (sg.rows * (d if sg.layout == "dense" else k_cap)
                       * sg.values.element_size())
            scales += sg.rows * 4 if codec.has_scale else 0
            if sg.layout == "rice":
                counts += sg.rows * 4
                t1 = time.perf_counter()
                used_words += (rice_words_host(sg, n_live) if host_words
                               else rice_words_card(sg, n_live_t))
                host_s += time.perf_counter() - t1
            r0 = 0
            for i, n_rows in members:
                synced = out[i].reshape(n_rows, d)
                for rr in range(n_rows):
                    row = r0 + rr
                    idx = sg.idx[row, :n_live[row]].long()
                    vals = decoded(sg.values[row, :n_live[row]],
                                   sg.scale[row], codec.name)
                    edges = torch.arange(0, d + CHECK_CHUNK, CHECK_CHUNK,
                                         device=idx.device).clamp_max(d)
                    cut = torch.searchsorted(idx, edges).tolist()
                    for c, a in enumerate(edges[:-1].tolist()):
                        b = min(d, a + CHECK_CHUNK)
                        lo, hi = cut[c], cut[c + 1]
                        want = compaction.scatter(
                            vals[lo:hi], idx[lo:hi] - a, b - a).to(
                                synced.dtype)
                        if not torch.equal(synced[rr, a:b], want):
                            raise AssertionError(
                                f"leaf {i} row {rr} [{a}, {b}): synced "
                                "gradient != decoded scatter of the compact "
                                "buffers")
                r0 += n_rows
        if layouts != {path.layout}:
            raise AssertionError(f"layouts stamped {sorted(layouts)}, not "
                                 f"{path.layout} on every group")
        if (values, counts, scales) != (path.value_bytes, path.count_bytes,
                                        path.scale_bytes):
            raise AssertionError(f"values {values} B, counts {counts} B, "
                                 f"scales {scales} B")
        want = values + counts + scales + 4 * used_words
        if int(wire) != want or want > path.max_bytes:
            raise AssertionError(f"wire bytes {int(wire)}, expected {want} "
                                 f"(at most {path.max_bytes})")
        torch.cuda.synchronize()
        if int(overflow) != dropped:
            raise AssertionError(f"overflow {int(overflow)} != the buffers' "
                                 f"{dropped} dropped survivors")
        record.append({"wire_bytes": want, "used_words": used_words,
                       "overflow": dropped,
                       "check_s": time.perf_counter() - t0,
                       "words_s": host_s,
                       "check_raised_peak":
                           torch.cuda.max_memory_allocated() > peak})
        return out, wire, overflow
    return checked


def topk_check(real, record: list):
    """Wrap ``ops.topk_emit``: record each group's kept count, support and
    k_target (topk keeps exactly k_target where the row has that many
    nonzeros, all its nonzeros otherwise)."""
    def checked(g2d, u_cod=None, *, k_target, **kw):
        er = real(g2d, u_cod, k_target=k_target, **kw)
        want = torch.clamp_max(er.nonzeros, k_target)
        if not torch.equal(er.nnz, want):
            raise AssertionError(f"topk kept {er.nnz.tolist()}, want "
                                 f"{want.tolist()} (k_target {k_target})")
        record.append(int(er.nnz.sum()))
        return er
    return checked


def closed_train(wire: str, layout: str = "auto") -> dict:
    """Algorithm 2 on ``wire`` (gspar, ``algo="closed"``, with error
    feedback; eps CLOSED_EPS dense, CLOSED_GATHER_EPS gather) at gemma-2b
    full width through ``make_compressed_train_step``, as the launcher's
    loop drives it (its model, Adam, seeds, batch and timing; it has no
    flag for algo or eps): three steps. Returns the launcher's summary."""
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.api import CompressionConfig
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.train import init_process_group
    from repro_torch.models.transformer import Transformer, init_model
    from repro_torch.optim.optimizers import adam, init_feedback
    from repro_torch.train.step import make_compressed_train_step
    comp = CompressionConfig(
        name="gspar", algo="closed", rho=RHO, wire=wire, wire_layout=layout,
        eps=CLOSED_EPS if wire == "dense" else CLOSED_GATHER_EPS,
        error_feedback=True, min_leaf_size=1024)
    cfg = registry.get("gemma-2b").model
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    own_group = init_process_group(dev)
    try:
        print(f"compression: {comp.describe()}", flush=True)
        model = Transformer(cfg, init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), dev))
        opt = adam(3e-4)
        opt_state = opt.init(model.leaves())
        ef_state = init_feedback(model.leaves())
        step = make_compressed_train_step(model, comp, opt)
        data_gen = torch.Generator(device=dev).manual_seed(1_000_003)
        comp_gen = torch.Generator(device=dev).manual_seed(2_000_003)
        metrics, seconds = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            batch = token_batch(data_gen, cfg.vocab, 8, 128)
            opt_state, ef_state, m = step(opt_state, ef_state, batch,
                                          comp_gen)
            metrics.append({k: float(v) for k, v in m.items()})
            seconds.append(time.perf_counter() - t0)
        layouts = list(step.layouts)
        del model, opt_state, ef_state, step
    finally:
        if own_group:
            dist.destroy_process_group()
    return {"metrics": metrics, "step_seconds": seconds, "layouts": layouts,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def train_phase(name: str, layout: str = "auto", check: str | None = None
                ) -> dict:
    """One launcher run of path ``name`` with the kernel counts set to 0
    just before it and read just after. ``check`` "host" or "card" holds
    every exchange to its exact bytes (Golomb-Rice words recomputed there)
    and gradient (the step times then include the checks); without it the
    run gives the step times and its bytes are held to the path's bounds.
    gspar on ``coo`` checks the COO wire's exact bytes."""
    from repro_torch.comm import sync
    from repro_torch.kernels.sparsify import kernel as K, ops
    from repro_torch.launch import train
    path = PATHS[name]
    record: list = []
    topk_record: list = []
    real, real_topk = sync._bucketed_sync, ops.topk_emit
    if check:
        sync._bucketed_sync = exchange_check(real, record, path,
                                             check == "host")
    ops.topk_emit = topk_check(real_topk, topk_record)
    argv = (TRAIN_ARGS + ["--compressor", path.compressor, "--wire-layout",
                          layout] + path.extra)
    K.reset_launches()
    try:
        summary = (closed_train("gather", layout) if name == "closed"
                   else train.main(argv))
    finally:
        sync._bucketed_sync, ops.topk_emit = real, real_topk
    launches = dict(K.LAUNCHES)
    want_layout = path.layout if layout == "auto" else layout
    if {lay for *_, lay in summary["layouts"]} != {want_layout}:
        raise AssertionError(f"{name} {layout}: layouts "
                             f"{summary['layouts']}")
    for step, m in enumerate(summary["metrics"]):
        if not math.isfinite(m["loss"]):
            raise AssertionError(f"step {step}: loss {m['loss']}")
        if layout == "coo" or record:
            want = record[step]["wire_bytes"] if record else WIRE_BYTES
            if m["wire_bytes"] != want:
                raise AssertionError(f"{name} {layout} step {step}: "
                                     f"wire_bytes {m['wire_bytes']} != {want}")
        elif path.value_bytes is not None:
            words = (m["wire_bytes"] - path.value_bytes - path.count_bytes
                     - path.scale_bytes)
            if not (0 < words and words % 4 == 0
                    and m["wire_bytes"] <= path.max_bytes):
                raise AssertionError(f"{name} step {step}: wire_bytes "
                                     f"{m['wire_bytes']} outside the RICE "
                                     "bounds")
        if m["overflow"] != 0 and not (
                path.binomial and record
                and m["overflow"] == record[step]["overflow"]
                and m["overflow"] <= 1e-5 * m["density"] * COORDS):
            raise AssertionError(f"step {step}: overflow {m['overflow']}")
        if not 0.0 < m["density"] <= (1.0 if "bern" in path.compressor
                                      or "terngrad" in path.compressor
                                      else 1.25 * RHO):
            raise AssertionError(f"step {step}: density {m['density']}")
    if check and len(record) != len(summary["metrics"]):
        raise AssertionError("an exchange went unchecked")
    if "topk" in path.compressor and not topk_record:
        raise AssertionError("topk_emit never ran on the topk path")
    for v in path.variants:
        if v == "rice_pack" and layout == "coo":
            continue
        if launches.get(v, 0) <= 0:
            raise AssertionError(f"kernel {v} never launched on the {name} "
                                 f"{layout} path")
    steps = summary["step_seconds"]
    net = [s - c["check_s"] for s, c in zip(steps, record)]
    print(f"train {name} --wire-layout {layout}"
          f"{f' (checked on the {check})' if check else ''}: steps "
          + ", ".join(f"{s:.4f} s" for s in steps)
          + (" (less the checks: " + ", ".join(f"{s:.4f} s" for s in net)
             + ")" if record else "")
          + "; wire_bytes " + ", ".join(
              f"{m['wire_bytes']:.0f}" for m in summary["metrics"])
          + "; density " + ", ".join(
              f"{m['density']:.6f}" for m in summary["metrics"])
          + "; loss " + ", ".join(f"{m['loss']:.4f}"
                                  for m in summary["metrics"])
          + f"; max_memory_allocated {summary['max_memory_allocated']} B",
          flush=True)
    summary.update(launches=launches, checks=record, net_seconds=net,
                   name=name)
    return summary


def dense_check(real, record: list):
    """Wrap ``ops.gspar_dense``: after each group's compression, run the
    gather wire's ``ops.gspar_emit`` on the same target and uniforms and
    hold its lambda bit-equal to the dense wire's, its overflow to 0 and
    the decode of its compact buffers (each row's live values at their
    indices, zeros elsewhere) to the dense Q, bit for bit. The checks' time
    is recorded, not hidden."""
    from repro_torch.comm.compaction import capacity_for
    from repro_torch.core import codecs
    from repro_torch.kernels.sparsify import ops

    def checked(g2d, u2d, u_cod=None, **kw):
        r = real(g2d, u2d, u_cod, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, d = g2d.shape
        k_cap = capacity_for(d, RHO)
        er, lam = ops.gspar_emit(g2d, u2d, k_cap=k_cap, rho=RHO,
                                 codec=codecs.FloatCodec(), ef=False)
        if not torch.equal(lam, r.lam):
            raise AssertionError(f"[{rows}, {d}]: gather and dense lambdas "
                                 "differ")
        if int(torch.clamp_min(er.nnz - k_cap, 0).sum()) != 0:
            raise AssertionError(f"[{rows}, {d}]: the gather wire "
                                 "overflowed")
        if not torch.equal(er.nnz.long(), r.nnz):
            raise AssertionError(f"[{rows}, {d}]: survivors {er.nnz} != "
                                 f"nonzeros of Q {r.nnz}")
        for row in range(rows):
            n = int(er.nnz[row])
            want = torch.zeros(d, dtype=r.q.dtype, device=r.q.device)
            want[er.idx[row, :n].long()] = er.values[row, :n]
            if not torch.equal(r.q[row], want):
                raise AssertionError(f"[{rows}, {d}] row {row}: dense Q != "
                                     "the decoded compact buffers")
            del want
        torch.cuda.synchronize()
        record.append({"rows": rows, "d": d, "kept": int(r.nnz.sum()),
                       "check_s": time.perf_counter() - t0})
        return r
    return checked


def dense_train_phase(name: str, check: bool = False) -> dict:
    """One launcher run of ``DENSE_RUNS[name]`` on the dense wire with the
    kernel counts set to 0 just before it and read just after (with EF as
    ``--wire dense --error-feedback``; gspar without EF on the launcher's
    default wire, no ``--wire``). Every step must charge exactly the bf16
    gradient's bytes, stamp no layout, overflow nothing and launch every
    variant of the run and no kernel of the gather wire; ``check`` (gspar)
    holds each group's Q to the gather wire's compact buffers
    (``dense_check``)."""
    from repro_torch.kernels.sparsify import kernel as K, ops
    from repro_torch.launch import train
    compressor, ef, variants = DENSE_RUNS[name]
    record: list = []
    real = ops.gspar_dense
    if check:
        ops.gspar_dense = dense_check(real, record)
    argv = DENSE_ARGS + ["--compressor", compressor] + (
        ["--wire", "dense", "--error-feedback"] if ef else [])
    K.reset_launches()
    try:
        summary = (closed_train("dense") if name == "closed_dense"
                   else train.main(argv))
    finally:
        ops.gspar_dense = real
    launches = dict(K.LAUNCHES)
    if summary["layouts"]:
        raise AssertionError(f"{name}: layouts {summary['layouts']}")
    top = 1.25 * RHO if compressor in ("gspar", "agspar", "unisp", "topk") \
        and name != "closed_dense" else 1.0
    for step, m in enumerate(summary["metrics"]):
        if not math.isfinite(m["loss"]):
            raise AssertionError(f"{name} step {step}: loss {m['loss']}")
        if m["wire_bytes"] != DENSE_WIRE_BYTES or m["overflow"] != 0:
            raise AssertionError(f"{name} step {step}: wire_bytes "
                                 f"{m['wire_bytes']}, overflow "
                                 f"{m['overflow']}")
        if not 0.0 < m["density"] <= top:
            raise AssertionError(f"{name} step {step}: density "
                                 f"{m['density']}")
    for v in variants:
        if launches.get(v, 0) <= 0:
            raise AssertionError(f"kernel {v} never launched on {name}")
    other = [v for v in ("stats_l1max", "compact_emit", "rice_pack",
                         "sparsify_prng") if launches.get(v, 0)]
    if not check and other:
        raise AssertionError(f"{name} launched the gather wire's kernels "
                             f"{other}: {launches}")
    wrong_ef = "sparsify" if ef else "sparsify_ef"
    if launches.get(wrong_ef, 0):
        raise AssertionError(f"{name} (EF {ef}) launched {wrong_ef}: "
                             f"{launches}")
    groups = len(record) // max(1, len(summary["metrics"]))
    if check and (groups == 0 or len(record) != groups * len(
            summary["metrics"])):
        raise AssertionError("a dense compression went unchecked")
    steps = summary["step_seconds"]
    net = [s - sum(c["check_s"] for c in record[i * groups:(i + 1) * groups])
           for i, s in enumerate(steps)] if check else list(steps)
    print(f"train {name}{' (checked)' if check else ''}: steps "
          + ", ".join(f"{s:.4f} s" for s in steps)
          + (" (less the checks: " + ", ".join(f"{s:.4f} s" for s in net)
             + ")" if check else "")
          + "; wire_bytes " + ", ".join(
              f"{m['wire_bytes']:.0f}" for m in summary["metrics"])
          + "; density " + ", ".join(
              f"{m['density']:.6f}" for m in summary["metrics"])
          + "; var " + ", ".join(
              f"{m['var_ratio']:.3f}" for m in summary["metrics"])
          + "; loss " + ", ".join(f"{m['loss']:.4f}"
                                  for m in summary["metrics"])
          + f"; max_memory_allocated {summary['max_memory_allocated']} B",
          flush=True)
    summary.update(launches=launches, checks=record, net_seconds=net,
                   name=name)
    return summary


# --- the step-size options at full width (var_lr_phase) ----------------------

def warmup(t: int) -> float:
    """Run A's schedule: a 3-step linear warmup to 3e-4, so that the
    residual is rescaled by sched(1) / sched(2) = 0.5 and 2/3."""
    return 3e-4 * min(t, 3) / 3


def f32_quotient(a: float, b: float) -> np.float32:
    return np.float32(a) / np.float32(b)


def var_lr_run(name: str) -> dict:
    """gemma-2b full width on the dense wire with gspar and
    ``var_adaptive_lr=True``, three steps through
    ``make_compressed_train_step``: run "A" with EF, ``adam(warmup)`` and ``lr_schedule=warmup``; run "B"
    without EF under ``sgd(3e-4, momentum=0.9)``. On a sampled leaf (the
    final norm scale, d_model wide: its group's buffers are small) each step
    checks, bit for bit: (A) the carried residual rescaled in place to
    ``(r.float() * ratio).to(bf16)``, ratio the float32 quotient
    sched(t) / sched(t + 1); the applied step size eta = lr_t / max(var,
    1) as a float32 quotient, through the optimizer's own update of that
    leaf recomputed from its state (A: ``round(p - eta upd)``, upd from
    Adam's moments; B: ``round(p - eta mu)``, JAX's float32 value rounded
    once); every parameter bfloat16; exactly DENSE_WIRE_BYTES a step."""
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.api import CompressionConfig
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.train import init_process_group
    from repro_torch.models.transformer import Transformer, init_model
    from repro_torch.optim import optimizers as topt
    from repro_torch.train.step import make_compressed_train_step
    ef = name == "A"
    comp = CompressionConfig(name="gspar", rho=RHO, wire="dense",
                             error_feedback=ef, min_leaf_size=1024)
    cfg = registry.get("gemma-2b").model
    dev = torch.device("cuda", 0)
    own_group = init_process_group(dev)
    rows = []
    try:
        model = Transformer(cfg, init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), dev))
        leaves = model.leaves()
        i = next(k for k, p in enumerate(leaves) if p.numel() == cfg.d_model)
        if ef:
            opt = topt.adam(warmup)
            step = make_compressed_train_step(model, comp, opt,
                                              var_adaptive_lr=True,
                                              lr_schedule=warmup)
            fb = topt.init_feedback(leaves)
        else:
            opt = topt.sgd(3e-4, momentum=0.9)
            step = make_compressed_train_step(model, comp, opt,
                                              var_adaptive_lr=True)
        state = opt.init(leaves)
        data_gen = torch.Generator(device=dev).manual_seed(1_000_003)
        comp_gen = torch.Generator(device=dev).manual_seed(2_000_003)
        for t in range(3):
            batch = token_batch(data_gen, cfg.vocab, 8, 128)
            p_before = leaves[i].detach().clone()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            if ef:
                res = fb.residual[i]
                r_before = res.clone()
                state, fb, m = step(state, fb, batch, comp_gen)
            else:
                state, m = step(state, batch, comp_gen)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            m = {k: float(v) for k, v in m.items()}
            var_scale = max(np.float32(m["var_ratio"]), np.float32(1.0))
            lr_t = warmup(t + 1) if ef else 3e-4
            eta = f32_quotient(lr_t, var_scale)
            ratio = (f32_quotient(warmup(t), warmup(t + 1))
                     if ef and t > 0 else np.float32(1.0))
            if ef and not torch.equal(
                    res, (r_before.float() * float(ratio)).to(res.dtype)):
                raise AssertionError(f"var_lr {name} step {t}: the residual "
                                     "was not rescaled by sched(t)/sched(t+1)")
            eta_t = torch.tensor(eta, device=dev)
            if ef:
                tt = torch.tensor(float(t + 1), dtype=torch.float32)
                bc1 = torch.tensor(float(1 - 0.9 ** tt), device=dev)
                bc2 = torch.tensor(float(1 - 0.999 ** tt), device=dev)
                mm, vv = state["m"][i], state["v"][i]
                upd = (mm / bc1) / ((vv / bc2).sqrt() + 1e-8)
            else:
                upd = state["mu"][i].float()
            want = (p_before.float() - upd * eta_t).to(torch.bfloat16)
            if not torch.equal(leaves[i].detach(), want):
                raise AssertionError(f"var_lr {name} step {t}: the applied "
                                     f"step size is not {eta!r}")
            if any(p.dtype != torch.bfloat16 for p in leaves):
                raise AssertionError(f"var_lr {name}: a parameter left "
                                     "bfloat16")
            if m["wire_bytes"] != DENSE_WIRE_BYTES or not math.isfinite(
                    m["loss"]) or not var_scale > 1.0:
                raise AssertionError(f"var_lr {name} step {t}: {m}")
            rows.append({"step": t, "var_scale": float(var_scale),
                         "eta": float(eta), "ratio": float(ratio),
                         "seconds": seconds, "peak_bytes": peak,
                         "loss": m["loss"], "wire_bytes": m["wire_bytes"]})
            print(f"var_lr {name} step {t}: var_scale {float(var_scale):.6f}"
                  f", eta {float(eta):.6e}, rescale ratio {float(ratio):.6f}"
                  f", {seconds:.4f} s, peak {peak} B, loss {m['loss']:.4f}",
                  flush=True)
        del model, leaves, state, step
        if ef:
            del fb, res, r_before
    finally:
        if own_group:
            dist.destroy_process_group()
    return {"steps": rows}


def var_lr_phase() -> dict:
    """Runs A and B of ``var_lr_run``, the launch counts set to 0 just
    before each and read just after: A must launch the dense emit with EF
    (kernel 6), B without (kernel 5), each after the stats pass (7) and
    the tail passes (2)."""
    from repro_torch.kernels.sparsify import kernel as K
    out = {}
    for name, want in (("A", "sparsify_ef/lam"), ("B", "sparsify/lam")):
        torch.cuda.empty_cache()
        K.reset_launches()
        run = var_lr_run(name)
        run["launches"] = {k: v for k, v in K.LAUNCHES.items() if v}
        for kern in ("stats", "tail_stats", want):
            if run["launches"].get(kern, 0) <= 0:
                raise AssertionError(f"var_lr {name}: {kern} never launched")
        out[name] = run
    return out


# --- the adaptive control loop and wire-format v4 (adaptive_phase) -----------

ADAPTIVE_ARGS = ["--arch", "gemma-2b", "--steps", "4", "--rho", str(RHO),
                 "--error-feedback", "--adaptive", "--skip-tau", "0.7",
                 "--rice-fitted", "--log-every", "1"]
ADAPTIVE_GATHER = ("rice_fit", "rice_pack/fitted")
FORCE_STEP = 2                  # the step whose bounds (B) and (D) force
# name -> (extra launcher arguments, checked, forced skips, the kernel
# variants the run must launch)
ADAPTIVE_RUNS = {
    "adaptive_A": (["--wire", "gather"], True, False,
                   GSPAR + ("compact_emit/lam",) + ADAPTIVE_GATHER),
    "adaptive_B": (["--wire", "gather"], True, True,
                   GSPAR + ("compact_emit/lam",) + ADAPTIVE_GATHER),
    "adaptive_C": (["--wire", "gather", "--compressor", "topk"], False,
                   False, ("topk_threshold", "select_stats/topk",
                           "compact_emit/topk") + ADAPTIVE_GATHER),
    "adaptive_D": ([], True, True, ("stats", "tail_stats",
                                    "sparsify_ef/lam")),
}


def fitted_words_card(sg, n_live_t):
    """Per row of a RICE group, on the card with torch ops from the live
    gaps (independent of the kernels): the Golomb-Rice words at each
    parameter of the fitted window, the first minimum and its r, and the
    words at the static parameter."""
    from repro_torch.core import coding
    k_cap, d = sg.k_cap, sg.d
    idx = sg.idx.long()
    live = torch.arange(k_cap, device=idx.device) < n_live_t[:, None]
    prev = torch.cat([torch.full_like(idx[:, :1], -1), idx[:, :-1]], 1)
    x = torch.where(live, idx - prev - 1, 0)
    if not bool(((x >= 0) & (~live | (idx < d))).all()):
        raise AssertionError("live indices do not ascend inside [0, d)")
    window = coding.rice_fit_window(k_cap, d)
    words = torch.stack([(k_cap * (r + 1) + (x >> r).sum(-1) + 31) // 32
                         for r in window])
    best = words.argmin(0)                    # the first minimum
    r_s = coding.rice_parameter(k_cap, d)
    static = (k_cap * (r_s + 1) + (x >> r_s).sum(-1) + 31) // 32
    return (words.gather(0, best[None])[0],
            torch.tensor(window, device=idx.device)[best], static, window)


def adaptive_check(real_sync, real_exchange, record: list, checked: bool,
                   forced: bool, min_leaf: int):
    """Wrap ``train.step.sync_tree`` (and ``sync._bucketed_sync`` beneath
    it, to keep the step's compact buffers): at step FORCE_STEP with
    ``forced`` set the bound of every other eligible leaf to 1e30 first;
    after each call record the skips, the wire bytes and the fitted r of
    every row, and with ``checked`` hold the step to the loop's contract:
    headers r in the window and used = the first minimum of the words
    recomputed on the card, never over the static words; skipped rows zero
    values, words and header; the charge exactly values + counts + 4 x used
    less the skipped rows' values; every leaf's synced value = last_avg +
    the decoded scatter of its buffers (bf16 rounding each), bit for bit;
    ``last_sent = g + r_in - r_out`` on every leaf; a forced leaf's
    residual its whole target ``(g - last_sent) + r_in``, its synced value
    its last_avg. The dense wire (no buffers): the same but the scatter
    and bytes (exactly the gradient's)."""
    from repro_torch.comm import compaction
    held: dict = {}

    def exchange(items, leaves, group, cfg):
        out = real_exchange(items, leaves, group, cfg)
        held["items"] = items
        return out

    def sync_tree(comp, generator, grads, *, control=None, feedback=None,
                  **kw):
        step = control.step
        force = []
        if forced and step == FORCE_STEP:
            eligible = [i for i, g in enumerate(grads)
                        if g.numel() >= min_leaf]
            force = eligible[::2]
            for i in force:
                control.bound[i].fill_(1e30)
        r_in = feedback.residual
        last_avg = list(control.last_avg)
        targets = {i: (grads[i] - control.last_sent[i]).add_(r_in[i])
                   for i in force}
        held.clear()
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        synced, fb, ctl, stats = real_sync(
            comp, generator, grads, control=control, feedback=feedback, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = {"step": step, "forced": len(force),
               "skipped": float(stats.skipped),
               "wire_bytes": float(stats.wire_bytes), "r_hist": {},
               "peak_through_sync": torch.cuda.max_memory_allocated()}
        items = held.pop("items", None)
        skipped_leaves = set()
        if items is not None:
            values = counts = used_total = refund = static_total = 0
            rec["dropped"] = 0
            for kind, sg, members in items:
                if kind == "dense":       # tiny leaves: float32, never skip
                    values += sg.numel() * 4
                    continue
                rec["dropped"] += int(sg.overflow().sum())
                h = sg.rice_used.long()
                zero = h == 0
                r_rows = h >> compaction.RICE_HDR_SHIFT
                for r, c in zip(*torch.unique(r_rows[~zero],
                                              return_counts=True)):
                    rec["r_hist"][int(r)] = rec["r_hist"].get(int(r), 0) \
                        + int(c)
                r0 = 0
                for i, rows in members:
                    z = zero[r0:r0 + rows]
                    if bool(z.all()):
                        skipped_leaves.add(i)
                    elif bool(z.any()):
                        raise AssertionError(f"leaf {i}: some rows skipped")
                    r0 += rows
                if not checked:
                    continue
                n_live_t = torch.clamp_max(sg.nnz.long(), sg.k_cap)
                want_used, want_r, static, window = fitted_words_card(
                    sg, n_live_t)
                used = h & compaction.RICE_HDR_USED_MASK
                live = ~zero
                if not (torch.equal(used[live], want_used[live])
                        and torch.equal(r_rows[live], want_r[live])):
                    raise AssertionError("fitted headers != the first "
                                         "minimum over the window")
                if bool((used > static).any()):
                    raise AssertionError("a fitted row uses more words than "
                                         "the static parameter")
                if bool(sg.values[zero].any()) or bool(
                        sg.rice_words[zero].any()):
                    raise AssertionError("a skipped row ships data")
                row_bytes = sg.k_cap * sg.values.element_size()
                values += sg.rows * row_bytes
                counts += sg.rows * 4
                used_total += int(used.sum())
                static_total += int(static[live].sum())
                refund += int(zero.sum()) * row_bytes
                _closure_check(sg, members, synced, last_avg)
            if checked:
                want = values + counts + 4 * used_total - refund
                if int(stats.wire_bytes) != want:
                    raise AssertionError(f"wire bytes {stats.wire_bytes}, "
                                         f"expected {want}")
                rec.update(used_words=used_total, static_words=static_total,
                           refund=refund)
        elif checked:
            if float(stats.wire_bytes) != DENSE_WIRE_BYTES:
                raise AssertionError(f"dense wire bytes {stats.wire_bytes}")
            skipped_leaves = {i for i in force}
        if items is not None and len(skipped_leaves) != rec["skipped"]:
            raise AssertionError(f"{len(skipped_leaves)} leaves ship zero "
                                 f"headers, skipped {rec['skipped']}")
        if not set(force) <= skipped_leaves or rec["skipped"] < len(force):
            raise AssertionError(f"forced leaves {force} not all skipped")
        if checked:
            for i, t in targets.items():
                if not (torch.equal(fb.residual[i], t)
                        and torch.equal(synced[i], last_avg[i])):
                    raise AssertionError(f"forced leaf {i}: residual != its "
                                         "target or synced != last_avg")
            for i, g in enumerate(grads):
                want = torch.add(g, r_in[i]).sub_(fb.residual[i])
                if not torch.equal(ctl.last_sent[i], want):
                    raise AssertionError(f"leaf {i}: last_sent != g + r_in "
                                         "- r_out")
                del want
        del targets, items
        rec["check_s"] = time.perf_counter() - t0
        record.append(rec)
        return synced, fb, ctl, stats
    return sync_tree, exchange


def _closure_check(sg, members, synced, last_avg) -> None:
    """Each member leaf's synced rows = its last_avg + the scatter of the
    row's decoded live values, both rounded as the closure rounds them
    (the scatter to the leaf dtype, then the sum), bit for bit, a chunk of
    CHECK_CHUNK coordinates at a time."""
    from repro_torch.comm import compaction
    d = sg.d
    n_live = torch.clamp_max(sg.nnz.long(), sg.k_cap).tolist()
    r0 = 0
    for i, rows in members:
        s_rows = synced[i].reshape(rows, d)
        a_rows = last_avg[i].reshape(rows, d)
        for rr in range(rows):
            row = r0 + rr
            idx = sg.idx[row, :n_live[row]].long()
            vals = decoded(sg.values[row, :n_live[row]], sg.scale[row],
                           sg.codec)
            edges = torch.arange(0, d + CHECK_CHUNK, CHECK_CHUNK,
                                 device=idx.device).clamp_max(d)
            cut = torch.searchsorted(idx, edges).tolist()
            for c, a in enumerate(edges[:-1].tolist()):
                b = min(d, a + CHECK_CHUNK)
                lo, hi = cut[c], cut[c + 1]
                want = compaction.scatter(vals[lo:hi], idx[lo:hi] - a,
                                          b - a).to(s_rows.dtype)
                want += a_rows[rr, a:b]
                if not torch.equal(s_rows[rr, a:b], want):
                    raise AssertionError(
                        f"leaf {i} row {rr} [{a}, {b}): synced != last_avg "
                        "+ the decoded scatter of the compact buffers")
        r0 += rows


def adaptive_run(name: str) -> dict:
    """One launcher run of ``ADAPTIVE_RUNS[name]`` (four steps, gemma-2b
    full width, the kernel counts set to 0 just before it and read just
    after), through ``adaptive_check``."""
    from repro_torch.comm import sync
    from repro_torch.kernels.sparsify import kernel as K
    from repro_torch.launch import train
    from repro_torch.train import step as step_lib
    extra, checked, forced, variants = ADAPTIVE_RUNS[name]
    record: list = []
    real_sync, real_exchange = step_lib.sync_tree, sync._bucketed_sync
    step_lib.sync_tree, sync._bucketed_sync = adaptive_check(
        real_sync, real_exchange, record, checked, forced, 1024)
    K.reset_launches()
    try:
        summary = train.main(ADAPTIVE_ARGS + extra)
    finally:
        step_lib.sync_tree, sync._bucketed_sync = real_sync, real_exchange
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    gather = "--wire" in extra
    for v in variants:
        if launches.get(v, 0) <= 0:
            raise AssertionError(f"kernel {v} never launched on {name}")
    if gather and launches.get("rice_pack", 0) != launches.get(
            "rice_pack/fitted", 0):
        raise AssertionError(f"{name}: a static rice_pack launched under "
                             f"--rice-fitted: {launches}")
    if not gather and any(launches.get(v, 0) for v in (
            "rice_pack", "rice_fit", "compact_emit")):
        raise AssertionError(f"{name}: the dense wire launched the gather "
                             f"wire's kernels: {launches}")
    if len(record) != len(summary["metrics"]):
        raise AssertionError(f"{name}: a step went unrecorded")
    for step, (m, rec) in enumerate(zip(summary["metrics"], record)):
        # a delta's survivors can pass a row's capacity: the overflow must
        # be the buffers' own count of dropped survivors (0 on the dense
        # wire)
        if not math.isfinite(m["loss"]) or m["overflow"] != rec.get(
                "dropped", 0):
            raise AssertionError(f"{name} step {step}: loss {m['loss']}, "
                                 f"overflow {m['overflow']}, buffers' "
                                 f"{rec.get('dropped', 0)}")
        if m["skipped"] != rec["skipped"] or m["wire_bytes"] != \
                rec["wire_bytes"]:
            raise AssertionError(f"{name} step {step}: metrics {m} != the "
                                 f"exchange's {rec}")
        if gather and m["wire_bytes"] > PATHS["gspar"].max_bytes:
            raise AssertionError(f"{name} step {step}: wire bytes "
                                 f"{m['wire_bytes']}")
    if forced and record[FORCE_STEP]["forced"] == 0:
        raise AssertionError(f"{name}: no leaf forced")
    steps = summary["step_seconds"]
    net = [s - rec["check_s"] for s, rec in zip(steps, record)]
    print(f"train {name} ({' '.join(extra) or '--wire dense'}"
          f"{', checked' if checked else ''}"
          f"{f', forced skips at step {FORCE_STEP}' if forced else ''}): "
          "steps " + ", ".join(f"{s:.4f} s" for s in steps)
          + " (less the checks: " + ", ".join(f"{s:.4f} s" for s in net)
          + "); wire_bytes " + ", ".join(f"{m['wire_bytes']:.0f}"
                                         for m in summary["metrics"])
          + "; skipped " + ", ".join(f"{m['skipped']:.0f}"
                                     for m in summary["metrics"])
          + "; overflow " + ", ".join(f"{m['overflow']:.0f}"
                                      for m in summary["metrics"])
          + "; fitted r " + ", ".join(str(dict(sorted(r["r_hist"].items())))
                                      for r in record)
          + "; loss " + ", ".join(f"{m['loss']:.4f}"
                                  for m in summary["metrics"])
          + f"; max_memory_allocated {summary['max_memory_allocated']} B",
          flush=True)
    summary.update(launches=launches, checks=record, net_seconds=net,
                   name=name)
    return summary


def adaptive_pass_ms() -> dict:
    """The control loop's passes alone at gemma-2b full width (bf16 leaves
    of random values, one worker, CUDA events, median of 3): the pre-pass
    (``sync._delta_and_skips``: the delta into last_sent, the delta
    energy, the bound and the flags), the energy alone (``sync._energy``
    over every leaf) and the closing (``sync._close_control``: the EF fold
    of skipped leaves, half of them here, the closure against last_avg and
    ``S' = g + r_in - r_out``)."""
    from repro_torch.comm import sync
    from repro_torch.configs.gemma_2b import FULL
    from repro_torch.core.api import CompressionConfig
    from repro_torch.models.common import leaf_order
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.optimizers import ControlState
    shapes = param_shapes(FULL)
    shapes = [shapes[n][0] for n in leaf_order(shapes)]
    gen = torch.Generator(device="cuda").manual_seed(3)

    def leaves():
        return [torch.randn(sh, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for sh in shapes]
    g, r, nr, a = leaves(), leaves(), leaves(), leaves()
    comp = CompressionConfig(name="gspar", rho=RHO, error_feedback=True,
                             adaptive=True, skip_tau=0.7, min_leaf_size=1024)
    ctl = ControlState(last_sent=leaves(), last_avg=a,
                       bound=[torch.zeros((), device="cuda")
                              for _ in shapes], step=1)
    out = {}
    send, flags, bounds = sync._delta_and_skips(comp, g, ctl)
    out["pre_pass_ms"] = cuda_ms(lambda: sync._delta_and_skips(comp, g, ctl),
                                 3)
    out["energy_ms"] = cuda_ms(lambda: [sync._energy(t) for t in send], 3)
    flags = [torch.tensor(i % 2 == 0, device="cuda")
             for i in range(len(shapes))]
    synced = leaves()
    out["close_ms"] = cuda_ms(lambda: (
        sync._fold_skipped(send, r, nr, flags),
        sync._close_control(comp, g, r, nr, bounds, synced, ctl)), 3)
    out["bytes_per_pass"] = sum(t.numel() for t in g) * 2
    del g, r, nr, a, ctl, send, synced
    torch.cuda.empty_cache()
    print(f"adaptive passes at full width: {out}", flush=True)
    return out


def adaptive_phase() -> dict:
    out = {"passes": adaptive_pass_ms()}
    for name in ADAPTIVE_RUNS:
        torch.cuda.empty_cache()
        out[name] = adaptive_run(name)
    return out


# --- the rest of the exchange (exchange_phase) ------------------------------

EXCHANGE_ARGS = ["--arch", "gemma-2b", "--steps", "3", "--rho", str(RHO),
                 "--log-every", "1"]
COMPACT = ("compact_bins", "compact_select")   # a bf16 group's compaction
REFERENCE = ("stats", "tail_stats", "sparsify/lam", "select_stats/lam",
             "rice_pack") + COMPACT
# name -> (extra launcher arguments, the check, the kernel variants the run
# must launch)
EXCHANGE_RUNS = {
    "exchange_A": (["--wire", "gather", "--exchange", "overlap",
                    "--error-feedback"], "overlap",
                   GSPAR + ("compact_emit/lam", "rice_pack")),
    "exchange_A_fitted": (["--wire", "gather", "--exchange", "overlap",
                           "--error-feedback", "--adaptive", "--skip-tau",
                           "0.7", "--rice-fitted"], "overlap",
                          GSPAR + ("compact_emit/lam",) + ADAPTIVE_GATHER),
    "exchange_B": (["--mesh", "1x1x1", "--wire", "gather",
                    "--error-feedback"], "pods",
                   GSPAR + ("compact_emit/lam", "rice_pack") + COMPACT),
    "exchange_B_unchecked": (["--mesh", "1x1x1", "--wire", "gather",
                              "--error-feedback"], None,
                             GSPAR + ("compact_emit/lam", "rice_pack")
                             + COMPACT),
    "exchange_C": (["--mesh", "1x1x1", "--wire", "gather",
                    "--resparsify-pods", "--error-feedback"], "resparsify",
                   GSPAR + ("compact_emit/lam", "rice_pack")),
    "exchange_D": (["--wire", "packed"], "packed",
                   GSPAR + ("compact_emit/lam", "rice_pack")),
    "exchange_E": (["--backend", "reference", "--wire", "gather",
                    "--error-feedback"], "reference", REFERENCE),
    "exchange_E_agspar": (["--backend", "reference", "--wire", "gather",
                           "--error-feedback", "--compressor", "agspar"],
                          None, REFERENCE),
    # identity+qsgd4 at k_cap = d: two layers (at full depth its compact
    # idx, 4 B a coordinate, and the codec's uniforms would not fit beside
    # the model)
    "exchange_E_qsgd": (["--backend", "reference", "--wire", "gather",
                         "--compressor", "qsgd", "--num-periods", "2"],
                        None, ("stats", "sparsify/one+qsgd4") + COMPACT),
}


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside the block (a check's or a timing's own) do
    not count as the path's: the counts are restored after it."""
    from repro_torch.kernels.sparsify import kernel as K
    counts = dict(K.LAUNCHES)
    try:
        yield
    finally:
        K.LAUNCHES.clear()
        K.LAUNCHES.update(counts)


def _same(what: str, a: list, b: list) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: leaf {i} differs")


def _live_scatter(sg, row: int) -> torch.Tensor:
    """One row of a SparseGrad decoded and scattered (float32, ``d``)."""
    from repro_torch.comm import compaction
    n = int(min(int(sg.n_valid[row]), sg.k_cap))
    return compaction.scatter(
        decoded(sg.values[row, :n], sg.scale[row], sg.codec),
        sg.idx[row, :n], sg.d)


def overlap_check(real, record: list):
    """Wrap ``sync._overlapped_sync``: run the sync exchange
    (``_bucketed_sync``) on the same items after it and hold the synced
    leaves and the wire bytes bit-equal; count the buckets (one int32 word
    stream each, ``sync._issue_gather``)."""
    from repro_torch.comm import sync

    def checked(items, leaves, group, cfg):
        streams: list = []
        issue = sync._issue_gather

        def counted(x, grp):
            streams.append(x.dtype)
            return issue(x, grp)
        sync._issue_gather = counted
        try:
            out, wire, ovf = real(items, leaves, group, cfg)
        finally:
            sync._issue_gather = issue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with uncounted():
            ref_out, ref_wire, ref_ovf = sync._bucketed_sync(items, leaves,
                                                             group, cfg)
        _same("overlap != sync", out, ref_out)
        if int(wire) != int(ref_wire) or int(ovf) != int(ref_ovf):
            raise AssertionError(f"overlap charged {int(wire)} B, sync "
                                 f"{int(ref_wire)} B")
        del ref_out
        record.append({"buckets": sum(d == torch.int32 for d in streams),
                       "streams": len(streams), "wire_bytes": int(wire),
                       "check_s": time.perf_counter() - t0})
        return out, wire, ovf
    return checked


def pod_checks(record: list, groups_timed: dict):
    """Wrap ``sync._compact_items`` and ``sync._add_compaction_drops`` for
    the pod stage without re-sparsification (run B): at the first step
    each group's compaction (values, idx, nnz and the Golomb-Rice words)
    bit-equal to its plain version on the same pod-average rows, and its
    time there beside ``torch.topk``'s; every step the pod stage's bytes
    recomputed from its words on the host (values + counts + 4 x used
    words), and each leaf's drop (what the worker residual gains) equal to
    the synced leaf less the scatter of what the pod sent, recomputed."""
    from repro_torch.comm import sync
    from repro_torch.core import codecs, coding
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    real_items, real_drops = sync._compact_items, sync._add_compaction_drops

    def compact_items(cfg, leaves, stacked):
        items = real_items(cfg, leaves, stacked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = {"inter_want": 0, "nonzero_drops": 0, "max_abs_drop": 0.0}
        first = not record
        for kind, sg, members in items:
            if kind != "sparse":         # tiny leaves: float32 (none here)
                rec["inter_want"] += sg.numel() * 4
                continue
            n_live = torch.clamp_max(sg.nnz.long(), sg.k_cap).tolist()
            rec["inter_want"] += (sg.rows * (sg.k_cap * sg.values
                                             .element_size() + 4)
                                  + 4 * rice_words_host(sg, n_live))
            if not first:
                continue
            stack = torch.cat([leaves[i].reshape(rows, sg.d)
                               for i, rows in members])
            t, budget = ref.topk_threshold_ref(stack, sg.k_cap,
                                               K.TOPK_BITS[stack.dtype])
            st = ref.select_stats_ref(stack, None, t, sg.k_cap, K.TILE,
                                      pkind="topk", budget=budget)
            vals, idx, _ = ref.compact_emit_ref(
                stack, None, t, sg.k_cap, codecs.FloatCodec(), False,
                pkind="topk", budget=budget)
            words, used = ref.rice_pack_ref(
                idx, st.nnz, sg.d, coding.rice_parameter(sg.k_cap, sg.d))
            for what, a, b in (("values", sg.values, vals), ("idx", sg.idx,
                                                              idx),
                               ("nnz", sg.nnz, st.nonzeros),
                               ("words", sg.rice_words, words),
                               ("used", sg.rice_used, used)):
                if not torch.equal(a, b):
                    raise AssertionError(f"pod compaction [{sg.rows}, "
                                         f"{sg.d}] {what} != plain")
            del vals, idx, words, used, st
            key = (sg.rows, sg.d, sg.k_cap)
            with uncounted():
                groups_timed[key] = {
                    "ms": cuda_ms(lambda: ops.magnitude_compact(
                        stack, k_cap=sg.k_cap), 3),
                    "three_kernels_ms": cuda_ms(lambda: three_kernels(
                        stack, sg.k_cap), 3),
                    "library_ms": cuda_ms(lambda: topk_library_k(
                        stack, sg.k_cap), 3)}
            del stack
        rec["check_s"] = time.perf_counter() - t0
        record.append(rec)
        return items

    def drops(items, leaves, residual):
        t0 = time.perf_counter()
        for item in items:
            kind, sg, members = item
            if kind != "sparse":
                continue
            tmp = [None] * len(leaves)
            for i, _ in members:
                tmp[i] = torch.zeros_like(residual[i])
            real_drops([item], leaves, tmp)
            r0 = 0
            for i, rows in members:
                lv = leaves[i].reshape(rows, sg.d)
                got = tmp[i].reshape(rows, sg.d)
                for rr in range(rows):
                    want = (lv[rr].float() - _live_scatter(sg, r0 + rr)).to(
                        got.dtype)
                    if not torch.equal(got[rr], want):
                        raise AssertionError(f"leaf {i} row {rr}: drop != "
                                             "synced - scatter(sent)")
                    record[-1]["nonzero_drops"] += int((want != 0).sum())
                    record[-1]["max_abs_drop"] = max(
                        record[-1]["max_abs_drop"],
                        float(want.float().abs().max()))
                residual[i].add_(tmp[i])
                r0 += rows
            del tmp
        record[-1]["check_s"] += time.perf_counter() - t0
    return compact_items, drops, real_items, real_drops


def topk_library_k(g: torch.Tensor, k: int):
    """``compaction.compact``'s selection from ``torch.topk(|g|, k)`` (the
    library yardstick, used nowhere in the port), in row batches of at
    most TOPK_UNITS coordinates: values and indices, unsorted."""
    rows, d = g.shape
    step = max(1, TOPK_UNITS // d)
    out = []
    for a in range(0, rows, step):
        out.append(torch.topk(g[a:a + step].abs(), k,
                              sorted=False).indices)
    return out


def reference_check(real, record: list):
    """Wrap ``ReferenceBackend.compress_sparse_ef`` (run E): each group's
    buffers scattered, and the residual, bit-equal to the dense wire's Q
    and residual (``dense_group`` with EF: kernel 6) on the same target
    and uniforms: at one worker the gather wire's synced leaves are the
    dense wire's."""
    from repro_torch.core.sparse import dense_group

    def checked(self, cfg, u, g, k_cap, u_cod=None):
        sg, res = real(self, cfg, u, g, k_cap, u_cod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with uncounted():
            r = dense_group(cfg.scheme(), u, g, True, u_cod=u_cod)
        if not torch.equal(res, r.residual):
            raise AssertionError("reference residual != the dense wire's")
        for row in range(sg.rows):
            if not torch.equal(_live_scatter(sg, row).to(r.q.dtype),
                               r.q[row]):
                raise AssertionError(f"row {row}: reference buffers != the "
                                     "dense wire's Q")
        del r
        record.append(time.perf_counter() - t0)
        return sg, res
    return checked


def packed_check(real, record: list):
    """Wrap ``train.step.sync_tree`` (run D, no EF): after each packed
    exchange, the gather wire with ``gspar+bf16`` on a copy of the same
    gradients and the same generator state: synced leaves and wire bytes
    bit-equal."""
    from repro_torch.core.api import CompressionConfig

    def checked(comp, generator, grads, **kw):
        state = generator.get_state()
        copy = [g.clone() for g in grads]
        out = real(comp, generator, grads, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        after = generator.get_state()
        generator.set_state(state)
        gather = CompressionConfig(name="gspar+bf16", rho=comp.rho,
                                   wire="gather",
                                   min_leaf_size=comp.min_leaf_size)
        with uncounted():
            want = real(gather, generator, copy, **kw)
        generator.set_state(after)
        _same("packed != gather gspar+bf16", out[0], want[0])
        if float(out[-1].wire_bytes) != float(want[-1].wire_bytes):
            raise AssertionError("packed and gather+bf16 bytes differ")
        del copy, want
        record.append(time.perf_counter() - t0)
        return out
    return checked


def exchange_run(name: str, groups_timed: dict) -> dict:
    """One launcher run of ``EXCHANGE_RUNS[name]`` (three steps, gemma-2b,
    the kernel counts set to 0 just before it and read just after), with
    its check."""
    from repro_torch.comm import sync
    from repro_torch.core import sparse
    from repro_torch.kernels.sparsify import kernel as K
    from repro_torch.launch import train
    from repro_torch.train import step as step_lib
    extra, check, variants = EXCHANGE_RUNS[name]
    record: list = []
    pod: dict = {}
    saved = (sync._overlapped_sync, sync._compact_items,
             sync._add_compaction_drops, step_lib.sync_tree,
             sparse.ReferenceBackend.compress_sparse_ef)
    if check == "overlap":
        sync._overlapped_sync = overlap_check(saved[0], record)
    elif check == "pods":
        sync._compact_items, sync._add_compaction_drops, *_ = pod_checks(
            record, groups_timed)
    elif check in ("resparsify", "packed"):
        def captured(comp, generator, grads, feedback=None, **kw):
            out = (packed_check(saved[3], record) if check == "packed"
                   else saved[3])(comp, generator, grads, feedback=feedback,
                                  **kw)
            if check == "resparsify":
                pr = out[1].pod_residual
                record.append({"pod_residual_nonzero": sum(
                    int((t != 0).sum()) for t in pr), "finite": all(
                        bool(torch.isfinite(t).all()) for t in pr)})
            return out
        step_lib.sync_tree = captured
    elif check == "reference":
        sparse.ReferenceBackend.compress_sparse_ef = reference_check(
            saved[4], record)
    K.reset_launches()
    try:
        summary = train.main(EXCHANGE_ARGS + extra)
    finally:
        (sync._overlapped_sync, sync._compact_items,
         sync._add_compaction_drops, step_lib.sync_tree,
         sparse.ReferenceBackend.compress_sparse_ef) = saved
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    for v in variants:
        if launches.get(v, 0) <= 0:
            raise AssertionError(f"kernel {v} never launched on {name}")
    # the reference backend forms its residual from the buffers: kernel 6
    # (the dense wire's EF emit) is on none of its paths
    if "reference" in extra and any(k.startswith("sparsify_ef")
                                    for k in launches):
        raise AssertionError(f"{name} launched kernel 6: {launches}")
    ms = summary["metrics"]
    for step, m in enumerate(ms):
        if not math.isfinite(m["loss"]):
            raise AssertionError(f"{name} step {step}: loss {m['loss']}")
        if m["wire_bytes"] != m["wire_bytes_intra"] + m["wire_bytes_inter"]:
            raise AssertionError(f"{name} step {step}: {m}")
        if check in ("pods", "resparsify") and m["wire_bytes_inter"] <= 0:
            raise AssertionError(f"{name} step {step}: no pod stage")
    n_groups = len(main_path_groups())
    if check == "pods" and any(launches.get(k) != len(ms) * n_groups
                               for k in COMPACT):
        raise AssertionError(f"{name}: {launches}")
    if check == "pods":
        for step, (m, rec) in enumerate(zip(ms, record)):
            if m["wire_bytes_inter"] != rec["inter_want"]:
                raise AssertionError(
                    f"{name} step {step}: wire_bytes_inter "
                    f"{m['wire_bytes_inter']} != {rec['inter_want']} from "
                    "the words")
            # one worker: the pod average holds at most k_cap nonzeros a
            # row, so the compaction keeps them all and ships the worker's
            # own words
            if m["wire_bytes_inter"] != m["wire_bytes_intra"] or m[
                    "overflow"] != 0 or rec["nonzero_drops"]:
                raise AssertionError(f"{name} step {step}: intra "
                                     f"{m['wire_bytes_intra']}, inter "
                                     f"{m['wire_bytes_inter']}, {rec}")
    if check == "resparsify":
        if launches["stats_l1max"] != 2 * n_groups * len(ms) or not all(
                r["finite"] and r["pod_residual_nonzero"] for r in record):
            raise AssertionError(f"{name}: {launches}, {record}")
    if check and len(record) < len(ms):
        raise AssertionError(f"{name}: a step went unchecked")
    steps = summary["step_seconds"]
    per = len(record) // len(steps) if record else 0
    check_s = [sum(r if isinstance(r, float) else r.get("check_s", 0.0)
                   for r in record[i * per:(i + 1) * per])
               for i in range(len(steps))]
    net = [s - c for s, c in zip(steps, check_s)]
    print(f"train {name} ({' '.join(extra)}"
          f"{f', checked: {check}' if check else ''}): steps "
          + ", ".join(f"{s:.4f} s" for s in steps)
          + (" (less the checks: " + ", ".join(f"{s:.4f} s" for s in net)
             + ")" if any(check_s) else "")
          + "; wire_bytes intra " + ", ".join(
              f"{m['wire_bytes_intra']:.0f}" for m in ms)
          + " inter " + ", ".join(f"{m['wire_bytes_inter']:.0f}" for m in ms)
          + "; overflow " + ", ".join(f"{m['overflow']:.0f}" for m in ms)
          + "; loss " + ", ".join(f"{m['loss']:.4f}" for m in ms)
          + (f"; buckets {[r['buckets'] for r in record]}"
             if check == "overlap" else "")
          + f"; max_memory_allocated {summary['max_memory_allocated']} B",
          flush=True)
    summary.update(launches=launches, checks=record, name=name,
                   net_seconds=net)
    return summary


def exchange_phase() -> dict:
    """Runs A-E of ``EXCHANGE_RUNS``: the overlapped exchange (A, and under
    the adaptive loop with the fitted wire), the pod hierarchy at
    ``--mesh 1x1x1`` without (B) and with (C) Algorithm 1's step 7, the
    packed wire (D) and the reference backend (E); returns the runs and
    the compaction's times on run B's pod-average rows."""
    groups_timed: dict = {}
    out = {}
    for name in EXCHANGE_RUNS:
        torch.cuda.empty_cache()
        out[name] = exchange_run(name, groups_timed)
    return {"runs": out, "pod_rows": groups_timed}


# --- the paper's section-5 experiments (experiments_phase) -------------------

SGD_CELLS = [(0.6, 0.25), (0.6, 1.0 / 64), (0.9, 0.25), (0.9, 1.0 / 64)]
SVRG_CELLS = [(0.6, 0.25), (0.9, 1.0 / 64)]
# kernels 1, 2, 5 and 7: the dense emit in each variant the paths run
# (gspar, unisp, qsgd and dense); pass 1 (kernel 3) is on none of them
EXPERIMENT_KERNELS = ("stats_l1max", "tail_stats", "stats", "sparsify/lam",
                      "sparsify/rho", "sparsify/one+qsgd4", "sparsify/one")
# the dense emit's variants that only the experiments run (convex run_sgd's
# unisp and qsgd, no EF): checked and timed at the convex step's group
EXPERIMENT_VARIANTS = (("sparsify/rho", "rho", "f32", False),
                       ("sparsify/one+qsgd4", "one", "qsgd4", False))
CONVEX_N, CONVEX_D, CONVEX_M, CONVEX_B = 1024, 2048, 4, 8


def _timed(fn):
    from repro_torch.kernels.sparsify import kernel as K
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: v for k, v in
                                            K.LAUNCHES.items() if v}


def rows_against_plain(chk: Check, what: str, got, want, q_card,
                       keep) -> int:
    """One compressed ``[rows, d]`` group on the card (``got``, with Q
    ``q_card``) against its plain version on the CPU (``want``): the
    selector's scalar per row within rtol 1e-6, Q bit-equal at ``keep``
    (where no uniform lies within 1e-6 of its keep probability), the bits
    bit-equal when that is everywhere. Returns the coordinates exempted."""
    if (got.lam is None) != (want.lam is None):
        raise AssertionError(f"{what}: lambda on one side only")
    if got.lam is not None:
        chk.close(f"{what} lambda", got.lam.cpu(), want.lam)
    chk.equal(f"{what} q", q_card.cpu()[keep], want.q[keep])
    if bool(keep.all()):
        chk.equal(f"{what} bits", got.bits.cpu(), want.bits)
    return int((~keep).sum())


def _keep(want, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Where gspar's uniform lies more than 1e-6 from its keep probability
    p = min(lambda |g|, 1), lambda the plain version's."""
    p = torch.clamp_max(want.lam[:, None] * g.cpu().abs(), 1.0)
    return (u.cpu() - p).abs() > 1e-6


def experiment_checks(tally: Tally) -> None:
    """The experiments' kernels at the shapes their paths give them, each
    held to its plain version before the timed runs (not counted as the
    paths' launches): ``Compressor.rows`` for gspar, unisp, qsgd and dense
    at the convex step's ``[4, 2048]`` float32 group of worker gradients
    (on the card against the CPU, ``rows_against_plain``), the dense emit's
    unisp and qsgd variants there (timed, with their bounds:
    ``EXPERIMENT_VARIANTS``), every shape group of one CNN step through
    ``compress_tree`` at both gspar densities (the card's tree against the
    plain version of each group on the same uniforms, replayed from the
    generator's seed), and pass 1 (kernel 3) at the conflict model's
    ``[256 x 32, 256]`` windows under the kernels' lambda: its survivors
    equal to its plain version's and to the Monte Carlo writes."""
    from repro_torch.core.api import CompressionConfig, _stack_group, \
        compress_tree
    from repro_torch.core.grouping import plan_tree
    from repro_torch.core.sparse import KernelBackend
    from repro_torch.data.synthetic import image_data, logreg_data, svm_data
    from repro_torch.experiments import cnn, conflicts, convex
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    chk = Check()
    exempt = 0
    gen = torch.Generator(device="cuda").manual_seed(5)
    n, d, M = CONVEX_N, CONVEX_D, CONVEX_M
    x, y, _ = logreg_data(0, n=n, d=d, c1=0.6, c2=0.25,
                           device="cuda")
    idx = torch.randint(0, n, (M, CONVEX_B), generator=gen, device="cuda")
    w = 0.01 * torch.randn(d, generator=gen, device="cuda")
    g = convex._worker_grads(w, x, y, 1.0 / n, idx)
    u = torch.rand((M, d), generator=gen, device="cuda")
    u_cod = torch.rand((M, d), generator=gen, device="cuda")
    for method in ("gspar", "unisp", "qsgd", "dense"):
        comp = convex._compressor(method, 0.05, 32)
        uu = u if comp.scheme.selector.samples else None
        uc = u_cod if comp.scheme.codec.stochastic else None
        got = comp.rows(g, uu, uc)
        want = comp.rows(g.cpu(), None if uu is None else uu.cpu(),
                         None if uc is None else uc.cpu())
        keep = (_keep(want, g, u) if method == "gspar"
                else torch.ones(g.shape, dtype=torch.bool))
        exempt += rows_against_plain(chk, f"convex {method}", got, want,
                                     got.q, keep)
    l1, mx = K.stats_l1max(g)
    dense_variant_checks(tally, g, u, l1, mx, None,
                         variants=EXPERIMENT_VARIANTS)

    xi, yi = image_data(0, n=2048, device="cuda")
    params = cnn.init_cnn(torch.Generator(device="cuda").manual_seed(0), 24)
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    idx = torch.randint(0, 2048, (M, 16), generator=gen, device="cuda")
    per_worker = [torch.autograd.grad(cnn.cnn_loss(live, xi[ix], yi[ix]),
                                      list(live.values())) for ix in idx]
    leaves = [torch.stack(t) for t in zip(*per_worker)]
    stk = [True] * len(leaves)
    groups = 0
    for rho in (0.1, 0.02):
        cfg = CompressionConfig(name="gspar", rho=rho, min_leaf_size=0)
        q, _, _ = compress_tree(cfg, torch.Generator(
            device="cuda").manual_seed(12), leaves, stacked=stk)
        replay = torch.Generator(device="cuda").manual_seed(12)
        for grp in plan_tree(cfg, leaves, stk).groups:
            if grp.kind != "sparse":
                raise AssertionError(f"cnn: a {grp.kind} group")
            stack = _stack_group(grp, leaves, None, False)
            ug = torch.rand((grp.rows, grp.d), generator=replay,
                            dtype=torch.float32, device="cuda")
            got, _ = KernelBackend().compress_dense(cfg, ug, stack, False)
            want, _ = KernelBackend().compress_dense(cfg, ug.cpu(),
                                                     stack.cpu(), False)
            q_tree = torch.cat([q[i].reshape(r, grp.d)
                                for i, r in grp.members])
            keep = _keep(want, stack, ug)
            what = f"cnn rho {rho} group {grp.rows}x{grp.d}"
            exempt += rows_against_plain(chk, what, got, want, q_tree, keep)
            chk.equal(f"{what} q vs compress_dense", q_tree[keep.cuda()],
                      got.q[keep.cuda()])
            groups += 1

    xs, ys, _ = svm_data(3, n=4096, d=256, device="cuda")
    gs = (xs[:64].T @ ys[:64]) / 64.0
    lam = ops.gspar_lambda(gs, rho=0.05, num_iters=4)
    trials, workers, ds = 256, 32, gs.shape[0]
    rows = trials * workers
    us = conflicts._mc_uniforms((trials, workers, ds), 0, "cuda").reshape(
        rows, ds)
    gg = gs.reshape(1, ds).expand(rows, ds).contiguous()
    s1 = lam.reshape(1).expand(rows).contiguous()
    st = K.select_stats(gg, us, s1, ds, pkind="lam")
    rst = ref.select_stats_ref(gg, us, s1, ds, K.TILE, pkind="lam")
    chk.equal("conflicts select_stats nnz", st.nnz, rst.nnz)
    p_ker = torch.where(gs.abs() > 0, torch.clamp_max(lam * gs.abs(), 1.0),
                        0.0)
    writes = conflicts.conflict_stats(p_ker, workers, trials)["writes"]
    if float(st.nnz.sum()) / trials != writes:
        raise AssertionError(f"conflicts: pass 1 keeps {st.nnz.sum()} over "
                             f"{trials} windows, Monte Carlo {writes}")
    print(f"experiment checks: convex gspar/unisp/qsgd/dense rows at "
          f"[{M}, {d}] f32, {groups} CNN groups, pass 1 at [{rows}, {ds}] "
          f"equal to their plain versions ({exempt} coordinates within "
          f"1e-6 of p exempt; lambda max rel err {chk.max_rel:.3g})",
          flush=True)


def experiments_phase(tally: Tally) -> dict:
    """The paper's three experiments on the card at the sizes of
    ``benchmarks/bench_convex.py``, ``bench_cnn.py`` and
    ``bench_conflicts.py`` without ``--quick``, through the port's entry
    points (``repro_torch.experiments``), after their kernels are held to
    their plain versions at the paths' shapes (``experiment_checks``), each
    run's launch counts set to 0 just before it and read just after. Fails
    unless var(gspar) < var(unisp) in every SGD cell, gspar's
    suboptimality falls from its first record to its last, every loss is
    finite, the analytic conflict counts equal the committed
    ``results/experiments/conflicts.json`` rows (rtol 1e-5), the Monte
    Carlo counts lie within 6 standard errors of them, the backend check's
    p_maxdiff is at most 1e-6, and kernels 1, 2, 5 and 7 each launched on
    these paths, the dense emit in every variant they run
    (``EXPERIMENT_KERNELS``)."""
    experiment_checks(tally)
    from repro_torch.data.synthetic import logreg_data, svm_data
    from repro_torch.experiments import cnn, conflicts, convex
    from repro_torch.core import sparsify
    runs, totals = [], {}
    t_phase = time.perf_counter()

    def record(kind, key, seconds, launches, **vals):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        runs.append({"kind": kind, "run": key, "seconds": seconds,
                     "launches": launches, **vals})
        print(f"experiment {kind} {key}: " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in vals.items()) + f"; {seconds:.3f} s; launches "
            + json.dumps(launches), flush=True)

    n, d = CONVEX_N, CONVEX_D
    for c1, c2 in SGD_CELLS:
        x, y, _ = logreg_data(0, n=n, d=d, c1=c1, c2=c2)
        (_, f_star), s, _ = _timed(lambda: convex.solve_reference(x, y,
                                                                  1.0 / n))
        cell = f"sgd_c1{c1}_c2{c2:.4f}"
        var = {}
        methods = ("dense", "gspar", "unisp") + (
            ("qsgd",) if (c1, c2) == SGD_CELLS[0] else ())
        for method in methods:
            r, s, launches = _timed(lambda: convex.run_sgd(
                x, y, 1.0 / n, method=method, rho=0.05, epochs=30,
                f_star=f_star))
            if not np.all(np.isfinite(r.subopt)):
                raise AssertionError(f"{cell} {method}: subopt {r.subopt}")
            var[method] = r.var_ratio
            if method == "gspar" and not r.subopt[-1] < r.subopt[0]:
                raise AssertionError(f"{cell} gspar: subopt {r.subopt[0]} "
                                     f"-> {r.subopt[-1]}")
            record("sgd", f"{cell}/{method}", s, launches,
                   subopt=float(r.subopt[-1]), var=r.var_ratio,
                   bits=float(r.bits[-1]), density=r.density,
                   f_star=f_star)
        if not var["gspar"] < var["unisp"]:
            raise AssertionError(f"{cell}: var gspar {var['gspar']} >= "
                                 f"unisp {var['unisp']}")
    for c1, c2 in SVRG_CELLS:
        x, y, _ = logreg_data(1, n=n, d=d, c1=c1, c2=c2)
        f_star = convex.solve_reference(x, y, 1.0 / n)[1]
        cell = f"svrg_c1{c1}_c2{c2:.4f}"
        for method in ("dense", "gspar", "unisp"):
            r, s, launches = _timed(lambda: convex.run_svrg(
                x, y, 1.0 / n, method=method, rho=0.2, outer=10,
                f_star=f_star))
            if not np.all(np.isfinite(r.subopt)) or (
                    method == "gspar" and not r.subopt[-1] < r.subopt[0]):
                raise AssertionError(f"{cell} {method}: subopt {r.subopt}")
            record("svrg", f"{cell}/{method}", s, launches,
                   subopt=float(r.subopt[-1]), var=r.var_ratio,
                   bits=float(r.bits[-1]), density=r.density)
    for method, rho in (("dense", 1.0), ("gspar", 0.1), ("gspar", 0.02)):
        (losses, bits, dens), s, launches = _timed(lambda: cnn.run_cnn(
            method=method, rho=rho, channels=24, steps=200))
        if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"cnn {method} {rho}: losses {losses}")
        record("cnn", f"ch24_{method}_rho{rho}", s, launches,
               loss=float(losses[-1]), loss_first=float(losses[0]),
               bits=float(bits[-1]), density=dens)
    # the conflict model on the benchmark's representative SVM gradient
    with open(Path(__file__).resolve().parent / "results" / "experiments"
              / "conflicts.json") as f:
        committed = json.load(f)
    x, y, _ = svm_data(3, n=4096, d=256)
    g = (x[:64].T @ y[:64]) / 64.0
    for rho in (0.05, 0.2):
        p = sparsify.greedy_probabilities(g, rho, num_iters=4)
        for workers in (16, 32):
            st, s, launches = _timed(lambda: conflicts.conflict_stats(
                p, workers))
            want = committed[f"conflicts_rho{rho}_w{workers}"]["gspar"]
            for key in ("writes_analytic", "conflicted_analytic"):
                if not math.isclose(st[key], want[key], rel_tol=1e-5):
                    raise AssertionError(f"conflicts rho {rho} w {workers} "
                                         f"{key}: {st[key]} != {want[key]}")
            for mc, an, se in (("writes", "writes_analytic", "writes_se"),
                               ("conflicted_mc", "conflicted_analytic",
                                "conflicted_se")):
                if abs(st[mc] - st[an]) > 6 * st[se]:
                    raise AssertionError(f"conflicts rho {rho} w {workers}: "
                                         f"{mc} {st[mc]} vs {st[an]}")
            record("conflicts", f"rho{rho}_w{workers}", s, launches,
                   **{k: float(v) for k, v in st.items()})
    bp, s, launches = _timed(lambda: conflicts.backend_parity(g, 0.05, 32))
    if bp["p_maxdiff"] > 1e-6:
        raise AssertionError(f"backend parity: {bp}")
    record("conflicts", "backend_parity", s, launches,
           p_maxdiff=bp["p_maxdiff"], conflicted_reference=bp["reference"]["conflicted_mc"],
           conflicted_kernel=bp["kernel"]["conflicted_mc"])
    for workers in (16, 32):
        for method, rho in (("dense", 1.0), ("gspar", 0.1)):
            (t_axis, losses, rate), s, launches = _timed(
                lambda: conflicts.run_async_svm(method=method, rho=rho,
                                                workers=workers, steps=400))
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"svm {method}: losses {losses}")
            record("svm", f"w{workers}_{method}", s, launches,
                   loss=float(losses[-1]), sim_time=float(t_axis[-1]),
                   conflict_rate=rate)
    for kern in EXPERIMENT_KERNELS:
        if totals.get(kern, 0) <= 0:
            raise AssertionError(f"experiments: kernel {kern} never launched")
    seconds = time.perf_counter() - t_phase
    print(f"experiments: {len(runs)} runs in {seconds:.1f} s; launches "
          + json.dumps(totals), flush=True)
    return {"runs": runs, "launches": totals, "seconds": seconds}


# the kernels line: variant -> (the run whose launches it reports, the
# TPU kernel's line in src/repro/kernels/sparsify/kernel.py, or the file
# and line of the XLA selection it replaces)
# --- the dense-attention architectures and checkpoints (arch_phase) ----------

# arch -> the periods it is cut to on one 80 GB card (widths as published),
# and whether its exchange is held to its exact bytes and gradient
ARCH_RUNS = {"gemma2-9b": (4, True), "gemma2-27b": (1, False),
             "starcoder2-7b": (10, False)}
ARCH_ARGS = ["--steps", "3", "--rho", str(RHO), "--wire", "gather",
             "--error-feedback", "--batch", "8", "--seq", "128", "--lr",
             "3e-4", "--log-every", "1"]
ARCH_KERNELS = GSPAR + ("compact_emit/lam", "rice_pack")
WINDOW_SEQ = 4_608         # gemma2-9b's 4,096 window bites on 512 queries
WINDOW_RTOL = 2e-2         # bf16 q, k, v and probabilities vs float64


def arch_plan(arch: str, periods: int):
    """The launcher's plan of ``arch`` cut to ``periods`` (meta tensors)
    and the ``MainPath`` of its gspar ``auto`` exchange: bf16 values at
    every slot, a count a row, the static RICE words as its bound."""
    import dataclasses as dc
    from repro_torch.comm import wire_layout
    from repro_torch.configs import registry
    from repro_torch.core import coding
    from repro_torch.core.api import CompressionConfig
    from repro_torch.core.grouping import plan_tree
    from repro_torch.models.common import leaf_order
    from repro_torch.models.transformer import param_shapes
    cfg = dc.replace(registry.get(arch).model, num_periods=periods)
    shapes = param_shapes(cfg)
    names = leaf_order(shapes)
    comp = CompressionConfig(name="gspar", rho=RHO, error_feedback=True,
                             wire="gather", min_leaf_size=1024)
    plan = plan_tree(comp, [torch.empty(shapes[n][0], dtype=cfg.dtype,
                                        device="meta") for n in names],
                     [shapes[n][1] for n in names])
    layouts = {wire_layout.choose(g.k_cap, g.d, 16.0) for g in plan.groups}
    rows = sum(g.rows for g in plan.groups)
    path = MainPath("gspar", layouts.pop() if len(layouts) == 1 else None,
                    2 * sum(g.rows * g.k_cap for g in plan.groups), 0,
                    ARCH_KERNELS, row_bytes=4 * rows,
                    rice_cap_bytes=4 * sum(
                        g.rows * coding.rice_wire_words(g.k_cap, g.d)
                        for g in plan.groups))
    return cfg, plan, path


def arch_run(arch: str) -> dict:
    """The launcher on ``arch`` at full width cut to its periods, gspar on
    the gather wire's ``auto`` with EF, three steps, the kernel counts set
    to 0 just before it and read just after; gemma2-9b's exchange held to
    its exact bytes and gradient (``exchange_check`` on the card)."""
    from repro_torch.comm import sync
    from repro_torch.kernels.sparsify import kernel as K
    from repro_torch.launch import train
    from repro_torch.models.transformer import param_shapes
    periods, checked = ARCH_RUNS[arch]
    cfg, plan, path = arch_plan(arch, periods)
    record: list = []
    real = sync._bucketed_sync
    if checked:
        if path.layout != "rice":
            raise AssertionError(f"{arch}: plan layouts not all rice")
        sync._bucketed_sync = exchange_check(real, record, path, False)
    K.reset_launches()
    try:
        summary = train.main(["--arch", arch, "--num-periods", str(periods)]
                             + ARCH_ARGS)
    finally:
        sync._bucketed_sync = real
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    ms = summary["metrics"]
    n_groups = len(plan.groups)
    n_rice = sum(lay == "rice" for *_, lay in summary["layouts"])
    for v in ARCH_KERNELS:
        want = len(ms) * (n_rice if v == "rice_pack" else n_groups)
        got = launches.get(v, 0)
        if not (got == want or (v == "tail_stats" and want <= got
                                <= 2 * want)):
            raise AssertionError(f"{arch}: kernel {v} launched {got} "
                                 f"times, want {want} ({n_groups} groups, "
                                 f"{n_rice} rice, {len(ms)} steps)")
    for step, m in enumerate(ms):
        if not math.isfinite(m["loss"]) or m["overflow"] != 0:
            raise AssertionError(f"{arch} step {step}: {m}")
        if not 0.0 < m["density"] <= 1.25 * RHO:
            raise AssertionError(f"{arch} step {step}: density "
                                 f"{m['density']}")
        if record and m["wire_bytes"] != record[step]["wire_bytes"]:
            raise AssertionError(f"{arch} step {step}: wire_bytes "
                                 f"{m['wire_bytes']} != {record[step]}")
        # under a quarter of the dense wire's bf16 gradient
        if not 0 < m["wire_bytes"] < 2 * summary["params"] / 4:
            raise AssertionError(f"{arch} step {step}: wire_bytes "
                                 f"{m['wire_bytes']}")
    if checked and len(record) != len(ms):
        raise AssertionError(f"{arch}: an exchange went unchecked")
    if summary["params"] != sum(math.prod(s)
                                for s, _ in param_shapes(cfg).values()):
        raise AssertionError(f"{arch}: {summary['params']} parameters")
    steps = summary["step_seconds"]
    net = [s - (record[i]["check_s"] if record else 0.0)
           for i, s in enumerate(steps)]
    layouts = sorted({lay for *_, lay in summary["layouts"]})
    print(f"train {arch} --num-periods {periods} ({summary['params']} "
          f"parameters, {n_groups} groups, layouts {layouts}"
          f"{', checked on the card' if checked else ''}): steps "
          + ", ".join(f"{s:.4f} s" for s in steps)
          + (" (less the checks: " + ", ".join(f"{s:.4f} s" for s in net)
             + ")" if record else "")
          + "; wire_bytes " + ", ".join(f"{m['wire_bytes']:.0f}" for m in ms)
          + "; density " + ", ".join(f"{m['density']:.6f}" for m in ms)
          + "; loss " + ", ".join(f"{m['loss']:.4f}" for m in ms)
          + f"; launches {launches}"
          + f"; max_memory_allocated {summary['max_memory_allocated']} B",
          flush=True)
    summary.update(launches=launches, checks=record, name=arch,
                   net_seconds=net, layout_names=layouts)
    return summary


def _window_reference(p: dict, acfg, x: torch.Tensor,
                      window: int | None) -> torch.Tensor:
    """The attention of ``p`` on ``x`` as the plain masked expression in
    float64 (query scale, RoPE, GQA, the softcap, the causal and window
    mask, softmax), from the same bf16 weights."""
    d64 = {k: v.double() for k, v in p.items()}
    x = x.double()
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, d64["wq"]) * acfg.scale
    k = torch.einsum("bsd,dhk->bshk", x, d64["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, d64["wv"])
    half = acfg.head_dim // 2
    freq = acfg.rope_theta ** (-torch.arange(half, dtype=torch.float64,
                                             device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * freq
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]

    def rope(t):
        a, b = t[..., :half], t[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    q, k = rope(q), rope(k)
    g = acfg.num_heads // acfg.num_kv_heads
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    sc = torch.einsum("bshd,bthd->bhst", q, k)
    sc = torch.tanh(sc / acfg.logit_softcap) * acfg.logit_softcap
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(s, device=x.device)[None, :]
    keep = j <= i
    if window is not None:
        keep &= (i - j) < window
    sc = sc.masked_fill(~keep, -math.inf)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), v)
    return torch.einsum("bshk,hkd->bsd", out, d64["wo"])


def window_check() -> dict:
    """One ``attn_sw`` block of gemma2-9b at full width (its bf16 weights
    at the JAX package's init) on a 4,608-token sequence, so that the
    config's 4,096 window bites on the last 512 queries: the port's
    attention against the plain masked expression in float64 on the card,
    within ``WINDOW_RTOL`` (relative Frobenius error, per query block);
    the windowless float64 expression must differ on the last 512
    queries by far more."""
    from repro_torch.configs import gemma2_9b
    from repro_torch.models import attention as attn
    from repro_torch.models.common import Initializer
    cfg = gemma2_9b.FULL
    acfg = cfg.attn_cfg("attn_sw")
    if acfg.window != 4096 or WINDOW_SEQ - acfg.window != 512:
        raise AssertionError(f"window {acfg.window}")
    ini = Initializer(torch.Generator(device="cuda").manual_seed(7),
                      torch.bfloat16, torch.device("cuda"))
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": ini.fan_in((d, h, hd)), "wk": ini.fan_in((d, kv, hd)),
         "wv": ini.fan_in((d, kv, hd)), "wo": ini.fan_in((h, hd, d), 1)}
    x = ini.normal((1, WINDOW_SEQ, d), stddev=1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        got = attn.attention_train(p, acfg, x).double()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        want = _window_reference(p, acfg, x, acfg.window)
        full = _window_reference(p, acfg, x, None)

    def rel(a, b, sl):
        return float((a[:, sl] - b[:, sl]).norm() / b[:, sl].norm())

    head, tail = slice(0, acfg.window), slice(acfg.window, WINDOW_SEQ)
    out = {"seq": WINDOW_SEQ, "window": acfg.window, "ms": ms,
           "rel_err_first_4096": rel(got, want, head),
           "rel_err_last_512": rel(got, want, tail),
           "windowless_rel_diff_last_512": rel(full, want, tail),
           "max_abs_err": float((got - want).abs().max())}
    if not (out["rel_err_first_4096"] <= WINDOW_RTOL
            and out["rel_err_last_512"] <= WINDOW_RTOL
            and out["windowless_rel_diff_last_512"] > 10 * WINDOW_RTOL):
        raise AssertionError(f"window check: {out}")
    print(f"window check (gemma2-9b attn_sw, {WINDOW_SEQ} tokens, window "
          f"{acfg.window}): {out}", flush=True)
    return out


def _ckpt_train(model, state, fb, step, steps, cfg):
    """Steps ``steps`` of ``step``, step t's batch and uniforms from
    generators on the card seeded with t."""
    from repro_torch.data.synthetic import token_batch
    for t in steps:
        batch = token_batch(torch.Generator(device="cuda").manual_seed(
            100 + t), cfg.vocab, 8, 128)
        state, fb, _ = step(state, fb, batch, torch.Generator(
            device="cuda").manual_seed(200 + t))
    return state, fb


def checkpoint_check(tmp: Path) -> dict:
    """Each smoke config in bf16 on the card, gspar on the gather wire's
    ``auto`` with EF and Adam: three steps against one step, ``save``,
    ``restore`` into fresh state (another seed's parameters, zero moments
    and residual) and two more; step 3's parameters, moments and residual
    must be bit-equal."""
    import dataclasses as dc
    from repro_torch.checkpoint import checkpoint
    from repro_torch.configs import registry
    from repro_torch.core.api import CompressionConfig
    from repro_torch.launch.train import init_process_group
    from repro_torch.models.transformer import Transformer, init_model
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as step_lib
    comp = CompressionConfig(name="gspar", rho=RHO, wire="gather",
                             error_feedback=True, min_leaf_size=1024)
    own = init_process_group(torch.device("cuda"))
    out = {}
    try:
        for arch in ARCH_RUNS:
            cfg = dc.replace(registry.get(arch).smoke, dtype=torch.bfloat16)

            def fresh(seed):
                model = Transformer(cfg, init_model(cfg, torch.Generator(
                    device="cuda").manual_seed(seed), "cuda"))
                opt = topt.adam(3e-4)
                return (model, opt.init(model.leaves()),
                        topt.init_feedback(model.leaves()),
                        step_lib.make_compressed_train_step(model, comp,
                                                            opt))

            model, state, fb, step = fresh(1)
            state, fb = _ckpt_train(model, state, fb, step, range(3), cfg)
            want = [t.detach().clone() for t in model.leaves()
                    + state["m"] + state["v"] + fb.residual]
            model, state, fb, step = fresh(1)
            state, fb = _ckpt_train(model, state, fb, step, range(1), cfg)
            path = str(tmp / f"{arch}.npz")
            checkpoint.save(path, model, state, fb, extra={"arch": arch})
            size = Path(path).stat().st_size
            model, state, fb, step = fresh(2)
            state, fb, _ = checkpoint.restore(path, model, state, fb)
            if state["step"] != 1:
                raise AssertionError(f"{arch}: restored step "
                                     f"{state['step']}")
            state, fb = _ckpt_train(model, state, fb, step, range(1, 3), cfg)
            got = (list(model.leaves()) + state["m"] + state["v"]
                   + fb.residual)
            _same(f"{arch} resumed at step 1", [t.detach() for t in got],
                  want)
            out[arch] = {"bytes": size, "leaves": len(want)}
    finally:
        if own:
            torch.distributed.destroy_process_group()
    print(f"checkpoint check (smoke configs, bf16, resumed at step 1, "
          f"bit-equal at step 3): {out}", flush=True)
    return out


def arch_phase(tmp: Path) -> dict:
    """The dense-attention architectures: ``window_check``, the
    checkpoint round trip (``checkpoint_check``), then ``arch_run`` for
    each of ``ARCH_RUNS``."""
    from repro_torch.kernels.sparsify import kernel as K
    with uncounted():
        window = window_check()
        torch.cuda.empty_cache()
        ckpt = checkpoint_check(tmp)
    runs = {}
    for arch in ARCH_RUNS:
        torch.cuda.empty_cache()
        runs[arch] = arch_run(arch)
    K.reset_launches()
    return {"runs": runs, "window": window, "checkpoint": ckpt}


ENTRIES = {
    "topk_threshold": ("topk+ternary",
                       "src/repro/kernels/sparsify/ops.py:268"),
    "stats_l1max": ("gspar", 275), "tail_stats": ("gspar", 195),
    "select_stats/lam": ("gspar", 384), "compact_emit/lam": ("gspar", 559),
    "rice_pack": ("gspar", 612),
    "select_stats/rho": ("unisp", 384), "compact_emit/rho": ("unisp", 559),
    "select_stats/topk": ("topk+ternary", 384),
    "compact_emit/topk+ternary": ("topk+ternary", 559),
    "compact_emit/lam+qsgd8": ("gspar+qsgd8", 559),
    "select_stats/bern": ("terngrad", 384),
    "compact_emit/bern+ternary": ("terngrad", 559),
    "compact_emit/topk": ("topk", 559), "compact_emit/bern": ("bernoulli",
                                                              559),
    "stats": ("gspar_dense", 239), "sparsify": ("gspar_dense_noef", 96),
    "sparsify_ef": ("gspar_dense", 123), "sparsify_prng": ("prng", 157),
    "sparsify_ef/rho": ("unisp_dense", 123),
    "sparsify_ef/topk": ("topk_dense", 123),
    "sparsify_ef/bern+ternary": ("terngrad_dense", 123),
    "sparsify_ef/lam+qsgd8": ("gspar+qsgd8_dense", 123),
    "sparsify_ef/one+qsgd4": ("qsgd_dense", 123),
    "sparsify/one": ("none_dense", 96),
    "select_stats/lam+rounded": ("gspar+qsgd8_dense", 384),
    "select_stats/bern+rounded": ("terngrad_dense", 384),
    "sparsify/rho": ("experiments", 96),
    "sparsify/one+qsgd4": ("experiments", 96),
    "topk_threshold/hist": ("closed_dense",
                            "src/repro/core/sparsify.py:40"),
    "rice_fit": ("adaptive_A", "src/repro/comm/compaction.py:300"),
    "rice_pack/fitted": ("adaptive_A", "src/repro/comm/compaction.py:265"),
    "compaction.compact": ("exchange_B", "src/repro/comm/compaction.py:64"),
    "compact_bins": ("exchange_B", "src/repro/comm/compaction.py:64"),
    "compact_select": ("exchange_B", "src/repro/comm/compaction.py:64"),
    "closed_lambda": ("closed_dense", "src/repro/core/sparsify.py:40"),
}
# what each run of the dense wire and kernel 8 drives
DENSE_PATHS = {
    name: (f"{c} --wire dense" + (" --error-feedback" if ef else "")
           if name != "closed_dense" else
           f"gspar algo=closed eps={CLOSED_EPS:g} wire=dense ef "
           "(make_compressed_train_step)")
    for name, (c, ef, _) in DENSE_RUNS.items()}
DENSE_PATHS.update({
    "gspar_dense_noef": "gspar (the launcher's default --wire dense)",
    "prng": "ops.gspar_sparsify_prng on every gemma-2b row as a leaf",
    "experiments": "the section-5 experiments (convex run_sgd unisp and "
                   "qsgd: [4, 2048] float32)",
    "adaptive_A": "gspar --wire gather --error-feedback --adaptive "
                  "--skip-tau 0.7 --rice-fitted",
    "exchange_B": "gspar --mesh 1x1x1 --wire gather --error-feedback (the "
                  "pod stage's compaction)"})


def ptxas_lines(log: str, kernels) -> list[str]:
    """From nvcc's ``-Xptxas -v`` log, one line per instantiation of the
    named kernels: its (demangled) name, registers, barriers, shared
    memory, stack and spills."""
    out, name, props = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
        elif "spill" in line:
            props = line.strip()
        elif "registers" in line and name is not None:
            if any(k in name for k in kernels):
                out.append((name, line.split(":", 1)[1].strip() + "; "
                            + props))
            name, props = None, ""
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(
            n for n, _ in out), capture_output=True, text=True).stdout
        out = [(n.split("::")[-1].split("(")[0], p)
               for n, (_, p) in zip(names.splitlines(), out)]
    return [f"ptxas {n}: {p}" for n, p in out]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.sparsify import kernel as K
    t0 = time.perf_counter()
    lib, log = K.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in ptxas_lines(log, ("compact_emit", "rice_pack", "rice_fit",
                                  "select_tiles_topk", "radix_",
                                  "compact_select", "compact_finish",
                                  "closed_finish")):
        print(line)
    dense = ptxas_lines(log, ("sparsify_tiles",))
    regs = [int(x.split(" registers")[0].rsplit(" ", 1)[-1]) for x in dense]
    spills = [x for x in dense if "0 bytes spill stores" not in x]
    print(f"ptxas sparsify_tiles: {len(dense)} instantiations, "
          f"{min(regs)}-{max(regs)} registers, {len(spills)} with spills")
    for line in spills:
        print(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    groups = main_path_groups()
    kp = kernel_phase(groups)
    variant_sweep()
    dense_sweep()
    reference_phase()
    runs = {}
    for key, name, layout, check in (
            ("gspar", "gspar", "auto", "host"),
            ("gspar_unchecked", "gspar", "auto", None),
            ("gspar_coo", "gspar", "coo", None),
            ("unisp", "unisp", "auto", "card"),
            ("topk+ternary", "topk+ternary", "auto", "card"),
            ("gspar+qsgd8", "gspar+qsgd8", "auto", "card"),
            ("terngrad", "terngrad", "auto", "card"),
            ("topk", "topk", "auto", None),
            ("bernoulli", "bernoulli", "auto", None),
            ("closed", "closed", "auto", None)):
        torch.cuda.empty_cache()
        runs[key] = train_phase(name, layout, check)
    for name in DENSE_RUNS:
        torch.cuda.empty_cache()
        runs[name] = dense_train_phase(name, check=name == "gspar_dense")
    torch.cuda.empty_cache()
    var_lr = var_lr_phase()
    torch.cuda.empty_cache()
    exp = experiments_phase(kp["tally"])
    torch.cuda.empty_cache()
    adaptive = adaptive_phase()
    print(json.dumps({"adaptive_passes": adaptive.pop("passes")}))
    runs.update(adaptive)
    torch.cuda.empty_cache()
    exchange = exchange_phase()
    torch.cuda.empty_cache()
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    try:
        archs = arch_phase(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    tally = kp["tally"]
    kernels = []
    launches = {key: run["launches"] for key, run in runs.items()}
    launches["prng"] = {"sparsify_prng": kp["prng"]["launches"]}
    launches["experiments"] = exp["launches"]
    for key, run in exchange["runs"].items():
        launches[key] = run["launches"]
    # the compaction launches its two kernels once a bf16 group: its count
    # is its select pass's, in run B
    launches["exchange_B"]["compaction.compact"] = launches[
        "exchange_B"].get("compact_select", 0)
    for name, (run, line) in ENTRIES.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparsify.cu",
            "replaces": line if isinstance(line, str)
            else f"src/repro/kernels/sparsify/kernel.py:{line}",
            "path": DENSE_PATHS.get(run) or PATHS[run].compressor,
            "launches": launches[run].get(name, 0),
            "max_abs_err": tally.check[name].max_abs,
            "max_rel_err": tally.check[name].max_rel,
            "ms": tally.ms[name], "plain_ms": tally.plain_ms[name],
            "bound_ms": 1e3 * tally.bound_bytes[name] / HBM_BYTES_PER_S,
            "bound_by": "bytes",
            "library_ms": tally.library_ms.get(name),
            "launches_experiments": exp["launches"].get(name, 0),
            "launches_var_lr": sum(run["launches"].get(name, 0)
                                   for run in var_lr.values()),
            "launches_adaptive": sum(run["launches"].get(name, 0)
                                     for run in adaptive.values()),
            "launches_exchange": sum(run["launches"].get(name, 0)
                                     for run in exchange["runs"].values()),
            "launches_arch": {arch: run["launches"].get(name, 0)
                              for arch, run in archs["runs"].items()},
        })
    kernels[list(ENTRIES).index("compact_emit/lam")]["ms_no_ef"] = \
        kp["ms_no_ef"]
    kernels[list(ENTRIES).index("compact_emit/lam")]["memset_ms"] = \
        kp["memset_ms"]
    for key in ("topk_peak_bytes", "library_peak_bytes"):
        kernels[list(ENTRIES).index("topk_threshold")][key] = \
            tally.library_ms[key]
    kernels[list(ENTRIES).index("sparsify_prng")]["max_sd_from_sum_p"] = \
        kp["prng"]["z_max"]
    kernels[list(ENTRIES).index("compaction.compact")]["three_kernels_ms"] = \
        tally.library_ms["compaction_three_kernels"]
    fit = kp["fitted"]
    for name, new, old in (("rice_fit", "fit", "fit_legacy"),
                           ("rice_pack/fitted", "pack", "pack_legacy"),
                           ("rice_pack", "static", None)):
        entry = kernels[list(ENTRIES).index(name)]
        entry["device_ms"] = fit["device_ms"][new]
        if old is not None:
            entry["legacy_ms"] = fit["ms"][old]
            entry["legacy_device_ms"] = fit["device_ms"][old]
    kernels[list(ENTRIES).index("rice_pack/fitted")]["pair_ms"] = \
        fit["ms"]["pair"]
    kernels[list(ENTRIES).index("rice_pack/fitted")]["pair_device_ms"] = \
        fit["device_ms"]["pair"]
    kernels[list(ENTRIES).index("closed_lambda")]["ops_ms"] = \
        kp["closed"]["ms"]
    kernels[list(ENTRIES).index("closed_lambda")]["torch_solve_ms"] = \
        kp["closed"]["ms_torch_solve"]
    closed = kp["closed"]
    for key, run in runs.items():
        print(json.dumps({key: {
            "step_seconds": run["step_seconds"],
            "net_seconds": run["net_seconds"],
            "max_memory_allocated": run["max_memory_allocated"],
            "wire_bytes": [m["wire_bytes"] for m in run["metrics"]],
            "density": [m["density"] for m in run["metrics"]],
            "loss": [m["loss"] for m in run["metrics"]],
            "checks": run["checks"], "launches": run["launches"]}}))
    print(json.dumps({"var_lr": var_lr}))
    print(json.dumps({"fitted_kernel_phase": {
        "r_hist": kp["fitted"]["r_hist"],
        "used_words": kp["fitted"]["used_words"],
        "static_words": kp["fitted"]["static_words"],
        "ms_per_step": kp["fitted"]["ms"],
        "device_ms_per_step": kp["fitted"]["device_ms"],
        "device_ops_per_call": kp["fitted"]["device_ops"]}}))
    print(json.dumps({"experiments": exp}))
    for key, run in exchange["runs"].items():
        print(json.dumps({key: {
            "step_seconds": run["step_seconds"],
            "net_seconds": run["net_seconds"],
            "max_memory_allocated": run["max_memory_allocated"],
            "wire_bytes_intra": [m["wire_bytes_intra"]
                                 for m in run["metrics"]],
            "wire_bytes_inter": [m["wire_bytes_inter"]
                                 for m in run["metrics"]],
            "loss": [m["loss"] for m in run["metrics"]],
            "checks": run["checks"] if run["checks"] and isinstance(
                run["checks"][0], dict) else len(run["checks"]),
            "launches": run["launches"]}}))
    for arch, run in archs["runs"].items():
        print(json.dumps({arch: {
            "num_periods": ARCH_RUNS[arch][0], "params": run["params"],
            "step_seconds": run["step_seconds"],
            "net_seconds": run["net_seconds"],
            "max_memory_allocated": run["max_memory_allocated"],
            "wire_bytes": [m["wire_bytes"] for m in run["metrics"]],
            "density": [m["density"] for m in run["metrics"]],
            "loss": [m["loss"] for m in run["metrics"]],
            "layouts": run["layouts"], "checks": run["checks"],
            "launches": run["launches"]}}))
    print(json.dumps({"window_check": archs["window"],
                      "checkpoint_check": archs["checkpoint"]}))
    print(json.dumps({"compaction_on_pod_rows": {
        str(k): v for k, v in exchange["pod_rows"].items()}}))
    print(json.dumps({"decode_ms_per_step": kp["decode_ms"],
                      "closed_form_lambda_rows": dict(
                          eps=[CLOSED_EPS, CLOSED_GATHER_EPS],
                          ms_per_step_at_eps_1=closed["ms"],
                          ms_hist_then_torch_solve=closed["ms_torch_solve"],
                          peak_scratch_bytes=closed["peak_scratch_bytes"],
                          max_rel_err_vs_float64_sort=closed[
                              "max_rel_err"]),
                      "seconds": time.perf_counter() - T0}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
