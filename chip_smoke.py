"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the shapes of the
main path (gemma-2b at full width: one launch per shape group), times the
receiver's decode of each group, checks the whole emit pipeline against
the CPU path on a small input, then drives two paths through the launcher
``repro_torch.launch.train --arch gemma-2b --steps 3 --compressor gspar
--rho 0.05 --wire gather --error-feedback`` on a one-worker NCCL group, at
full width, each with the kernel launch counts set to 0 just before it:

- the main path, the launcher's default ``--wire-layout auto``: every
  group must be stamped ``rice``; each step must charge exactly the values,
  the phase-one counts and 4 bytes per realized Golomb-Rice word, recomputed
  on the host from the step's compact buffers with the port's numpy
  ``coding.rice_stream_words``, and no more than the static capacity; the
  synced gradient must be bit-equal to ``compaction.scatter`` of the same
  compact buffers (at one worker that is the whole exchange);
- the same ``auto`` run again, unchecked: its step times are the main
  path's (the checked run's steps include the checks' host work);
- ``--wire-layout coo``: the exact wire bytes of the COO gather wire.

Each checks finite losses, no overflow, the density inside the capacity
slack, and every kernel of the path launched. Prints the card's name and
power limit, one JSON line of per-kernel numbers, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or any phase fails. Imports nothing of JAX.
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
              "--rho", str(RHO), "--wire", "gather", "--error-feedback",
              "--log-every", "1"]
WIRE_BYTES = 939_814_656         # 156,635,776 COO slots x (2 B bf16 + 4 B)
RICE_VALUE_BYTES = 313_271_552   # 156,635,776 value slots x 2 B bf16
RICE_COUNT_BYTES = 656           # 164 rows x one int32 count
RICE_MAX_BYTES = 430_749_040     # values + counts + the static word capacity
CHECK_CHUNK = 1 << 24            # coordinates per chunk of the scatter check
SUM_RTOL = 1e-6                  # f64 sums rounded once to f32, both sides
REPS = 5
T0 = time.perf_counter()


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
    comp = CompressionConfig(name="gspar", rho=RHO, error_feedback=True,
                             min_leaf_size=1024)
    plan = plan_tree(comp, leaves, [shapes[n][1] for n in names])
    if any(g.kind != "sparse" for g in plan.groups):
        raise AssertionError("gemma-2b has no dense-passthrough leaf")
    return [(g.rows, g.d, g.k_cap) for g in plan.groups]


def kernel_phase(groups) -> dict:
    """Each kernel against its plain version on every main-path group, with
    the same inputs and the same per-row scalars; times per step (one launch
    per group; tail_stats per solver pass)."""
    from repro_torch.comm import compaction, sync, wire_layout
    from repro_torch.core import coding
    from repro_torch.kernels.sparsify import kernel as K, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = K.KERNELS
    chk = {n: Check() for n in names}
    ms = dict.fromkeys(names, 0.0)
    plain_ms = dict.fromkeys(names, 0.0)
    bound_bytes = dict.fromkeys(names, 0.0)
    library_ms = 0.0
    ms_no_ef = 0.0
    decode_ms = {"rice": 0.0, "coo": 0.0}
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

        # the RICE stage on the compact buffers compact_emit produced
        vals, idx, _ = K.compact_emit(g, u, lam, st.base, k_cap=k_cap,
                                      wire_dtype=g.dtype, ef=False)
        r = coding.rice_parameter(k_cap, d)
        words, used = K.rice_pack(idx, st.nnz, d=d, r=r)
        want_w, want_u = ref.rice_pack_ref(idx, st.nnz, d, r)
        chk["rice_pack"].equal("rice_pack words", words, want_w)
        chk["rice_pack"].equal("rice_pack used", used, want_u)
        del want_w, want_u
        n_live = torch.clamp_max(st.nnz, k_cap).tolist()
        for row in range(rows):             # the words decode to idx
            dec = compaction.rice_decode(words[row], k_cap, d, r)
            chk["rice_pack"].equal(f"rice_decode row {row}",
                                   dec[:n_live[row]], idx[row, :n_live[row]])
        ms["rice_pack"] += cuda_ms(lambda: K.rice_pack(idx, st.nnz, d=d,
                                                       r=r))
        plain_ms["rice_pack"] += cuda_ms(
            lambda: ref.rice_pack_ref(idx, st.nnz, d, r), 1)
        # what the words depend on: each row's live idx prefix (dead codes
        # are zeros, never read for their value), nnz; written: every word
        # of the capacity (the zero padding ships) and used
        bound_bytes["rice_pack"] += (sum(n_live) + words.numel()
                                     + 2 * rows) * 4
        # the receiver's decode and scatter-add at one worker, both layouts
        dense = torch.zeros(n + wire_layout.DROP_SLOTS, dtype=torch.float32,
                            device="cuda")
        lp = wire_layout.LeafPlan("rice", rows, d, k_cap, k_cap,
                                  words.shape[1], r)
        decode_ms["rice"] += cuda_ms(lambda: sync.decode_into(
            dense, lp, vals.reshape(1, -1), words.reshape(1, -1),
            used[None], 0, n))
        coo_words = idx + (torch.arange(rows, dtype=torch.int32,
                                        device="cuda") * d)[:, None]
        lp = wire_layout.LeafPlan("coo", rows, d, k_cap, k_cap, k_cap)
        decode_ms["coo"] += cuda_ms(lambda: sync.decode_into(
            dense, lp, vals.reshape(1, -1), coo_words.reshape(1, -1), None,
            0, n))
        del vals, idx, words, used, dense, coo_words
        print(f"group [{rows}, {d}] k_cap {k_cap}: kernels agree with their "
              f"plain versions (nnz {int(st.nnz.sum())}, "
              f"gated rows {int(gate.sum())})", flush=True)
        del g, u, st, rst
        torch.cuda.empty_cache()
    return {"check": chk, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": {k: 1e3 * v / HBM_BYTES_PER_S
                         for k, v in bound_bytes.items()},
            "library_ms": library_ms, "ms_no_ef": ms_no_ef,
            "decode_ms": decode_ms}


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


def rice_exchange_check(real, record: list):
    """Wrap ``sync._bucketed_sync``: after each exchange, hold its charged
    bytes to the values, the counts and 4 bytes per realized Golomb-Rice
    word of the step's compact buffers (recomputed on the host with numpy),
    and the synced leaves to the scatter of the same buffers. The checks'
    time and any peak memory they add are recorded, not hidden."""
    from repro_torch.comm import compaction
    from repro_torch.core import coding

    def checked(items, leaves, group, cfg):
        out, wire, overflow = real(items, leaves, group, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        values = counts = used_words = 0
        host_s = 0.0
        layouts = set()
        for kind, sg, members in items:
            if kind != "sparse":
                raise AssertionError("gemma-2b has no dense passthrough")
            layouts.add(sg.layout)
            k_cap, d = sg.k_cap, sg.d
            values += sg.values.numel() * sg.values.element_size()
            counts += sg.rows * 4
            t1 = time.perf_counter()
            idx_h, nnz_h = sg.idx.cpu().numpy(), sg.nnz.cpu().numpy()
            n_live = [min(int(x), k_cap) for x in nnz_h]
            for row in range(sg.rows):
                used_words += coding.rice_stream_words(
                    idx_h[row, :n_live[row]], k_cap, d)
            del idx_h
            host_s += time.perf_counter() - t1
            r0 = 0
            for i, n_rows in members:
                synced = out[i].reshape(n_rows, d)
                for rr in range(n_rows):
                    row = r0 + rr
                    idx = sg.idx[row, :n_live[row]].long()
                    vals = sg.values[row, :n_live[row]]
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
                                "gradient != scatter of the compact buffers")
                r0 += n_rows
        if layouts != {"rice"}:
            raise AssertionError(f"layouts stamped {sorted(layouts)}, not "
                                 "rice on every group")
        if (values, counts) != (RICE_VALUE_BYTES, RICE_COUNT_BYTES):
            raise AssertionError(f"values {values} B, counts {counts} B")
        want = values + counts + 4 * used_words
        if int(wire) != want or want > RICE_MAX_BYTES:
            raise AssertionError(f"wire bytes {int(wire)}, expected {want} "
                                 f"(at most {RICE_MAX_BYTES})")
        torch.cuda.synchronize()
        record.append({"wire_bytes": want, "used_words": used_words,
                       "check_s": time.perf_counter() - t0,
                       "host_words_s": host_s,
                       "check_raised_peak":
                           torch.cuda.max_memory_allocated() > peak})
        return out, wire, overflow
    return checked


def train_phase(layout: str, check: bool = False) -> dict:
    """One launcher run with the kernel counts set to 0 just before it and
    read just after. ``auto`` is the main path; with ``check`` every
    exchange is held to its exact bytes and gradient (the step times then
    include the checks), without it the run gives the step times and its
    bytes are held to the RICE bounds. ``coo`` checks the COO wire's exact
    bytes."""
    from repro_torch.comm import sync
    from repro_torch.kernels.sparsify import kernel as K
    from repro_torch.launch import train
    record: list = []
    real = sync._bucketed_sync
    if check:
        sync._bucketed_sync = rice_exchange_check(real, record)
    K.reset_launches()
    try:
        summary = train.main(TRAIN_ARGS + ["--wire-layout", layout])
    finally:
        sync._bucketed_sync = real
    launches = dict(K.LAUNCHES)
    want_layout = "rice" if layout == "auto" else layout
    if {lay for *_, lay in summary["layouts"]} != {want_layout}:
        raise AssertionError(f"{layout}: layouts {summary['layouts']}")
    for step, m in enumerate(summary["metrics"]):
        if not math.isfinite(m["loss"]):
            raise AssertionError(f"step {step}: loss {m['loss']}")
        if layout == "coo" or record:
            want = record[step]["wire_bytes"] if record else WIRE_BYTES
            if m["wire_bytes"] != want:
                raise AssertionError(f"{layout} step {step}: wire_bytes "
                                     f"{m['wire_bytes']} != {want}")
        else:
            words = m["wire_bytes"] - RICE_VALUE_BYTES - RICE_COUNT_BYTES
            if not (0 < words and words % 4 == 0
                    and m["wire_bytes"] <= RICE_MAX_BYTES):
                raise AssertionError(f"{layout} step {step}: wire_bytes "
                                     f"{m['wire_bytes']} outside the RICE "
                                     "bounds")
        if m["overflow"] != 0:
            raise AssertionError(f"step {step}: overflow {m['overflow']}")
        if not 0.0 < m["density"] <= 1.25 * RHO:
            raise AssertionError(f"step {step}: density {m['density']}")
    if check and len(record) != len(summary["metrics"]):
        raise AssertionError("an exchange went unchecked")
    for name, count in launches.items():
        if count <= 0 and (name != "rice_pack" or layout != "coo"):
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{layout} path")
    print(f"train --wire-layout {layout}{' (checked)' if check else ''}: "
        "steps " + ", ".join(f"{s:.3f} s" for s in summary["step_seconds"])
        + (" (of which host checks " + ", ".join(
            f"{c['check_s']:.3f} s" for c in record) + ")" if record else "")
        + "; wire_bytes " + ", ".join(
            f"{m['wire_bytes']:.0f}" for m in summary["metrics"])
        + "; density " + ", ".join(
            f"{m['density']:.6f}" for m in summary["metrics"])
        + "; loss " + ", ".join(f"{m['loss']:.4f}"
                                for m in summary["metrics"])
        + f"; max_memory_allocated {summary['max_memory_allocated']} B",
        flush=True)
    summary["launches"] = launches
    summary["checks"] = record
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
    tr = train_phase("auto", check=True)
    torch.cuda.empty_cache()
    timed = train_phase("auto")
    torch.cuda.empty_cache()
    coo = train_phase("coo")

    replaces = {"stats_l1max": 275, "tail_stats": 195, "select_stats": 384,
                "compact_emit": 559, "rice_pack": 612}
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
    for name, run in (("train_checked", tr), ("train", timed),
                      ("train_coo", coo)):
        print(json.dumps({name: {
            "step_seconds": run["step_seconds"],
            "max_memory_allocated": run["max_memory_allocated"],
            "wire_bytes": [m["wire_bytes"] for m in run["metrics"]],
            "density": [m["density"] for m in run["metrics"]],
            "loss": [m["loss"] for m in run["metrics"]],
            "checks": run["checks"], "launches": run["launches"]}}))
    print(json.dumps({"decode_ms_per_step": kp["decode_ms"],
                      "seconds": time.perf_counter() - T0}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
