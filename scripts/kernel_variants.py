"""Times design variants of the hand-written kernels on one GPU.

    python3 scripts/kernel_variants.py [--only NAME[,NAME...]]

Builds copies of ``src/repro_torch/csrc/sparsify.cu`` that differ from it
in one design choice each, and times each against the source as it
stands, in turns (each variant, then each again in reverse order; the mean
of the two), on the cases its choice touches, on synthetic gemma-2b groups
made as ``chip_smoke.py`` makes them (bf16 normal x lognormal g, f32
uniforms, from a seed), summed over the groups: one step's worth, as in
chip_smoke's kernel phase. The variants:

- ``memset``: compact_emit's dead slots zeroed by a memset of both compact
  buffers at every capacity (the source: by the kernel where k_cap < d);
- ``zeroing``: by the kernel at every capacity, k_cap = d included;
- ``bounds5``: compact_emit compiled for 5 blocks an SM (the source: 4);
- ``rice8``, ``rice32``: rice_pack with 8 codes a thread at 8 blocks an SM,
  32 at 4 (the source: 16 at 6);
- ``topk_tiles1``, ``topk_tiles4``, ``topk_tiles16``: pass 1 for topk
  (select_stats/topk) with 1, 4 or 16 tiles a block (the source: 8);
- ``topk_f64``: pass 1 for topk converting each item's square to f64 (the
  source: an f32 sum of a thread's sweep, converted once);
- ``topk_branchless``: pass 1 for topk with selects in place of the
  branch on a strict survivor;
- ``radix2``: topk_threshold for bf16 in two rounds of 2^8 and 2^7 bins
  with per-warp histograms (the source: one round of 2^15 bins), the same
  build with ``kernel.TOPK_BITS`` set;
- ``radix_unroll8``: topk_threshold's histogram pass with 8 16-byte loads
  in flight a thread (the source: 4);
- ``select_blocks3``: the compaction's ``compact_select`` compiled for 3
  blocks an SM (the source: 4);
- ``select_no_sleep``: its look-back spinning without a back-off (the
  source: ``__nanosleep`` between reads);
- ``fit_blocks6``, ``fit_blocks8``: ``rice_fit``'s tile pass
  (``rice_fit_sums``) compiled for 6 or 8 blocks an SM (the source: no
  bound);
- ``fitpack_blocks3``, ``fitpack_blocks5``, ``fitpack_blocks6``: the
  fitted ``rice_pack`` (``rice_pack_fitted``, from the fit's bases) for 3,
  5 or 6 blocks an SM (the source: 4).

And four diagnostics of ``compact_select``, each the source with a part of
its work taken out, timed only (their outputs are not the source's):
``select_copy_only`` (a block copies its tile to shared memory and
leaves), ``select_count_only`` (and counts it), ``select_no_lookback``
(every step but the look-back: a tile takes a made-up base) and
``select_no_store`` (every step but the staging and the stores); and
three of the fitted ``rice_pack``: ``fitpack_loads_only`` (a block reads
its codes, sums their quotients and leaves), ``fitpack_no_rem`` (no remainder
field) and ``fitpack_no_unary`` (no unary field). The fitted pair's cases
are timed by the profiler's device time (``chip_smoke.device_ms``), the
others by CUDA events around the wrapper (``chip_smoke.cuda_ms``).

``--only`` runs the named variants (and the source) alone. Every variant's
outputs are held bit-equal to the source's. Prints the card's name and
power limit, then one JSON line per variant: ms per step for each timed
case. Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RHO = 0.05


COMPACT = ("compact_emit/lam f32 EF", "compact_emit/topk f32 EF",
           "compact_emit/bern f32 EF, k_cap = d",
           "compact_emit/bern+ternary, k_cap = d")
# variant -> the cases its design choice touches
CASES = {"memset": COMPACT, "zeroing": COMPACT, "bounds5": COMPACT,
         "rice8": ("rice_pack",), "rice32": ("rice_pack",),
         "topk_tiles1": ("select_stats/topk",),
         "topk_tiles4": ("select_stats/topk",),
         "topk_tiles16": ("select_stats/topk",),
         "topk_f64": ("select_stats/topk",),
         "topk_branchless": ("select_stats/topk",),
         "radix2": ("topk_threshold",),
         "radix_unroll8": ("topk_threshold",),
         "select_blocks3": ("compact_select",),
         "select_no_sleep": ("compact_select",),
         "select_copy_only": ("compact_select",),
         "select_count_only": ("compact_select",),
         "select_no_lookback": ("compact_select",),
         "select_no_store": ("compact_select",),
         "fit_blocks6": ("rice_fit",),
         "fit_blocks8": ("rice_fit",),
         "fitpack_blocks3": ("rice_pack/fitted",),
         "fitpack_blocks5": ("rice_pack/fitted",),
         "fitpack_blocks6": ("rice_pack/fitted",),
         "fitpack_loads_only": ("rice_pack/fitted",),
         "fitpack_no_rem": ("rice_pack/fitted",),
         "fitpack_no_unary": ("rice_pack/fitted",)}
# variants that take work out: timed, their outputs not held to the source's
# the cases timed by device time alone
DEVICE = {"rice_fit", "rice_pack/fitted"}
DIAGNOSTIC = {"fitpack_loads_only", "fitpack_no_rem", "fitpack_no_unary",
              "select_copy_only", "select_count_only", "select_no_lookback",
              "select_no_store"}
# variants that are the source's build with other topk_threshold rounds
BITS = {"radix2": (8, 7)}


def variants(src: str) -> dict[str, str]:
    def sub(old: str, new: str) -> str:
        if src.count(old) != 1:
            raise AssertionError(f"variant pattern not found once: {old!r}")
        return src.replace(old, new)

    def rice(items: int, blocks: int) -> str:
        out = sub("constexpr int kRiceItems = 16;",
                  f"constexpr int kRiceItems = {items};")
        return out.replace("constexpr int kRiceMinBlocks = 6;",
                           f"constexpr int kRiceMinBlocks = {blocks};")

    def alone(old: str, new: str) -> str:
        lb = "  if (w == kSelWarps) {\n"
        if src.count(lb) != 1:
            raise AssertionError(f"variant pattern not found once: {lb!r}")
        return sub(old, new).replace(lb, lb + "    return;\n")

    def tiles(n: int) -> str:
        return sub("constexpr int kTopkTiles = 8;",
                   f"constexpr int kTopkTiles = {n};")

    zero = "  const int zero_dead = k_cap < d;"
    copied = "  sel_sync_tile();                       // the tile is in shared memory\n"
    counted = "  sh_thr[threadIdx.x] = inc - mine;      // my lanes' before " \
        "me, in my warp\n"
    staged = "    const int wn = __shfl_sync(kFull, r0 + __popc(km), 31) - wr;"
    scan = "  unsigned inc = len;\n"
    fit_lb = "__global__ void __launch_bounds__(kThreads)\nrice_fit_sums("
    rem = "  if (r > 0) {\n    // The remainder field"
    unary = "  // The unary field: my len bits"
    return {
        "source": src,
        "memset": sub(zero, "  const int zero_dead = 0;"),
        "zeroing": sub(zero, "  const int zero_dead = 1;"),
        "bounds5": sub("__launch_bounds__(kThreads, 4)\ncompact_emit(",
                       "__launch_bounds__(kThreads, 5)\ncompact_emit("),
        "rice8": rice(8, 8),
        "rice32": rice(32, 4),
        "topk_tiles1": tiles(1),
        "topk_tiles4": tiles(4),
        "topk_tiles16": tiles(16),
        "topk_f64": sub("      float dn_s = 0.f, vs_s = 0.f;\n",
                        "      double dn_s = 0.0, vs_s = 0.0;\n"),
        "topk_branchless": sub(
            """        if (a > s1) {
          ++c;
          vs_s += __fmul_rn(x[k], x[k]);
          vm = fmaxf(vm, a);
        } else if (a == s1 && ties_on) {
          c += 1 << 16;
        }
""", """        const bool gt = a > s1;
        c += gt ? 1 : (a == s1 && ties_on ? 1 << 16 : 0);
        vs_s += gt ? __fmul_rn(x[k], x[k]) : 0.f;
        vm = fmaxf(vm, gt ? a : 0.f);
"""),
        "radix_unroll8": sub("  constexpr int kUnroll = 4;\n",
                             "  constexpr int kUnroll = 8;\n"),
        "select_blocks3": sub("constexpr int kSelMinBlocks = 4;",
                              "constexpr int kSelMinBlocks = 3;"),
        "select_no_sleep": sub("      __nanosleep(64);\n", ""),
        # the look-back warp leaves at once too, or it would wait on
        # aggregates that are never published
        "select_copy_only": alone(copied, copied + "  if (sh_tile[0].x == "
                                  "1u) idx[0] = 1;\n  return;\n"),
        "select_count_only": alone(counted, counted + "  if (inc == -1) "
                                   "idx[0] = 1;\n  return;\n"),
        "select_no_lookback": sub(
            "b == 0 ? 0ull : select_lookback(st, b)",
            "(unsigned long long)(b * 1024)"),
        "select_no_store": sub(staged, staged + "\n    continue;"),
        "fit_blocks6": sub(fit_lb, fit_lb.replace("(kThreads)",
                                                  "(kThreads, 6)")),
        "fit_blocks8": sub(fit_lb, fit_lb.replace("(kThreads)",
                                                  "(kThreads, 8)")),
        "fitpack_blocks3": sub("constexpr int kPackMinBlocks = 4;",
                               "constexpr int kPackMinBlocks = 3;"),
        "fitpack_blocks5": sub("constexpr int kPackMinBlocks = 4;",
                               "constexpr int kPackMinBlocks = 5;"),
        "fitpack_blocks6": sub("constexpr int kPackMinBlocks = 4;",
                               "constexpr int kPackMinBlocks = 6;"),
        "fitpack_loads_only": sub(scan, "  if (len == 12345u) wrow[0] = "
                                  "1u;\n  return;\n" + scan),
        "fitpack_no_rem": sub(rem, rem.replace("r > 0", "false")),
        "fitpack_no_unary": sub(unary, "  return;\n" + unary),
    }


def build(K, texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *K.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, (args, res) in K._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = res
        libs[name] = lib
    return libs


def _counts(st) -> tuple:
    """Pass 1's counts, bases and max|v| (its sums, within rtol 1e-6, are
    held by chip_smoke and the GPU tests, not here)."""
    return st.nnz, st.nonzeros, st.max_abs, st.base, st.tie_base


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import codecs, coding
    from repro_torch.kernels.sparsify import kernel as K, ops
    only = None
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    print(cs.card_line(), flush=True)
    texts = {n: t for n, t in variants(K._SOURCE.read_text()).items()
             if only is None or n == "source" or n in only}
    libs = build(K, texts)
    names = ["source"] + [n for n in CASES if n in libs or (
        n in BITS and (only is None or n in only))]
    source_bits = K.TOPK_BITS[torch.bfloat16]

    def use(name: str) -> None:
        lib = libs.get(name, libs["source"])
        K._lib_handle = lib
        K.RICE_TILE = lib.gspar_rice_tile()
        K.TOPK_BITS[torch.bfloat16] = BITS.get(name, source_bits)

    f32, ter = codecs.FloatCodec(), codecs.get("ternary")
    gen = torch.Generator(device="cuda").manual_seed(0)
    total: dict[str, dict[str, float]] = {n: {} for n in names}
    wanted = set().union(*(CASES[n] for n in names[1:]))
    for rows, d, k_cap in cs.main_path_groups():
        g = cs.heavy_tailed(rows, d, gen)
        u = torch.rand((rows, d), generator=gen, device="cuda")
        use("source")
        l1, mx = K.stats_l1max(g)
        lam = ops.greedy_lambda(l1, mx, RHO, d,
                                tail_fn=ops._kernel_tail_fn(g))
        st = K.select_stats(g, u, lam, k_cap)
        zero = torch.zeros(rows, device="cuda")
        stb = K.select_stats(g, u, zero, d, pkind="bern", s2=mx)
        scb = codecs.finalize_scale(ter, stb.sum_sq, stb.max_abs)
        ucb = torch.rand((rows, d), device="cuda")
        k_target = max(1, round(RHO * d))
        t, budget = ops.topk_threshold(g, k_target)
        stt = K.select_stats(g, None, t, k_cap, pkind="topk", budget=budget)
        bins = K.compact_bins(g, k_cap)
        _, idx, _ = K.compact_emit(g, u, lam, st, k_cap=k_cap, codec=f32,
                                   ef=False)
        r = coding.rice_parameter(k_cap, d)
        window = coding.rice_fit_window(k_cap, d)
        fit = K.rice_fit_tiles(idx, st.nnz, d=d, window=window)
        cases = {
            "compact_emit/lam f32 EF": lambda: K.compact_emit(
                g, u, lam, st, k_cap=k_cap, codec=f32, ef=True),
            "compact_emit/topk f32 EF": lambda: K.compact_emit(
                g, None, t, stt, k_cap=k_cap, codec=f32, ef=True,
                pkind="topk", budget=budget),
            "compact_emit/bern f32 EF, k_cap = d": lambda: K.compact_emit(
                g, u, zero, stb, k_cap=d, codec=f32, ef=True, pkind="bern",
                s2=mx),
            "compact_emit/bern+ternary, k_cap = d": lambda: K.compact_emit(
                g, u, zero, stb, k_cap=d, codec=ter, ef=False, pkind="bern",
                s2=mx, scale=scb, u_cod=ucb),
            "rice_pack": lambda: K.rice_pack(idx, st.nnz, d=d, r=r),
            "select_stats/topk": lambda: _counts(K.select_stats(
                g, None, t, k_cap, pkind="topk", budget=budget)),
            "topk_threshold": lambda: K.topk_threshold(g, k_target),
            "compact_select": lambda: K.compact_select(
                g, bins, k_cap=k_cap, codec=f32),
            "rice_fit": lambda: K.rice_fit_tiles(idx, st.nnz, d=d,
                                                 window=window),
            "rice_pack/fitted": lambda: K.rice_pack_fitted(
                idx, st.nnz, fit.r, d=d, window=window, bases=fit.bases),
        }
        cases = {c: fn for c, fn in cases.items() if c in wanted}
        for case, fn in cases.items():     # each variant as the source
            use("source")
            want = fn()
            for name in names[1:]:
                if case not in CASES[name] or name in DIAGNOSTIC:
                    continue
                use(name)
                out = fn()
                if not all(a is None and b is None or torch.equal(a, b)
                           for a, b in zip(out, want)):
                    raise AssertionError(f"{name}: {case} differs from the "
                                         "source's output")
                del out
            del want
        times: dict[str, dict[str, list]] = {n: {} for n in names}
        for name in names + names[::-1]:
            use(name)
            for case, fn in cases.items():
                if name == "source" or case in CASES[name]:
                    ms = (cs.device_ms(fn)[0] if case in DEVICE
                          else cs.cuda_ms(fn))
                    times[name].setdefault(case, []).append(ms)
        for name in names:
            for case, ts in times[name].items():
                total[name][case] = (total[name].get(case, 0.0)
                                     + statistics.mean(ts))
        del g, u, st, stb, stt, ucb, idx, bins, cases, fit
        torch.cuda.empty_cache()
    use("source")
    for name, ms in total.items():
        print(json.dumps({"variant": name, "ms_per_step": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
