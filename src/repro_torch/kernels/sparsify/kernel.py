"""Wrappers of the hand-written CUDA kernels in ``csrc/sparsify.cu``.

The kernels ported from the Pallas TPU kernels of
``repro.kernels.sparsify.kernel`` (file and line in each wrapper's
docstring). The sparse emit path: the four passes of the two-pass emit,
for every selector kind (``PKINDS``: gspar's lam, unisp's rho, bernoulli's
bern, topk) and every value codec (f32, bf16, qsgd<N>, ternary), and the
Golomb-Rice packing of the RICE wire layout (with the data-fitted
parameter of wire-format v4: ``rice_fit_pack``, which is ``rice_fit`` and
``rice_pack_fitted`` with the fit's tile bases passed between them), and
topk's threshold and tie budget (``topk_threshold``). The dense wire: ``stats``, ``sparsify``,
``sparsify_ef`` (every selector kind of ``DENSE_KINDS`` with every codec:
the integer codecs' decoded levels from the scale that ``select_stats``
gives with ``round_v``) and ``sparsify_prng``. Each wrapper takes
one shape group as a ``[rows, d]`` batch (``[rows, k_cap]`` for the
packing) and per-row scalar tensors, as the vmap over a group is on the
TPU:

- a tensor on the CPU goes to the plain PyTorch version in ``ref.py``;
- a tensor on a CUDA device launches the kernel, or raises. There is no
  fallback from the card to the plain version.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` at the repository root, on
first use, and loaded with ``ctypes`` (the library's file name carries a
hash of the source, so an edited source is rebuilt). A wrapper enqueues its
kernels on PyTorch's current stream, allocates outputs and scratch with
PyTorch, checks ``cudaGetLastError`` after the launch, and adds one to
``LAUNCHES[name]`` (and, for the compaction passes and the dense emit, to
the variant's count): the launch counts a run can read back.

The magnitude compaction of a bfloat16 group (``compact_bins``, then
``compact_select``) and Algorithm 2's lambda (``magnitude_hist``, then
``closed_lambda``) take their row scalars from the group's magnitude
histogram, whose bins are single bf16 values.

What bounds each kernel on an H100 (3.35 TB/s of HBM): every one is a
memory-bound stream over the group (or its compact buffer, or the
histogram), so its bound is the bytes it must move over the memory rate;
see each docstring and PERF.md.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.comm.compaction import rice_cap_words, rice_fit_cap_words
from repro_torch.kernels.sparsify import ref
from repro_torch.kernels.sparsify.ref import (CompactBins, SelectStats,
                                              Sparsified)

TILE = 16384          # coordinates per CUDA block; must equal kTile in the .cu
RICE_TILE = 4096      # codes per CUDA block; must equal kRiceTile in the .cu
KERNELS = ("stats_l1max", "tail_stats", "select_stats", "compact_emit",
           "rice_pack", "rice_fit", "stats", "sparsify", "sparsify_ef",
           "sparsify_prng", "topk_threshold", "compact_bins",
           "compact_select", "closed_lambda")
# topk_threshold's radix-select rounds: the key bits each counts, from the
# top (bf16: one round of 2^15 bins; f32: three of at most 2^11)
TOPK_BITS = {torch.bfloat16: (15,), torch.float32: (11, 10, 10)}
DET_U = ref.DET_U     # pass 2's uniform under deterministic rounding
PKINDS = ref.PKINDS   # selector kinds of passes 1-2, in the .cu's enum order
DENSE_KINDS = ref.DENSE_KINDS   # and of the dense emit (kernels 5 and 6)
# Launches per kernel, and per variant of the two compaction passes and of
# the dense emit: ``"select_stats/topk"``, ``"compact_emit/lam+qsgd8"``,
# ``"sparsify_ef/one+qsgd4"`` (the selector kind, then an integer codec's
# name; float codecs count under the kind alone; ``"select_stats/
# lam+rounded"``: the dense wire's scale pass).
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

_REPO = Path(__file__).resolve().parents[4]
_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "sparsify.cu"
BUILD_DIR = _REPO / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int16: 3}        # g takes the first two
_lib_handle: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "gspar_tile": ((), _L),
    "gspar_rice_tile": ((), _L),
    "gspar_select_tile": ((), _L),
    "gspar_error_string": ((_I,), ctypes.c_char_p),
    "gspar_stats_l1max": ((_P, _I, _L, _L, _I, _P, _P, _P, _P, _P), _I),
    "gspar_tail_stats": ((_P, _I, _L, _L, _I, _P, _P, _P, _P, _P, _P, _P), _I),
    "gspar_select_stats": ((_P, _I, _P, _L, _L, _I, _I, _I, _P, _P, _P, _L)
                           + (_P,) * 15 + (_I, _P), _I),
    "gspar_compact_emit": ((_P, _I, _P, _L, _L, _I, _I, _I, _I, _P, _P, _P,
                            _P, _P, _P, _L, _P, _I, _P, _P, _I, _P, _P,
                            ctypes.c_float, _I, _P), _I),
    "gspar_rice_pack": ((_P, _P, _L, _L, _I, _P, _L, _I) + (_P,) * 3
                        + (_P,), _I),
    "gspar_rice_fit": ((_P, _P, _L, _L) + (_I,) * 5 + (_P, _I, _P) + (_P,),
                       _I),
    "gspar_rice_pack_fitted": ((_P, _P, _L, _L, _P, _P, _L, _I) + (_P,) * 2
                               + (_P,), _I),
    "gspar_rice_fit_pack": ((_P, _P, _L, _L) + (_I,) * 6 + (_P, _L, _P, _P)
                            + (_P,), _I),
    "gspar_rice_fit_legacy": ((_P, _P, _L, _L) + (_I,) * 6 + (_P,) * 3
                              + (_P,), _I),
    "gspar_stats": ((_P, _I, _L, _L, _I) + (_P,) * 6 + (_P,), _I),
    "gspar_sparsify": ((_P, _I, _P, _L, _L, _I, _I, _P, _P, _P, _P, _I,
                        ctypes.c_uint, _I, _P, _P, ctypes.c_float, _I, _P,
                        _I) + (_P,) * 9 + (_P,), _I),
    "gspar_philox": ((_P, _P, _L, _P), _I),
    "gspar_topk_threshold": ((_P, _I, _L, _L, _I, _L, _I, _I, _I)
                             + (_P,) * 4 + (_P,), _I),
    "gspar_magnitude_hist": ((_P, _L, _L, _I, _P, _P), _I),
    "gspar_closed_lambda": ((_P, _L, ctypes.c_double, _P, _P, _P), _I),
    "gspar_compact_bins": ((_P, _L, _L, _I, _L) + (_P,) * 7 + (_P,), _I),
    "gspar_compact_select": ((_P, _L, _L, _I, _L, _P, _P, _P, _P, _P, _I, _P,
                              _P, ctypes.c_float, _I, _P), _I),
}


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES.update(dict.fromkeys(KERNELS, 0))


def library_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libsparsify-{digest}.so"


def build() -> tuple[Path, str]:
    """Compile ``csrc/sparsify.cu`` (once per source hash). Returns the
    library path and nvcc's log (``-Xptxas -v``: registers, shared memory
    and spills per kernel), kept beside the library for later calls."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = res
        if (lib.gspar_tile(), lib.gspar_rice_tile()) != (TILE, RICE_TILE):
            raise RuntimeError(
                f"kernel tiles {lib.gspar_tile()}, {lib.gspar_rice_tile()} "
                f"!= {TILE}, {RICE_TILE}")
        _lib_handle = lib
    return _lib_handle


def _check(err: int, name: str, variant: str | None = None) -> None:
    if err != 0:
        msg = _lib().gspar_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
    LAUNCHES[name] += 1
    if variant is not None:
        key = f"{name}/{variant}"
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _vec(t: torch.Tensor) -> int:
    """16-byte vector loads: aligned base and rows a multiple of 8 long."""
    return int(t.data_ptr() % 16 == 0 and t.shape[1] % 8 == 0)


def _on_card(name: str, g: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (take the plain version); raises on anything the kernel cannot take."""
    if g.device.type == "cpu":
        return False
    if g.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {g.device}")
    if g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"{name}: g must be a contiguous [rows, d] tensor")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: g dtype {g.dtype} is not float32/bfloat16")
    if g.shape[1] >= 2**31 or g.shape[0] > 65535:
        raise ValueError(f"{name}: group {tuple(g.shape)} exceeds the grid")
    for t in others:
        if t.device != g.device or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous on "
                             f"{g.device}")
    return True


def stats_l1max(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum|g|, max|g|)`` per row, float32 — lambda_0 and the saturation
    gate of Algorithm 3. Replaces ``stats_l1max_2d``
    (src/repro/kernels/sparsify/kernel.py:275). Bound: one read of g
    (2 B/coord in bf16)."""
    if not _on_card("stats_l1max", g):
        return ref.stats_l1max_ref(g)
    rows, d = g.shape
    nt = ref.ntiles(d, TILE)
    f32 = dict(dtype=torch.float32, device=g.device)
    psum = torch.empty((rows, nt), dtype=torch.float64, device=g.device)
    pmax = torch.empty((rows, nt), **f32)
    l1 = torch.empty(rows, **f32)
    mx = torch.empty(rows, **f32)
    _check(_lib().gspar_stats_l1max(
        _ptr(g), _DTYPE_CODE[g.dtype], rows, d, _vec(g), _ptr(psum),
        _ptr(pmax), _ptr(l1), _ptr(mx), _stream(g)), "stats_l1max")
    return l1, mx


def tail_stats(g: torch.Tensor, thresh: torch.Tensor, gate: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(count, sum|g|)`` per row over ``|g| < thresh[row]``, count int64
    and sum float32; rows with ``gate[row]`` False do no work and report
    zeros. Replaces ``tail_stats_2d`` (src/repro/kernels/sparsify/
    kernel.py:195), which counts in float32. Bound: one read of g for the
    gated rows."""
    thresh = thresh.to(torch.float32).contiguous()
    gate = gate.to(torch.uint8).contiguous()
    if not _on_card("tail_stats", g, thresh, gate):
        return ref.tail_stats_ref(g, thresh, gate.bool())
    rows, d = g.shape
    nt = ref.ntiles(d, TILE)
    pcnt = torch.empty((rows, nt), dtype=torch.int32, device=g.device)
    psum = torch.empty((rows, nt), dtype=torch.float64, device=g.device)
    cnt = torch.empty(rows, dtype=torch.int64, device=g.device)
    l1 = torch.empty(rows, dtype=torch.float32, device=g.device)
    _check(_lib().gspar_tail_stats(
        _ptr(g), _DTYPE_CODE[g.dtype], rows, d, _vec(g), _ptr(thresh),
        _ptr(gate), _ptr(pcnt), _ptr(psum), _ptr(cnt), _ptr(l1), _stream(g)),
        "tail_stats")
    return cnt, l1


def _kind_scalars(name: str, g: torch.Tensor, pkind: str, s1: torch.Tensor,
                  s2: torch.Tensor | None, budget: torch.Tensor | None):
    """The per-row selector scalars as the kernels read them: s1 float32
    (lambda, rho or the topk threshold), s2 float32 (bern: max|g|), budget
    int64 (topk: ties to keep)."""
    if pkind not in PKINDS:
        raise ValueError(f"{name}: unknown select kind {pkind!r}; have "
                         f"{PKINDS}")
    rows = g.shape[0]
    s1 = s1.to(torch.float32).expand(rows).contiguous()
    if pkind == "bern":
        if s2 is None:
            raise ValueError(f"{name}: pkind='bern' needs s2 = max|g|")
        s2 = s2.to(torch.float32).expand(rows).contiguous()
    else:
        s2 = None
    if pkind == "topk":
        if budget is None or budget.dtype != torch.int64:
            raise ValueError(f"{name}: pkind='topk' needs an int64 budget")
        budget = budget.expand(rows).contiguous()
    else:
        budget = None
    return s1, s2, budget


def _uniforms(name: str, g: torch.Tensor, u: torch.Tensor | None,
              pkind: str) -> torch.Tensor | None:
    """The sampling selectors read float32 uniforms shaped like g; topk
    reads none."""
    if pkind == "topk":
        return None
    if u is None or u.shape != g.shape or u.dtype != torch.float32:
        raise ValueError(f"{name}: u must be float32 shaped like g")
    return u


def select_stats(g: torch.Tensor, u: torch.Tensor | None, s1: torch.Tensor,
                 k_cap: int, *, pkind: str = "lam",
                 s2: torch.Tensor | None = None,
                 budget: torch.Tensor | None = None,
                 round_v: bool = False) -> SelectStats:
    """Pass 1 of the two-pass compaction for selector kind ``pkind`` (lam:
    gspar, rho: unisp, bern: bernoulli, topk; ``ref._select_row`` defines
    them from ``s1``, ``s2`` and ``budget``): survivors, support, sum p, sum
    g^2, and sum v^2 / max|v| over the first ``k_cap`` survivors of each
    row, plus the per-tile base ranks that pass 2 writes from (and for topk
    the per-tile tie bases). With ``round_v`` sum v^2 and max|v| are taken
    over v rounded to g's dtype: the dense wire's codec scale (at ``k_cap =
    d``), over the v that ``apply_mask`` casts to the leaf dtype; the
    gather wire's is over float32 v. Replaces ``select_stats_2d``
    (src/repro/kernels/sparsify/kernel.py:384). Bound: one read of g and,
    for the sampling kinds, of the f32 uniforms (6 B/coord with bf16 g;
    topk 2)."""
    s1, s2, budget = _kind_scalars("select_stats", g, pkind, s1, s2, budget)
    u = _uniforms("select_stats", g, u, pkind)
    extra = [t for t in (u, s2, budget) if t is not None]
    if not _on_card("select_stats", g, s1, *extra):
        return ref.select_stats_ref(g, u, s1, k_cap, TILE, pkind=pkind,
                                    s2=s2, budget=budget, round_v=round_v)
    rows, d = g.shape
    nt = ref.ntiles(d, TILE)
    dev = g.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    topk = pkind == "topk"
    pcnt = torch.empty((rows, nt), **i32)
    pnzc = torch.empty((rows, nt), **i32)
    pties = torch.empty((rows, nt), **i32) if topk else None
    ppsum = None if topk else torch.empty((rows, nt), **f64)
    pden = torch.empty((rows, nt), **f64)
    pvsq = torch.empty((rows, nt), **f64)
    pvmx = torch.empty((rows, nt), **f32)
    out = SelectStats(
        nnz=torch.empty(rows, **i32), nonzeros=torch.empty(rows, **i32),
        p_sum=torch.empty(rows, **f32), den=torch.empty(rows, **f32),
        sum_sq=torch.empty(rows, **f32), max_abs=torch.empty(rows, **f32),
        base=torch.empty((rows, nt), **i32),
        tie_base=torch.empty((rows, nt), **i32) if topk else None)
    _check(_lib().gspar_select_stats(
        _ptr(g), _DTYPE_CODE[g.dtype], _ptr(u), rows, d, _vec(g),
        _vec(u) if u is not None else 0, PKINDS.index(pkind), _ptr(s1),
        _ptr(s2), _ptr(budget), k_cap, _ptr(pcnt), _ptr(pnzc), _ptr(pties),
        _ptr(ppsum), _ptr(pden), _ptr(pvsq), _ptr(pvmx), _ptr(out.base),
        _ptr(out.tie_base), _ptr(out.nnz), _ptr(out.nonzeros),
        _ptr(out.p_sum), _ptr(out.den), _ptr(out.sum_sq), _ptr(out.max_abs),
        int(round_v), _stream(g)), "select_stats",
        pkind + ("+rounded" if round_v else ""))
    return out


def topk_threshold(g: torch.Tensor, k_target: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``g [rows, d]``: ``t``, the ``k_target``-th largest |g|
    (float32), and the tie budget ``k_target - #{|g| > t}`` (int64), exact
    at any row length (t = 0 and budget = k_target - nnz where the row has
    fewer nonzeros). A radix select on the magnitude's bit pattern, in the
    rounds of ``TOPK_BITS`` (a histogram pass over the group and a
    one-block-per-row finish each); no sort. Replaces the XLA ``lax.top_k``
    of ``topk_emit`` (src/repro/kernels/sparsify/ops.py:268). Bound: one
    read of g per round (2 B/coord for bf16 in one round)."""
    if not _on_card("topk_threshold", g):
        return ref.topk_threshold_ref(g, k_target, TOPK_BITS[g.dtype])
    rows, d = g.shape
    if not 1 <= k_target <= d:
        raise ValueError(f"topk_threshold: k_target {k_target} outside "
                         f"[1, {d}]")
    bits = TOPK_BITS[g.dtype]
    dev = g.device
    hist = torch.empty((rows, 1 << max(bits)), dtype=torch.int32, device=dev)
    state = torch.empty((rows, 3), dtype=torch.int64, device=dev)
    t = torch.empty(rows, dtype=torch.float32, device=dev)
    budget = torch.empty(rows, dtype=torch.int64, device=dev)
    b0, b1, b2 = (tuple(bits) + (0, 0))[:3]
    _check(_lib().gspar_topk_threshold(
        _ptr(g), _DTYPE_CODE[g.dtype], rows, d, _vec(g), k_target, b0, b1,
        b2, _ptr(hist), _ptr(state), _ptr(t), _ptr(budget), _stream(g)),
        "topk_threshold")
    return t, budget


def magnitude_hist(g: torch.Tensor) -> torch.Tensor:
    """Per row of a bfloat16 ``g [rows, d]``: the count of each magnitude,
    ``[rows, 2^15]`` int32 indexed by the 15-bit pattern of |g|
    (``ref.magnitude_keys``). This is ``topk_threshold``'s histogram pass
    for bfloat16 (its one round), alone: the bins of Algorithm 2's lambda
    (``closed_lambda``); it counts as a ``topk_threshold`` launch, variant
    ``"hist"``. On the CPU ``ref.magnitude_counts`` (``torch.bincount`` of
    the keys). Bound: one read of g (2 B/coord)."""
    if g.dtype != torch.bfloat16:
        raise ValueError("magnitude_hist: g must be bfloat16")
    if not _on_card("magnitude_hist", g):
        return ref.magnitude_counts(g)
    rows, d = g.shape
    hist = torch.empty((rows, ref.KEY_BINS), dtype=torch.int32,
                       device=g.device)
    _check(_lib().gspar_magnitude_hist(_ptr(g), rows, d, _vec(g), _ptr(hist),
                                       _stream(g)), "topk_threshold", "hist")
    return hist


def closed_lambda(counts: torch.Tensor, eps: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2's lambda of each bfloat16 row from its magnitude
    histogram ``counts [rows, 2^15]`` (int32, ``magnitude_hist``): ``(lam
    [rows] float32, bin [rows] int32)``, ``bin`` the highest non-empty bin
    whose value m satisfies ``m T <= eps sum g^2 + L`` (T, L: sum |g| and
    sum g^2 over the bins below; -1 where none does, and lambda 0), as
    ``ref.closed_lambda_bins_ref`` solves it. One block a row reads the
    row's counts once and solves by one block scan in float64 (no sort, no
    float64 scratch). Replaces the XLA ``jnp.sort`` of
    ``closed_form_lambda`` (src/repro/core/sparsify.py:40) with
    ``magnitude_hist``. Bound: one read of the counts (128 KB a row)."""
    if counts.dim() != 2 or counts.shape[1] != ref.KEY_BINS \
            or counts.dtype != torch.int32:
        raise ValueError("closed_lambda: counts must be int32 [rows, 2^15]")
    if counts.device.type == "cpu":
        return ref.closed_lambda_bins_ref(counts, eps)
    if counts.device.type != "cuda" or not counts.is_contiguous():
        raise ValueError(f"closed_lambda: no kernel for {counts.device} or "
                         "a non-contiguous histogram")
    rows = counts.shape[0]
    lam = torch.empty(rows, dtype=torch.float32, device=counts.device)
    bins = torch.empty(rows, dtype=torch.int32, device=counts.device)
    _check(_lib().gspar_closed_lambda(_ptr(counts), rows, float(eps),
                                      _ptr(lam), _ptr(bins),
                                      _stream(counts)), "closed_lambda")
    return lam, bins


def compact_bins(g: torch.Tensor, k_cap: int) -> CompactBins:
    """The magnitude compaction's row scalars of a bfloat16 ``g [rows, d]``
    at capacity ``k_cap`` (``ref.CompactBins``): the threshold t and tie
    budget (``topk_threshold``'s at ``k_target = k_cap``), the nonzeros,
    the kept count and an integer codec's scale inputs over the kept values
    (sum v^2, max|v|). One histogram pass over g (``radix_hist`` at bf16's
    15 bits) and a one-block-a-row finish over the 2^15 bins, where a bin
    is one value: it replaces pass 1 of topk (``select_stats``) on the
    compaction's path. Replaces, with ``compact_select``, the
    ``lax.top_k`` of ``compaction.compact`` (src/repro/comm/
    compaction.py:64). Bound: one read of g (2 B/coord)."""
    if g.dtype != torch.bfloat16:
        raise ValueError("compact_bins: g must be bfloat16")
    if not 1 <= k_cap <= g.shape[-1]:
        raise ValueError(f"compact_bins: k_cap {k_cap} outside [1, "
                         f"{g.shape[-1]}]")
    if not _on_card("compact_bins", g):
        return ref.compact_bins_ref(g, k_cap)
    rows, d = g.shape
    dev = g.device
    hist = torch.empty((rows, ref.KEY_BINS), dtype=torch.int32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = CompactBins(
        t=torch.empty(rows, **f32),
        budget=torch.empty(rows, dtype=torch.int64, device=dev),
        nonzeros=torch.empty(rows, **i32), kept=torch.empty(rows, **i32),
        sum_sq=torch.empty(rows, **f32), max_abs=torch.empty(rows, **f32))
    _check(_lib().gspar_compact_bins(
        _ptr(g), rows, d, _vec(g), k_cap, _ptr(hist), *map(_ptr, out),
        _stream(g)), "compact_bins")
    return out


def compact_select(g: torch.Tensor, bins: CompactBins, *, k_cap: int, codec,
                   scale: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The magnitude compaction's one pass over a bfloat16 ``g [rows, d]``
    after ``compact_bins``: per row, |g| > t and the first ``budget``
    coordinates with |g| == t > 0, in coordinate order, as ``values [rows,
    k_cap]`` (``codec.wire_dtype``: g itself for a float codec; an integer
    codec's level from the row's ``scale [rows]``, rounded
    deterministically: ``compact_emit``'s ``det_round``) and ``idx [rows,
    k_cap]`` int32; slots past ``kept`` hold idx 0 and value 0. A block
    reads its tile of g once and takes the survivors and ties of the row's
    tiles before it from a chained scan with decoupled look-back (blocks
    ordered by a ticket). Bit-equal to ``ref.compact_emit_ref`` with
    ``pkind="topk"`` at t and budget. Bound: one read of g (2 B/coord) and
    the compact write."""
    if g.dtype != torch.bfloat16:
        raise ValueError("compact_select: g must be bfloat16")
    wire_dtype = codec.wire_dtype(g.dtype)
    rows = g.shape[0]
    if codec.integer_coded:
        if scale is None:
            raise ValueError("compact_select: an integer codec needs scale")
        scale = scale.to(torch.float32).contiguous()
        if scale.shape != (rows,):
            raise ValueError("compact_select: scale must be [rows]")
    else:
        scale = None
    extra = [bins.t, bins.budget, bins.kept] + (
        [scale] if scale is not None else [])
    if not _on_card("compact_select", g, *extra):
        return ref.compact_emit_ref(
            g, None, bins.t, k_cap, codec, False, pkind="topk",
            budget=bins.budget, scale=scale,
            det_round=codec.integer_coded)[:2]
    if k_cap >= 2**31 or not 1 <= k_cap <= g.shape[1]:
        raise ValueError(f"compact_select: k_cap {k_cap} outside [1, d]")
    rows, d = g.shape
    nt = ref.ntiles(d, _lib().gspar_select_tile())
    status = torch.empty(rows * (nt + 1), dtype=torch.int64, device=g.device)
    vals = torch.empty((rows, k_cap), dtype=wire_dtype, device=g.device)
    idx = torch.empty((rows, k_cap), dtype=torch.int32, device=g.device)
    _check(_lib().gspar_compact_select(
        _ptr(g), rows, d, _vec(g), k_cap, _ptr(bins.t), _ptr(bins.budget),
        _ptr(bins.kept), _ptr(status), _ptr(vals), _DTYPE_CODE[wire_dtype],
        _ptr(idx), _ptr(scale), float(getattr(codec, "levels", 0.0)),
        int(codec.name == "ternary"), _stream(g)), "compact_select",
        codec.name + "+det" if codec.integer_coded else None)
    return vals, idx


def compact_emit(g: torch.Tensor, u: torch.Tensor | None, s1: torch.Tensor,
                 sel: SelectStats, *, k_cap: int, codec, ef: bool,
                 pkind: str = "lam", s2: torch.Tensor | None = None,
                 budget: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None,
                 u_cod: torch.Tensor | None = None, det_round: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Pass 2: write each row's first ``k_cap`` survivors in coordinate
    order into ``values [rows, k_cap]`` (``codec.wire_dtype``) and ``idx
    [rows, k_cap]`` (int32, ascending; unused slots idx 0, value 0).

    A float codec writes the value rounded to its wire dtype, and with
    ``ef`` the residual ``g - encoded value`` for every coordinate: the
    codec's float32 output, rounded to the wire dtype only for a rounding
    codec (bf16), as the TPU kernel subtracts ``codec.encode(v)`` before the
    store casts it. An integer codec (qsgd, ternary) writes the level of
    each kept value from the row's ``scale [rows]`` and the codec uniform
    ``u_cod [rows, k_cap]`` at the survivor's compact rank; it takes no
    ``ef`` (the backend subtracts the decoded values from the compact
    buffers, as the JAX package does). With ``det_round`` (and no
    ``u_cod``) it rounds deterministically, as the pod stage's compaction
    encodes (``repro.comm.sync._encode_det``): qsgd rounds up where the
    fraction is at least 0.5, ternary keeps where |v| / scale is at least
    0.5, which is the stochastic rule at the uniform ``DET_U``, the float32
    just below 0.5. ``sel`` is ``select_stats``'s
    output (its per-tile base ranks and tie bases; the plain version
    recomputes them). Replaces ``compact_emit_2d`` with ``rice_r=-1``
    (src/repro/kernels/sparsify/kernel.py:559). Bound: one read of g (and
    u), the compact write (and the codec uniforms), and with ``ef`` one
    write of the residual. The buffers come from ``torch.empty``: the
    kernel zeroes the dead tail, or the launcher memsets both buffers where
    the capacity is a whole row (``k_cap >= d``)."""
    s1, s2, budget = _kind_scalars("compact_emit", g, pkind, s1, s2, budget)
    u = _uniforms("compact_emit", g, u, pkind)
    wire_dtype = codec.wire_dtype(g.dtype)
    rows = g.shape[0]
    if codec.integer_coded:
        if ef:
            raise ValueError("compact_emit: an integer codec's EF residual "
                             "is scattered from the compact buffers")
        if scale is None or (u_cod is None) != det_round:
            raise ValueError("compact_emit: an integer codec needs scale "
                             "and either u_cod or det_round")
        scale = scale.to(torch.float32).contiguous()
        if scale.shape != (rows,) or (u_cod is not None and (
                u_cod.shape != (rows, k_cap) or u_cod.dtype != torch.float32)):
            raise ValueError("compact_emit: scale must be [rows] and u_cod "
                             "float32 [rows, k_cap]")
    else:
        scale = u_cod = None
    extra = [t for t in (u, s2, budget, scale, u_cod) if t is not None]
    if not _on_card("compact_emit", g, s1, sel.base, sel.nnz, *extra):
        return ref.compact_emit_ref(g, u, s1, k_cap, codec, ef, pkind=pkind,
                                    s2=s2, budget=budget, scale=scale,
                                    u_cod=u_cod, det_round=det_round)
    if sel.nnz.shape != (rows,) or sel.nnz.dtype != torch.int32:
        raise ValueError("compact_emit: sel.nnz must be int32 [rows]")
    if k_cap >= 2**31:
        raise ValueError(f"compact_emit: k_cap {k_cap} exceeds int32 ranks")
    d = g.shape[1]
    # no memset here: the kernel (at k_cap >= d the launcher) zeroes the
    # dead tail
    vals = torch.empty((rows, k_cap), dtype=wire_dtype, device=g.device)
    idx = torch.empty((rows, k_cap), dtype=torch.int32, device=g.device)
    res = torch.empty_like(g) if ef else None
    _check(_lib().gspar_compact_emit(
        _ptr(g), _DTYPE_CODE[g.dtype], _ptr(u), rows, d, _vec(g),
        _vec(u) if u is not None else 0, _vec(res) if ef else 0,
        PKINDS.index(pkind), _ptr(s1), _ptr(s2), _ptr(budget),
        _ptr(sel.base), _ptr(sel.tie_base), _ptr(sel.nnz), k_cap,
        _ptr(vals), _DTYPE_CODE[wire_dtype], _ptr(idx), _ptr(res),
        int(codec.rounds_values), _ptr(scale), _ptr(u_cod),
        float(getattr(codec, "levels", 0.0)), int(codec.name == "ternary"),
        _stream(g)), "compact_emit",
        pkind + (f"+{codec.name}" + ("+det" if det_round else "")
                 if codec.integer_coded else ""))
    return vals, idx, res


def rice_pack(idx: torch.Tensor, nnz: torch.Tensor, *, d: int,
              r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Golomb-Rice packing of pass 2's compact index stream: ``idx [rows,
    k_cap]`` (int32, ascending over the first ``min(nnz, k_cap)`` slots) ->
    ``(words [rows, rice_cap_words(k_cap, d, r)], used [rows])``, int32,
    bit-equal to ``compaction.rice_encode(values, idx, d, r, nnz=nnz)``.
    Replaces the ``rice_r >= 0`` parts of ``compact_emit_2d``
    (src/repro/kernels/sparsify/kernel.py:497-556, ``pallas_call`` at :612),
    which pack inside pass 2; this kernel packs from the compact buffer
    after it, in one launch after one memset (a chained scan with
    decoupled look-back over its blocks' quotient sums, blocks ordered by a
    ticket). Bound: one read of each row's live idx prefix (4 B per live
    code) and one write of the words."""
    if not 0 <= r <= 30:
        raise ValueError(f"rice_pack: r={r} outside [0, 30]")
    if not _rice_on_card("rice_pack", idx, nnz):
        return ref.rice_pack_ref(idx, nnz, d, r)
    return _rice_pack(idx, nnz, r, None, rice_cap_words(idx.shape[1], d, r))


def rice_pack_fitted(idx: torch.Tensor, nnz: torch.Tensor,
                     r_rows: torch.Tensor, *, d: int,
                     window: tuple[int, ...],
                     bases: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rice_pack`` with each row at its own parameter ``r_rows [rows]``
    (int32 on the device, inside ``window``): ``(words [rows,
    rice_fit_cap_words(k_cap, d, window)], header [rows])``, int32, ``header
    = (r << 26) | used``, bit-equal to ``compaction.rice_encode_fitted`` at
    ``rice_fit``'s r. Replaces XLA's ``_rice_pack_gaps`` at the chosen r
    (src/repro/comm/compaction.py:265, called from :321, where every
    candidate of the window is packed). ``bases`` are the quotient bases
    of its tiles at ``r_rows`` (``rice_fit_tiles``'s, int32 [rows,
    ntiles(k_cap, RICE_TILE) + 1]); without them the wrapper forms them
    first with the fit's kernel at ``r_rows`` (a ``rice_fit/at_r``
    launch). Then one launch, no memset: a block a tile writes its
    remainder words and its unary span at once from its base, every word
    once and whole. Counts as a ``rice_pack`` launch and a
    ``rice_pack/fitted`` one. Bound: one read of each row's live idx
    prefix and one write of the words."""
    if r_rows.shape != idx.shape[:1] or r_rows.dtype != torch.int32:
        raise ValueError("rice_pack_fitted: r_rows must be int32 [rows]")
    cap_words = rice_fit_cap_words(idx.shape[1], d, window)
    extra = () if bases is None else (bases,)
    if not _rice_on_card("rice_pack_fitted", idx, nnz, r_rows, *extra):
        return ref.rice_pack_fitted_ref(idx, nnz, r_rows, d, window)
    rows, k_cap = idx.shape
    if k_cap < 1:
        raise ValueError("rice_pack_fitted: k_cap must be at least 1")
    if bases is None:
        bases = rice_fit_tiles(idx, nnz, d=d, window=window,
                               r_rows=r_rows).bases
    nb = ref.ntiles(k_cap, RICE_TILE)
    if bases.shape != (rows, nb + 1) or bases.dtype != torch.int32:
        raise ValueError(f"rice_pack_fitted: bases must be int32 [{rows}, "
                         f"{nb + 1}]")
    buf = torch.empty(rows * (cap_words + 1), dtype=torch.int32,
                      device=idx.device)
    words = buf[:rows * cap_words].view(rows, cap_words)
    header = buf[rows * cap_words:]
    _check(_lib().gspar_rice_pack_fitted(
        _ptr(idx), _ptr(nnz), rows, k_cap, _ptr(r_rows), _ptr(bases),
        cap_words, _rice_vec(idx), _ptr(words), _ptr(header), _stream(idx)),
        "rice_pack", "fitted")
    return words, header


def rice_fit_pack(idx: torch.Tensor, nnz: torch.Tensor, *, d: int,
                  window: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wire-format v4's packing of compact index streams: ``rice_fit``'s
    parameter of each row, then ``rice_pack_fitted`` at it from the tile
    bases the fit formed on the way: ``(words, header)``, bit-equal to
    ``compaction.rice_encode_fitted``. Three launches, no memset, from one
    host call (a ``rice_fit`` launch, a ``rice_pack`` and a
    ``rice_pack/fitted`` one)."""
    rs = _fit_window(tuple(window))
    cap_words = rice_fit_cap_words(idx.shape[1], d, window)
    if not _rice_on_card("rice_fit_pack", idx, nnz):
        r_rows, _ = ref.rice_fit_ref(idx, nnz, d, window)
        return ref.rice_pack_fitted_ref(idx, nnz, r_rows, d, window)
    rows, k_cap = idx.shape
    if k_cap < 1:
        raise ValueError("rice_fit_pack: k_cap must be at least 1")
    # one buffer: the fit's (tile sums, r, header, bases), then the words
    # and the header of the packing
    nf = rows * (5 * ref.ntiles(k_cap, RICE_TILE) + 3)
    buf = torch.empty(nf + rows * (cap_words + 1), dtype=torch.int32,
                      device=idx.device)
    words = buf[nf:nf + rows * cap_words].view(rows, cap_words)
    header = buf[nf + rows * cap_words:]
    _check(_lib().gspar_rice_fit_pack(
        idx.data_ptr(), nnz.data_ptr(), rows, k_cap, len(window), *rs,
        _rice_vec(idx), buf.data_ptr(), cap_words, words.data_ptr(),
        header.data_ptr(), _stream(idx)), "rice_fit")
    _check(0, "rice_pack", "fitted")
    return words, header


def _rice_on_card(name: str, idx: torch.Tensor, nnz: torch.Tensor,
                  *others: torch.Tensor) -> bool:
    """The checks of the Golomb-Rice wrappers: True on the card (launch),
    False on the CPU (the plain version); raises on what the kernels
    cannot take."""
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be an int32 [rows, k_cap] "
                         "tensor")
    if nnz.shape != idx.shape[:1] or nnz.dtype != torch.int32:
        raise ValueError(f"{name}: nnz must be int32 [rows]")
    if idx.device.type == "cpu":
        return False
    if idx.device.type != "cuda" or any(t.device != idx.device
                                        for t in (nnz,) + others):
        raise ValueError(f"{name}: no kernel for devices {idx.device}, "
                         f"{[str(t.device) for t in (nnz,) + others]}")
    if not all(t.is_contiguous() for t in (idx, nnz) + others):
        raise ValueError(f"{name}: inputs must be contiguous")
    if idx.shape[0] > 65535 or idx.shape[1] >= 2**31:
        raise ValueError(f"{name}: {list(idx.shape)} exceeds the grid")
    return True


def _rice_vec(idx: torch.Tensor) -> int:
    """16-byte idx loads: an aligned base and rows a multiple of 4 long."""
    return int(idx.data_ptr() % 16 == 0 and idx.shape[1] % 4 == 0)


def _rice_pack(idx: torch.Tensor, nnz: torch.Tensor, r: int,
               r_rows: torch.Tensor | None, cap_words: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    rows, k_cap = idx.shape
    # one buffer: the blocks' look-back status words and a ticket counter
    # per row (int64, as int32 pairs), the words, used; the launcher zeroes
    # the status words and the words with one memset
    ns = 2 * rows * (ref.ntiles(k_cap, RICE_TILE) + 1)
    buf = torch.empty(ns + rows * (cap_words + 1), dtype=torch.int32,
                      device=idx.device)
    words = buf[ns:ns + rows * cap_words].view(rows, cap_words)
    used = buf[ns + rows * cap_words:]
    _check(_lib().gspar_rice_pack(
        _ptr(idx), _ptr(nnz), rows, k_cap, r, _ptr(r_rows), cap_words,
        _rice_vec(idx), _ptr(buf), _ptr(words), _ptr(used), _stream(idx)),
        "rice_pack", None if r_rows is None else "fitted_legacy")
    return words, used


class RiceFit(NamedTuple):
    """``rice_fit_tiles``: each row's parameter ``r`` and header ``(r <<
    26) | used`` (int32 [rows]), and the quotient bases of its tiles of
    ``RICE_TILE`` codes at r (int32 [rows, ntiles(k_cap, RICE_TILE) + 1]:
    entry t the sum of ``(gap - 1) >> r`` over the codes before tile t, the
    last the row's total; ``ref.rice_tile_bases_ref``)."""
    r: torch.Tensor
    header: torch.Tensor
    bases: torch.Tensor


@functools.lru_cache(maxsize=64)
def _fit_window(window: tuple[int, ...]) -> tuple[int, int, int, int]:
    """The window as the kernels take it, four parameters (the last one
    repeated); raises unless it is 1-4 ascending parameters in [0, 30]."""
    if not 1 <= len(window) <= 4 or list(window) != sorted(set(window)) \
            or not 0 <= window[0] <= window[-1] <= 30:
        raise ValueError(f"rice_fit: window {window} is not 1-4 ascending "
                         "parameters in [0, 30]")
    return tuple(window) + (window[-1],) * (4 - len(window))


def rice_fit(idx: torch.Tensor, nnz: torch.Tensor, *, d: int,
             window: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """The data-fitted Golomb-Rice parameter of each row of pass 2's compact
    index stream (wire-format v4): ``(r [rows], header [rows])``, int32,
    the first minimum of the used words over the ascending ``window``,
    ``header = (r << 26) | used``; bit-equal to the choice of
    ``compaction.rice_encode_fitted``. Replaces the candidate sweep and
    argmin of XLA's ``rice_encode_fitted``
    (src/repro/comm/compaction.py:300-324): ``rice_fit_tiles``, whose tile
    bases it drops. Bound: one read of each row's live idx prefix (4 B per
    live code)."""
    fit = rice_fit_tiles(idx, nnz, d=d, window=window)
    return fit.r, fit.header


def rice_fit_tiles(idx: torch.Tensor, nnz: torch.Tensor, *, d: int,
                   window: tuple[int, ...],
                   r_rows: torch.Tensor | None = None) -> RiceFit:
    """``rice_fit`` with the quotient bases of each row's tiles at its r,
    which ``rice_pack_fitted`` packs from; given ``r_rows`` (int32 [rows],
    inside the window), each row at its own r in place of the fit's choice
    (counted as ``rice_fit/at_r``). Two launches, no memset: a block a
    tile of ``RICE_TILE`` codes reads its live codes once and stores its
    quotient sum at every candidate; then a block a row takes the first
    minimum and scans the sums at it into the bases. Bound: one read of
    each row's live idx prefix (4 B per live code)."""
    rs = _fit_window(tuple(window))
    extra = () if r_rows is None else (r_rows,)
    if r_rows is not None and (r_rows.shape != idx.shape[:1]
                               or r_rows.dtype != torch.int32):
        raise ValueError("rice_fit_tiles: r_rows must be int32 [rows]")
    on_card = _rice_on_card("rice_fit", idx, nnz, *extra)
    rice_fit_cap_words(idx.shape[1], d, window)      # raises past 2^26
    if not on_card:
        return RiceFit(*ref.rice_fit_tiles_ref(idx, nnz, d, window, RICE_TILE,
                                               r_rows=r_rows))
    rows, k_cap = idx.shape
    if k_cap < 1:
        raise ValueError("rice_fit: k_cap must be at least 1")
    nb = ref.ntiles(k_cap, RICE_TILE)
    # one buffer, as the launcher cuts it: the tiles' int4 sums, then r,
    # header and bases
    ns = rows * 4 * nb
    buf = torch.empty(ns + rows * (nb + 3), dtype=torch.int32,
                      device=idx.device)
    _check(_lib().gspar_rice_fit(
        idx.data_ptr(), nnz.data_ptr(), rows, k_cap, len(window), *rs,
        _ptr(r_rows), _rice_vec(idx), buf.data_ptr(), _stream(idx)),
        "rice_fit", None if r_rows is None else "at_r")
    return RiceFit(buf[ns:ns + rows], buf[ns + rows:ns + 2 * rows],
                   buf[ns + 2 * rows:].view(rows, nb + 1))


def rice_fit_legacy(idx: torch.Tensor, nnz: torch.Tensor, *, d: int,
                    window: tuple[int, ...]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rice_fit`` by wire-format v4's first route (a memset, the block
    reduction with 64-bit atomics, a one-thread-a-row finish), kept only
    as the yardstick ``chip_smoke.py`` times beside ``rice_fit_tiles``;
    counted as ``rice_fit/legacy``."""
    rs = _fit_window(tuple(window))
    if not _rice_on_card("rice_fit", idx, nnz):
        return ref.rice_fit_ref(idx, nnz, d, window)
    rows, k_cap = idx.shape
    acc = torch.empty((rows, 4), dtype=torch.int64, device=idx.device)
    out = torch.empty((2, rows), dtype=torch.int32, device=idx.device)
    _check(_lib().gspar_rice_fit_legacy(
        _ptr(idx), _ptr(nnz), rows, k_cap, len(window), *rs, _rice_vec(idx),
        _ptr(acc), _ptr(out[0]), _ptr(out[1]), _stream(idx)), "rice_fit",
        "legacy")
    return out[0], out[1]


def rice_pack_fitted_legacy(idx: torch.Tensor, nnz: torch.Tensor,
                            r_rows: torch.Tensor, *, d: int,
                            window: tuple[int, ...]
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rice_pack_fitted`` by wire-format v4's first route (the static
    ``rice_pack``'s chained scan with look-back, at a per-row r, after a
    memset of its status words and the words), kept only as the yardstick
    ``chip_smoke.py`` times beside the redesign; counted as
    ``rice_pack/fitted_legacy``."""
    if r_rows.shape != idx.shape[:1] or r_rows.dtype != torch.int32:
        raise ValueError("rice_pack_fitted: r_rows must be int32 [rows]")
    cap_words = rice_fit_cap_words(idx.shape[1], d, window)
    if not _rice_on_card("rice_pack_fitted", idx, nnz, r_rows):
        return ref.rice_pack_fitted_ref(idx, nnz, r_rows, d, window)
    return _rice_pack(idx, nnz, 0, r_rows, cap_words)


def stats(g: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sum|g|, sum g^2, max|g|)`` per row, float32 — lambda_0, the
    saturation gate and the variance ratio's denominator on the dense wire.
    sum|g| and max|g| are ``stats_l1max``'s bit for bit (one CUDA body).
    Replaces ``stats_2d`` (src/repro/kernels/sparsify/kernel.py:239).
    Bound: one read of g (2 B/coord in bf16)."""
    if not _on_card("stats", g):
        return ref.stats_ref(g)
    rows, d = g.shape
    nt = ref.ntiles(d, TILE)
    f32 = dict(dtype=torch.float32, device=g.device)
    f64 = dict(dtype=torch.float64, device=g.device)
    psum, psq = torch.empty((rows, nt), **f64), torch.empty((rows, nt), **f64)
    pmax = torch.empty((rows, nt), **f32)
    l1, l2, mx = (torch.empty(rows, **f32) for _ in range(3))
    _check(_lib().gspar_stats(
        _ptr(g), _DTYPE_CODE[g.dtype], rows, d, _vec(g), _ptr(psum),
        _ptr(psq), _ptr(pmax), _ptr(l1), _ptr(l2), _ptr(mx), _stream(g)),
        "stats")
    return l1, l2, mx


def _dense_q(name: str, g: torch.Tensor, u: torch.Tensor | None,
             s1: torch.Tensor | None, out_dtype, ef: bool, seed: int | None,
             out: torch.Tensor | None, pkind: str = "lam",
             s2: torch.Tensor | None = None,
             budget: torch.Tensor | None = None,
             tie_base: torch.Tensor | None = None, codec=None,
             scale: torch.Tensor | None = None,
             u_cod: torch.Tensor | None = None,
             den: torch.Tensor | None = None) -> Sparsified:
    """Kernels 5, 6 and 8 behind one C entry: Q of ``g [rows, d]`` for the
    selector kind ``pkind`` in ``out_dtype`` (written into ``out`` when
    given), with ``ef`` the residual, with ``seed`` the Philox uniforms in
    place of ``u``, with an integer ``codec`` the decoded levels. ``den``,
    the rows' sum g^2 from an earlier pass, is passed through; without it
    the pass reduces sum g^2 itself (kernel 8 never does)."""
    if pkind not in DENSE_KINDS:
        raise ValueError(f"{name}: unknown select kind {pkind!r}; have "
                         f"{DENSE_KINDS}")
    integer = codec is not None and codec.integer_coded
    out_dtype = out_dtype or g.dtype
    if out_dtype not in ((g.dtype,) if integer else (g.dtype,
                                                     torch.bfloat16)):
        raise ValueError(f"{name}: wire dtype {out_dtype} for g {g.dtype}; "
                         "have g's own or bfloat16 (an integer codec: g's)")
    rows = g.shape[0]
    kind = dict(pkind=pkind)
    if pkind == "one":
        s1 = None
    else:
        s1, s2, budget = _kind_scalars(name, g, pkind, s1, s2, budget)
        kind.update(s2=s2, budget=budget)
    u = None if seed is not None or pkind == "one" else _uniforms(
        name, g, u, pkind)
    if pkind == "topk" and (tie_base is None or tie_base.dtype != torch.int32
                            or tie_base.shape != (rows, ref.ntiles(
                                g.shape[1], TILE))):
        raise ValueError(f"{name}: topk needs pass 1's int32 tie_base "
                         "[rows, tiles]")
    if integer:
        if scale is None or u_cod is None or u_cod.shape != g.shape \
                or u_cod.dtype != torch.float32:
            raise ValueError(f"{name}: an integer codec needs scale [rows] "
                             "and float32 u_cod shaped like g")
        scale = scale.to(torch.float32).expand(rows).contiguous()
        kind.update(codec=codec, scale=scale, u_cod=u_cod)
    else:
        scale = u_cod = None
    if out is not None and (out.shape != g.shape or out.dtype != out_dtype
                            or out.device != g.device):
        raise ValueError(f"{name}: out must be {out_dtype} shaped like g")
    if den is not None and (den.shape != (rows,) or den.dtype != torch.float32
                            or seed is not None):
        raise ValueError(f"{name}: den must be float32 [rows] (none with "
                         "the Philox uniforms)")
    kind.update(den=den)
    extra = [t for t in (s1, u, s2, budget, tie_base, scale, u_cod, out, den)
             if t is not None]
    if not _on_card(name, g, *extra):
        if seed is not None:
            r = ref.sparsify_prng_ref(g, s1, seed)
        else:
            r = (ref.sparsify_ef_ref if ef else ref.sparsify_ref)(
                g, u, s1, out_dtype, **kind)
        if out is not None:
            out.copy_(r.q)
            r = r._replace(q=out)
        return r
    d = g.shape[1]
    dev = g.device
    nt = ref.ntiles(d, TILE)
    q = out if out is not None else torch.empty(g.shape, dtype=out_dtype,
                                                device=dev)
    res = torch.empty_like(g) if ef else None
    pcnt = torch.empty((rows, nt), dtype=torch.int32, device=dev)
    psure = torch.empty_like(pcnt)
    psq = torch.empty((rows, nt), dtype=torch.float64, device=dev)
    nnz = torch.empty(rows, dtype=torch.int64, device=dev)
    n_sure = torch.empty_like(nnz)
    sum_sq = torch.empty(rows, dtype=torch.float32, device=dev)
    reduce_den = den is None and seed is None
    pden = torch.empty_like(psq) if reduce_den else None
    den_out = torch.empty_like(sum_sq) if reduce_den else None
    vec = int(all(_vec(t) for t in (g, q, *(t for t in (u, res, u_cod)
                                            if t is not None))))
    _check(_lib().gspar_sparsify(
        _ptr(g), _DTYPE_CODE[g.dtype], _ptr(u), rows, d, vec,
        DENSE_KINDS.index(pkind), _ptr(s1), _ptr(s2), _ptr(budget),
        _ptr(tie_base), int(seed is not None), (seed or 0) & 0xFFFFFFFF,
        int(integer), _ptr(scale), _ptr(u_cod),
        float(getattr(codec, "levels", 0.0)),
        int(codec is not None and codec.name == "ternary"), _ptr(q),
        _DTYPE_CODE[out_dtype], _ptr(res), _ptr(pcnt), _ptr(psure),
        _ptr(psq), _ptr(pden), _ptr(nnz), _ptr(n_sure), _ptr(sum_sq),
        _ptr(den_out), _stream(g)), name,
        None if seed is not None else
        pkind + (f"+{codec.name}" if integer else ""))
    return Sparsified(q, res, nnz, n_sure, sum_sq,
                      den_out if reduce_den else den)


def sparsify(g: torch.Tensor, u: torch.Tensor | None,
             s1: torch.Tensor | None, out_dtype=None, *,
             out: torch.Tensor | None = None, **kind) -> Sparsified:
    """Dense ``Q = [u < p] g / p`` in dense layout, p the keep probability
    of the selector kind (``pkind``: ``lam`` p = min(s1[row] |g|, 1) by
    default, ``rho``, ``bern`` with ``s2`` = max|g|, ``topk`` with
    ``budget`` and pass 1's ``tie_base``, ``one``: the identity, Q = g),
    with v rounded to g's dtype and then to ``out_dtype`` (the wire dtype:
    g's or bfloat16), or with an integer ``codec`` (``scale [rows]``,
    ``u_cod`` shaped like g) the decoded levels in g's dtype; per row the
    nonzeros of Q, those with p = 1, sum Q^2 and sum g^2
    (``ref.Sparsified``; ``den``, sum g^2 from an earlier pass, is passed
    through instead of reduced). Launches count per variant
    (``"sparsify/rho+qsgd8"``). Replaces ``sparsify_2d``
    (src/repro/kernels/sparsify/kernel.py:96), which takes lam and a float
    wire dtype. Bound: one read of g and u (and u_cod), one write of Q (8
    B/coord with bf16 g and Q and a sampling kind; 12 with an integer
    codec; 4 for topk and identity)."""
    return _dense_q("sparsify", g, u, s1, out_dtype, False, None, out,
                    **kind)


def sparsify_ef(g: torch.Tensor, u: torch.Tensor | None,
                s1: torch.Tensor | None, out_dtype=None, *,
                out: torch.Tensor | None = None, **kind) -> Sparsified:
    """``sparsify`` plus the EF residual ``g - float32(Q)`` after the wire
    rounding (or the decode), in g's dtype, from the same pass. Replaces
    ``sparsify_ef_2d`` (src/repro/kernels/sparsify/kernel.py:123). Bound:
    ``sparsify``'s bytes plus one write of the residual (10 B/coord in
    bf16 with a sampling kind and a float codec)."""
    return _dense_q("sparsify_ef", g, u, s1, out_dtype, True, None, out,
                    **kind)


def sparsify_prng(g: torch.Tensor, lam: torch.Tensor, seed: int
                  ) -> Sparsified:
    """``sparsify`` with the uniforms from Philox4x32-10 in the kernel
    (``ref.philox_uniforms``: key (seed, 0), counter (coordinate / 4, row,
    0, 0)) instead of an input buffer; Q in g's dtype. Its stream is not
    the TPU's on-core one (that one is seeded per tile). Replaces
    ``sparsify_prng_2d`` (src/repro/kernels/sparsify/kernel.py:157).
    Bound: one read of g, one write of Q (4 B/coord in bf16)."""
    return _dense_q("sparsify_prng", g, None, lam, g.dtype, False, seed,
                    None)


def philox4x32_10(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Kernel 8's generator on its own: Philox4x32-10 of the counters
    ``ctr [n, 4]`` under the keys ``key [n, 2]`` (int64 holding uint32
    words) -> ``[n, 4]`` int64 words. CPU tensors take
    ``ref.philox4x32_10_ref``. Counts no launch: it serves the
    generator's known-answer test."""
    if ctr.device.type == "cpu":
        return torch.cat([ref.philox4x32_10_ref(
            ctr[j:j + 1], (int(key[j, 0]), int(key[j, 1])))
            for j in range(ctr.shape[0])])
    ck = torch.cat([ctr, key], 1).to(torch.int64) & 0xFFFFFFFF
    ck = torch.where(ck >= 2**31, ck - 2**32, ck).to(torch.int32).contiguous()
    out = torch.empty((ctr.shape[0], 4), dtype=torch.int32, device=ctr.device)
    err = _lib().gspar_philox(_ptr(ck), _ptr(out), ctr.shape[0], _stream(ck))
    if err != 0:
        raise RuntimeError(f"philox: CUDA launch failed: "
                           f"{_lib().gspar_error_string(err).decode()}")
    return out.to(torch.int64) & 0xFFFFFFFF
