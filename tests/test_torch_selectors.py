"""The paper's baselines and the integer codecs in the port against the JAX
package, on the same numpy inputs (the gradient, the selector's uniforms
``u`` and the codec's uniforms ``u_cod``) and with the JAX package's
scalars (lambda, rho, max|g|, the topk threshold and tie budget, the codec
scale):

- kernels 3-4 for every selector kind (lam, rho, bern, topk) x codec (f32,
  bf16, qsgd4, qsgd8, ternary): the port's plain versions (the CPU path of
  its wrappers) against the Pallas kernels in interpret mode. Counts, kept
  coordinates, values (the integer levels) and the float codecs' fused
  residual bit-equal; sums within rtol 1e-6 (float64 sums rounded once
  here, tile-order float32 sums on the JAX side);
- topk's tie budget, on a row whose threshold ties straddle both packages'
  tiles, and past 2^24 coordinates, where the JAX package's float32 budget
  is inexact (ROADMAP.md queue C);
- the integer codecs' EF residual against the contract ``g.at[idx].add(
  -decoded)`` computed in numpy (not against the JAX package's output, see
  ROADMAP.md queue C);
- the backend and ``compress_tree_sparse`` for unisp, topk+ternary,
  gspar+qsgd8 and terngrad, with the JAX package's accounting;
- ``sync_tree`` over two gloo ranks with per-worker scales: bit-equal to a
  numpy worker-major decode, at the JAX package's wire bytes.
"""
import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.comm import compaction as jcompaction
from repro.comm import wire_layout as jwire_layout
from repro.core import codecs as jcodecs
from repro.core import coding as jcoding
from repro.core.api import CompressionConfig as JConfig
from repro.core.sparse import PallasBackend
from repro.kernels.sparsify import kernel as JK
from repro.kernels.sparsify import ops as jops
from repro_torch.comm.compaction import capacity_for
from repro_torch.core import codecs as tcodecs
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.api import compress_tree_sparse
from repro_torch.core.grouping import plan_tree
from repro_torch.core.sparse import KernelBackend
from repro_torch.kernels.sparsify import kernel as TK
from repro_torch.kernels.sparsify import ops as tops
from repro_torch.kernels.sparsify import ref as tref

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, D, RHO = 2, 70_000, 0.05          # 2 TPU tiles and 5 CUDA tiles a row
K_CAP = capacity_for(D, RHO)
K_TARGET = max(1, int(round(RHO * D)))
SUM_RTOL = 1e-6
PKINDS = tref.PKINDS
CODECS = tcodecs.CODEC_NAMES
# every kind with every codec at the configured capacity; an overflowing
# capacity once per kind (the cut does not depend on the codec)
CASES = ([(p, c, K_CAP) for p in PKINDS for c in CODECS]
         + [(p, "f32", 512) for p in PKINDS])


def _inputs():
    """A bf16 gradient group (the main path's leaf dtype), both kinds of
    uniforms, as numpy arrays."""
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((ROWS, D))
         * np.exp(rng.standard_normal((ROWS, D)))).astype(np.float32)
    g = g.astype(ml_dtypes.bfloat16)
    return (g, rng.random((ROWS, D), dtype=np.float32),
            rng.random((ROWS, K_CAP), dtype=np.float32))


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x) -> np.ndarray:
    """Bit pattern of a torch or numpy array, for bit-equality checks."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.kind == "i":
        return a
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _jax_scalars(pkind, g, n):
    """The per-row scalars the JAX emit ops hand the kernels (ops.py:
    unisp_emit, bern_emit, topk_emit; lam: Algorithm 3's first lambda)."""
    g2d, _, _, _ = jops._pad_2d(g)
    l1, mx = JK.stats_l1max_2d(g2d, interpret=True)
    zero = jnp.float32(0)
    if pkind == "lam":
        return jops.greedy_lambda(l1, mx, RHO, n), zero
    if pkind == "rho":
        return jnp.float32(RHO), zero
    if pkind == "bern":
        return zero, mx
    topv = jax.lax.top_k(jnp.abs(g.astype(jnp.float32)), K_TARGET)[0]
    t = topv[-1]
    return t, (jnp.float32(K_TARGET)
               - jnp.count_nonzero(topv > t).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_rows(pkind: str, codec_name: str, k_cap: int):
    """Passes 1 and 2 of the Pallas kernels in interpret mode, rows
    vmapped: the scalars, the select statistics, the codec scale, the
    compact buffers and (float codecs) the fused residual."""
    codec = jcodecs.get(codec_name)
    g, u, uc = _inputs()

    def one(g, u, ucod):
        g2d, n, _, _ = jops._pad_2d(g)
        u2d = g2d if pkind == "topk" else jops._pad_2d(u)[0]
        s1, s2 = _jax_scalars(pkind, g, n)
        sel = JK.select_stats_2d(g2d, u2d, s1, s2, k_cap=k_cap, pkind=pkind,
                                 interpret=True)
        scale = jcodecs.finalize_scale(codec, sel[4], sel[5])
        ef = not codec.integer_coded
        vals, idx, _, _, res = JK.compact_emit_2d(
            g2d, u2d, s1, s2, scale, ucod[:k_cap], pkind=pkind, codec=codec,
            out_dtype=codec.wire_dtype(g.dtype), k_cap=k_cap, d=n, ef=ef,
            interpret=True)
        return dict(s1=s1, s2=s2, sel=sel, scale=scale, values=vals, idx=idx,
                    residual=res.reshape(-1)[:n] if ef else jnp.zeros(()))

    out = jax.jit(jax.vmap(one))(jnp.asarray(g), jnp.asarray(u),
                                 jnp.asarray(uc))
    return jax.tree.map(np.asarray, out)


def _port_scalars(pkind, want):
    """The JAX scalars in the port's form: s1/s2 float32 per row, topk's
    budget int64 (exact below 2^24)."""
    kw = dict(pkind=pkind)
    if pkind == "bern":
        kw["s2"] = torch.from_numpy(want["s2"].copy())
    if pkind == "topk":
        kw["budget"] = torch.from_numpy(want["s2"].astype(np.int64))
    return torch.from_numpy(want["s1"].copy()), kw


def _close(got: torch.Tensor, want, rtol=SUM_RTOL):
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


@pytest.mark.parametrize("pkind,codec,k_cap", CASES)
def test_select_stats_matches_pallas(pkind, codec, k_cap):
    g, u, _ = _inputs()
    want = _jax_rows(pkind, codec, k_cap)
    s1, kw = _port_scalars(pkind, want)
    uu = None if pkind == "topk" else _torch(u)
    st = TK.select_stats(_torch(g), uu, s1, k_cap, **kw)
    cnt, nzc, psum, den, vsq, vmx = want["sel"]
    np.testing.assert_array_equal(st.nnz.numpy(), cnt)
    np.testing.assert_array_equal(st.nonzeros.numpy(), nzc)
    _close(st.p_sum, psum)
    _close(st.den, den)
    _close(st.sum_sq, vsq)
    np.testing.assert_array_equal(st.max_abs.numpy(), vmx)
    assert (st.tie_base is not None) == (pkind == "topk")
    if k_cap < K_CAP:
        assert (cnt > k_cap).all()       # the capacity cut is exercised
    if pkind == "topk":
        assert (cnt == K_TARGET).all()


@pytest.mark.parametrize("pkind,codec,k_cap", CASES)
def test_compact_emit_matches_pallas(pkind, codec, k_cap):
    """Values (the integer levels, with the JAX scale and the codec
    uniforms at compact rank) and ascending idx with zero padding, and for
    the float codecs the fused EF residual, bit-equal to the Pallas
    kernel's."""
    g, u, uc = _inputs()
    want = _jax_rows(pkind, codec, k_cap)
    s1, kw = _port_scalars(pkind, want)
    uu = None if pkind == "topk" else _torch(u)
    tg = _torch(g)
    c = tcodecs.get(codec)
    st = TK.select_stats(tg, uu, s1, k_cap, **kw)
    vals, idx, res = TK.compact_emit(
        tg, uu, s1, st, k_cap=k_cap, codec=c, ef=not c.integer_coded,
        scale=torch.from_numpy(want["scale"].copy()),
        u_cod=torch.from_numpy(uc[:, :k_cap]).contiguous(), **kw)
    assert vals.dtype == c.wire_dtype(tg.dtype)
    np.testing.assert_array_equal(_bits(vals), _bits(want["values"]))
    np.testing.assert_array_equal(idx.numpy(), want["idx"])
    if c.integer_coded:
        assert res is None
        assert np.abs(want["values"]).max() > 0
    else:
        np.testing.assert_array_equal(_bits(res), _bits(want["residual"]))


def _tie_row(d: int, ties, n_above: int, sign_flip: bool):
    g = np.zeros(d, ml_dtypes.bfloat16)
    g[:n_above] = 8.0
    g[ties] = -2.0
    if sign_flip:
        g[ties[::2]] = 2.0
    return g


def test_topk_tie_budget_straddles_the_tiles():
    """A bf16 group whose threshold ties run across the port's tile edges
    (16384) and the TPU's (65536), with a budget that cuts inside a tile:
    the port keeps exactly the coordinates of XLA's ``lax.top_k`` (lowest
    index first among ties), as the Pallas kernel does, with the same
    threshold and budget. A third row has fewer nonzeros than k: its
    threshold is 0, which ties nothing, and every nonzero is kept."""
    d, k = 3 * 65536 + 11, 9000
    ties = np.arange(65536 - 9000, 2 * 65536 + 4000, 5)
    sparse = np.zeros(d, ml_dtypes.bfloat16)
    sparse[70_000:70_050] = -3.0
    g = np.stack([_tie_row(d, ties, 1000, False),
                  _tie_row(d, ties, 1000, True), sparse])
    tg = _torch(g)
    t, budget = tops.topk_threshold(tg, k)
    jg = jnp.asarray(g)
    topv, topi = jax.lax.top_k(jnp.abs(jg.astype(jnp.float32)), k)
    assert np.array_equal(t.numpy(), np.asarray(topv[:, -1]))
    assert t.tolist() == [2.0, 2.0, 0.0]
    jbudget = k - np.count_nonzero(np.asarray(topv) > np.asarray(
        topv[:, -1:]), axis=1)
    assert np.array_equal(budget.numpy(), jbudget)
    er = tops.topk_emit(tg, k_cap=10240, k_target=k)
    jer = jax.vmap(functools.partial(jops.topk_emit, k_cap=10240, k_target=k,
                                     interpret=True))(jg)
    np.testing.assert_array_equal(er.idx.numpy(), np.asarray(jer.idx))
    np.testing.assert_array_equal(_bits(er.values), _bits(jer.values))
    np.testing.assert_array_equal(er.nnz.numpy(), np.asarray(jer.nnz))
    for r in range(2):
        assert int(er.nnz[r]) == k
        kept = er.idx[r, :k].numpy()
        assert np.array_equal(kept, np.sort(np.asarray(topi[r])))
        assert kept[-1] == ties[k - 1000 - 1]      # the cut inside a tile
    assert int(er.nnz[2]) == 50
    assert np.array_equal(er.idx[2, :50].numpy(), np.arange(70_000, 70_050))


def test_topk_budget_stays_exact_past_2_24():
    """Past 2^24 coordinates the JAX package's float32 budget
    (``f32(k_target) - f32(count)``, ops.py:268-271) rounds; the port's is
    an integer, so it keeps exactly k_target. One row of 2^24 + 5
    coordinates, all ties but the last: budget 2^24 + 3, which float32
    rounds to 2^24 + 4."""
    d, k = 2**24 + 5, 2**24 + 3
    g = torch.ones((1, d), dtype=torch.bfloat16)
    g[0, -1] = 0.0
    t, budget = tops.topk_threshold(g, k)
    assert float(t[0]) == 1.0 and int(budget[0]) == k
    assert int(np.float32(k) - np.float32(0)) == k + 1     # the reference
    st = tref.select_stats_ref(g, None, t, k, TK.TILE, pkind="topk",
                               budget=budget)
    assert int(st.nnz[0]) == k
    assert int(st.tie_base[0, -1]) == TK.TILE * (st.base.shape[1] - 1)


def _np_residual(g: np.ndarray, vals: np.ndarray, idx: np.ndarray,
                 scale: np.ndarray, codec) -> np.ndarray:
    """The JAX package's contract for the integer codecs' EF residual
    (sparse.py:165-186), in numpy: ``g.at[idx].add(-decoded.astype(
    g.dtype))`` over every slot of every row, the padding included, with
    ``decoded = level * (scale / s)`` (qsgd) or ``level * scale``."""
    out = g.astype(np.float32).copy()
    for r in range(g.shape[0]):
        if codec.name == "ternary":
            dec = vals[r].astype(np.float32) * np.float32(scale[r])
        else:
            dec = vals[r].astype(np.float32) * (
                np.float32(scale[r]) / np.float32(codec.levels))
        neg = -(dec.astype(g.dtype).astype(np.float32))
        row = out[r]
        for j in range(vals.shape[1]):     # sequential: g's dtype each add
            i = idx[r, j]
            row[i] = np.float32(g.dtype.type(row[i] + neg[j]))
    return out.astype(g.dtype)


@pytest.mark.parametrize("name", ["gspar+qsgd8", "topk+ternary", "terngrad"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_integer_codec_residual_is_the_scatter_contract(name, dtype):
    """The backend's EF residual for an integer codec equals the numpy
    scatter contract bit for bit; only the live slots are scattered, the
    padding slots (idx 0, value 0) change nothing."""
    g, u, _ = _inputs()
    d = 3000
    g = g[:, :d].astype({"bfloat16": ml_dtypes.bfloat16,
                         "float32": np.float32}[dtype])
    cfg = TConfig(name=name, rho=RHO, error_feedback=True, wire="gather")
    k_cap = cfg.capacity(d)
    gen = np.random.default_rng(9)
    uc = torch.from_numpy(gen.random((ROWS, k_cap), dtype=np.float32))
    uu = None if name.startswith("topk") else torch.from_numpy(
        np.ascontiguousarray(u[:, :d]))
    sg, res = KernelBackend().compress_sparse_ef(cfg, uu, _torch(g), k_cap,
                                                 uc)
    assert (sg.nnz < k_cap).any() or name == "terngrad"
    want = _np_residual(g, sg.values.numpy(), sg.idx.numpy(),
                        sg.scale.numpy(), cfg.scheme().codec)
    np.testing.assert_array_equal(_bits(res), _bits(want))


PIPELINES = ("unisp", "topk+ternary", "gspar+qsgd8", "terngrad")


def _jax_emit(name, g, u, uc, k_cap, rice_r):
    """The JAX backend's emit for one composition, rows vmapped, fed the
    same uniforms (PallasBackend._emit without its key draws)."""
    scheme = JConfig(name=name, rho=RHO, wire="gather").scheme()
    sel, codec = scheme.selector, scheme.codec
    kw = dict(k_cap=k_cap, codec=codec, rice_r=rice_r, interpret=True)
    ucod = uc if codec.stochastic else None
    if sel.name == "topk":
        f = lambda g, u, c: (jops.topk_emit(                  # noqa: E731
            g, c, k_target=sel.k_target(g.size), **kw), None)
    elif sel.name == "gspar":
        f = lambda g, u, c: jops.gspar_emit(g, u, c, rho=RHO, **kw)  # noqa
    elif sel.name == "unisp":
        f = lambda g, u, c: (jops.unisp_emit(g, u, c, rho=RHO, **kw),  # noqa
                             None)
    else:
        f = lambda g, u, c: jops.bern_emit(g, u, c, **kw)     # noqa: E731
    er, s = jax.vmap(f)(jnp.asarray(g), jnp.asarray(u),
                        None if ucod is None else jnp.asarray(ucod))
    return scheme, er, s


@pytest.mark.parametrize("name", PIPELINES)
def test_backend_matches_jax_backend(name):
    """The whole emit on the default ``auto`` layout with the same
    uniforms: the same layout and RICE words, compact buffers and counts
    bit-equal (gspar: lambda within rtol 1e-6 and the same kept set but for
    draws within 1e-6 of their keep probability), and the JAX backend's
    per-row accounting (``PallasBackend._finish``) within rtol 1e-6."""
    g, u, uc = _inputs()
    cfg = TConfig(name=name, rho=RHO, wire="gather")
    k_cap = cfg.capacity(D)
    gen = np.random.default_rng(5)
    uc = gen.random((ROWS, k_cap), dtype=np.float32)
    scheme = cfg.scheme()
    uu = None if scheme.selector.name == "topk" else _torch(u)
    sg = KernelBackend().compress_sparse(cfg, uu, _torch(g), k_cap,
                                         torch.from_numpy(uc))
    r = jcoding.rice_parameter(k_cap, D) if sg.layout == "rice" else -1
    jscheme, er, s = _jax_emit(name, g, u, uc, k_cap, r)
    layout = {"terngrad": "dense"}.get(name, "rice")
    assert sg.layout == layout
    backend = PallasBackend(interpret=True)
    if name.startswith("gspar"):
        lam = tops.gspar_emit(_torch(g), _torch(u), torch.from_numpy(uc),
                              k_cap=k_cap, rho=RHO, codec=scheme.codec)[1]
        _close(lam, s)
        for row in range(ROWS):
            kept = set(sg.idx[row, :int(sg.nnz[row])].tolist())
            jkept = set(np.asarray(er.idx[row, :int(er.nnz[row])]).tolist())
            p = np.minimum(np.asarray(s)[row]
                           * np.abs(g[row].astype(np.float32)), 1.0)
            assert all(abs(u[row, i] - p[i]) < 1e-6 for i in kept ^ jkept)
    for row in range(ROWS):
        er_r = jax.tree.map(lambda x: x[row], er)
        want = backend._finish(jscheme, jnp.asarray(g[row]), er_r, layout,
                               None if s is None else s[row])
        if not name.startswith("gspar") or np.array_equal(
                sg.idx[row].numpy(), np.asarray(want.idx)):
            np.testing.assert_array_equal(_bits(sg.values[row]),
                                          _bits(want.values))
            np.testing.assert_array_equal(sg.idx[row].numpy(), want.idx)
            assert int(sg.nnz[row]) == int(want.nnz)
            if layout == "rice":
                np.testing.assert_array_equal(sg.rice_words[row].numpy(),
                                              np.asarray(want.rice_words))
        for f in ("bits", "var_ratio", "p_sum", "scale"):
            _close(getattr(sg, f)[row], getattr(want, f))


def test_compress_tree_sparse_draws_per_selector_and_codec():
    """``compress_tree_sparse`` draws the selector's ``[rows, d]`` uniforms
    (none for topk) and then the codec's ``[rows, k_cap]`` from one
    generator, group by group, and hands them to the backend: its items are
    the backend's output on the stacked groups, with error feedback."""
    rng = np.random.default_rng(1)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in [(3, 2000), (5000,), (2, 2000)]]
    stacked = [True, False, True]
    residual = [torch.full_like(x, 0.01) for x in leaves]
    for name in PIPELINES:
        cfg = TConfig(name=name, rho=RHO, error_feedback=True,
                      min_leaf_size=256, wire="gather")
        scheme = cfg.scheme()
        items, new_res, stats = compress_tree_sparse(
            cfg, torch.Generator().manual_seed(4), leaves, stacked=stacked,
            residual=residual)
        gen = torch.Generator().manual_seed(4)
        plan = plan_tree(cfg, leaves, stacked)
        for grp, (kind, sg, members) in zip(plan.groups, items):
            assert kind == "sparse" and members == grp.members
            stack = torch.cat([(leaves[i] + residual[i]).reshape(n, grp.d)
                               for i, n in grp.members])
            u = (None if scheme.selector.name == "topk" else
                 torch.rand((grp.rows, grp.d), generator=gen))
            uc = (torch.rand((grp.rows, grp.k_cap), generator=gen)
                  if scheme.codec.stochastic else None)
            want, want_res = KernelBackend().compress_sparse_ef(
                cfg, u, stack, grp.k_cap, uc)
            assert torch.equal(sg.values, want.values)
            assert torch.equal(sg.idx, want.idx)
            r0 = 0
            for i, n in grp.members:
                assert torch.equal(new_res[i].reshape(n, grp.d),
                                   want_res[r0:r0 + n])
                r0 += n
        assert float(stats.density) > 0


SYNC_SHAPES = [(4, 3000), (5000,), (64,), (3, 700), (2, 200)]
SYNC_STACKED = [True, False, False, True, True]
SYNC_CASES = [(n, "auto") for n in PIPELINES] + [
    (n, lay) for n in ("gspar+qsgd8", "topk+ternary")
    for lay in ("coo", "bitmap", "dense", "rice")]

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.comm import sync
from repro_torch.core import api

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shapes, stacked = eval(sys.argv[4]), eval(sys.argv[5])
cases = eval(sys.argv[6])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
rng = np.random.default_rng(100 + rank)
leaves = [torch.from_numpy((rng.standard_normal(s)
                            * np.exp(rng.standard_normal(s))
                            ).astype(np.float32)) for s in shapes]
results = {}
for name, layout in cases:
    cfg = api.CompressionConfig(name=name, rho=0.1, min_leaf_size=256,
                                wire="gather", wire_layout=layout)
    items, _, _ = api.compress_tree_sparse(
        cfg, torch.Generator().manual_seed(7 + rank), leaves, stacked=stacked)
    synced, _, stats = sync.sync_tree(
        cfg, torch.Generator().manual_seed(7 + rank), leaves, stacked=stacked)
    results[(name, layout)] = {
        "items": [(k, (p.values, p.idx, p.d, p.nnz, p.layout, p.scale)
                   if k == "sparse" else p, m) for k, p, m in items],
        "synced": synced, "wire": float(stats.wire_bytes)}
torch.save(results, out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_codecs")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), outs[r],
         repr(SYNC_SHAPES), repr(SYNC_STACKED), repr(SYNC_CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(o, weights_only=False) for o in outs]


def _np_decode(vals: torch.Tensor, scale: float, codec) -> np.ndarray:
    v = vals.numpy().astype(np.float32)
    if codec.name == "ternary":
        return v * np.float32(scale)
    if codec.integer_coded:
        return v * (np.float32(scale) / np.float32(codec.levels))
    return v


def _np_wire(items, codec) -> int:
    """The JAX package's wire bytes for one rank's items (sync.py)."""
    wire = 0
    for kind, payload, _ in items:
        if kind == "dense":
            wire += payload.numel() * 4
            continue
        vals, idx, d, nnz, lay, _ = payload
        rows, k_cap = vals.shape
        vb = vals.element_size()
        wire += rows * 4 if codec.has_scale else 0
        if lay == "dense":
            wire += rows * d * vb
        elif lay == "coo":
            wire += rows * k_cap * (vb + 4)
        elif lay == "bitmap":
            wire += rows * (k_cap * vb + jcompaction.bitmap_words(d) * 4)
        else:
            wire += rows * (k_cap * vb + 4) + 4 * sum(
                jcoding.rice_stream_words(
                    idx[r, :min(int(nnz[r]), k_cap)].numpy(), k_cap, d)
                for r in range(rows))
    return wire


@pytest.mark.parametrize("case", SYNC_CASES, ids=lambda c: "-".join(c))
def test_sync_decodes_each_worker_with_its_scale(two_ranks, case):
    """Every rank's synced leaves equal a numpy scatter-add of both ranks'
    decoded buffers in worker order (each row decoded with its sender's
    scale), divided by two, bit for bit; and each rank's wire bytes are the
    JAX package's accounting: value slots at the wire dtype's width, the
    layout's index words (RICE: counts and realized words), 4 bytes of
    scale per row, 4 per dense-passthrough element."""
    name, layout = case
    codec = TConfig(name=name, wire="gather").scheme().codec
    per_rank = [r[case]["items"] for r in two_ranks]
    want = [None] * len(SYNC_SHAPES)
    for e, (kind, payload, members) in enumerate(per_rank[0]):
        if kind == "dense":
            flat = (per_rank[0][e][1].numpy() + per_rank[1][e][1].numpy()) / 2
            off = 0
            for i, n in members:
                want[i] = flat[off:off + n].reshape(SYNC_SHAPES[i])
                off += n
            continue
        vals, _, d, _, lay, _ = payload
        rows = vals.shape[0]
        assert lay == layout or layout == "auto"
        dense = np.zeros((rows, d), np.float32)
        for w in range(2):                     # worker-major order
            v, ix, _, _, _, sc = per_rank[w][e][1]
            for r in range(rows):
                np.add.at(dense[r], ix[r].numpy(),
                          _np_decode(v[r], float(sc[r]), codec))
        dense = dense / np.float32(2)
        r0 = 0
        for i, n in members:
            want[i] = dense[r0:r0 + n].reshape(SYNC_SHAPES[i])
            r0 += n
    for rank in range(2):
        assert two_ranks[rank][case]["wire"] == _np_wire(per_rank[rank],
                                                         codec)
        for i, (got, w) in enumerate(zip(two_ranks[rank][case]["synced"],
                                         want)):
            np.testing.assert_array_equal(
                got.numpy().view(np.uint32), w.view(np.uint32),
                err_msg=f"rank {rank} leaf {i}")
    if layout == "auto":                   # the JAX chooser's layouts
        lays = set()
        for vals, _, d, _, lay, _ in (p for k, p, _ in per_rank[0]
                                      if k == "sparse"):
            assert lay == jwire_layout.choose(
                vals.shape[1], d, 8.0 * vals.element_size(), "auto")
            lays.add(lay)
        assert lays == ({"dense"} if name == "terngrad"
                        else {"rice", "bitmap"})


@pytest.mark.parametrize("argv", [
    ["--compressor", "unisp"], ["--compressor", "topk+ternary"],
    ["--compressor", "gspar+qsgd8"], ["--compressor", "terngrad"],
    ["--compressor", "gspar", "--codec", "qsgd4", "--qsgd-bits", "8"]],
    ids=["unisp", "topk+ternary", "gspar+qsgd8", "terngrad", "codec-flag"])
def test_launcher_runs_the_baselines_and_codecs(argv):
    """The launcher on the CPU path at the smoke size: each group stamped
    with the layout the JAX chooser picks for its wire dtype, finite
    losses, no overflow, and wire bytes inside the static capacity (values,
    counts, scales and the RICE word capacity; terngrad's dense wire
    exactly)."""
    from repro_torch.configs import gemma_2b as tgemma
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.common import leaf_order
    from repro_torch.models.transformer import param_shapes
    summary = tlaunch.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                            "--device", "cpu", "--rho", str(RHO),
                            "--wire", "gather", "--error-feedback"] + argv)
    args = tlaunch.parse_args(["--arch", "x"] + argv)
    cfg = TConfig(name=args.compressor, codec=args.codec, rho=RHO,
                  min_leaf_size=1024, wire="gather")
    codec = cfg.scheme().codec
    shapes = param_shapes(tgemma.SMOKE)
    names = leaf_order(shapes)
    plan = plan_tree(cfg, [torch.empty(shapes[n][0], device="meta")
                           for n in names], [shapes[n][1] for n in names])
    vb = torch.empty((), dtype=codec.wire_dtype(torch.float32)).element_size()
    sparse = [g for g in plan.groups if g.kind == "sparse"]
    want = [(g.rows, g.d, g.k_cap,
             jwire_layout.choose(g.k_cap, g.d, 8.0 * vb, "auto"))
            for g in sparse]
    assert summary["layouts"] == want
    fixed = sum(g.d * 4 for g in plan.groups if g.kind == "dense") + sum(
        g.rows * ((g.d if lay == "dense" else g.k_cap) * vb
                  + (4 if codec.has_scale else 0)
                  + (4 if lay == "rice" else 0))
        for g, (*_, lay) in zip(sparse, want))
    cap = sum(g.rows * 4 * jcoding.rice_wire_words(g.k_cap, g.d)
              for g, (*_, lay) in zip(sparse, want) if lay == "rice")
    for m in summary["metrics"]:
        assert np.isfinite(m["loss"]) and m["overflow"] == 0.0
        assert fixed <= m["wire_bytes"] <= fixed + cap
        if not cap:
            assert m["wire_bytes"] == fixed


def test_tiled_passes_match_one_tile(monkeypatch):
    """The row-and-column tiles that bound the temporaries of the dense
    pack, the integer codecs' residual scatter and the accounting
    (``compaction.slot_tiles``: rows longer than a tile go in column
    chunks) give the same result as one tile over the whole group."""
    from repro_torch.comm import wire_layout as tw
    from repro_torch.core import sparse as tsparse
    g, u, _ = _inputs()
    d = 3000
    tg = _torch(g[:, :d].copy())
    cfg = TConfig(name="terngrad", error_feedback=True, wire="gather")
    uc = torch.from_numpy(np.random.default_rng(2).random((ROWS, d),
                                                          dtype=np.float32))
    uu = torch.from_numpy(np.ascontiguousarray(u[:, :d]))
    want_sg, want_res = KernelBackend().compress_sparse_ef(cfg, uu, tg, d, uc)
    want_pack = tw.scatter_live(want_sg.values, want_sg.idx, want_sg.nnz, d)
    monkeypatch.setattr(tw, "SCATTER_UNITS", 700)
    monkeypatch.setattr(tsparse, "ACCOUNT_UNITS", 700)
    sg, res = KernelBackend().compress_sparse_ef(cfg, uu, tg, d, uc)
    assert torch.equal(res, want_res)
    assert torch.equal(tw.scatter_live(sg.values, sg.idx, sg.nnz, d),
                       want_pack)
    for f in ("bits", "var_ratio"):
        torch.testing.assert_close(getattr(sg, f), getattr(want_sg, f),
                                   rtol=1e-6, atol=0)
