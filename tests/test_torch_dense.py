"""The port's dense wire (``wire="dense"``, the default, as in the JAX
package): kernels 5-8 and the ops entry points against the JAX package's
Pallas kernels (interpret mode) and ops, the port's dense Q against the JAX
package's dense-wire function, the dense-vs-gather identity inside the
port, one compressed train step against a JAX step assembled from the JAX
package's pieces, the exchange over two gloo ranks and over three and
four against the JAX package's pmean of the same Q on as many CPU devices
(bit-equal: both sum the workers in worker order in float32), and the
launcher on the CPU. Inputs come from numpy seeds.

Tolerances, with their reasons:
- kernels fed the JAX package's lambda and uniforms: Q and the residual
  bit-equal; sums within rtol 1e-6 (float64 sums rounded once here,
  tile-order float32 sums there), max exact;
- the ops, whose lambda is the port's own: lambda within rtol 1e-6, Q the
  same except at draws within 1e-5 of their keep probability, and values
  within rtol 1e-6 or one ulp of the wire dtype, whichever is larger (a
  one-ulp move of p moves g / p by about as much, and may flip its
  rounding to bfloat16);
- against the JAX dense-wire function, whose per-coordinate solver
  (``greedy_probabilities``) forms p as (rho d |g|) / sum|g| and rescales
  it by c = 1 + an ulp where nothing saturates: the same, with draws within
  1e-5 of p exempt;
- the train step: as ``tests/test_torch_step.py`` states it;
- the port's two wires: bit-equal Q from the same generator seed; the
  residual bit-equal with the bf16 codec and on float32 leaves, while with
  the f32 codec on bfloat16 leaves the dense residual subtracts the
  bf16-rounded Q and the gather wire's fused residual the unrounded value
  (ROADMAP.md queue C)."""
import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import gemma_2b as jgemma
from repro.core import _compressors as jcompressors
from repro.core import codecs as jcodecs
from repro.core import coding as jcoding
from repro.core import sparsify as jsparsify
from repro.core.api import CompressionConfig as JConfig
from repro.core.grouping import plan_tree as jplan_tree
from repro.kernels.sparsify import kernel as JK
from repro.kernels.sparsify import ops as jops
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.core import codecs as tcodecs
from repro_torch.core import coding as tcoding
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.api import compress_tree, compress_tree_sparse
from repro_torch.kernels.sparsify import kernel as TK
from repro_torch.kernels.sparsify import ops as tops
from repro_torch.kernels.sparsify import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Transformer, param_shapes
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

# small inputs: one intra-op thread keeps the parallel test run from
# oversubscribing the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, D, RHO = 2, 70_000, 0.05      # <= 2 TPU tiles per row, ragged
SUM_RTOL = 1e-6
NEAR = 1e-5                         # draws this close to p may flip
KERNEL_CASES = [("float32", "float32"), ("float32", "bfloat16"),
                ("bfloat16", "bfloat16")]     # (g, wire dtype)


def _inputs(dtype: str, rows: int = ROWS, d: int = D, seed: int = 21):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((rows, d))
         * np.exp(rng.standard_normal((rows, d)))).astype(np.float32)
    u = rng.random((rows, d), dtype=np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    return tg, torch.from_numpy(u), jg, jnp.asarray(u)


def _bits(x) -> np.ndarray:
    """Bit pattern of a torch or JAX array, for bit-equality checks."""
    if isinstance(x, torch.Tensor):
        x = x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
        return x.numpy().view({2: np.uint16, 4: np.uint32}[x.element_size()])
    a = np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _close(got: torch.Tensor, want, rtol=SUM_RTOL):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol)


@functools.lru_cache(maxsize=None)
def _jax_kernels(dtype: str, out_dtype: str):
    """Kernels 5-7 of the JAX package per row (vmapped), with the greedy
    lambda from ``stats_2d`` and the tail kernel."""
    _, _, jg, ju = _inputs(dtype)
    odt = getattr(jnp, out_dtype)

    def one(g, u):
        g2d, n, _, _ = jops._pad_2d(g)
        u2d, _, _, _ = jops._pad_2d(u)
        l1, l2, mx = JK.stats_2d(g2d, interpret=True)
        lam = jops.greedy_lambda(l1, mx, RHO, n, 2,
                                 tail_fn=jops._kernel_tail_fn(g2d, n, True))
        q = JK.sparsify_2d(g2d, u2d, lam, interpret=True, out_dtype=odt)
        qe, res = JK.sparsify_ef_2d(g2d, u2d, lam, interpret=True,
                                    out_dtype=odt)

        def cut(x):
            return x.reshape(-1)[:n]
        return dict(l1=l1, l2=l2, mx=mx, lam=lam, q=cut(q), qe=cut(qe),
                    res=cut(res))

    return jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(jg, ju))


# --- kernels 5-7 against the Pallas kernels ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_matches_pallas(dtype):
    """Kernel 7's sums within rtol 1e-6, max exact; its sum|g| and max|g|
    are kernel 1's bit for bit (the two wires' lambdas must agree)."""
    tg, _, _, _ = _inputs(dtype)
    want = _jax_kernels(dtype, dtype)
    l1, l2, mx = TK.stats(tg)
    _close(l1, want["l1"])
    _close(l2, want["l2"])
    np.testing.assert_array_equal(mx.numpy(), want["mx"])
    l1_k1, mx_k1 = TK.stats_l1max(tg)
    assert torch.equal(l1, l1_k1) and torch.equal(mx, mx_k1)


def _counts(q: torch.Tensor, g: torch.Tensor, lam: torch.Tensor):
    """The accounting kernels 5-6 fuse, recomputed from q: nonzeros, those
    with p = min(lam |g|, 1) = 1, and sum q^2."""
    w = q.double()
    p = torch.clamp_max(lam[:, None] * g.float().abs(), 1.0)
    nz = w != 0
    return nz.sum(1), (nz & (p >= 1.0)).sum(1), (w * w).sum(1)


@pytest.mark.parametrize("dtype,out_dtype", KERNEL_CASES)
def test_sparsify_matches_pallas(dtype, out_dtype):
    """Kernel 5 fed JAX's lambda and uniforms: Q in the wire dtype
    bit-equal, and the fused counts and sum Q^2 those of Q."""
    tg, tu, _, _ = _inputs(dtype)
    want = _jax_kernels(dtype, out_dtype)
    lam = torch.tensor(want["lam"])
    out = TK.sparsify(tg, tu, lam, getattr(torch, out_dtype))
    assert out.q.dtype == getattr(torch, out_dtype) and out.residual is None
    np.testing.assert_array_equal(_bits(out.q), _bits(want["q"]))
    nnz, sure, sq = _counts(out.q, tg, lam)
    assert torch.equal(out.nnz, nnz) and torch.equal(out.n_sure, sure)
    _close(out.sum_sq, sq)
    assert (out.n_sure > 0).all() and (out.nnz > out.n_sure).all()


@pytest.mark.parametrize("dtype,out_dtype", KERNEL_CASES)
def test_sparsify_ef_matches_pallas(dtype, out_dtype):
    """Kernel 6: Q and the residual g - float32(Q) after the wire rounding,
    in g's dtype, bit-equal to the Pallas kernel's."""
    tg, tu, _, _ = _inputs(dtype)
    want = _jax_kernels(dtype, out_dtype)
    lam = torch.tensor(want["lam"])
    out = TK.sparsify_ef(tg, tu, lam, getattr(torch, out_dtype))
    assert out.residual.dtype == tg.dtype
    np.testing.assert_array_equal(_bits(out.q), _bits(want["qe"]))
    np.testing.assert_array_equal(_bits(out.residual), _bits(want["res"]))
    assert torch.equal(out.q, TK.sparsify(tg, tu, lam,
                                          getattr(torch, out_dtype)).q)


# --- kernel 8: Philox4x32-10 ------------------------------------------------

# Random123's kat_vectors for philox4x32 at 10 rounds: counter, key, output.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = tref.philox4x32_10_ref(torch.tensor([ctr], dtype=torch.int64),
                                 key)
    assert got[0].tolist() == list(want)
    assert TK.philox4x32_10(torch.tensor([ctr]), torch.tensor([key]))[
        0].tolist() == list(want)


def test_prng_stream_is_seeded_and_tiling_free(monkeypatch):
    """Coordinate i of row r takes word i % 4 of the counter (i // 4, r, 0,
    0): the same seed gives the same Q, another seed another Q, and the
    uniforms do not depend on how the row is chunked."""
    tg, _, _, _ = _inputs("float32", d=10_001)
    lam = tops.gspar_lambda(tg[0], RHO).expand(ROWS)
    a = tref.sparsify_prng_ref(tg, lam, 1234)
    assert torch.equal(a.q, TK.sparsify_prng(tg, lam, 1234).q)
    assert not torch.equal(a.q, tref.sparsify_prng_ref(tg, lam, 1235).q)
    u = tref.philox_uniforms(1, 10_001, 1234)
    bits = tref.philox4x32_10_ref(
        torch.tensor([[5, 1, 0, 0]], dtype=torch.int64), (1234, 0))[0]
    assert u[21].item() == (int(bits[1]) >> 8) * 2.0 ** -24
    assert ((u >= 0) & (u < 1)).all()
    monkeypatch.setattr(tref, "PHILOX_UNITS", 1001)
    assert torch.equal(tref.philox_uniforms(1, 10_001, 1234), u)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prng_density_within_binomial_bounds(dtype):
    """``ops.gspar_sparsify_prng``: the kept count within 6 sd of sum p, the
    bound of the JAX package's test of its on-core PRNG (which cannot run
    here: the interpreter's PRNG yields zero bits)."""
    tg, _, _, _ = _inputs(dtype, rows=1, d=1 << 16, seed=26)
    leaf = tg.reshape(-1)
    q = tops.gspar_sparsify_prng(leaf, 1234, rho=RHO)
    assert q.shape == leaf.shape and q.dtype == leaf.dtype
    p = torch.clamp_max(tops.gspar_lambda(leaf, RHO) * leaf.double().abs(),
                        1.0)
    sd = float((p * (1 - p)).sum().sqrt())
    nnz = int((q != 0).sum())
    assert abs(nnz - float(p.sum())) < 6 * sd + 1e-6


# --- the ops entry points against the JAX package's ops ---------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gspar_stats_and_lambda_match_jax(dtype):
    tg, _, jg, _ = _inputs(dtype)
    leaf, jleaf = tg[0].reshape(7, -1), jg[0].reshape(7, -1)
    got = tops.gspar_stats(leaf)
    want = jops.gspar_stats(jleaf, interpret=True)
    for a, b in zip(got[:2], want[:2]):
        _close(a.reshape(1), np.reshape(b, 1))
    assert float(got[2]) == float(want[2])
    _close(tops.gspar_lambda(leaf, RHO).reshape(1),
           np.reshape(jops.gspar_lambda(jleaf, RHO, interpret=True), 1))


def _near(u: torch.Tensor, p) -> np.ndarray:
    """The draws within ``NEAR`` of their keep probability."""
    return np.abs(u.numpy() - np.asarray(p, np.float32)) < NEAR


def _assert_q_close(got: torch.Tensor, want, exempt: np.ndarray,
                    wire: torch.dtype) -> None:
    """The same kept set and values as the module docstring states, away
    from the ``exempt`` draws (at most 0.1% of them)."""
    got32, want32 = got.float().numpy(), np.asarray(want, np.float32)
    assert exempt.sum() <= 1e-3 * exempt.size
    keep = ~exempt
    np.testing.assert_array_equal(got32[keep] != 0, want32[keep] != 0)
    rtol = max(SUM_RTOL, float(torch.finfo(wire).eps))
    np.testing.assert_allclose(got32[keep], want32[keep], rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gspar_sparsify_matches_jax(dtype):
    """``ops.gspar_sparsify`` on a flat leaf (its own lambda) against the
    JAX op with the same uniforms."""
    tg, tu, jg, ju = _inputs(dtype)
    got = tops.gspar_sparsify(tg[0], tu[0], rho=RHO)
    want = np.asarray(jops.gspar_sparsify(jg[0], ju[0], rho=RHO,
                                          interpret=True), np.float32)
    assert got.shape == tg[0].shape and got.dtype == tg.dtype
    lam = tops.gspar_lambda(tg[0], RHO)
    p = torch.clamp_max(lam * tg[0].float().abs(), 1.0)
    _assert_q_close(got, want, _near(tu[0], p), tg.dtype)


# --- the port's dense Q against the JAX package's dense-wire function ------

@pytest.mark.parametrize("dtype,codec", [("float32", "f32"),
                                         ("float32", "bf16"),
                                         ("bfloat16", "f32")])
def test_dense_q_matches_jax_dense_wire(dtype, codec):
    """``ops.gspar_dense`` against what ``Scheme.apply_dense`` computes with
    the port's uniforms: ``greedy_probabilities``, ``u < p``,
    ``apply_mask``, the codec's encode and decode in the leaf dtype; and
    the coding-model bits and variance ratio of ``Scheme.compress`` from
    the same Q."""
    tg, tu, jg, ju = _inputs(dtype)
    jcodec = jcodecs.get(codec)
    wire = getattr(torch, str(jcodec.wire_dtype(jg.dtype)))
    r = tops.gspar_dense(tg, tu, rho=RHO, codec=tcodecs.get(codec))
    for row in range(ROWS):
        p = jsparsify.greedy_probabilities(jg[row], RHO)
        v = jsparsify.apply_mask(jg[row], p, ju[row] < p)
        if jcodec.rounds_values:
            scale = jcodec.scale(v)
            q = jcodec.decode(jcodec.encode(v, scale, None),
                              scale).astype(jg.dtype)
        else:
            q = v.astype(jg.dtype)
        pt = torch.clamp_max(r.lam[row] * tg[row].float().abs(), 1.0)
        _assert_q_close(r.q[row].to(tg.dtype), q,
                        _near(tu[row], pt) | _near(tu[row], p), wire)
        want = jcompressors.finish_compressed(
            jg[row], q, p, jcoding.realized_coding_bits(
                q, p, jcodec.value_bits))
        bits = tcoding.realized_coding_bits(
            r.n_sure[row], r.nnz[row] - r.n_sure[row], D, jcodec.value_bits)
        _close(bits.reshape(1), np.reshape(want.bits, 1))
        _close((r.sum_sq[row] / r.den[row]).reshape(1),
               np.reshape(want.var_ratio, 1), rtol=1e-5)


# --- the dense and gather wires of the port agree ---------------------------

TREE = [(3, 3000), (5000,), (64,), (2, 2000), (2, 3000)]
TREE_STACKED = [True, False, False, True, True]


def _tree(dtype: str, ef: bool):
    rng = np.random.default_rng(17)
    leaves = [torch.from_numpy((rng.standard_normal(s) * np.exp(
        rng.standard_normal(s))).astype(np.float32)).to(getattr(torch, dtype))
        for s in TREE]
    res = ([torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32))
            .to(getattr(torch, dtype)) for s in TREE] if ef else None)
    return leaves, res


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("codec", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_gather_wires_agree(dtype, codec, ef):
    """From the same generator seed, ``compress_tree``'s Q equals the
    scatter of ``compress_tree_sparse``'s decoded buffers bit for bit (at
    zero overflow), the tiny leaves equal the gather wire's float32
    passthrough, and the accounting agrees (the variance ratio to rtol
    1e-6: float64 sum q^2 here, float32 there). The residuals are bit-equal
    except for the f32 codec on bfloat16 leaves, where the dense wire
    subtracts the rounded Q and the gather wire the unrounded value."""
    leaves, res = _tree(dtype, ef)
    kw = dict(name=f"gspar+{codec}", rho=0.1, min_leaf_size=256,
              error_feedback=ef)
    q, d_res, d_stats = compress_tree(
        TConfig(**kw), torch.Generator().manual_seed(3), leaves,
        stacked=TREE_STACKED, residual=res)
    items, g_res, g_stats = compress_tree_sparse(
        TConfig(wire="gather", wire_layout="coo", **kw),
        torch.Generator().manual_seed(3), leaves, stacked=TREE_STACKED,
        residual=res)
    for kind, payload, members in items:
        if kind == "dense":
            off = 0
            for i, n in members:
                assert q[i].dtype == leaves[i].dtype
                assert torch.equal(q[i].reshape(-1).float(),
                                   payload[off:off + n])
                off += n
            continue
        assert int(payload.overflow().sum()) == 0
        dense = torch.zeros((payload.rows, payload.d))
        dense.scatter_add_(1, payload.idx.long(), payload.decode_values())
        r0 = 0
        for i, rows in members:
            want = dense[r0:r0 + rows].to(leaves[i].dtype)
            assert q[i].dtype == leaves[i].dtype
            np.testing.assert_array_equal(
                _bits(q[i].reshape(rows, -1)), _bits(want))
            r0 += rows
    for f in ("bits", "dense_bits", "density"):
        assert torch.equal(getattr(d_stats, f), getattr(g_stats, f)), f
    _close(d_stats.var_ratio.reshape(1), g_stats.var_ratio.reshape(1))
    if not ef:
        assert d_res is None and g_res is None
        return
    for i, leaf in enumerate(leaves):
        target = (leaf + res[i]).float()
        want = (target - q[i].float()).to(leaf.dtype)
        if leaf.numel() < 256:
            want = torch.zeros_like(leaf)
        np.testing.assert_array_equal(_bits(d_res[i]), _bits(want))
        if codec == "f32" and dtype == "bfloat16" and leaf.numel() >= 256:
            kept = q[i] != 0
            assert torch.equal(d_res[i][~kept], g_res[i][~kept])
            assert not torch.equal(d_res[i][kept], g_res[i][kept])
        else:
            np.testing.assert_array_equal(_bits(d_res[i]), _bits(g_res[i]))


def test_dense_wrappers_refuse_what_the_kernels_cannot_take():
    tg, tu, _, _ = _inputs("bfloat16", d=1000)
    lam = torch.ones(ROWS)
    with pytest.raises(ValueError, match="wire dtype"):
        TK.sparsify(tg, tu, lam, torch.float32)     # widening the wire
    with pytest.raises(ValueError, match="u must be"):
        TK.sparsify_ef(tg, tu.double(), lam)
    with pytest.raises(ValueError, match="out must be"):
        TK.sparsify(tg, tu, lam, out=torch.empty(ROWS, 999,
                                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="tie_base"):   # topk's tie bases
        TK.sparsify(tg, None, torch.ones(ROWS), pkind="topk",
                    budget=torch.zeros(ROWS, dtype=torch.int64))
    with pytest.raises(ValueError, match="integer codec needs"):
        TK.sparsify_ef(tg, tu, lam, codec=tcodecs.get("qsgd8"))


def test_config_takes_the_dense_wire_by_default():
    cfg = TConfig()
    assert cfg.wire == "dense"
    assert "layout=" not in cfg.describe()
    assert "wire=dense" in cfg.describe()
    assert TConfig(codec="bf16", error_feedback=True).wire == "dense"


# --- one compressed train step against a JAX step ---------------------------

LR, SEED, MIN_LEAF = 1e-3, 11, 1024


def _jax_dense_step(params, tokens, stacked):
    """One Algorithm-1 step at one worker on the dense wire, from the JAX
    package's pieces: the loss gradient, per sparse group and row
    ``stats_2d`` -> ``greedy_lambda`` (tail kernel) -> ``sparsify_ef_2d``
    (interpret mode) fed the port's uniforms (re-drawn from an identically
    seeded generator), the pmean of one worker, ``adam``. Returns (new
    params leaves, new residual leaves, exempt masks)."""
    grads = jax.jit(jax.grad(jstep.make_loss_fn(jgemma.SMOKE)))(
        params, {"tokens": jnp.asarray(tokens)})
    leaves, tdef = jax.tree_util.tree_flatten(grads)
    leaves = [np.asarray(g) for g in leaves]
    plan = jplan_tree(JConfig(name="gspar", rho=RHO, min_leaf_size=MIN_LEAF),
                      leaves, stacked)
    gen = torch.Generator().manual_seed(SEED)

    def one(g, u):
        g2d, n, _, _ = jops._pad_2d(g)
        u2d, _, _, _ = jops._pad_2d(u)
        l1, _, mx = JK.stats_2d(g2d, interpret=True)
        lam = jops.greedy_lambda(l1, mx, RHO, n, 2,
                                 tail_fn=jops._kernel_tail_fn(g2d, n, True))
        q, res = JK.sparsify_ef_2d(g2d, u2d, lam, interpret=True)
        return q.reshape(-1)[:n], res.reshape(-1)[:n], lam

    synced, res, exempt = ([None] * len(leaves) for _ in range(3))
    for grp in plan.groups:
        if grp.kind == "dense":       # passthrough, zero residual
            for i, _ in grp.members:
                synced[i] = leaves[i]
                res[i] = np.zeros_like(leaves[i])
                exempt[i] = np.zeros(leaves[i].shape, bool)
            continue
        stack = np.concatenate([leaves[i].reshape(rows, grp.d)
                                for i, rows in grp.members])
        u = torch.rand((grp.rows, grp.d), generator=gen,
                       dtype=torch.float32).numpy()
        q, r, lam = (np.asarray(x) for x in jax.jit(jax.vmap(one))(
            jnp.asarray(stack), jnp.asarray(u)))
        p = np.minimum(lam[:, None] * np.abs(stack), 1.0)
        near = np.abs(u - p) < NEAR
        r0 = 0
        for i, rows in grp.members:
            shape = leaves[i].shape
            synced[i] = q[r0:r0 + rows].reshape(shape)
            res[i] = r[r0:r0 + rows].reshape(shape)
            exempt[i] = near[r0:r0 + rows].reshape(shape)
            r0 += rows
    opt = jopt.adam(LR)
    new, _ = opt.update(jax.tree_util.tree_unflatten(tdef, synced),
                        opt.init(params), params)
    return [np.asarray(x) for x in jax.tree.leaves(new)], res, exempt


@pytest.fixture
def one_worker_group():
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_dense_step_matches_jax_step(one_worker_group):
    """The port's step on the dense wire (gemma-2b smoke, float32, EF,
    Adam) against the JAX step of ``_jax_dense_step``: new parameters and
    the EF residual to atol 1e-6 (rtol 1e-5 for the residual) away from
    the exempt draws (at most 0.1% of them); wire bytes are the leaves'
    own, 4 B per parameter."""
    params = jax.jit(lambda k: split_params(
        jtf.init_model(k, jgemma.SMOKE))[0])(jax.random.key(3))
    tokens = np.random.default_rng(5).integers(0, jgemma.SMOKE.vocab,
                                               (4, 32))
    model = Transformer(tgemma.SMOKE, params_from_numpy(
        jax.tree.map(np.asarray, params)))
    want_p, want_r, exempt = _jax_dense_step(params, tokens, model.stacked)
    comp = TConfig(name="gspar", rho=RHO, error_feedback=True,
                   min_leaf_size=MIN_LEAF)
    opt = topt.adam(LR)
    step = tstep.make_compressed_train_step(model, comp, opt)
    _, fb, metrics = step(opt.init(model.leaves()),
                          topt.init_feedback(model.leaves()),
                          {"tokens": torch.from_numpy(tokens)},
                          torch.Generator().manual_seed(SEED))
    n_exempt = sum(int(e.sum()) for e in exempt)
    assert n_exempt <= 1e-3 * sum(e.size for e in exempt)
    for name, p, r, wp, wr, ex in zip(model.leaf_names, model.leaves(),
                                      fb.residual, want_p, want_r, exempt):
        keep = ~ex
        np.testing.assert_allclose(p.detach().numpy()[keep], wp[keep],
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(r.numpy()[keep], wr[keep], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    n_params = sum(p.numel() for p in model.leaves())
    assert float(metrics["wire_bytes"]) == 4.0 * n_params
    assert float(metrics["overflow"]) == 0.0
    assert 0.0 < float(metrics["density"]) <= 1.25 * RHO
    assert step.layouts == []


# --- the exchange over gloo ranks ------------------------------------------

GLOO_SHAPES = [(4, 3000), (5000,), (64,), (3, 700)]
GLOO_STACKED = [True, False, False, True]
RAGGED_UNITS, RAGGED_N = 4096, 10_007    # the exchange's chunk in the ranks

WORKER = f"RAGGED_UNITS, RAGGED_N = {RAGGED_UNITS}, {RAGGED_N}" + r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.comm import sync
from repro_torch.core import api

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shapes, stacked = eval(sys.argv[4]), eval(sys.argv[5])
world, sizes = int(sys.argv[6]), eval(sys.argv[7])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
sync.EXCHANGE_UNITS = RAGGED_UNITS     # several chunks a buffer
results = {}
for m in sizes:                 # the first m ranks, every rank creating it
    group = (None if m == world
             else dist.new_group(list(range(m)), backend="gloo"))
    if rank >= m:
        continue
    rng = np.random.default_rng(100 + rank)
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [torch.from_numpy((rng.standard_normal(s) * np.exp(
            rng.standard_normal(s))).astype(np.float32)).to(dtype)
            for s in shapes]
        cfg = api.CompressionConfig(rho=0.1, min_leaf_size=256)
        q, _, _ = api.compress_tree(
            cfg, torch.Generator().manual_seed(7 + rank), leaves,
            stacked=stacked)
        synced, _, stats = sync.sync_tree(
            cfg, torch.Generator().manual_seed(7 + rank), leaves,
            stacked=stacked, group=group)
        results[(m, str(dtype))] = {
            "q": q, "synced": synced, "wire": float(stats.wire_bytes),
            "overflow": float(stats.overflow), "layouts": stats.layouts}
        # a buffer whose last chunk is no multiple of m
        odd = torch.from_numpy(np.random.default_rng(200 + rank)
                               .standard_normal(RAGGED_N)
                               .astype(np.float32)).to(dtype)
        mean = odd.clone()
        sync._worker_order_mean(mean, m, group)
        results[(m, "ragged " + str(dtype))] = {"q": odd, "mean": mean}
torch.save(results, out)
dist.destroy_process_group()
"""


def _gloo_ranks(tmp, world: int, sizes: tuple) -> list:
    """Run ``world`` gloo ranks; each syncs over the first m ranks for m in
    ``sizes``. Returns each rank's results keyed (m, dtype)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), outs[r],
         repr(GLOO_SHAPES), repr(GLOO_STACKED), str(world), repr(sizes)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ranks = _gloo_ranks(tmp_path_factory.mktemp("gloo_dense"), 2, (2,))
    return [{dt: r[(2, dt)] for m, dt in r} for r in ranks]


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_dense_sync_is_the_worker_mean(two_ranks, dtype):
    """Each rank's synced leaves equal the mean of both ranks' Q in the
    leaf dtype, bit for bit: numpy's float32 (a + b) / 2, and for bfloat16
    the sum rounded once to bfloat16, then halved (one addition: the order
    of the two workers does not matter)."""
    for i in range(len(GLOO_SHAPES)):
        a, b = (r[dtype]["q"][i] for r in two_ranks)
        if a.dtype == torch.float32:
            want = torch.from_numpy((a.numpy() + b.numpy()) / np.float32(2))
        else:
            want = (a.float() + b.float()).to(torch.bfloat16) / 2
        assert not torch.equal(a, b)
        for rank in range(2):
            got = two_ranks[rank][dtype]["synced"][i]
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"rank {rank} leaf {i}")


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_dense_wire_bytes_are_the_leaves(two_ranks, dtype):
    itemsize = 4 if dtype == "torch.float32" else 2
    want = sum(int(np.prod(s)) for s in GLOO_SHAPES) * itemsize
    for rank in range(2):
        r = two_ranks[rank][dtype]
        assert r["wire"] == want
        assert r["overflow"] == 0.0 and r["layouts"] == ()


PMEAN = r"""
import sys
import ml_dtypes
import numpy as np
import repro                               # jax API shims first
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm.sync import _sync_leaves_dense

data = np.load(sys.argv[1])
out = {}
for key in sorted({k.rsplit("_", 1)[0] for k in data.files}):
    m = int(key.split("_")[0])
    leaves = []
    for i in range(int(sys.argv[3])):
        a = data[f"{key}_{i}"]
        leaves.append(a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16
                      else a)
    mesh = Mesh(np.array(jax.devices()[:m]), ("data",))
    fn = jax.shard_map(lambda qs: _sync_leaves_dense(qs, "data")[0],
                       mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    for i, s in enumerate(fn([jnp.asarray(a) for a in leaves])):
        s = np.asarray(s)[0]
        out[f"{key}_{i}"] = s.view(np.uint16) if s.dtype != np.float32 else s
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def many_ranks(tmp_path_factory):
    """Four gloo ranks syncing over two, three and four of them, and the
    JAX package's dense sync (``pmean``, repro/comm/sync.py:158) of the
    same per-worker Q on as many fake CPU devices, in one subprocess."""
    tmp = tmp_path_factory.mktemp("gloo_dense_many")
    ranks = _gloo_ranks(tmp, 4, (2, 3, 4))
    arrays = {}
    for m in (2, 3, 4):
        for dt in ("torch.float32", "torch.bfloat16"):
            for i in range(len(GLOO_SHAPES)):
                arrays[f"{m}_{dt[6:]}_{i}"] = np.stack(
                    [_bits(ranks[r][(m, dt)]["q"][i]) if dt.endswith("16")
                     else ranks[r][(m, dt)]["q"][i].numpy()
                     for r in range(m)])
    np.savez(tmp / "q.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", PMEAN, str(tmp / "q.npz"),
         str(tmp / "pmean.npz"), str(len(GLOO_SHAPES))],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ranks, np.load(tmp / "pmean.npz")


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("m", [3, 4])
def test_dense_sync_matches_jax_pmean_past_two_workers(many_ranks, m,
                                                       dtype):
    """At three and four gloo ranks every rank's synced leaves equal the
    JAX package's ``pmean`` of the same per-worker Q, bit for bit: both
    sum the workers in worker order in float32 (bfloat16 rounded once)
    and divide by m. The exchange is the one every backend takes (an
    ordered reduce-scatter and an all-gather), NCCL's included. The wire
    charges numel x itemsize, as at two."""
    _assert_matches_pmean(many_ranks, m, dtype)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_dense_sync_matches_jax_pmean_at_two_workers(many_ranks, dtype):
    """The same at two gloo ranks, against the JAX package's ``pmean``."""
    _assert_matches_pmean(many_ranks, 2, dtype)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("m", [2, 3, 4])
def test_dense_exchange_chunks_a_ragged_buffer(many_ranks, m, dtype):
    """The exchange a chunk of ``EXCHANGE_UNITS`` (4,096 in the ranks) at a
    time on 10,007 elements, whose last chunk is no multiple of m and is
    padded: every rank gets the float32 sum of the workers in worker order,
    rounded once to the dtype, divided by m (numpy's float32)."""
    ranks, _ = many_ranks
    key = (m, "ragged " + dtype)
    acc = ranks[0][key]["q"].float().numpy().copy()
    for r in range(1, m):
        acc += ranks[r][key]["q"].float().numpy()
    want = torch.from_numpy(acc).to(ranks[0][key]["q"].dtype)
    want = torch.from_numpy(want.float().numpy() / np.float32(m)).to(
        want.dtype)
    for r in range(m):
        np.testing.assert_array_equal(_bits(ranks[r][key]["mean"]),
                                      _bits(want), err_msg=f"rank {r}")


def _assert_matches_pmean(many_ranks, m: int, dtype: str) -> None:
    ranks, want = many_ranks
    itemsize = 4 if dtype == "torch.float32" else 2
    for i in range(len(GLOO_SHAPES)):
        w = want[f"{m}_{dtype[6:]}_{i}"]
        w = w if itemsize == 2 else w.view(np.uint32)
        qs = [ranks[r][(m, dtype)]["q"][i] for r in range(m)]
        assert not torch.equal(qs[0], qs[1])
        for r in range(m):
            res = ranks[r][(m, dtype)]
            np.testing.assert_array_equal(_bits(res["synced"][i]), w,
                                          err_msg=f"m={m} rank {r} leaf {i}")
            assert res["wire"] == itemsize * sum(
                int(np.prod(s)) for s in GLOO_SHAPES)


# --- the launcher -----------------------------------------------------------

@pytest.mark.parametrize("ef", [False, True])
def test_launcher_trains_on_the_dense_wire(ef):
    """``--wire dense`` on the CPU path: finite losses, exactly 4 bytes per
    parameter of the float32 smoke model, no overflow, no layout."""
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "2", "--device",
            "cpu", "--rho", str(RHO), "--log-every", "1", "--wire", "dense"]
    summary = tlaunch.main(argv + (["--error-feedback"] if ef else []))
    assert not dist.is_initialized()
    n = sum(int(np.prod(s)) for s, _ in param_shapes(tgemma.SMOKE).values())
    assert summary["params"] == n and summary["layouts"] == []
    for m in summary["metrics"]:
        assert np.isfinite(m["loss"])
        assert m["wire_bytes"] == 4 * n
        assert m["overflow"] == 0.0
        assert 0.0 < m["density"] <= 1.25 * RHO


def test_launcher_defaults_to_the_dense_wire(capsys):
    """Without ``--wire`` the launcher runs the dense wire, as the JAX
    launcher does, and prints no wire layout."""
    summary = tlaunch.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                            "--device", "cpu", "--rho", str(RHO),
                            "--error-feedback"])
    out = capsys.readouterr().out
    assert "wire=dense" in out and "layout" not in out
    n = sum(int(np.prod(s)) for s, _ in param_shapes(tgemma.SMOKE).values())
    assert summary["metrics"][0]["wire_bytes"] == 4 * n
