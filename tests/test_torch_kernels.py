"""The port's sparsify kernels (plain PyTorch versions, the CPU path of every
wrapper) against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs and with the JAX package's per-row scalars (lambda, the
tail threshold): counts, kept coordinates, values and the EF residual
bit-equal; sums within rtol 1e-6 (float64 sums rounded once to float32 here,
tile-order float32 sums on the JAX side).

The CUDA kernels themselves run only on a card: ``tests/test_torch_gpu.py``
holds them against the plain versions there and skips on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core import coding as jcoding
from repro.kernels.sparsify import kernel as JK
from repro.kernels.sparsify import ops as jops
from repro_torch.comm import compaction as tcompaction
from repro_torch.comm.compaction import capacity_for
from repro_torch.core import coding as tcoding
from repro_torch.core import codecs as tcodecs
from repro_torch.kernels.sparsify import kernel as TK
from repro_torch.kernels.sparsify import ops as tops

# small inputs: one intra-op thread keeps the parallel test run from
# oversubscribing the host's cores
torch.set_num_threads(1)

ROWS, D, RHO = 3, 100_000, 0.05           # <= 2 TPU tiles per row, ragged
K_CAPS = (capacity_for(D, RHO), 1024)     # as configured, and overflowing
SUM_RTOL = 1e-6
CASES = [("float32", "f32"), ("float32", "bf16"), ("bfloat16", "f32")]
# every case at the configured capacity; the overflowing capacity once per
# leaf dtype (the cut does not depend on the codec)
CAP_CASES = [c + (K_CAPS[0],) for c in CASES] + [
    ("float32", "f32", K_CAPS[1]), ("bfloat16", "f32", K_CAPS[1])]


def _inputs(dtype: str):
    rng = np.random.default_rng(7)
    g = (rng.standard_normal((ROWS, D))
         * np.exp(rng.standard_normal((ROWS, D)))).astype(np.float32)
    u = rng.random((ROWS, D), dtype=np.float32)
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


@functools.lru_cache(maxsize=None)
def _jax_rows(dtype: str, codec_name: str, k_cap: int):
    """Every per-row quantity of the JAX kernels, rows vmapped."""
    codec = jcodecs.get(codec_name)
    _, _, jg, ju = _inputs(dtype)

    def one(g, u):
        g2d, n, _, _ = jops._pad_2d(g)
        u2d, _, _, _ = jops._pad_2d(u)
        l1, mx = JK.stats_l1max_2d(g2d, interpret=True)
        lam0 = jops.greedy_lambda(l1, mx, RHO, n)
        thresh = jnp.where(lam0 > 0, 1.0 / lam0, 0.0)
        n_below, l1_below = JK.tail_stats_2d(g2d, thresh, interpret=True)
        n_below = n_below - jnp.float32(g2d.size - n)     # padding slots
        lam = jops.greedy_lambda(
            l1, mx, RHO, n, 2, tail_fn=jops._kernel_tail_fn(g2d, n, True))
        sel = JK.select_stats_2d(g2d, u2d, lam, 0.0, k_cap=k_cap,
                                 pkind="lam", interpret=True)
        scale = jcodecs.finalize_scale(codec, sel[4], sel[5])
        vals, idx, words, used, res = JK.compact_emit_2d(
            g2d, u2d, lam, 0.0, scale, jnp.zeros((1,), jnp.float32),
            pkind="lam", codec=codec, out_dtype=codec.wire_dtype(g.dtype),
            k_cap=k_cap, d=n, rice_r=jcoding.rice_parameter(k_cap, n),
            ef=True, interpret=True)
        return dict(l1=l1, mx=mx, thresh=thresh, n_below=n_below,
                    l1_below=l1_below, lam=lam, sel=sel, values=vals,
                    idx=idx, rice_words=words, rice_used=used,
                    residual=res.reshape(-1)[:n])

    out = jax.jit(jax.vmap(one))(jg, ju)
    return jax.tree.map(np.asarray, out)


def _close(got: torch.Tensor, want, rtol=SUM_RTOL):
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_l1max_matches_pallas(dtype):
    tg, _, _, _ = _inputs(dtype)
    want = _jax_rows(dtype, "f32", K_CAPS[0])
    l1, mx = TK.stats_l1max(tg)
    _close(l1, want["l1"])
    np.testing.assert_array_equal(mx.numpy(), want["mx"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_stats_matches_pallas(dtype):
    """Fed JAX's threshold: the integer count equals JAX's float32 count
    (exact below 2^24 coordinates), the mass agrees to rtol 1e-6; a row
    whose gate is off reports zeros."""
    tg, _, _, _ = _inputs(dtype)
    want = _jax_rows(dtype, "f32", K_CAPS[0])
    thresh = torch.tensor(want["thresh"])
    cnt, l1 = TK.tail_stats(tg, thresh, torch.ones(ROWS, dtype=torch.bool))
    np.testing.assert_array_equal(cnt.numpy(),
                                  want["n_below"].astype(np.int64))
    _close(l1, want["l1_below"])
    gate = torch.tensor([True, False, True])
    cnt2, l12 = TK.tail_stats(tg, thresh, gate)
    assert cnt2[1] == 0 and l12[1] == 0
    assert torch.equal(cnt2[gate], cnt[gate])


@pytest.mark.parametrize("dtype,codec,k_cap", CAP_CASES)
def test_select_stats_matches_pallas(dtype, codec, k_cap):
    tg, tu, _, _ = _inputs(dtype)
    want = _jax_rows(dtype, codec, k_cap)
    st = TK.select_stats(tg, tu, torch.tensor(want["lam"]), k_cap)
    cnt, nzc, psum, den, vsq, vmx = want["sel"]
    np.testing.assert_array_equal(st.nnz.numpy(), cnt)
    np.testing.assert_array_equal(st.nonzeros.numpy(), nzc)
    _close(st.p_sum, psum)
    _close(st.den, den)
    _close(st.sum_sq, vsq)
    np.testing.assert_array_equal(st.max_abs.numpy(), vmx)
    if k_cap == K_CAPS[1]:
        assert (cnt > k_cap).all()       # the capacity cut is exercised


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("dtype,codec,k_cap", CAP_CASES)
def test_compact_emit_matches_pallas(dtype, codec, k_cap, ef):
    """Values in the wire dtype, ascending idx with zero padding, and the EF
    residual — every survivor subtracted, overflow-dropped ones included —
    bit-equal to the Pallas kernel's."""
    tg, tu, _, _ = _inputs(dtype)
    want = _jax_rows(dtype, codec, k_cap)
    lam = torch.tensor(want["lam"])
    st = TK.select_stats(tg, tu, lam, k_cap)
    vals, idx, res = TK.compact_emit(tg, tu, lam, st, k_cap=k_cap,
                                     codec=tcodecs.get(codec), ef=ef)
    assert vals.shape == idx.shape == (ROWS, k_cap)
    np.testing.assert_array_equal(_bits(vals), _bits(want["values"]))
    np.testing.assert_array_equal(idx.numpy(), want["idx"])
    if ef:
        np.testing.assert_array_equal(_bits(res), _bits(want["residual"]))
    else:
        assert res is None


@pytest.mark.parametrize("dtype,k_cap", [("float32", K_CAPS[0]),
                                         ("bfloat16", K_CAPS[0]),
                                         ("float32", K_CAPS[1]),
                                         ("bfloat16", K_CAPS[1])])
def test_rice_pack_matches_pallas(dtype, k_cap):
    """The RICE variant of pass 2: the port packs the compact idx after
    ``compact_emit`` (``rice_pack``; on the CPU its plain version, the
    port's encoder), the TPU kernel inside it. Words and used counts
    bit-equal, at the configured and the overflowing capacity, and the
    words decode to each row's kept coordinates."""
    tg, tu, _, _ = _inputs(dtype)
    want = _jax_rows(dtype, "f32", k_cap)
    lam = torch.tensor(want["lam"])
    st = TK.select_stats(tg, tu, lam, k_cap)
    _, idx, _ = TK.compact_emit(tg, tu, lam, st, k_cap=k_cap,
                                codec=tcodecs.FloatCodec(), ef=False)
    r = tcoding.rice_parameter(k_cap, D)
    assert r == jcoding.rice_parameter(k_cap, D)
    words, used = TK.rice_pack(idx, st.nnz, d=D, r=r)
    assert words.shape == (ROWS, tcompaction.rice_cap_words(k_cap, D, r))
    np.testing.assert_array_equal(words.numpy(), want["rice_words"])
    np.testing.assert_array_equal(used.numpy(), want["rice_used"])
    dec = tcompaction.rice_decode(words, k_cap, D, r)
    n_live = torch.clamp_max(st.nnz, k_cap)
    for row in range(ROWS):
        n = int(n_live[row])
        assert torch.equal(dec[row, :n], idx[row, :n])
    if k_cap == K_CAPS[1]:
        assert (st.nnz > k_cap).all()


@pytest.mark.parametrize("dtype,codec", [CASES[0], CASES[2]])
def test_gspar_emit_matches_jax(dtype, codec):
    """The whole pipeline with the same uniforms: lambda within rtol 1e-6,
    and the same kept set except for draws within 1e-6 of their keep
    probability (a one-ulp move of lambda may flip those)."""
    tg, tu, jg, ju = _inputs(dtype)
    k_cap = K_CAPS[0]
    jer, jlam = jax.vmap(functools.partial(
        jops.gspar_emit, u_cod=None, k_cap=k_cap, rho=RHO,
        codec=jcodecs.get(codec), ef=True, interpret=True))(jg, ju)
    er, lam = tops.gspar_emit(tg, tu, k_cap=k_cap, rho=RHO,
                              codec=tcodecs.get(codec), ef=True)
    _close(lam, jlam)
    g32 = tg.to(torch.float32).abs()
    for r in range(ROWS):
        kept = set(er.idx[r, :int(er.nnz[r])].tolist())
        jkept = set(np.asarray(jer.idx[r, :int(jer.nnz[r])]).tolist())
        p = torch.clamp_max(lam[r] * g32[r], 1.0)
        for i in kept ^ jkept:
            assert abs(float(tu[r, i]) - float(p[i])) < 1e-6
        assert len(kept ^ jkept) <= 2
    np.testing.assert_array_equal(er.nnz.numpy() > 0, True)
