"""The bfloat16 magnitude compaction and Algorithm 2's lambda from the
magnitude bins (``kernel.compact_bins``, ``compact_select`` and
``closed_lambda``), here their plain versions, against the JAX package and
against the composition they replace, on the same numpy inputs.

- The compaction against ``repro.comm.compaction.compact`` row by row (the
  JAX buffer descends by magnitude, the port's ascends by coordinate:
  compared after sorting the JAX live slots by coordinate), and bit for bit
  against the three-step composition ``topk_threshold`` and passes 1-2 of
  topk that float32 groups still take: ties straddling the kernel's tile
  edges at the cut, rows with fewer nonzeros than k_cap, an all-zero row.
  The deterministic rounding of the integer codecs against
  ``repro.comm.sync._encode_det``, with fractions at exactly 0.5.
- Lambda against ``repro.core.sparsify.closed_form_lambda`` at eps 1.0 and
  40 (rtol 1e-6: the JAX package sums in float32), and against a
  restatement of the bin solve in numpy (the same bin, lambda bit for bit),
  whose bin holds the k*-th magnitude of the port's float64 sort.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
import jax.numpy as jnp
from repro.comm import compaction as jcompaction
from repro.comm.sync import _encode_det
from repro.core import codecs as jcodecs
from repro.core import sparsify as jsp

from repro_torch.core import codecs
from repro_torch.core import sparsify as tsp
from repro_torch.kernels.sparsify import kernel as K
from repro_torch.kernels.sparsify import ops, ref

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 40_000                   # past two of the kernel's 16,384-wide tiles
BF16_BELOW_2 = 1.9921875     # the bfloat16 just below 2


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (and back), so that both
    packages see the same bf16 numbers."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _rows(name: str) -> np.ndarray:
    """Named [rows, D] groups of bfloat16 values."""
    rng = np.random.default_rng(11)
    if name == "dense":                 # heavy tails: the capacity cuts
        x = rng.standard_normal((3, D)) * np.exp(rng.standard_normal((3, D)))
    elif name == "ties":                # ties at the cut across tile edges
        x = np.where(rng.random((2, D)) < 0.007,
                     rng.standard_normal((2, D)) * 8, 0.0)
        x[0, 16_384 - 1_000:16_384 + 1_000] = 0.75
        x[1, [5, 16_383, 16_384, 32_767, 32_768, 39_999]] = -0.75
        x[1, 20_000:22_000] = 0.75
    elif name == "sparse":              # fewer nonzeros than k_cap
        x = np.zeros((2, D))
        x[0, rng.choice(D, 100, replace=False)] = rng.standard_normal(100)
        x[1, [0, 16_384, D - 1]] = [1.0, -2.0, 0.5]
    else:
        x = np.zeros((1, D))
    return _bf16(x.astype(np.float32))


def _group(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def _jax_sorted(vals, idx):
    """The JAX buffer's live (nonzero) slots in coordinate order."""
    vals = np.asarray(vals).astype(np.float64)
    idx = np.asarray(idx)
    live = vals != 0
    order = np.argsort(idx[live], kind="stable")
    return vals[live][order], idx[live][order]


def _port_live(vals, idx, n):
    n = int(min(int(n), vals.shape[-1]))
    v, i = vals[:n].to(torch.float64).numpy(), idx[:n].numpy()
    assert np.all(np.diff(i) > 0)                  # ascending coordinates
    assert not vals[n:].any() and not idx[n:].any()
    return v, i


@pytest.mark.parametrize("name", ["dense", "ties", "sparse", "zero"])
@pytest.mark.parametrize("k_cap", [512, 2048])
def test_compaction_matches_jax_compact(name, k_cap):
    x = _rows(name)
    g = _group(x)
    c = ops.magnitude_compact(g, k_cap=k_cap)
    for r in range(x.shape[0]):
        jv, ji, jn = jcompaction.compact(
            jnp.asarray(x[r]).astype(jnp.bfloat16), k_cap)
        assert int(c.nnz[r]) == int(jn) == int((x[r] != 0).sum())
        assert int(c.live[r]) == min(int(jn), k_cap)
        wv, wi = _jax_sorted(jv, ji)
        pv, pi = _port_live(c.values[r], c.idx[r], c.live[r])
        np.testing.assert_array_equal(pi, wi, err_msg=f"{name} row {r}")
        np.testing.assert_array_equal(pv, wv)
    if name == "ties":       # the cut falls inside the ties
        mag = np.sort(np.abs(x), axis=1)[:, ::-1]
        assert (mag[:, k_cap - 1] == 0.75).all()


def _three_steps(g, k_cap, codec, scale=None):
    """The composition that float32 groups take (and bfloat16 groups took):
    topk's threshold at k_cap, pass 1 and pass 2 of topk."""
    t, budget = ref.topk_threshold_ref(g, k_cap, K.TOPK_BITS[g.dtype])
    st = ref.select_stats_ref(g, None, t, k_cap, K.TILE, pkind="topk",
                              budget=budget)
    if scale is None:
        scale = codecs.finalize_scale(codec, st.sum_sq, st.max_abs)
    vals, idx, _ = ref.compact_emit_ref(
        g, None, t, k_cap, codec, False, pkind="topk", budget=budget,
        scale=scale if codec.integer_coded else None,
        det_round=codec.integer_coded)
    return t, budget, st, scale, vals, idx


@pytest.mark.parametrize("codec", ["f32", "bf16", "qsgd4", "qsgd8",
                                   "ternary"])
@pytest.mark.parametrize("name", ["dense", "ties", "sparse", "zero"])
def test_compaction_is_the_three_step_composition(name, codec):
    """Bit for bit: values, idx, nnz and live of the whole op; the row
    scalars of ``compact_bins`` against topk's threshold and pass 1 (sum
    v^2 over the same kept values, summed in another order: rtol 1e-6),
    and the integer codecs' levels at one scale."""
    g = _group(_rows(name))
    cdc = codecs.get(codec)
    for k_cap in (512, 2048):
        bins = K.compact_bins(g, k_cap)
        t, budget, st, scale, vals, idx = _three_steps(g, k_cap, cdc)
        assert torch.equal(bins.t, t) and torch.equal(bins.budget, budget)
        assert torch.equal(bins.nonzeros, st.nonzeros)
        assert torch.equal(bins.kept, st.nnz)
        assert torch.equal(bins.max_abs, st.max_abs)
        torch.testing.assert_close(bins.sum_sq, st.sum_sq, rtol=1e-6,
                                   atol=0)
        got = K.compact_select(g, bins, k_cap=k_cap, codec=cdc, scale=scale)
        assert torch.equal(got[0], vals) and torch.equal(got[1], idx)
        c = ops.magnitude_compact(g, k_cap=k_cap, codec=cdc)
        torch.testing.assert_close(c.scale, scale, rtol=1e-6, atol=0)
        assert torch.equal(c.nnz, st.nonzeros)
        if not cdc.integer_coded:
            assert torch.equal(c.values, vals) and torch.equal(c.idx, idx)
            assert torch.equal(c.live, st.nnz)


def _det_rows() -> np.ndarray:
    """bf16 rows whose qsgd4 fractions hit exactly 0.5 (norm 2: |v| = 1
    gives scaled 7.5) and whose ternary ratios hit exactly 0.5 and the
    bfloat16 below it, then heavy-tailed rows."""
    x = np.zeros((2, D), np.float32)
    x[0, [1, 9, 16_384, 30_000]] = [1.0, -1.0, 1.0, -1.0]    # qsgd: 7.5
    x[1, [2, 3, 4, 5, 6]] = [4.0, 2.0, -2.0, BF16_BELOW_2, 0.5]
    return np.concatenate([x, _rows("dense")])


@pytest.mark.parametrize("codec", ["qsgd4", "ternary"])
def test_det_round_matches_encode_det(codec):
    """The pod stage's compaction and keyless encode on bf16 rows: levels
    and live slots equal to ``_encode_det`` over JAX's compact buffer
    (scale within rtol 1e-6), ties at exactly 0.5 rounding up (qsgd) and
    kept (ternary)."""
    x = _det_rows()
    tc, jc = codecs.get(codec), jcodecs.get(codec)
    c = ops.magnitude_compact(_group(x), k_cap=256, codec=tc)
    for r in range(x.shape[0]):
        jv, ji, jn = jcompaction.compact(
            jnp.asarray(x[r]).astype(jnp.bfloat16), 256)
        enc, scale = _encode_det(jc, jv)
        wv, wi = _jax_sorted(enc, ji)
        pv, pi = _port_live(c.values[r], c.idx[r], c.live[r])
        np.testing.assert_array_equal(pi, wi, err_msg=f"{codec} row {r}")
        np.testing.assert_array_equal(pv, wv)
        np.testing.assert_allclose(float(c.scale[r]), float(scale),
                                   rtol=1e-6)
        assert int(c.nnz[r]) == int(jn)
    if codec == "qsgd4":
        assert c.values[0, :4].tolist() == [8, -8, 8, -8]
    else:                     # |v| / 4 = 1, 0.5, 0.5 kept; just below not
        assert c.idx[1, :c.live[1]].tolist() == [2, 3, 4]


def _lambda_rows() -> np.ndarray:
    rng = np.random.default_rng(5)
    d = 4096
    x = rng.standard_normal((4, d)) * np.exp(rng.standard_normal((4, d)))
    x[1] = np.round(x[1] * 4) / 4                            # ties
    x[2, rng.random(d) < 0.5] = 0.0                          # zeros
    x[3] = 0.0
    return _bf16(x.astype(np.float32))


@pytest.mark.parametrize("eps", [1.0, 40.0])
def test_closed_lambda_matches_jax(eps):
    """``ops.closed_lambda`` on bf16 rows (the histogram, then the bin
    solve) against ``repro.core.sparsify.closed_form_lambda``, rtol 1e-6."""
    x = _lambda_rows()
    lam = ops.closed_lambda(_group(x), eps)
    for r in range(x.shape[0]):
        want = jsp.closed_form_lambda(
            jnp.asarray(x[r]).astype(jnp.bfloat16), eps)[0]
        np.testing.assert_allclose(float(lam[r]), float(want), rtol=1e-6,
                                   atol=0, err_msg=f"row {r}")


def _numpy_bin_solve(counts: np.ndarray, eps: float):
    """The bin solve restated in numpy, one row: (lambda, bin)."""
    c = counts.astype(np.int64)
    val = (np.arange(1 << 15, dtype=np.uint32) << 16).view(np.float32)
    v = np.zeros(c.shape)
    v[c > 0] = val[c > 0]
    s1 = c.astype(np.float64) * v
    s2 = s1 * v
    total = s2.sum()
    t_low = np.cumsum(s1) - s1
    l_low = np.cumsum(s2) - s2
    ok = np.nonzero((c > 0) & (v * t_low <= eps * total + l_low))[0]
    if not ok.size:
        return np.float32(0.0), -1
    b = int(ok[-1])
    den = eps * total + s2[b] + l_low[b]
    lam = (s1[b] + t_low[b]) / den if den > 0 else 0.0
    return np.float32(lam), b


@pytest.mark.parametrize("eps", [1.0, 40.0])
def test_closed_lambda_is_the_bincount_solve(eps):
    """``kernel.closed_lambda`` (its plain version) on the bincount of each
    row: the bin and lambda of a numpy restatement bit for bit, and the
    bin holds the k*-th magnitude of the port's float64 sort."""
    x = _lambda_rows()
    g = _group(x)
    counts = K.magnitude_hist(g)
    for r in range(x.shape[0]):
        np.testing.assert_array_equal(
            counts[r].numpy(), np.bincount(
                ref.magnitude_keys(g[r]).numpy(), minlength=1 << 15))
    lam, b = K.closed_lambda(counts, eps)
    assert lam.dtype == torch.float32 and b.dtype == torch.int32
    for r in range(x.shape[0]):
        want_lam, want_b = _numpy_bin_solve(counts[r].numpy(), eps)
        assert int(b[r]) == want_b
        assert lam[r].numpy().view(np.uint32) == want_lam.view(np.uint32)
        a = np.sort(np.abs(x[r]).astype(np.float64))[::-1]
        tail_l1 = np.cumsum(a[::-1])[::-1]
        tail_l2 = np.cumsum((a * a)[::-1])[::-1]
        k = int(np.argmax(a * tail_l1 <= eps * tail_l2[0] + tail_l2))
        key = int(np.float32(a[k]).view(np.uint32) >> 16)
        assert key == want_b, f"row {r}"
        np.testing.assert_allclose(
            float(lam[r]), float(tsp.closed_form_lambda(g[r], eps)[0]),
            rtol=1e-6, atol=0)


def test_closed_lambda_takes_no_bin_below_zero_eps():
    """eps < 0: no bin qualifies on a row with a nonzero (lambda 0, bin
    -1); an all-zero row keeps bin 0 and lambda 0."""
    counts = K.magnitude_hist(_group(_lambda_rows()))
    lam, b = K.closed_lambda(counts, -1.0)
    assert b.tolist() == [-1, -1, -1, 0]
    assert lam.tolist() == [0.0] * 4


def test_port_imports_no_jax():
    """The compaction's and lambda's modules load neither JAX nor the JAX
    package."""
    code = (
        "import sys\n"
        "import repro_torch.kernels.sparsify.ops, repro_torch.core.sparsify\n"
        "import repro_torch.comm.sync, repro_torch.core.sparse\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
