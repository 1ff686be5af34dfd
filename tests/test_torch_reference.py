"""The port's magnitude compaction and reference backend against the JAX
package's, on the same numpy inputs.

``compaction.compact`` (``ops.magnitude_compact``: ``topk_threshold`` and
passes 1-2 of topk, here their plain versions) against the JAX
``compaction.compact``: ties at the k_cap-th magnitude (the lowest
coordinates kept), rows with fewer nonzeros than k_cap, an all-zero row,
and ``nnz`` before the cut. The JAX buffer descends by magnitude, the
port's ascends by coordinate: compared after sorting the JAX live slots by
coordinate. The pod stage's deterministic codec rounding (``det_round``)
against ``repro.comm.sync._encode_det``, with fractions at exactly 0.5.

``ReferenceBackend`` against the JAX ``ReferenceBackend`` row by row, the
JAX ``jax.random.uniform`` fed the port's draws: agspar with EF,
identity+qsgd4 (``k_cap = d``) and topk's ``_topk_fast`` at a capacity
below k_target (its overflow). Kept coordinates, nnz and topk's values and
residual bit for bit; agspar's values ``g / p`` to rtol 1e-5 (lambda and
the qsgd scale are sums taken in different orders by the two packages, as
``tests/test_torch_compositions.py`` allows), qsgd's levels bit for bit
away from draws within 1e-5 of their fraction. Also ``kernel_interpret``
and the backends' selection."""
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
import jax
import jax.numpy as jnp
from repro.comm import compaction as jcompaction
from repro.comm.sync import _encode_det
from repro.core import codecs as jcodecs
from repro.core.api import CompressionConfig as JConfig
from repro.core.sparse import ReferenceBackend as JReference

from repro_torch.comm import compaction
from repro_torch.core import codecs
from repro_torch.core.api import CompressionConfig, compress_tree_sparse
from repro_torch.core.sparse import (KernelBackend, ReferenceBackend,
                                     resolve_backend)
from repro_torch.kernels.sparsify import kernel as K
from repro_torch.kernels.sparsify import ops

torch.set_num_threads(1)


def _rows() -> dict:
    """Named [rows, d] float32 groups: heavy-tailed rows, rows with ties at
    the capacity's magnitude, sparse rows under the capacity, a zero
    row."""
    rng = np.random.default_rng(7)
    d = 1000
    dense = (rng.standard_normal((3, d))
             * np.exp(rng.standard_normal((3, d)))).astype(np.float32)
    ties = np.round(rng.standard_normal((2, d)) * 2).astype(np.float32)
    sparse = np.zeros((2, d), np.float32)
    sparse[0, rng.choice(d, 40, replace=False)] = rng.standard_normal(40)
    sparse[1, [3, 500, 999]] = [1.0, -2.0, 0.5]
    zero = np.zeros((1, d), np.float32)
    return {"dense": dense, "ties": ties, "sparse": sparse, "zero": zero}


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
@pytest.mark.parametrize("k_cap", [128, 256])
def test_compact_matches_jax(name, k_cap):
    x = _rows()[name]
    got_v, got_i, got_n = compaction.compact(torch.from_numpy(x), k_cap)
    for r in range(x.shape[0]):
        jv, ji, jn = jcompaction.compact(jnp.asarray(x[r]), k_cap)
        assert int(got_n[r]) == int(jn) == int((x[r] != 0).sum())
        wv, wi = _jax_sorted(jv, ji)
        pv, pi = _port_live(got_v[r], got_i[r], got_n[r])
        np.testing.assert_array_equal(pi, wi, err_msg=f"{name} row {r}")
        np.testing.assert_array_equal(pv, wv)
        # one vector in, one buffer out
        v1, i1, n1 = compaction.compact(torch.from_numpy(x[r]), k_cap)
        assert torch.equal(v1, got_v[r]) and torch.equal(i1, got_i[r])
    if name == "ties":       # the cut falls inside the ties
        mag = np.sort(np.abs(x), axis=1)[:, ::-1]
        assert (mag[:, k_cap - 1] == mag[:, k_cap]).all()


def test_compact_keeps_the_lowest_coordinates_among_ties():
    x = np.zeros(300, np.float32)
    x[[7, 50, 51, 200, 299]] = [-3.0, 2.0, -2.0, 2.0, 2.0]
    v, i, n = compaction.compact(torch.from_numpy(x), 3)
    assert i.tolist() == [7, 50, 51] and v.tolist() == [-3.0, 2.0, -2.0]
    assert int(n) == 5


def _det_row() -> np.ndarray:
    """Values whose qsgd4 fractions hit exactly 0.5 (norm 2: |v| = 1 gives
    scaled 7.5) and whose ternary ratios hit exactly 0.5 and the float32
    below it."""
    x = np.zeros((2, 512), np.float32)
    x[0, [1, 9, 100, 300]] = [1.0, -1.0, 1.0, -1.0]          # qsgd: 7.5
    x[1, [2, 3, 4, 5, 6]] = [4.0, 2.0, -2.0, np.nextafter(
        np.float32(2.0), np.float32(0)), 0.5]                # ternary
    return x


@pytest.mark.parametrize("codec", ["qsgd4", "qsgd8", "ternary", "bf16"])
def test_deterministic_rounding_matches_encode_det(codec):
    """The pod stage's compaction and keyless encode: levels (and scales)
    equal to ``_encode_det`` over JAX's compact buffer, ties at exactly
    0.5 rounding up (qsgd) and kept (ternary); the kernel's uniform is the
    float32 just below 0.5."""
    assert K.DET_U == float(np.nextafter(np.float32(0.5), np.float32(0)))
    x = np.concatenate([_det_row(), _rows()["dense"][:, :512]])
    tc, jc = codecs.get(codec), jcodecs.get(codec)
    c = ops.magnitude_compact(torch.from_numpy(x), k_cap=128, codec=tc)
    for r in range(x.shape[0]):
        jv, ji, jn = jcompaction.compact(jnp.asarray(x[r]), 128)
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
    if codec == "ternary":    # |v| / 4 = 1, 0.5, 0.5 kept; just below not
        assert c.idx[1, :c.live[1]].tolist() == [2, 3, 4]


def test_plain_pass_two_rounds_at_det_u_only_by_name():
    g = torch.from_numpy(_det_row())
    t, budget = K.topk_threshold(g, 128)
    sel = K.select_stats(g, None, t, 128, pkind="topk", budget=budget)
    q4 = codecs.get("qsgd4")
    scale = codecs.finalize_scale(q4, sel.sum_sq, sel.max_abs)
    det, _, _ = K.compact_emit(g, None, t, sel, k_cap=128, codec=q4,
                               ef=False, pkind="topk", budget=budget,
                               scale=scale, det_round=True)
    u = torch.full((2, 128), K.DET_U)
    fed, _, _ = K.compact_emit(g, None, t, sel, k_cap=128, codec=q4,
                               ef=False, pkind="topk", budget=budget,
                               scale=scale, u_cod=u)
    assert torch.equal(det, fed)
    with pytest.raises(ValueError, match="det_round"):
        K.compact_emit(g, None, t, sel, k_cap=128, codec=q4, ef=False,
                       pkind="topk", budget=budget, scale=scale)


def _jax_rows(cfg_kw, x, u, u_cod, k_cap, ef):
    """The JAX reference backend row by row, its two ``jax.random.uniform``
    draws (the selector's, the codec's) fed from ``u`` and ``u_cod``."""
    cfg = JConfig(backend="reference", wire="gather", **cfg_kw)
    out = []
    real = jax.random.uniform
    for r in range(x.shape[0]):
        feed = [a[r] for a in (u, u_cod) if a is not None]

        def fake(key, shape, dtype=jnp.float32, *a, **kw):
            nxt = feed.pop(0)
            assert tuple(shape) == nxt.shape
            return jnp.asarray(nxt, dtype)

        jax.random.uniform = fake
        try:
            be = JReference()
            g = jnp.asarray(x[r])
            if ef:
                sg, res = be.compress_sparse_ef(cfg, jax.random.key(0), g,
                                                k_cap)
            else:
                sg, res = be.compress_sparse(cfg, jax.random.key(0), g,
                                             k_cap), None
        finally:
            jax.random.uniform = real
        assert not feed
        out.append((sg, res))
    return out


@pytest.mark.parametrize("name,ef", [("agspar", True), ("identity+qsgd4",
                                                        False),
                                     ("identity+qsgd4", True)])
def test_reference_backend_matches_jax(name, ef):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 2048))
         * np.exp(rng.standard_normal((3, 2048)))).astype(np.float32)
    kw = dict(name=name, rho=0.05, error_feedback=ef)
    cfg = CompressionConfig(wire="gather", backend="reference", **kw)
    scheme = cfg.scheme()
    k_cap = cfg.capacity(2048)
    gen = torch.Generator().manual_seed(3)
    u = (torch.rand(x.shape, generator=gen) if scheme.selector.samples
         else None)
    u_cod = (torch.rand(x.shape, generator=gen) if scheme.codec.stochastic
             else None)
    be = ReferenceBackend()
    g = torch.from_numpy(x)
    if ef:
        sg, res = be.compress_sparse_ef(cfg, u, g, k_cap, u_cod)
    else:
        sg, res = be.compress_sparse(cfg, u, g, k_cap, u_cod), None
    want = _jax_rows(kw, x, None if u is None else u.numpy(),
                     None if u_cod is None else u_cod.numpy(), k_cap, ef)
    codec = scheme.codec
    for r, (jsg, jres) in enumerate(want):
        assert int(sg.nnz[r]) == int(jsg.nnz)
        np.testing.assert_allclose(float(sg.scale[r]), float(jsg.scale),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(sg.bits[r]), float(jsg.bits),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(sg.var_ratio[r]),
                                   float(jsg.var_ratio), rtol=1e-5)
        np.testing.assert_allclose(float(sg.p_sum[r]), float(jsg.p_sum),
                                   rtol=1e-5)
        wv, wi = _jax_sorted(jsg.values, jsg.idx)
        pv, pi = _port_live(sg.values[r], sg.idx[r], sg.nnz[r])
        np.testing.assert_array_equal(pi, wi)
        if codec.integer_coded:
            # a level may flip where the draw sits within an ulp of the
            # fraction (the scales are sums in different orders)
            frac = np.abs(x[r][pi]) / float(jsg.scale) * codec.levels
            near = np.abs(u_cod[r].numpy()[pi] - (frac - np.floor(frac))) \
                < 1e-5
            assert near.sum() <= 2
            np.testing.assert_array_equal(pv[~near], wv[~near])
        else:
            # g / p at lambda from sums in different orders: an ulp apart
            np.testing.assert_allclose(pv, wv, rtol=1e-5)
        if ef and not codec.integer_coded:
            # g - v cancels where v is near g: the values' ulp, absolute
            np.testing.assert_allclose(res[r].numpy(), np.asarray(jres),
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(pv).max())


def test_topk_fast_reports_the_capacity_overflow():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    kw = dict(name="topk", rho=0.5, error_feedback=True)
    cfg = CompressionConfig(wire="gather", backend="reference", **kw)
    sg, res = ReferenceBackend().compress_sparse_ef(
        cfg, None, torch.from_numpy(x), 384)
    want = _jax_rows(kw, x, None, None, 384, True)
    for r, (jsg, jres) in enumerate(want):
        assert int(sg.nnz[r]) == int(jsg.nnz) == 512
        assert int(sg.overflow()[r]) == 128
        wv, wi = _jax_sorted(jsg.values, jsg.idx)
        pv, pi = _port_live(sg.values[r], sg.idx[r], 384)
        np.testing.assert_array_equal(pi, wi)
        np.testing.assert_array_equal(pv, wv)
        np.testing.assert_array_equal(res[r].numpy(), np.asarray(jres))
        assert float(sg.bits[r]) == float(jsg.bits)


def test_backend_selection_and_kernel_interpret():
    """``backend="reference"`` takes the reference backend, ``auto`` and
    ``pallas`` the kernel backend, which hands agspar and identity to the
    reference backend. ``kernel_interpret`` None and False both take the
    kernels (their plain versions here, on CPU tensors, as anywhere the
    tensor lies on the CPU) and give the same result; True is refused, as
    the port has no route from the card to the plain versions."""
    assert isinstance(resolve_backend(CompressionConfig(
        backend="reference")), ReferenceBackend)
    for b in ("auto", "pallas"):
        assert isinstance(resolve_backend(CompressionConfig(backend=b)),
                          KernelBackend)
    sch = CompressionConfig(name="agspar").scheme()
    assert KernelBackend.uses_dense(sch) and ReferenceBackend.uses_dense(
        CompressionConfig().scheme())
    assert not KernelBackend.uses_dense(CompressionConfig().scheme())
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        CompressionConfig(kernel_interpret=True)
    leaves = [torch.randn(2, 600, generator=torch.Generator().manual_seed(0))]
    out = []
    for interp in (None, False):
        cfg = CompressionConfig(name="gspar", rho=0.1, wire="gather",
                                kernel_interpret=interp)
        items, _, _ = compress_tree_sparse(
            cfg, torch.Generator().manual_seed(1), leaves, [True])
        (kind, sg, _), = items
        assert kind == "sparse"
        out.append((sg.values, sg.idx))
    for a, b in zip(*out):
        assert torch.equal(a, b)
