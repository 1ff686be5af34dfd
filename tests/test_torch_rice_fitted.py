"""Wire-format v4 in the port against the JAX package, on the same numpy
inputs: the data-fitted Golomb-Rice window, parameter and word count
(``coding``), the fitted encoder and the per-row decode (``compaction``),
the plain versions of the two kernels of the fitted packing (``rice_fit``
and ``rice_pack_fitted``, which the wrappers take on the CPU) and the
pipelines' fitted packing (``ops._two_pass``), bit for bit over the gap
regimes of ``tests/test_rice.py::TestRiceFitted``: iid draws, a clustered
front block, one far coordinate, an all-dead row, k_cap = d, overflowing
rows and ragged word tails; the zero header (the skip sentinel) decodes
dead. Also the off-wire estimators of ``repro.core.coding``, the config's
adaptive fields and ``describe()``, and the ``repro_torch.api`` facade."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.comm import compaction as J
from repro.core import coding as JC
from repro.core.api import CompressionConfig as JConfig
from repro_torch import api as tapi
from repro_torch.comm import compaction as T
from repro_torch.comm import wire_layout as TW
from repro_torch.core import coding as TC
from repro_torch.core.api import CompressionConfig
from repro_torch.kernels.sparsify import kernel as K, ops

torch.set_num_threads(1)

# (d, k_cap, live coordinates) of each regime, drawn from seed 23
REGIMES = {
    "iid": (1 << 14, 256, "iid200"),
    "clustered": (1 << 14, 256, "front200"),
    "single_far": (1 << 14, 256, "far"),
    "all_dead": (4096, 64, "none"),
    "kcap_eq_d": (300, 300, "iid170"),
    "ragged_tail": (1000, 37, "iid29"),
    "r0_dense": (130, 128, "iid100"),
}


def _coords(rng, d, spec):
    if spec == "none":
        return np.zeros(0, np.int64)
    if spec == "far":
        return np.asarray([d - 1])
    if spec.startswith("front"):
        return np.arange(int(spec[5:]), dtype=np.int64)
    return np.sort(rng.choice(d, int(spec[3:]), replace=False))


@functools.lru_cache(maxsize=None)
def _jax_encode(d, window):
    """The JAX fitted encoder, jitted (eager JAX compiles every primitive
    anew at each shape, several seconds a call)."""
    return jax.jit(functools.partial(J.rice_encode_fitted, d=d,
                                     window=window))


@functools.lru_cache(maxsize=None)
def _jax_decode(k_cap, d, window):
    return jax.jit(functools.partial(J.rice_decode_fitted, k_cap=k_cap, d=d,
                                     window=window))


def _compact(d, k_cap, coords, rng):
    """The compact pair of a row: live slots ascending, then zeros."""
    vals = np.zeros(k_cap, np.float32)
    idx = np.zeros(k_cap, np.int32)
    n = min(coords.size, k_cap)
    vals[:n] = (1.0 + rng.random(n)).astype(np.float32)
    idx[:n] = coords[:n]
    return vals, idx


def _regime(name):
    d, k_cap, spec = REGIMES[name]
    rng = np.random.default_rng(23)
    coords = _coords(rng, d, spec)
    vals, idx = _compact(d, k_cap, coords, rng)
    return d, k_cap, coords, vals, idx


@pytest.mark.parametrize("name", list(REGIMES))
def test_fitted_encoder_matches_jax(name):
    """Window, capacity, words and header bit-equal to the JAX encoder, on
    the generic and the sorted path; used and r as the coding model's
    fitted twins say; never more words than the static parameter."""
    d, k_cap, coords, vals, idx = _regime(name)
    window = JC.rice_fit_window(k_cap, d)
    assert TC.rice_fit_window(k_cap, d) == window
    assert T.rice_fit_cap_words(k_cap, d, window) == J.rice_fit_cap_words(
        k_cap, d, window)
    _, jw, jh = _jax_encode(d, window)(jnp.asarray(vals), jnp.asarray(idx))
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    n = torch.tensor(min(coords.size, k_cap), dtype=torch.int32)
    for nnz in (None, n):
        _, tw, th = T.rice_encode_fitted(tv, ti, d, window, nnz=nnz)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert int(th) == int(jh)
    used = int(th) & T.RICE_HDR_USED_MASK
    r = int(th) >> T.RICE_HDR_SHIFT
    assert (T.RICE_HDR_SHIFT, T.RICE_HDR_USED_MASK) == (
        J.RICE_HDR_SHIFT, J.RICE_HDR_USED_MASK)
    assert used == TC.rice_fitted_stream_words(coords, k_cap, d) \
        == JC.rice_fitted_stream_words(coords, k_cap, d)
    assert r == TC.rice_fitted_parameter(coords, k_cap, d) \
        == JC.rice_fitted_parameter(coords, k_cap, d)
    assert used <= TC.rice_stream_words(coords, k_cap, d)
    if name == "clustered":                  # the fit pays somewhere
        assert used < TC.rice_stream_words(coords, k_cap, d)
    if name == "all_dead":
        assert r == window[0]


@pytest.mark.parametrize("name", list(REGIMES))
def test_fitted_decode_matches_jax(name):
    """Decoded at the header's r, the live slots are the coordinates and
    equal JAX's decode (each row decoded once: no candidate sweep)."""
    d, k_cap, coords, vals, idx = _regime(name)
    window = JC.rice_fit_window(k_cap, d)
    _, jw, jh = _jax_encode(d, window)(jnp.asarray(vals), jnp.asarray(idx))
    got = T.rice_decode_fitted(torch.from_numpy(np.array(jw)), k_cap, d,
                               window, torch.tensor(int(jh))).numpy()
    want = np.asarray(_jax_decode(k_cap, d, window)(jw, header=jh))
    n = min(coords.size, k_cap)
    np.testing.assert_array_equal(got[:n], coords[:n])
    np.testing.assert_array_equal(got[:n], want[:n])


def test_header_is_decode_authoritative():
    """Every candidate's static stream, shipped under its own header in the
    fitted capacity, decodes as the static decode at that r; a batch of
    rows at different r decodes each row at its own."""
    rng = np.random.default_rng(29)
    d, k_cap = 1 << 12, 128
    coords = np.sort(rng.choice(d, 100, replace=False))
    vals, idx = _compact(d, k_cap, coords, rng)
    window = JC.rice_fit_window(k_cap, d)
    assert len(window) > 1
    cap = T.rice_fit_cap_words(k_cap, d, window)
    rows, headers = [], []
    for r in window:
        _, w, used = T.rice_encode(torch.from_numpy(vals),
                                   torch.from_numpy(idx), d, r)
        padded = torch.zeros(cap, dtype=torch.int32)
        padded[:w.shape[0]] = w
        header = (r << T.RICE_HDR_SHIFT) | int(used)
        got = T.rice_decode_fitted(padded, k_cap, d, window,
                                   torch.tensor(header, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(),
                                      T.rice_decode(w, k_cap, d, r).numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            _jax_decode(k_cap, d, window)(jnp.asarray(padded.numpy()),
                                          header=jnp.int32(header))))
        rows.append(padded)
        headers.append(header)
    batch = T.rice_decode_fitted(torch.stack(rows), k_cap, d, window,
                                 torch.tensor(headers, dtype=torch.int32))
    for row in batch:
        np.testing.assert_array_equal(row[:100].numpy(), coords)


def test_zero_header_skip_sentinel_decodes_dead():
    """A zeroed header over zero words decodes to k_cap in-range
    coordinates, and with its zero values every slot of the row goes to the
    receiver's scratch tail: the row adds nothing."""
    d, k_cap = 4096, 64
    window = JC.rice_fit_window(k_cap, d)
    cap = T.rice_fit_cap_words(k_cap, d, window)
    idx = T.rice_decode_fitted(torch.zeros(cap, dtype=torch.int32), k_cap, d,
                               window, torch.tensor(0, dtype=torch.int32))
    assert idx.shape == (k_cap,) and int(idx.min()) >= 0
    assert int(idx.max()) < d + k_cap
    lp = TW.LeafPlan("rice", 1, d, k_cap, k_cap, cap, 3, True, window)
    drop = d
    upd, crd = TW.unpack_gathered(
        lp, torch.zeros((1, k_cap)), torch.full((1, cap), -1,
                                                dtype=torch.int32),
        0, torch.zeros((1, 1), dtype=torch.int32), drop=drop)
    assert bool((crd >= drop).all()) and not bool(upd.any())


def _rows():
    """A [rows, k_cap] compact group of one d: every regime's density, an
    empty row, a full row and overflowing nnz."""
    rng = np.random.default_rng(31)
    d, k_cap = 5000, 384
    specs = [200, 384, 0, 40, 384, 7]
    idx = np.zeros((len(specs), k_cap), np.int32)
    nnz = np.zeros(len(specs), np.int32)
    for row, n in enumerate(specs):
        c = np.sort(rng.choice(d, n, replace=False))
        if row == 3:
            c = np.arange(n) + 3000              # clustered
        idx[row, :n] = c
        nnz[row] = n + (50 if row == 4 else 0)   # row 4 overflows
    return d, k_cap, idx, nnz


def test_kernels_plain_versions_match_jax_encoder():
    """``rice_fit`` and ``rice_pack_fitted`` on the CPU (their plain
    versions) give r, header and words bit-equal to the JAX package's
    ``rice_encode_fitted`` of each row's live prefix."""
    d, k_cap, idx, nnz = _rows()
    window = JC.rice_fit_window(k_cap, d)
    ti, tn = torch.from_numpy(idx), torch.from_numpy(nnz)
    r, header = K.rice_fit(ti, tn, d=d, window=window)
    words, header2 = K.rice_pack_fitted(ti, tn, r, d=d, window=window)
    assert torch.equal(header, header2)
    assert torch.equal(r, header >> T.RICE_HDR_SHIFT)
    for row in range(idx.shape[0]):
        n = min(int(nnz[row]), k_cap)
        vals = np.zeros(k_cap, np.float32)
        vals[:n] = 1.0
        _, jw, jh = _jax_encode(d, window)(jnp.asarray(vals),
                                           jnp.asarray(idx[row]))
        np.testing.assert_array_equal(words[row].numpy(), np.asarray(jw))
        assert int(header[row]) == int(jh)
    assert len(set(r.tolist())) > 1            # rows at different r
    with pytest.raises(ValueError):
        K.rice_fit(ti, tn, d=d, window=(3, 2))


def test_two_pass_packs_the_fitted_format():
    """The pipelines' fitted packing (``gspar_emit`` and ``topk_emit`` with
    a window) ships the words and headers of the fitted encoder on their
    own compact buffers, and the same compact buffers as the static
    packing."""
    rng = np.random.default_rng(37)
    g = torch.from_numpy((rng.standard_normal((3, 3000))
                          * np.exp(rng.standard_normal((3, 3000))))
                         .astype(np.float32))
    u = torch.from_numpy(rng.random((3, 3000)).astype(np.float32))
    k_cap, d = 256, 3000
    window = TC.rice_fit_window(k_cap, d)
    r_s = TC.rice_parameter(k_cap, d)
    for emit in (lambda **kw: ops.gspar_emit(g, u, rho=0.05, **kw)[0],
                 lambda **kw: ops.topk_emit(g, k_target=150, **kw)):
        er = emit(k_cap=k_cap, rice_r=r_s, rice_window=window)
        st = emit(k_cap=k_cap, rice_r=r_s)
        assert torch.equal(er.idx, st.idx) and torch.equal(er.values,
                                                           st.values)
        _, w, h = T.rice_encode_fitted(er.values, er.idx, d, window,
                                       nnz=er.nnz)
        assert torch.equal(er.rice_words, w)
        assert torch.equal(er.rice_used, h)
        assert bool(((er.rice_used & T.RICE_HDR_USED_MASK)
                     <= st.rice_used).all())


def test_off_wire_estimators_match_jax():
    rng = np.random.default_rng(41)
    p = np.clip(rng.random(3000) * 1.5, 0, 1).astype(np.float32)
    got = TC.expected_coding_bits(torch.from_numpy(p))
    want = np.asarray(JC.expected_coding_bits(jnp.asarray(p)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for s, rho, d in ((10, 0.1, 1000), (500, 0.01, 1 << 20), (3, 0.5, 7)):
        assert TC.theorem4_bound_bits(s, rho, d) \
            == JC.theorem4_bound_bits(s, rho, d)
    assert TC.qsgd_coding_bits(1000, 4) == JC.qsgd_coding_bits(1000, 4)
    idx = np.sort(rng.choice(1 << 16, 700, replace=False))
    gaps = np.diff(idx, prepend=-1)
    assert TC.elias_gamma_bits(gaps) == JC.elias_gamma_bits(gaps)
    for m in (None, 1, 5, 64):
        assert TC.golomb_bits(gaps, m) == JC.golomb_bits(gaps, m)
    for method in ("golomb", "elias"):
        assert TC.delta_coded_index_bits(idx, 1 << 16, method) \
            == JC.delta_coded_index_bits(idx, 1 << 16, method)
    assert TC.golomb_bits([]) == 0.0 and TC.elias_gamma_bits([]) == 0.0
    for bad in (lambda: TC.elias_gamma_bits([0]),
                lambda: TC.golomb_bits([0]),
                lambda: TC.delta_coded_index_bits(idx, 1 << 16, "x")):
        with pytest.raises(ValueError):
            bad()


def test_fitted_capacity_refuses_past_the_header():
    """A row whose fitted capacity reaches the header's 2^26 words raises
    rather than truncate; gemma-2b's widest row fits."""
    d = 524_288_000
    k_cap = T.capacity_for(d, 0.05)
    window = TC.rice_fit_window(k_cap, d)
    assert T.rice_fit_cap_words(k_cap, d, window) == 7_168_000
    with pytest.raises(ValueError, match="header"):
        T.rice_fit_cap_words(1 << 30, 2**31 - 1, (0, 1))


ADAPTIVE = dict(name="topk", rho=0.01, wire="gather", wire_layout="rice",
                error_feedback=True, adaptive=True, delta_beta=1.0,
                skip_tau=0.7, bound_decay=0.9, rice_fitted=True)


def test_config_takes_the_adaptive_fields_with_jax_errors():
    cfg = CompressionConfig(**ADAPTIVE)
    jcfg = JConfig(**ADAPTIVE)
    want = jcfg.describe().split(" ef ", 1)[1]
    assert cfg.describe().split(" ef ", 1)[1] == want
    assert want == "adaptive(beta=1 tau=0.7 decay=0.9) rice_fitted"
    CompressionConfig(rice_fitted=True, wire="gather")
    for bad in (dict(adaptive=True), dict(adaptive=True, error_feedback=True,
                                          resparsify_pods=True),
                dict(delta_beta=1.5), dict(skip_tau=-1.0),
                dict(bound_decay=1.0)):
        for make in (CompressionConfig, JConfig):
            with pytest.raises(ValueError):
                make(**bad)
    for bad in (dict(wire="packed"), dict(exchange="overlap"),
                dict(resparsify_pods=True)):
        with pytest.raises(NotImplementedError, match="item 9"):
            CompressionConfig(**bad)


def test_facade_matches_jax():
    assert tapi.__all__ == japi.__all__
    for name in tapi.__all__:
        assert getattr(tapi, name) is not None
    leaves = [torch.ones(3), torch.ones((2, 2), dtype=torch.bfloat16)]
    zs = tapi.zeros_like_residual(leaves)
    assert all(z.dtype == x.dtype and z.shape == x.shape and not z.any()
               for z, x in zip(zs, leaves))
