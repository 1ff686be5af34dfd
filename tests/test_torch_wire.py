"""The port's wire layouts and index codecs against the JAX package, on the
same numpy inputs: the static layout rule (``rice_parameter``, the word
capacities, ``realized_wire_bits`` and the ``auto`` chooser) equal over a
grid of ``(k_cap, d, value width)`` that holds gemma-2b's groups at full
width and at the smoke size; ``coordinate_order``, the bitmap codec and the
Golomb-Rice codec bit-equal on the sorted and the generic path; and the
RICE codec's edge cases (the cases of ``tests/test_rice.py``) against the
JAX codec and the off-wire word count ``coding.rice_stream_words``."""
import jax
import numpy as np
import pytest
import torch

from repro.comm import compaction as J
from repro.comm import wire_layout as JW
from repro.core import coding as JC
from repro_torch.comm import compaction as T
from repro_torch.comm import wire_layout as TW
from repro_torch.core import coding as TC

torch.set_num_threads(1)

# gemma-2b at full width and its smoke config, rho 0.05 (row length d)
GEMMA_D = (524_288, 4_194_304, 33_554_432, 2_048, 524_288_000)
SMOKE_D = (16_384, 65_536, 131_072)
GRID = ([(T.capacity_for(d, 0.05), d) for d in GEMMA_D + SMOKE_D]
        + [(128, 128), (128, 512), (128, 1 << 20), (1, 1 << 30), (100, 100),
           (128, 200), (384, 3000), (896, 1 << 16), (3328, 1 << 18),
           (640, 5000), (100_000, 100_000), (7, 70)])


@pytest.mark.parametrize("k_cap,d", GRID)
def test_static_layout_rule_matches_jax(k_cap, d):
    r = TC.rice_parameter(k_cap, d)
    assert r == JC.rice_parameter(k_cap, d)
    assert TC.rice_wire_words(k_cap, d) == JC.rice_wire_words(k_cap, d)
    assert T.rice_cap_words(k_cap, d, r) == J.rice_cap_words(k_cap, d, r)
    assert T.bitmap_words(d) == J.bitmap_words(d)
    for vb in (8.0, 16.0, 32.0):
        for layout in TW.LAYOUTS:
            assert (TC.realized_wire_bits(layout, k_cap, d, vb)
                    == JC.realized_wire_bits(layout, k_cap, d, vb))
        assert TW.choose(k_cap, d, vb) == JW.choose(k_cap, d, vb)


def test_auto_picks_rice_on_the_gemma_groups():
    """At rho 0.05 with bf16 values every gemma-2b group, at full width and
    at the smoke size, rides RICE."""
    for d in GEMMA_D + SMOKE_D:
        assert TW.choose(T.capacity_for(d, 0.05), d, 16.0) == "rice"
        assert TW.choose(T.capacity_for(d, 0.05), d, 32.0) == "rice"
    assert TW.choose(128, 200, 32.0) == "bitmap"
    assert TW.choose(100, 100, 32.0) == "dense"
    assert TW.choose(128, 1 << 20, 32.0, "coo") == "coo"
    with pytest.raises(ValueError):
        TW.choose(128, 200, 32.0, "csr")


def _compact(rng, rows, d, k_cap, n_live, zero_level=False):
    """``(vals, idx, nnz)`` of a counting compaction: ascending live prefix
    per row, padding idx 0 / value 0; with ``zero_level`` one live value is
    zero (a codec-zeroed level)."""
    vals = np.zeros((rows, k_cap), np.float32)
    idx = np.zeros((rows, k_cap), np.int32)
    nnz = np.zeros(rows, np.int32)
    for r in range(rows):
        n = int(n_live[r]) if np.ndim(n_live) else int(n_live)
        live = np.sort(rng.choice(d, min(n, k_cap), replace=False))
        idx[r, :live.size] = live
        vals[r, :live.size] = (rng.standard_normal(live.size) + 3.0)
        if zero_level and live.size > 2:
            vals[r, 1] = 0.0
        nnz[r] = n
    return vals, idx, nnz


CODEC_CASES = [  # rows, d, k_cap, n_live per row, r (None: the static one)
    (3, 1000, 128, (50, 0, 128), None),
    (2, 70, 64, (5, 64), 0),
    (2, 1 << 16, 128, (1, 130), 8),       # the second row overflows k_cap
    (4, 4096, 256, (256, 17, 3, 0), 3),
    (2, 100, 6, (3, 6), 1),
    (1, 100_003, 8192, (6000,), None),
]


@pytest.mark.parametrize("sorted_path", [True, False])
@pytest.mark.parametrize("rows,d,k_cap,n_live,r", CODEC_CASES)
def test_codecs_match_jax(rows, d, k_cap, n_live, r, sorted_path):
    """coordinate_order, bitmap_pack/bitmap_select and rice_encode/
    rice_decode bit-equal to the JAX package's (rows vmapped there, batched
    here), and the used counts equal to the off-wire word count."""
    rng = np.random.default_rng(d + k_cap)
    vals, idx, nnz = _compact(rng, rows, d, k_cap, n_live,
                              zero_level=not sorted_path)
    r = TC.rice_parameter(k_cap, d) if r is None else r
    tn = torch.from_numpy(nnz) if sorted_path else None
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    co = T.coordinate_order(tv, ti, d, nnz=tn)
    bm = T.bitmap_pack(tv, ti, d, nnz=tn)
    sel = T.bitmap_select(bm[1], bm[0], d)
    rc = T.rice_encode(tv, ti, d, r, nnz=tn)
    dec = T.rice_decode(rc[1], k_cap, d, r)

    @jax.jit
    def jax_rows(v, i, n):
        def one(v, i, n):
            n = n if sorted_path else None
            bm = J.bitmap_pack(v, i, d, nnz=n)
            rc = J.rice_encode(v, i, d, r, nnz=n)
            return (J.coordinate_order(v, i, d, nnz=n), bm,
                    J.bitmap_select(bm[1], bm[0], d), rc,
                    J.rice_decode(rc[1], k_cap, d, r))
        return jax.vmap(one)(v, i, n)

    jco, jbm, jsel, jrc, jdec = jax_rows(vals, idx, nnz)
    for got, want in zip((*co, *bm, sel, *rc, dec),
                         (*jco, *jbm, jsel, *jrc, jdec)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for row in range(rows):
        live = vals[row][:min(nnz[row], k_cap)] != 0
        if sorted_path:
            live[:] = True
        live_idx = idx[row][:live.size][live]
        want_used = TC.rice_stream_words(live_idx, k_cap, d, r)
        assert int(rc[2][row]) == want_used == JC.rice_stream_words(
            live_idx, k_cap, d, r)
        assert want_used <= T.rice_cap_words(k_cap, d, r)


def _roundtrip(vals, idx, d, r, nnz=None):
    """Encode, decode and scatter one message; returns the dense
    reconstruction, the used word count and the words."""
    sv, w, used = T.rice_encode(vals, idx, d, r, nnz=nnz)
    dec = T.rice_decode(w, vals.shape[-1], d, r)
    rec = torch.zeros(vals.shape[:-1] + (d,), dtype=vals.dtype)
    live = sv != 0
    rec.scatter_add_(-1, torch.where(live, dec, 0).long(),
                     torch.where(live, sv, 0.0))
    return rec, used, w


def _q(d, coords, values=None):
    q = np.zeros(d, np.float32)
    for i, c in enumerate(coords):
        q[c] = float(c + 1) if values is None else values[i]
    return q


def _from_dense(q, k_cap):
    """The counting compaction of a dense row: ascending nonzeros."""
    nz = np.flatnonzero(q)
    vals = np.zeros(k_cap, np.float32)
    idx = np.zeros(k_cap, np.int32)
    vals[:nz.size], idx[:nz.size] = q[nz], nz
    return (torch.from_numpy(vals), torch.from_numpy(idx),
            torch.tensor(nz.size, dtype=torch.int32))


@pytest.mark.parametrize("d,density", [(70, 0.3), (1000, 0.05),
                                       (4096, 0.1), (1 << 16, 0.01)])
def test_rice_roundtrip_exact(d, density):
    rng = np.random.default_rng(d)
    k_cap = min(d, max(128, -(-int(d * density) // 128) * 128))
    q = _q(d, rng.choice(d, int(d * density), replace=False),
           rng.standard_normal(int(d * density)) + 3.0)
    r = TC.rice_parameter(k_cap, d)
    for nnz_given in (True, False):
        v, i, n = _from_dense(q, k_cap)
        rec, used, w = _roundtrip(v, i, d, r, n if nnz_given else None)
        np.testing.assert_array_equal(rec.numpy(), q)
        assert int(used) <= T.rice_cap_words(k_cap, d, r)
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(jax.jit(J.rice_encode, static_argnums=(
                2, 3))(v.numpy(), i.numpy(), d, r)[1]))


def test_rice_k0_all_dead_row():
    d, k_cap, r = 1 << 12, 128, 4
    vals = torch.zeros(k_cap)
    idx = torch.zeros(k_cap, dtype=torch.int32)
    rec, used, _ = _roundtrip(vals, idx, d, r,
                              torch.tensor(0, dtype=torch.int32))
    assert not rec.any()
    assert int(used) == -(-(k_cap * (r + 1)) // 32)
    assert int(used) == TC.rice_stream_words([], k_cap, d, r)


def test_rice_kcap_equals_d_full_row():
    d = 256
    rng = np.random.default_rng(0)
    q = (rng.standard_normal(d).astype(np.float32)
         + np.sign(rng.standard_normal(d)).astype(np.float32) * 2)
    r = TC.rice_parameter(d, d)
    assert r == 0
    rec, used, _ = _roundtrip(*_from_dense(q, d)[:2], d, r)
    np.testing.assert_array_equal(rec.numpy(), q)
    assert int(used) == TC.rice_stream_words(np.arange(d), d, d, r)


def test_rice_single_element_stream():
    d, k_cap = 4096, 1
    r = TC.rice_parameter(k_cap, d)
    for coord in (0, 1, d - 1):
        q = _q(d, [coord], [1.5])
        rec, used, _ = _roundtrip(*_from_dense(q, k_cap)[:2], d, r)
        np.testing.assert_array_equal(rec.numpy(), q)
        assert int(used) == TC.rice_stream_words([coord], k_cap, d, r)


def test_rice_adversarial_max_gap_hits_capacity_exactly():
    """One live coordinate at d-1 carries the whole (d-1) >> r unary mass,
    the worst case the capacity prices: the stream fills it exactly."""
    d, k_cap = 1 << 16, 128
    q = _q(d, [d - 1], [2.5])
    for r in (0, 3, 8, TC.rice_parameter(k_cap, d)):
        v, i, n = _from_dense(q, k_cap)
        rec, used, _ = _roundtrip(v, i, d, r, n)
        np.testing.assert_array_equal(rec.numpy(), q)
        assert int(used) == T.rice_cap_words(k_cap, d, r)
        assert int(used) == TC.rice_stream_words([d - 1], k_cap, d, r)


def test_rice_r0_and_ragged_word_tail():
    d, coords = 70, [0, 31, 32, 63, 69]
    q = _q(d, coords)
    rec, used, _ = _roundtrip(*_from_dense(q, 64)[:2], d, 0)
    np.testing.assert_array_equal(rec.numpy(), q)
    assert int(used) == TC.rice_stream_words(coords, 64, d, 0)


def test_rice_batched_rows():
    d, rows, k_cap, r = 512, 4, 128, 2
    rng = np.random.default_rng(5)
    q = np.where(rng.random((rows, d)) < 0.1,
                 rng.standard_normal((rows, d)), 0.0).astype(np.float32)
    parts = [_from_dense(row, k_cap) for row in q]
    vals, idx = torch.stack([p[0] for p in parts]), torch.stack(
        [p[1] for p in parts])
    nnz = torch.stack([p[2] for p in parts])
    rec, used, _ = _roundtrip(vals, idx, d, r, nnz)
    np.testing.assert_array_equal(rec.numpy(), q)
    for row in range(rows):
        assert int(used[row]) == TC.rice_stream_words(np.flatnonzero(q[row]),
                                                      k_cap, d, r)


def test_rice_stream_words_match_jax_property():
    rng = np.random.default_rng(7)
    for _ in range(40):
        d = int(rng.integers(64, 1 << 16))
        k_cap = int(min(d, rng.integers(1, 1024)))
        live = np.sort(rng.choice(d, int(rng.integers(0, k_cap + 1)),
                                  replace=False))
        for r in (None, 0, 5):
            assert (TC.rice_stream_words(live, k_cap, d, r)
                    == JC.rice_stream_words(live, k_cap, d, r))
        assert (TC.rice_stream_words(live, k_cap, d)
                <= TC.rice_wire_words(k_cap, d))
