"""The tile bases of wire-format v4's packing against the JAX encoder.

``rice_fit`` hands the fitted ``rice_pack`` the quotient base of every tile
of ``kernel.RICE_TILE`` codes: the sum of ``(gap - 1) >> r`` over the codes
before the tile (``ref.rice_tile_bases_ref``, which the wrappers take on
the CPU). Tile t's unary span then begins ``k_cap r + base + t * tile``
bits into the stream, so its first code's terminator sits ``(gap0 - 1) >>
r`` bits after that, behind a run of ones and right after the terminator
of the code before it. Each row here is encoded by
``repro.comm.compaction.rice_encode_fitted`` from numpy inputs drawn from a
seed, and the port's bases (and its fit, header and fitted words) are
held to the JAX words: rows that are empty, overflowing (nnz > k_cap), a
single code at d - 1, clustered, ending on a tile edge, and spread over
several tiles with a ragged last one, at windows that hold r = 0 and not.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import compaction as J
from repro.core import coding as JC
from repro_torch.kernels.sparsify import kernel as K, ref

torch.set_num_threads(1)

TILE = K.RICE_TILE
# (d, k_cap) of the two row shapes: a window above r = 0, and one from it
SHAPES = {"wide": (1 << 18, 3 * TILE + 77), "dense": (6000, TILE + 100)}
# name: (shape, live count, how the live coordinates lie)
ROWS = {
    "empty": ("wide", 0, "iid"),
    "overflowing": ("wide", 3 * TILE + 77 + 500, "iid"),
    "single_at_d_minus_1": ("wide", 1, "far"),
    "clustered": ("wide", 2 * TILE + 5, "front"),
    "ends_on_a_tile_edge": ("wide", 2 * TILE, "iid"),
    "ragged_last_tile": ("wide", 3 * TILE + 30, "iid"),
    "r0_several_tiles": ("dense", TILE + 60, "iid"),
    "r0_overflowing": ("dense", TILE + 400, "iid"),
}


@functools.lru_cache(maxsize=None)
def _jax_encode(d, window):
    return jax.jit(functools.partial(J.rice_encode_fitted, d=d,
                                     window=window))


def _row(name):
    """A compact row: ``(d, k_cap, window, vals, idx, nnz)``; the live
    slots ascend, the rest are zeros, nnz may pass k_cap."""
    shape, n, spec = ROWS[name]
    d, k_cap = SHAPES[shape]
    rng = np.random.default_rng(31 + list(ROWS).index(name))
    if spec == "far":
        coords = np.asarray([d - 1])
    elif spec == "front":
        coords = np.arange(d // 3, d // 3 + n)
    else:
        coords = np.sort(rng.choice(d, n, replace=False))
    m = min(n, k_cap)
    vals = np.zeros(k_cap, np.float32)
    idx = np.zeros(k_cap, np.int32)
    vals[:m] = (1.0 + rng.random(m)).astype(np.float32)
    idx[:m] = coords[:m]
    return d, k_cap, JC.rice_fit_window(k_cap, d), vals, idx, n


def _bits(words):
    w = np.asarray(words).astype(np.uint32)
    return ((w[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)


@pytest.mark.parametrize("name", list(ROWS))
def test_tile_bases_place_each_tile_in_the_jax_words(name):
    """Each tile's first terminator sits at bit k_cap r + base + t tile +
    ((gap0 - 1) >> r) of the JAX encoder's words, after a run of ones and
    the terminator before it; the last base (the row's total) gives the
    header's used words, and past it the words are zeros."""
    d, k_cap, window, vals, idx, n = _row(name)
    _, jw, jh = _jax_encode(d, window)(jnp.asarray(vals), jnp.asarray(idx),
                                       nnz=jnp.int32(n))
    jh = int(jh)
    r = jh >> J.RICE_HDR_SHIFT
    bits = _bits(jw)
    ti = torch.from_numpy(idx)[None]
    tn = torch.tensor([n], dtype=torch.int32)
    bases = ref.rice_tile_bases_ref(ti, tn, torch.tensor([r]), d, TILE)[0]
    n_live = min(n, k_cap)
    x = np.zeros(k_cap, np.int64)                        # gap - 1 a code
    x[:n_live] = np.diff(idx[:n_live].astype(np.int64), prepend=-1) - 1
    nb = -(-k_cap // TILE)
    assert bases.shape == (nb + 1,)
    np.testing.assert_array_equal(
        bases.numpy(), np.concatenate([[0], np.cumsum(x >> r)])[
            np.minimum(np.arange(nb + 1) * TILE, k_cap)])
    for t in range(nb):
        start = k_cap * r + int(bases[t]) + t * TILE
        q0 = int(x[t * TILE]) >> r
        assert bits[start:start + q0].all(), f"tile {t}: its ones"
        assert bits[start + q0] == 0, f"tile {t}: its first terminator"
        if t:
            assert bits[start - 1] == 0, f"tile {t}: the terminator before"
    end = k_cap * r + int(bases[nb]) + k_cap
    assert jh & J.RICE_HDR_USED_MASK == -(-end // 32)
    assert not bits[end:].any()
    assert bits[end - 1] == 0                          # the last terminator


@pytest.mark.parametrize("name", list(ROWS))
def test_port_fit_and_fitted_words_match_jax(name):
    """``rice_fit_tiles`` (r, header, bases), ``rice_fit`` and
    ``rice_fit_pack`` on the CPU against the JAX encoder's choice and
    words; ``rice_pack_fitted`` at a given r forms its own bases."""
    d, k_cap, window, vals, idx, n = _row(name)
    _, jw, jh = _jax_encode(d, window)(jnp.asarray(vals), jnp.asarray(idx),
                                       nnz=jnp.int32(n))
    ti = torch.from_numpy(idx)[None].repeat(2, 1)
    tn = torch.tensor([n, n], dtype=torch.int32)
    fit = K.rice_fit_tiles(ti, tn, d=d, window=window)
    assert fit.header.tolist() == [int(jh)] * 2
    assert fit.r.tolist() == [int(jh) >> J.RICE_HDR_SHIFT] * 2
    assert torch.equal(fit.bases, ref.rice_tile_bases_ref(ti, tn, fit.r, d,
                                                          TILE))
    assert all(torch.equal(a, b) for a, b in zip(
        K.rice_fit(ti, tn, d=d, window=window), fit[:2]))
    words, header = K.rice_fit_pack(ti, tn, d=d, window=window)
    assert torch.equal(header, fit.header)
    for row in range(2):
        np.testing.assert_array_equal(words[row].numpy(), np.asarray(jw))
    # each row at another r of the window: the header of that packing
    other = torch.tensor([window[0], window[-1]], dtype=torch.int32)
    at_r = K.rice_fit_tiles(ti, tn, d=d, window=window, r_rows=other)
    w2, h2 = K.rice_pack_fitted(ti, tn, other, d=d, window=window)
    assert torch.equal(at_r.header, h2) and torch.equal(at_r.r, other)
    assert torch.equal(at_r.bases, ref.rice_tile_bases_ref(ti, tn, other, d,
                                                           TILE))
    want_w, want_h = ref.rice_pack_fitted_ref(ti, tn, other, d, window)
    assert torch.equal(w2, want_w) and torch.equal(h2, want_h)
