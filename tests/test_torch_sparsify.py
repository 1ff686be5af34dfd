"""The port's pure solvers (``repro_torch.core.sparsify``) against the JAX
package's (``repro.core.sparsify``), and the properties of
``tests/test_sparsify.py`` on the port's functions. Inputs come from numpy
seeds: heavy-tailed rows, rows with ties (values on a coarse grid), rows
with zeros and all-zero rows, in float32 and bfloat16.

Tolerances, with their reasons:
- scalars (lambda, density, variance inflation) and probabilities within
  rtol 1e-6: the port sums in float64 and rounds once, the JAX package sums
  in float32 in XLA's order;
- masks and values exact (bit for bit) given the same probabilities and the
  same uniforms: ``sample_mask`` and ``apply_mask`` are elementwise and
  repeat the JAX package's operations in its order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as jsp
from repro_torch.core import sparsify as tsp

torch.set_num_threads(1)

RTOL = 1e-6
KINDS = ["heavy", "ties", "zeros", "allzero"]


def _row(kind: str, d: int = 20_000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(d) * np.exp(rng.standard_normal(d))).astype(
        np.float32)
    if kind == "ties":
        g = (np.round(g * 4) / 4).astype(np.float32)
    elif kind == "zeros":
        g[rng.random(d) < 0.4] = 0.0
    elif kind == "allzero":
        g[:] = 0.0
    return g


def _pair(g: np.ndarray, dtype: str):
    return (torch.from_numpy(g).to(getattr(torch, dtype)),
            jnp.asarray(g).astype(getattr(jnp, dtype)))


def _close(got: torch.Tensor, want, rtol=RTOL):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _bits(x) -> np.ndarray:
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)
    return a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eps", [0.0, 0.1, 1.0, 4.0])
def test_closed_form_lambda_matches_jax(kind, eps, dtype):
    """Algorithm 2's scalar, the plain solve (one sort) and the group
    solver (bins, no sort), against the JAX package's."""
    tg, jg = _pair(_row(kind, seed=int(eps * 10)), dtype)
    jl, jok = jsp.closed_form_lambda(jg, eps)
    tl, tok = tsp.closed_form_lambda(tg, eps)
    rows = tsp.closed_form_lambda_rows(torch.stack([tg, tg.flip(0)]), eps)
    assert bool(tok) == bool(jok)
    for got in (tl, rows[0], rows[1]):
        _close(got, jl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_closed_form_probabilities_match_jax(kind, dtype):
    tg, jg = _pair(_row(kind, seed=3), dtype)
    _close(tsp.closed_form_probabilities(tg, 0.5),
           jsp.closed_form_probabilities(jg, 0.5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rho", [0.01, 0.05, 0.3])
def test_greedy_probabilities_match_jax(kind, rho, dtype):
    tg, jg = _pair(_row(kind, seed=5), dtype)
    _close(tsp.greedy_probabilities(tg, rho, 2),
           jsp.greedy_probabilities(jg, rho, 2))


@pytest.mark.parametrize("kind", KINDS)
def test_uniform_probabilities_match_jax(kind):
    tg, jg = _pair(_row(kind, seed=7), "float32")
    np.testing.assert_array_equal(
        _bits(tsp.uniform_probabilities(tg, 0.05)),
        _bits(jsp.uniform_probabilities(jg, 0.05)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_mask_and_values_match_jax_given_the_uniforms(kind, dtype):
    """With the JAX package's p and the same numpy uniforms, the mask and
    Q(g) are the JAX package's bit for bit (the sign of zero included):
    ``sample_mask`` as ``u < p``, ``apply_mask`` and ``sparsify``."""
    g = _row(kind, seed=9)
    tg, jg = _pair(g, dtype)
    u = np.random.default_rng(10).random(g.shape, dtype=np.float32)
    jp = jsp.greedy_probabilities(jg, 0.1, 2)
    tp = torch.from_numpy(np.array(jp))
    jz = (jnp.asarray(u) < jp).astype(jp.dtype)
    tz = tsp.sample_mask(torch.from_numpy(u), tp)
    np.testing.assert_array_equal(_bits(tz), _bits(jz))
    want = jsp.apply_mask(jg, jp, jz)
    for got in (tsp.apply_mask(tg, tp, tz),
                tsp.sparsify(torch.from_numpy(u), tg, tp)):
        assert got.dtype == tg.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", KINDS)
def test_density_and_variance_inflation_match_jax(kind):
    tg, jg = _pair(_row(kind, seed=11), "float32")
    jp = jsp.greedy_probabilities(jg, 0.05, 2)
    tp = torch.from_numpy(np.array(jp))
    _close(tsp.expected_density(tp), jsp.expected_density(jp))
    _close(tsp.variance_inflation(tg, tp), jsp.variance_inflation(jg, jp))


# --- the properties of tests/test_sparsify.py on the port's functions -------

@pytest.mark.parametrize("eps", [0.1, 0.5, 1.0, 4.0])
def test_closed_form_variance_budget_is_met(eps):
    g = torch.from_numpy(_row("heavy", d=5000, seed=13))
    p = tsp.closed_form_probabilities(g, eps)
    var = float(tsp.variance_inflation(g, p))
    assert var <= (1 + eps) * (1 + 1e-5)
    assert 0.0 <= float(p.min()) and float(p.max()) <= 1.0


def test_closed_form_monotone_in_eps_and_eps_zero_keeps_everything():
    g = torch.from_numpy(_row("zeros", d=5000, seed=15))
    dens = [float(tsp.expected_density(tsp.closed_form_probabilities(g, e)))
            for e in (0.0, 0.25, 1.0, 4.0)]
    assert dens == sorted(dens, reverse=True)
    p0 = tsp.closed_form_probabilities(g, 0.0)
    assert torch.equal(p0, (g != 0).to(torch.float32))


def test_zero_gradient_keeps_nothing():
    g = torch.zeros(1000)
    for p in (tsp.closed_form_probabilities(g, 1.0),
              tsp.greedy_probabilities(g, 0.1),
              tsp.uniform_probabilities(g, 0.1)):
        assert torch.equal(p, torch.zeros(1000))
    assert float(tsp.closed_form_lambda_rows(g[None], 1.0)[0]) == 0.0


@pytest.mark.parametrize("rho", [0.01, 0.05, 0.25, 0.9])
def test_greedy_density_close_to_target(rho):
    """Never above the target (up to rounding), and near it after the
    JAX test's eight rescales."""
    g = torch.from_numpy(_row("heavy", d=4096, seed=17))
    dens = float(tsp.expected_density(tsp.greedy_probabilities(g, rho, 8)))
    assert rho * 0.7 <= dens <= rho * 1.02 + 1e-6


def test_group_solver_reads_rows_in_chunks():
    """A float32 group is solved one row at a time (a chunk of one row):
    each row gives the plain solve's lambda."""
    g = torch.from_numpy(np.stack([_row("heavy", seed=19),
                                   _row("ties", seed=21)]))
    for eps in (0.0, 1.0):
        got = tsp.closed_form_lambda_rows(g, eps)
        for r in range(2):
            _close(got[r], tsp.closed_form_lambda(g[r], eps)[0])


def test_group_solver_takes_the_magnitude_histogram():
    """bfloat16 rows: the counts of ``kernel.magnitude_hist`` (here its
    plain version) give the same lambda as the solver's own bincount."""
    from repro_torch.kernels.sparsify import kernel as K
    from repro_torch.kernels.sparsify import ops
    g = torch.from_numpy(np.stack([_row("heavy", seed=23),
                                   _row("zeros", seed=25)])).to(
        torch.bfloat16)
    hist = K.magnitude_hist(g)
    assert hist.shape == (2, 1 << 15) and int(hist.sum()) == g.numel()
    for eps in (0.0, 0.5, 40.0):
        want = tsp.closed_form_lambda_rows(g, eps)
        assert torch.equal(tsp.closed_form_lambda_rows(g, eps, hist), want)
        assert torch.equal(ops.closed_lambda(g, eps), want)
