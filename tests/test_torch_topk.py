"""topk's threshold in the port: the plain version of the ``topk_threshold``
kernel (a radix select on the magnitudes' bit patterns, ``torch.bincount``
per round) against the JAX package's ``topk_emit`` scalars, which one XLA
``lax.top_k`` forms (src/repro/kernels/sparsify/ops.py:268-271), and
against ``torch.topk``, on the same numpy rows.

Every case is exact: the threshold t bit for bit and the tie budget
``k_target - #{|g| > t}`` as an integer (the JAX package's float32 budget
is exact below 2^24, which every row here is; past it see
``tests/test_torch_selectors.py::test_topk_budget_stays_exact_past_2_24``).
The cases: heavy-tailed rows, threshold ties straddling the port's tiles,
rows with fewer nonzeros than k_target (t = 0), k_target = d, signed zeros,
a multi-row group, and each radix design the kernel can run (bf16 in one
round of 2^15 bins or two of 2^8 and 2^7; f32 in three).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.kernels.sparsify import kernel as TK
from repro_torch.kernels.sparsify import ops as tops
from repro_torch.kernels.sparsify import ref as tref

torch.set_num_threads(1)

D = 70_001                       # 5 port tiles and a ragged end
DESIGNS = {"bfloat16": [(15,), (8, 7)], "float32": [(11, 10, 10)]}


def _heavy(rng, rows, d):
    return rng.standard_normal((rows, d)) * np.exp(rng.standard_normal(
        (rows, d)))


def _case(name: str, dtype: str):
    """(rows as float32 numpy in ``dtype``'s values, k_target)."""
    rng = np.random.default_rng([CASES.index(name), len(dtype)])
    if name == "heavy":                   # a multi-row group
        g, k = _heavy(rng, 3, D), 3500
    elif name == "ties":                  # few magnitudes, ties over tiles
        g = np.round(rng.standard_normal((2, D)) * 2) / 4
        g[:, :TK.TILE] = 0.25             # the threshold's ties, tile 0-1
        k = int(np.count_nonzero(np.abs(g[0]) > 0.25)) + TK.TILE + 7
    elif name == "sparse":                # fewer nonzeros than k_target
        g = np.zeros((2, D))
        g[0, 5:5000:7] = rng.standard_normal(len(range(5, 5000, 7)))
        g[1, D - 3:] = -0.5
        k = 3500
    elif name == "k=d":                   # k_target = d, zeros included
        g = _heavy(rng, 2, D)
        g[:, ::11] = 0.0
        k = D
    elif name == "signed zeros":          # -0.0 is a zero magnitude
        g = _heavy(rng, 1, D)
        g[0, : D // 2] = -0.0
        k = D - D // 4
    else:                                  # k_target = 1: the largest
        g, k = _heavy(rng, 2, D), 1
    if dtype == "bfloat16":
        g = g.astype(ml_dtypes.bfloat16)
    return g.astype(np.float32 if dtype == "float32" else g.dtype), k


def _torch(g: np.ndarray) -> torch.Tensor:
    if g.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(g.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(g.copy())


def _jax_scalars(g: np.ndarray, k: int):
    """topk_emit's threshold and budget (ops.py:268-271), per row."""
    a = jnp.abs(jnp.asarray(g).astype(jnp.float32))
    topv = jax.lax.top_k(a, k)[0]
    t = topv[:, -1]
    budget = jnp.float32(k) - jnp.count_nonzero(
        topv > t[:, None], axis=1).astype(jnp.float32)
    return np.asarray(t), np.asarray(budget).astype(np.int64)


def _torch_topk(g: torch.Tensor, k: int):
    topv = torch.topk(g.abs().float(), k, sorted=True).values
    return topv[:, -1], k - (topv > topv[:, -1:]).sum(-1)


CASES = ["heavy", "ties", "sparse", "k=d", "signed zeros", "largest"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,bits", [
    (dt, b) for dt, bs in DESIGNS.items() for b in bs])
def test_radix_select_matches_top_k(case, dtype, bits):
    """The plain radix select gives lax.top_k's and torch.topk's threshold
    bit for bit and their tie budget exactly, in every design."""
    g, k = _case(case, dtype)
    tg = _torch(g)
    t, budget = tref.topk_threshold_ref(tg, k, bits)
    jt, jbudget = _jax_scalars(g, k)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  jt.view(np.uint32))
    np.testing.assert_array_equal(budget.numpy(), jbudget)
    tt, tbudget = _torch_topk(tg, k)
    assert torch.equal(t, tt) and torch.equal(budget, tbudget)
    assert t.dtype == torch.float32 and budget.dtype == torch.int64
    if case == "sparse":
        nnz = (tg != 0).sum(-1)
        assert (t == 0).all() and torch.equal(budget, k - nnz)
    if case == "ties":
        assert (t == 0.25).all() and (budget > 1).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_topk_threshold_takes_the_plain_version_on_the_cpu(dtype):
    """``ops.topk_threshold`` (through ``kernel.topk_threshold``) runs the
    plain version in the kernel's design on a CPU tensor and counts no
    launch; a k_target outside [1, d] raises."""
    g, k = _case("ties", dtype)
    tg = _torch(g)
    launches = dict(TK.LAUNCHES)
    got = tops.topk_threshold(tg, k)
    want = tref.topk_threshold_ref(tg, k, TK.TOPK_BITS[tg.dtype])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert TK.LAUNCHES == launches
    for bad in (0, D + 1):
        with pytest.raises(ValueError):
            tops.topk_threshold(tg, bad)


def test_topk_emit_keeps_exactly_k_target_with_the_radix_threshold():
    """topk_emit on the CPU with the radix threshold keeps exactly
    k_target coordinates of every row that has that many nonzeros (ties
    at the threshold cut by lowest index) and every nonzero otherwise."""
    g, k = _case("ties", "bfloat16")
    tg = _torch(g)
    er = tops.topk_emit(tg, k_cap=k + 100, k_target=k)
    assert er.nnz.tolist() == [k, k]
    a = tg.abs().float()
    for r in range(2):
        idx = er.idx[r, :k].long()
        assert int((a[r] > 0.25).sum()) + int(
            (a[r, idx] == 0.25).sum()) == k
        ties = torch.nonzero(a[r] == 0.25).reshape(-1)
        kept_ties = idx[a[r, idx] == 0.25]
        assert torch.equal(kept_ties, ties[:kept_ties.numel()])
    g, k = _case("sparse", "float32")
    er = tops.topk_emit(_torch(g), k_cap=k + 100, k_target=k)
    assert er.nnz.tolist() == [len(range(5, 5000, 7)), 3]
