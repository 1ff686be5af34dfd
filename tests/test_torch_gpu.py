"""The port's CUDA kernels against their plain PyTorch versions on a card.
These tests need a CUDA device (the kernels have no CPU mode) and skip
without one; they import neither JAX nor the JAX package, so they run on a
GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Counts, kept coordinates, values, the EF residual and the Golomb-Rice
words bit-equal; sums within rtol 1e-6 (float64 accumulation on both sides,
rounded once)."""
import pytest
import torch

from repro_torch.comm.compaction import rice_decode
from repro_torch.core.codecs import FloatCodec
from repro_torch.core.coding import rice_parameter
from repro_torch.kernels.sparsify import kernel as K
from repro_torch.kernels.sparsify import ops
from repro_torch.kernels.sparsify import ref

pytestmark = pytest.mark.gpu

ROWS, D, RHO = 3, 100_003, 0.05         # ragged: d % 8 != 0, partial tile
K_CAPS = (8192, 1024)                    # as configured, and overflowing


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _group(gen, dtype, d=D):
    g = (torch.randn((ROWS, d), generator=gen, device="cuda")
         * torch.randn((ROWS, d), generator=gen, device="cuda").exp())
    return g.to(dtype), torch.rand((ROWS, d), generator=gen, device="cuda")


@pytest.mark.parametrize("d", [D, 65_536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(card, dtype, d):
    g, u = _group(card, dtype, d)
    l1, mx = K.stats_l1max(g)
    rl1, rmx = ref.stats_l1max_ref(g)
    torch.testing.assert_close(l1, rl1, rtol=1e-6, atol=0)
    assert torch.equal(mx, rmx)
    lam = RHO * d / l1
    gate = torch.tensor([True, False, True], device="cuda")
    cnt, tl1 = K.tail_stats(g, 1.0 / lam, gate)
    rcnt, rtl1 = ref.tail_stats_ref(g, 1.0 / lam, gate)
    assert torch.equal(cnt, rcnt)
    torch.testing.assert_close(tl1, rtl1, rtol=1e-6, atol=0)
    for k_cap in K_CAPS:
        st = K.select_stats(g, u, lam, k_cap)
        rst = ref.select_stats_ref(g, u, lam, k_cap, K.TILE)
        for f in ("nnz", "nonzeros", "base", "max_abs"):
            assert torch.equal(getattr(st, f), getattr(rst, f)), f
        for f in ("p_sum", "den", "sum_sq"):
            torch.testing.assert_close(getattr(st, f), getattr(rst, f),
                                       rtol=1e-6, atol=0)
        wires = ([torch.float32, torch.bfloat16] if dtype == torch.float32
                 else [torch.bfloat16])
        for wire in wires:
            for ef, rnd in ((False, False), (True, False), (True, True)):
                got = K.compact_emit(g, u, lam, st.base, k_cap=k_cap,
                                     wire_dtype=wire, ef=ef,
                                     round_residual=rnd)
                want = ref.compact_emit_ref(g, u, lam, k_cap, wire, ef, rnd)
                for a, b in zip(got, want):
                    assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("k_cap,d,r", [
    (8192, D, None), (1024, D, None),      # the emit tests' capacities
    (1000, 5000, 0),                       # r = 0: no remainder field
    (77, 100_000, 5),                      # a partial warp and boundary word
    (3 * 2048 + 5, 1 << 20, 3)])           # several blocks, a ragged last
def test_rice_pack_matches_plain_version(card, k_cap, d, r):
    """The CUDA Golomb-Rice packing against its plain version on rows that
    are empty, partly full, full, overflowing, and a single coordinate at
    d - 1 (the unary mass that fills the capacity exactly): words and used
    counts bit-equal, and the words decode to the kept coordinates."""
    r = rice_parameter(k_cap, d) if r is None else r
    nnz = [0, k_cap // 3, k_cap, k_cap + 50, 1]
    idx = torch.zeros((len(nnz), k_cap), dtype=torch.int32, device="cuda")
    for row, n in enumerate(nnz[:4]):
        live = torch.randperm(d, generator=card, device="cuda")[:min(n, k_cap)]
        idx[row, :live.numel()] = live.sort().values.to(torch.int32)
    idx[4, 0] = d - 1
    nnz = torch.tensor(nnz, dtype=torch.int32, device="cuda")
    launches = K.LAUNCHES["rice_pack"]
    words, used = K.rice_pack(idx, nnz, d=d, r=r)
    assert K.LAUNCHES["rice_pack"] == launches + 1
    want_w, want_u = ref.rice_pack_ref(idx, nnz, d, r)
    assert torch.equal(used, want_u)
    assert torch.equal(words, want_w)
    assert int(used[4]) == words.shape[1]
    dec = rice_decode(words, k_cap, d, r)
    for row in range(len(nnz)):
        n = min(int(nnz[row]), k_cap)
        assert torch.equal(dec[row, :n], idx[row, :n])


def test_emit_pipeline_card_matches_cpu(card):
    """gspar_emit on the card against the CPU path on the same input:
    lambda within rtol 1e-6, the same kept set except draws within 1e-6 of
    their keep probability."""
    g, u = _group(card, torch.bfloat16)
    kw = dict(k_cap=K_CAPS[0], rho=RHO, codec=FloatCodec(), ef=True)
    er, lam = ops.gspar_emit(g, u, **kw)
    er_c, lam_c = ops.gspar_emit(g.cpu(), u.cpu(), **kw)
    torch.testing.assert_close(lam.cpu(), lam_c, rtol=1e-6, atol=0)
    p = torch.clamp_max(lam_c[:, None] * g.cpu().float().abs(), 1.0)
    for r in range(ROWS):
        kept = set(er.idx[r, :int(er.nnz[r])].tolist())
        kept_c = set(er_c.idx[r, :int(er_c.nnz[r])].tolist())
        for i in kept ^ kept_c:
            assert abs(float(u[r, i]) - float(p[r, i])) < 1e-6


def test_wrappers_refuse_what_the_kernels_cannot_take(card):
    g, u = _group(card, torch.float32)
    with pytest.raises(ValueError):
        K.stats_l1max(g.t())                      # not contiguous
    with pytest.raises(ValueError):
        K.stats_l1max(g.to(torch.float16))        # no half kernel
    with pytest.raises(ValueError):
        K.select_stats(g, u.cpu(), torch.ones(ROWS, device="cuda"), 128)
    launches = K.LAUNCHES["stats_l1max"]
    K.stats_l1max(g)
    assert K.LAUNCHES["stats_l1max"] == launches + 1
