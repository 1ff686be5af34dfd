"""The port's CUDA kernels against their plain PyTorch versions on a card.
These tests need a CUDA device (the kernels have no CPU mode) and skip
without one; they import neither JAX nor the JAX package, so they run on a
GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Counts, kept coordinates, values (the integer codecs' levels), the EF
residual and the Golomb-Rice words bit-equal; sums within rtol 1e-6
(float64 accumulation on both sides, rounded once)."""
import contextlib
import dataclasses

import pytest
import torch

from repro_torch.comm.compaction import rice_decode
from repro_torch.core import codecs
from repro_torch.core.codecs import FloatCodec
from repro_torch.core.coding import rice_parameter
from repro_torch.core.sparse import residual_from_buffers
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
        for codec in (FloatCodec(), FloatCodec(16, True)):
            for ef in (False, True):
                got = K.compact_emit(g, u, lam, st, k_cap=k_cap, codec=codec,
                                     ef=ef)
                want = ref.compact_emit_ref(g, u, lam, k_cap, codec, ef)
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


def _scalars(g, pkind, k_target):
    """The per-row selector scalars the emit pipelines hand the kernels."""
    rows, d = g.shape
    if pkind == "topk":
        t, budget = ops.topk_threshold(g, k_target)
        return dict(s1=t, budget=budget)
    if pkind == "bern":
        return dict(s1=torch.zeros(rows, device="cuda"),
                    s2=K.stats_l1max(g)[1])
    if pkind == "rho":
        return dict(s1=torch.full((rows,), RHO, device="cuda"))
    return dict(s1=RHO * d / K.stats_l1max(g)[0])


def _check_variants(g, u, pkind, k_cap, k_target=None):
    """select_stats and compact_emit of one selector kind against their
    plain versions: float codecs with and without the fused EF residual,
    and the integer codecs with their scale and codec uniforms."""
    kw = _scalars(g, pkind, k_target or max(1, round(RHO * g.shape[1])))
    s1 = kw.pop("s1")
    uu = None if pkind == "topk" else u
    st = K.select_stats(g, uu, s1, k_cap, pkind=pkind, **kw)
    rst = ref.select_stats_ref(g, uu, s1, k_cap, K.TILE, pkind=pkind, **kw)
    for f in ("nnz", "nonzeros", "base", "tie_base", "max_abs"):
        a, b = getattr(st, f), getattr(rst, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    for f in ("p_sum", "den", "sum_sq"):
        torch.testing.assert_close(getattr(st, f), getattr(rst, f),
                                   rtol=1e-6, atol=0)
    u_cod = torch.rand((g.shape[0], k_cap), device="cuda")
    for name in ("f32", "bf16", "qsgd4", "qsgd8", "ternary"):
        codec = codecs.get(name)
        scale = codecs.finalize_scale(codec, st.sum_sq, st.max_abs)
        for ef in ((False, True) if not codec.integer_coded else (False,)):
            got = K.compact_emit(g, uu, s1, st, k_cap=k_cap, codec=codec,
                                 ef=ef, pkind=pkind, scale=scale,
                                 u_cod=u_cod, **kw)
            want = ref.compact_emit_ref(g, uu, s1, k_cap, codec, ef,
                                        pkind=pkind, scale=scale,
                                        u_cod=u_cod, **kw)
            assert got[0].dtype == codec.wire_dtype(g.dtype)
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(a, b), \
                    (pkind, name, ef)
    return st


@pytest.mark.parametrize("pkind", ["rho", "bern", "topk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selector_kinds_match_plain_versions(card, dtype, pkind):
    """Passes 1 and 2 for the baselines' selector kinds, at the configured
    and an overflowing capacity, with every codec; each launch counts under
    its variant."""
    g, u = _group(card, dtype)
    before = dict(K.LAUNCHES)
    for k_cap in K_CAPS:
        st = _check_variants(g, u, pkind, k_cap)
        if pkind == "topk":       # exactly k_target kept: no overflow
            assert (st.nnz == round(RHO * D)).all()
    assert K.LAUNCHES[f"select_stats/{pkind}"] \
        == before.get(f"select_stats/{pkind}", 0) + 2
    assert K.LAUNCHES[f"compact_emit/{pkind}+qsgd8"] \
        == before.get(f"compact_emit/{pkind}+qsgd8", 0) + 2


def test_topk_ties_straddle_the_kernel_tiles(card):
    """A bf16 row whose threshold ties run across two kernel tiles, with a
    budget that cuts inside a tile: the kept ties are the lowest-indexed
    ones, exactly ``k_target`` coordinates are kept, and both passes agree
    with their plain versions."""
    d, k_target = 5 * K.TILE + 77, 3000
    g = torch.zeros((2, d), dtype=torch.bfloat16, device="cuda")
    g[:, :1000] = 8.0                                     # above the threshold
    ties = torch.arange(K.TILE - 2500, 3 * K.TILE + 500, 7, device="cuda")
    g[:, ties] = -2.0                                     # |g| == t
    g[1, ties[::2]] = 2.0
    t, budget = ops.topk_threshold(g, k_target)
    assert (t == 2.0).all() and (budget == k_target - 1000).all()
    st = _check_variants(g, None, "topk", 4096, k_target)
    assert (st.nnz == k_target).all()
    vals, idx, _ = K.compact_emit(g, None, t, st, k_cap=4096,
                                  codec=FloatCodec(), ef=False, pkind="topk",
                                  budget=budget)
    want = torch.cat([torch.arange(1000, device="cuda"),
                      ties[:k_target - 1000]]).to(torch.int32)
    for r in range(2):
        assert torch.equal(idx[r, :k_target], want)


def test_topk_keeps_every_nonzero_of_a_sparse_row(card):
    """A row with fewer nonzeros than k_target: the threshold is 0, which
    ties nothing, so both passes keep exactly the nonzeros."""
    g = torch.zeros((2, D), dtype=torch.bfloat16, device="cuda")
    g[0, 5:5000:7] = 1.5
    g[1, :3] = -0.25
    st = _check_variants(g, None, "topk", K_CAPS[0])
    assert st.nnz.tolist() == [len(range(5, 5000, 7)), 3]


@pytest.mark.parametrize("name", ["qsgd8", "ternary"])
def test_integer_codec_residual_on_the_card(card, name):
    """The integer codecs' EF residual, scattered from the compact buffers
    on the card, equals the same scatter on the CPU (live slots only)."""
    from repro_torch.core.api import CompressionConfig
    from repro_torch.core.sparse import KernelBackend
    g, u = _group(card, torch.bfloat16)
    cfg = CompressionConfig(name=f"gspar+{name}", rho=RHO,
                            error_feedback=True, wire="gather")
    u_cod = torch.rand((ROWS, K_CAPS[0]), device="cuda")
    sg, res = KernelBackend().compress_sparse_ef(cfg, u, g, K_CAPS[0], u_cod)
    on_cpu = dataclasses.replace(sg, values=sg.values.cpu(),
                                 idx=sg.idx.cpu(), nnz=sg.nnz.cpu(),
                                 scale=sg.scale.cpu())
    assert torch.equal(res.cpu(), residual_from_buffers(g.cpu(), on_cpu))


@pytest.mark.parametrize("d", [D, 65_536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_wire_kernels_match_plain_versions(card, dtype, d):
    """Kernels 5-8 on a ragged (scalar path) and an aligned row (16-byte
    vectors): Q, the residual and the fused counts bit-equal to the plain
    versions, sum Q^2 to rtol 1e-6, in every wire dtype; kernel 7's sum|g|
    and max|g| bit-equal to kernel 1's."""
    g, u = _group(card, dtype, d)
    l1, l2, mx = K.stats(g)
    rl1, rl2, rmx = ref.stats_ref(g)
    torch.testing.assert_close(l1, rl1, rtol=1e-6, atol=0)
    torch.testing.assert_close(l2, rl2, rtol=1e-6, atol=0)
    assert torch.equal(mx, rmx)
    l1_k1, mx_k1 = K.stats_l1max(g)
    assert torch.equal(l1, l1_k1) and torch.equal(mx, mx_k1)
    lam = ops.greedy_lambda(l1, mx, RHO, d, tail_fn=ops._kernel_tail_fn(g))
    for wire in {dtype, torch.bfloat16}:
        for kern, plain in ((K.sparsify, ref.sparsify_ref),
                            (K.sparsify_ef, ref.sparsify_ef_ref)):
            got, want = kern(g, u, lam, wire), plain(g, u, lam, wire)
            for f in ("q", "residual", "nnz", "n_sure"):
                a, b = getattr(got, f), getattr(want, f)
                assert (a is None and b is None) or torch.equal(a, b), f
            torch.testing.assert_close(got.sum_sq, want.sum_sq, rtol=1e-6,
                                       atol=0)
    got, want = K.sparsify_prng(g, lam, 1234), ref.sparsify_prng_ref(
        g, lam, 1234)
    assert torch.equal(got.q, want.q) and torch.equal(got.nnz, want.nnz)


def test_philox_on_the_card_gives_the_known_answers(card):
    """Kernel 8's generator against Random123's Philox4x32-10 known-answer
    vectors."""
    ctr = torch.tensor([[0, 0, 0, 0], [0xFFFFFFFF] * 4,
                        [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344]],
                       device="cuda")
    key = torch.tensor([[0, 0], [0xFFFFFFFF] * 2, [0xA4093822, 0x299F31D0]],
                       device="cuda")
    want = [[0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
            [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD],
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]]
    assert K.philox4x32_10(ctr, key).tolist() == want


def test_dense_pipeline_card_matches_cpu(card):
    """ops.gspar_dense on the card against the CPU path: lambda within rtol
    1e-6, the same kept coordinates except draws within 1e-6 of their keep
    probability, Q bit-equal where lambda is."""
    g, u = _group(card, torch.bfloat16)
    r = ops.gspar_dense(g, u, rho=RHO, ef=True)
    rc = ops.gspar_dense(g.cpu(), u.cpu(), rho=RHO, ef=True)
    torch.testing.assert_close(r.lam.cpu(), rc.lam, rtol=1e-6, atol=0)
    p = torch.clamp_max(rc.lam[:, None] * g.cpu().float().abs(), 1.0)
    flips = (r.q.cpu() != 0) != (rc.q != 0)
    assert not bool((flips & ((u.cpu() - p).abs() >= 1e-6)).any())
    same = r.lam.cpu() == rc.lam
    assert torch.equal(r.q.cpu()[same], rc.q[same])
    assert torch.equal(r.residual.cpu()[same], rc.residual[same])


def _dirty_cache(nbytes: int) -> None:
    """Leave a freed block of nonzero bytes in the caching allocator, so that
    a following ``torch.empty`` of that size finds garbage, not zeros."""
    junk = torch.full((nbytes // 4 + 1,), -1, dtype=torch.int32, device="cuda")
    del junk


def _sweep_edges(g, u, pkind, kw):
    """Per row, the survivor counts before each sweep of kernel 4 (the ranks
    at which a capacity would cut on a sweep edge)."""
    sweep = K.TILE // 8
    edges = []
    for r in range(g.shape[0]):
        z = ref._select_row(pkind, g[r].cpu(), None if u is None else
                            u[r].cpu(), kw["s1"][r].cpu(),
                            kw["s2"][r].cpu() if "s2" in kw else None,
                            kw["budget"][r].cpu() if "budget" in kw
                            else None)[3]
        pad = torch.zeros(-(-z.numel() // sweep) * sweep, dtype=torch.int64)
        pad[:z.numel()] = z.to(torch.int64)
        edges.append(set(torch.cumsum(pad.view(-1, sweep).sum(1), 0)
                         .tolist()))
    return edges


@pytest.mark.parametrize("pkind", ["lam", "rho", "bern", "topk"])
def test_compact_emit_overflows_inside_a_sweep(card, pkind):
    """Every selector kind and codec at a capacity that each row passes
    inside a sweep (not on a sweep's or tile's edge): the first k_cap
    survivors, the residual of every coordinate (the dropped ones too) and
    the slots, bit-equal to the plain version; and at a capacity above every
    row's survivors, whose dead slots the kernel zeroes itself (the buffers
    come from ``torch.empty`` over freed nonzero memory)."""
    g, u = _group(card, torch.bfloat16)
    kw = _scalars(g, pkind, max(1, round(RHO * D)))
    nnz = K.select_stats(g, None if pkind == "topk" else u, kw["s1"], 1,
                         pkind=pkind, **{k: v for k, v in kw.items()
                                         if k != "s1"}).nnz
    edges = set().union(*_sweep_edges(g, None if pkind == "topk" else u,
                                      pkind, kw))
    k_cap = int(nnz.min()) // 2 + 1
    while k_cap in edges:
        k_cap += 1
    assert k_cap < int(nnz.min())
    _check_variants(g, u, pkind, k_cap)
    k_cap = int(nnz.max()) + 300
    _dirty_cache(ROWS * k_cap * 4)
    _check_variants(g, u, pkind, k_cap)


@pytest.mark.parametrize("pkind", ["lam", "rho", "bern", "topk"])
def test_compact_emit_unaligned_rows_take_scalar_stores(card, pkind):
    """A group with d % 8 != 0 (rows past the first start unaligned: scalar
    residual stores and loads) and a one-row group whose g and u start one
    element past a 16-byte boundary while the residual is aligned (scalar
    loads, vector residual stores): bit-equal to the plain version."""
    g, u = _group(card, torch.bfloat16, 40_003)
    _check_variants(g, u, pkind, 1500)
    big_g, big_u = _group(card, torch.bfloat16, 32_769)
    g1, u1 = big_g[0, 1:].view(1, -1), big_u[0, 1:].view(1, -1)
    assert g1.data_ptr() % 16 and u1.data_ptr() % 16
    for k_cap in (2000, 300):
        _check_variants(g1, u1, pkind, k_cap)


@pytest.mark.parametrize("pkind", ["bern", "lam"])
def test_compact_emit_at_a_whole_row_capacity(card, pkind):
    """k_cap = d (bern's capacity: nearly every slot dead), whose dead
    slots the launcher zeroes with a memset, and k_cap = d - 1, whose dead
    slots the kernel zeroes itself, each over freed nonzero memory:
    bit-equal to the plain version."""
    g, u = _group(card, torch.bfloat16)
    for k_cap in (D, D - 1):
        _dirty_cache(ROWS * k_cap * 4)
        _check_variants(g, u, pkind, k_cap)


@pytest.mark.parametrize("ties", ["one tile", "none"])
def test_topk_ties_in_one_tile_or_none(card, ties):
    """topk rows whose threshold ties all lie in one kernel tile, cut by the
    budget inside it, and rows without a tie beyond the threshold itself:
    both passes bit-equal to the plain versions, exactly k_target kept."""
    d = 3 * K.TILE + 77
    g = torch.zeros((2, d), dtype=torch.bfloat16, device="cuda")
    if ties == "one tile":
        k_target = 3000
        g[:, :1000] = 8.0
        tie = torch.arange(K.TILE + 100, 2 * K.TILE - 100, 5, device="cuda")
        g[:, tie] = -2.0
        g[1, tie[::2]] = 2.0
    else:                    # 256 distinct magnitudes, exact in bf16
        k_target = 100
        g[:, 7:7 + 256 * 90:90] = torch.arange(
            1, 257, device="cuda").to(torch.bfloat16)
    _, budget = ops.topk_threshold(g, k_target)
    if ties == "none":
        assert (budget == 1).all()        # the threshold's own coordinate
    st = _check_variants(g, None, "topk", 4096, k_target)
    assert (st.nnz == k_target).all()


def _check_rice(idx, nnz, d, r):
    words, used = K.rice_pack(idx, nnz, d=d, r=r)
    want_w, want_u = ref.rice_pack_ref(idx, nnz, d, r)
    assert torch.equal(used, want_u)
    assert torch.equal(words, want_w)
    dec = rice_decode(words, idx.shape[1], d, r)
    for row in range(idx.shape[0]):
        n = min(int(nnz[row]), idx.shape[1])
        assert torch.equal(dec[row, :n], idx[row, :n])


def test_rice_pack_rows_far_wider_than_the_card(card):
    """Rows of k_cap >= 2^20 codes: each spans 513 blocks, three rows 1539,
    far more than the card holds at once (132 SMs), so the look-back of a
    block must only ever wait on blocks that have started. Full, half-full
    and overflowing rows, bit-equal to the plain version."""
    k_cap, d = 512 * K.RICE_TILE + 3, 1 << 25
    assert k_cap >= 1 << 20
    counts = [k_cap, k_cap // 2 + 7, k_cap + 1000]
    idx = torch.zeros((3, k_cap), dtype=torch.int32, device="cuda")
    for row, n in enumerate(counts):
        live = torch.randperm(d, generator=card, device="cuda")[:min(n, k_cap)]
        idx[row, :live.numel()] = live.sort().values.to(torch.int32)
    nnz = torch.tensor(counts, dtype=torch.int32, device="cuda")
    for r in (rice_parameter(k_cap, d), 0, 30):
        _check_rice(idx, nnz, d, r)


@pytest.mark.parametrize("r", [0, 3, 30])
def test_rice_pack_long_unary_runs(card, r):
    """Codes whose unary runs are long: a run that starts a block (its first
    code) and one at a block's last code, and at r = 0 rows of a few
    far-apart codes whose runs cover many staging windows, a single code at
    d - 1 among them; bit-equal to the plain version."""
    tile = K.RICE_TILE
    k_cap, d = 3 * tile + 1, 1 << 22
    gap = torch.full((k_cap,), 20, dtype=torch.int64, device="cuda")
    gap[tile] += 300_000
    gap[2 * tile - 1] += 500_000
    idx = (torch.cumsum(gap, 0) - 20).to(torch.int32)[None].repeat(2, 1)
    _check_rice(idx, torch.tensor([k_cap, 2 * tile + 1], dtype=torch.int32,
                                  device="cuda"), d, r)
    sparse = torch.zeros((2, 1000), dtype=torch.int32, device="cuda")
    sparse[0, 0] = d - 1
    sparse[1, :6] = torch.tensor([5, 6, 100_000, 1_000_001, 3_000_000,
                                  d - 1], device="cuda")
    _check_rice(sparse, torch.tensor([1, 6], dtype=torch.int32,
                                     device="cuda"), d, r)


def _threshold_rows(gen, case, dtype, d=D):
    """The CPU tests' threshold cases on the card: (rows, k_target)."""
    if case == "heavy":                      # a multi-row group
        g, k = _group(gen, torch.float32, d)[0], 3500
    elif case == "ties":                     # ties straddling the tiles
        g = torch.round(torch.randn((2, d), generator=gen, device="cuda")
                        * 2) / 4
        g[:, :K.TILE] = 0.25
        k = int((g[0].abs() > 0.25).sum()) + K.TILE + 7
    elif case == "sparse":                   # fewer nonzeros than k_target
        g = torch.zeros((2, d), device="cuda")
        g[0, 5:5000:7] = 1.5
        g[1, d - 3:] = -0.5
        k = 3500
    elif case == "k=d":                      # k_target = d, zeros included
        g, k = _group(gen, torch.float32, d)[0][:2], d
        g[:, ::11] = 0.0
    else:                                    # signed zeros
        g, k = _group(gen, torch.float32, d)[0][:1], d - d // 4
        g[0, :d // 2] = -0.0
    return g.to(dtype), k


def _topk_library(g, k):
    """The same two numbers from torch.topk (the library yardstick)."""
    topv = torch.topk(g.abs().float(), k, sorted=True).values
    return topv[:, -1], k - (topv > topv[:, -1:]).sum(-1)


@pytest.mark.parametrize("case", ["heavy", "ties", "sparse", "k=d",
                                  "signed zeros"])
@pytest.mark.parametrize("dtype,bits", [(torch.float32, None),
                                        (torch.bfloat16, None),
                                        (torch.bfloat16, (8, 7))])
def test_topk_threshold_matches_plain_version_and_torch_topk(
        card, dtype, bits, case, monkeypatch):
    """The radix-select kernel: t bit-equal and the budget equal to its
    plain version's and to torch.topk's, on ragged rows (scalar loads) and
    aligned ones (16-byte vectors), in the kernel's design and, for bf16,
    in the two-round design of 2^8 and 2^7 bins; one launch a call."""
    if bits is not None:
        monkeypatch.setitem(K.TOPK_BITS, dtype, bits)
    for d in (D, 65_536):
        g, k = _threshold_rows(card, case, dtype, d)
        before = K.LAUNCHES["topk_threshold"]
        t, budget = K.topk_threshold(g, k)
        assert K.LAUNCHES["topk_threshold"] == before + 1
        rt, rbudget = ref.topk_threshold_ref(g, k, K.TOPK_BITS[dtype])
        lt, lbudget = _topk_library(g, k)
        assert torch.equal(t, rt) and torch.equal(budget, rbudget), (d, k)
        assert torch.equal(t, lt) and torch.equal(budget, lbudget), (d, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_threshold_past_2_24(card, dtype):
    """Rows of 2^24 + 5: all ties but the last (budget 2^24 + 3, which a
    float32 budget would round), and a heavy-tailed row at k_target =
    rho d; both against the plain version and torch.topk, and pass 1 keeps
    exactly k_target."""
    d = 2**24 + 5
    g = torch.ones((2, d), dtype=dtype, device="cuda")
    g[0, -1] = 0.0
    g[1] = (torch.randn(d, generator=card, device="cuda")
            * torch.randn(d, generator=card, device="cuda").exp())
    for k in (d - 2, round(RHO * d)):
        t, budget = K.topk_threshold(g, k)
        rt, rbudget = ref.topk_threshold_ref(g, k, K.TOPK_BITS[dtype])
        lt, lbudget = _topk_library(g, k)
        assert torch.equal(t, rt) and torch.equal(budget, rbudget)
        assert torch.equal(t, lt) and torch.equal(budget, lbudget)
        st = K.select_stats(g, None, t, k, pkind="topk", budget=budget)
        assert st.nnz.tolist() == [k, k]
    assert int(K.topk_threshold(g, d - 2)[1][0]) == d - 2


@pytest.mark.parametrize("tiles", [1, 8, 10, 17])
def test_select_stats_topk_blocks_span_tiles(card, tiles):
    """Pass 1 for topk covers several tiles a block: rows of 1, 8, 10 and
    17 tiles (the last block of a row holding fewer than a block's tiles,
    and a ragged last tile), with threshold ties in every tile, at a
    capacity that overflows inside a tile and one that does not: counts,
    bases and tie bases bit-equal to the plain version, sums within rtol
    1e-6, and pass 2 bit-equal."""
    d = (tiles - 1) * K.TILE + 4099
    g = torch.round(torch.randn((3, d), generator=card, device="cuda")
                    * 3) / 4
    g = g.to(torch.bfloat16)
    k_target = max(1, int((g[0].abs() > 0.5).sum()) + 11)
    st = _check_variants(g, None, "topk", max(16, k_target // 2), k_target)
    t, budget = ops.topk_threshold(g, k_target)
    assert (st.nnz == k_target).all() and (t > 0).all()
    st = _check_variants(g, None, "topk", k_target + 100, k_target)
    rst = ref.select_stats_ref(g, None, t, k_target + 100, K.TILE,
                               pkind="topk", budget=budget)
    assert torch.equal(st.tie_base, rst.tie_base)
    assert int(rst.tie_base[0, -1]) > 0 or tiles == 1


def _dense_kind(g, pkind):
    """The dense emit's per-row scalars for ``pkind`` (topk with pass 1's
    tie bases), and the plain version's keywords (no tie bases)."""
    rows, d = g.shape
    l1, _, mx = K.stats(g)
    if pkind == "one":
        return dict(pkind="one"), dict(pkind="one"), None
    if pkind == "lam":
        return dict(pkind="lam"), dict(pkind="lam"), RHO * d / l1
    if pkind == "rho":
        s1 = torch.full((rows,), RHO, device="cuda")
        return dict(pkind="rho"), dict(pkind="rho"), s1
    if pkind == "bern":
        kw = dict(pkind="bern", s2=mx)
        return kw, dict(kw), torch.zeros(rows, device="cuda")
    t, budget = K.topk_threshold(g, max(1, round(RHO * d)))
    plain = dict(pkind="topk", budget=budget)
    st = K.select_stats(g, None, t, d, pkind="topk", budget=budget)
    return dict(plain, tie_base=st.tie_base), plain, t


@pytest.mark.parametrize("codec_name", list(codecs.CODEC_NAMES))
@pytest.mark.parametrize("pkind", ["lam", "rho", "bern", "topk", "one"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_emit_every_kind_and_codec(card, dtype, pkind, codec_name):
    """Kernels 5 and 6 for every selector kind and codec (an integer
    codec's scale from pass 1 with ``round_v`` at k_cap = d) against
    their plain versions: Q, the residual and the counts bit-equal."""
    g, u = _group(card, dtype)
    u_cod = torch.rand(g.shape, generator=card, device="cuda")
    kw, plain_kw, s1 = _dense_kind(g, pkind)
    uu = u if pkind in ("lam", "rho", "bern") else None
    codec = codecs.get(codec_name)
    out_dtype = dtype if codec.integer_coded else codec.wire_dtype(dtype)
    ckw = {}
    if codec.integer_coded:
        if pkind == "one":
            _, l2, mx = K.stats(g)
            scale = codecs.finalize_scale(codec, l2, mx)
        else:
            extra = {k: kw[k] for k in ("s2", "budget") if k in kw}
            st = K.select_stats(g, uu, s1, D, pkind=pkind,
                                round_v=pkind != "topk", **extra)
            rst = ref.select_stats_ref(g, uu, s1, D, K.TILE, pkind=pkind,
                                       round_v=pkind != "topk", **extra)
            assert torch.equal(st.max_abs, rst.max_abs)
            torch.testing.assert_close(st.sum_sq, rst.sum_sq, rtol=1e-6,
                                       atol=0)
            scale = codecs.finalize_scale(codec, st.sum_sq, st.max_abs)
        ckw = dict(codec=codec, scale=scale, u_cod=u_cod)
    for kern, plain in ((K.sparsify, ref.sparsify_ref),
                        (K.sparsify_ef, ref.sparsify_ef_ref)):
        got = kern(g, uu, s1, out_dtype, **kw, **ckw)
        want = plain(g, uu, s1, out_dtype, **plain_kw, **ckw)
        for f in ("q", "residual", "nnz", "n_sure"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None and b is None) or torch.equal(a, b), f
        torch.testing.assert_close(got.sum_sq, want.sum_sq, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(got.den, want.den, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["unisp+qsgd8", "topk+ternary", "qsgd",
                                  "terngrad", "agspar", "none"])
def test_dense_compositions_card_match_cpu(card, name):
    """The dense wire's pipeline of a composition on the card against the
    same pipeline on the CPU (plain versions): bit-equal where the scalars
    are exact (rho, max|g|, topk's threshold, the identity), and agspar's
    lambda within rtol 1e-6."""
    from repro_torch.core.api import CompressionConfig
    from repro_torch.core.sparse import dense_group
    g, u = _group(card, torch.bfloat16)
    u_cod = torch.rand(g.shape, generator=card, device="cuda")
    scheme = CompressionConfig(name=name, rho=RHO).scheme()
    uu = u if scheme.selector.samples else None
    uc = u_cod if scheme.codec.stochastic else None
    a = dense_group(scheme, uu, g, True, u_cod=uc)
    b = dense_group(scheme, None if uu is None else uu.cpu(), g.cpu(), True,
                    u_cod=None if uc is None else uc.cpu())
    if name == "agspar":
        torch.testing.assert_close(a.lam.cpu(), b.lam, rtol=1e-6, atol=0)
        return
    assert torch.equal(a.q.cpu(), b.q)
    assert torch.equal(a.residual.cpu(), b.residual)
    if a.scale is not None:
        torch.testing.assert_close(a.scale.cpu(), b.scale, rtol=1e-6, atol=0)


def test_closed_lambda_on_the_card(card):
    """Algorithm 2's lambda from bins on the card (bf16: the magnitude
    histogram of topk_threshold's pass, equal to ``torch.bincount``'s)
    against the plain float64 sort, per row, f32 and bf16."""
    from repro_torch.core import sparsify
    for dtype in (torch.float32, torch.bfloat16):
        g, _ = _group(card, dtype)
        if dtype == torch.bfloat16:
            assert torch.equal(K.magnitude_hist(g).cpu(),
                               K.magnitude_hist(g.cpu()))
        for eps in (0.0, 1.0, 40.0):
            lam = ops.closed_lambda(g, eps)
            for r in range(ROWS):
                want = sparsify.closed_form_lambda(g[r], eps)[0]
                torch.testing.assert_close(lam[r], want, rtol=1e-6, atol=0)


# --- the section-5 experiments' kernel paths and the step-size options ------

@pytest.mark.parametrize("method", ["gspar", "unisp", "qsgd", "dense"])
def test_experiment_compression_card_matches_cpu(card, method):
    """``Compressor.rows`` at the convex experiment's shape ([M = 4, d =
    2048] float32) on the card against the plain versions on the CPU: the
    scalars within rtol 1e-6 (gspar's lambda from kernels 7 and 2), Q and
    the bits bit-equal where no uniform lies within 1e-6 of its keep
    probability."""
    from repro_torch.experiments.convex import _compressor
    comp = _compressor(method, 0.05, 32)
    g = (torch.randn((4, 2048), generator=card, device="cuda")
         * torch.randn((4, 2048), generator=card, device="cuda").exp())
    u = torch.rand(g.shape, generator=card, device="cuda")
    u_cod = torch.rand(g.shape, generator=card, device="cuda")
    uu = u if comp.scheme.selector.samples else None
    uc = u_cod if comp.scheme.codec.stochastic else None
    K.reset_launches()
    a = comp.rows(g, uu, uc)
    assert K.LAUNCHES["sparsify"] == 1
    b = comp.rows(g.cpu(), None if uu is None else uu.cpu(),
                  None if uc is None else uc.cpu())
    if a.lam is not None:
        torch.testing.assert_close(a.lam.cpu(), b.lam, rtol=1e-6, atol=0)
    keep = torch.ones(g.shape, dtype=torch.bool)
    if method == "gspar":
        p = torch.clamp_max(b.lam[:, None] * g.cpu().abs(), 1.0)
        keep = (u.cpu() - p).abs() > 1e-6
    assert torch.equal(a.q.cpu()[keep], b.q[keep])
    if bool(keep.all()):
        assert torch.equal(a.bits.cpu(), b.bits)


@pytest.mark.parametrize("rho", [0.1, 0.02])
def test_cnn_groups_card_match_cpu(card, rho):
    """Every shape group of one CNN step (channels 24, 4 workers as the
    stacked axis) through ``compress_tree`` on the card against the plain
    version of the group on the CPU, on the same uniforms (replayed from
    the generator's seed): lambda within rtol 1e-6, Q bit-equal where no
    uniform lies within 1e-6 of its keep probability."""
    from repro_torch.core.api import CompressionConfig, _stack_group, \
        compress_tree
    from repro_torch.core.grouping import plan_tree
    from repro_torch.core.sparse import KernelBackend
    from repro_torch.data.synthetic import image_data
    from repro_torch.experiments import cnn
    x, y = image_data(0, n=256, device="cuda")
    params = cnn.init_cnn(torch.Generator(device="cuda").manual_seed(0), 24)
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    idx = torch.randint(0, 256, (4, 16), generator=card, device="cuda")
    leaves = [torch.stack(t) for t in zip(*[
        torch.autograd.grad(cnn.cnn_loss(live, x[ix], y[ix]),
                            list(live.values())) for ix in idx])]
    stk = [True] * len(leaves)
    cfg = CompressionConfig(name="gspar", rho=rho, min_leaf_size=0)
    K.reset_launches()
    q, _, _ = compress_tree(cfg, torch.Generator(device="cuda").manual_seed(
        12), leaves, stacked=stk)
    assert K.LAUNCHES["sparsify"] > 0
    replay = torch.Generator(device="cuda").manual_seed(12)
    for grp in plan_tree(cfg, leaves, stk).groups:
        stack = _stack_group(grp, leaves, None, False)
        u = torch.rand((grp.rows, grp.d), generator=replay, device="cuda")
        want, _ = KernelBackend().compress_dense(cfg, u.cpu(), stack.cpu(),
                                                 False)
        got, _ = KernelBackend().compress_dense(cfg, u, stack, False)
        torch.testing.assert_close(got.lam.cpu(), want.lam, rtol=1e-6,
                                   atol=0)
        p = torch.clamp_max(want.lam[:, None] * stack.cpu().abs(), 1.0)
        keep = (u.cpu() - p).abs() > 1e-6
        q_tree = torch.cat([q[i].reshape(r, grp.d) for i, r in grp.members])
        assert torch.equal(q_tree.cpu()[keep], want.q[keep])


def test_experiment_sgd_and_svrg_steps_card_match_cpu(card):
    """One gspar SGD step and one SVRG step of the convex experiment at
    its benchmark size on the card against the CPU: new weights within
    rtol 1e-5 (atol 1e-7), bits equal."""
    from repro_torch.data.synthetic import logreg_data
    from repro_torch.experiments import convex
    from repro_torch.optim.optimizers import SVRG, sgd
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dev in ("cuda", "cpu"):
        x, y, _ = logreg_data(0, n=1024, d=2048, device=dev)
        comp = convex._compressor("gspar", 0.05, 32)
        gen = torch.Generator(device="cpu").manual_seed(3)
        idx = torch.randint(0, 1024, (4, 8), generator=gen).to(dev)
        u = torch.rand((4, 2048), generator=gen).to(dev)
        w = torch.randn(2048, generator=gen).to(dev) * 0.01
        zero = torch.zeros((), device=dev)
        step = convex.make_sgd_step(x, y, 1 / 1024, comp, lr0=0.5,
                                    adaptive=True)
        w1, bits, _, _ = step(w, 2, zero, zero, idx, u)
        svrg = SVRG(sgd(0.2))
        wv = w.clone()
        state = svrg.set_reference(svrg.init([wv]), [w * 0.5],
                                   [convex.logreg_grad(w * 0.5, x, y,
                                                       1 / 1024)])
        sv = convex.make_svrg_step(x, y, 1 / 1024, comp, svrg)
        wv, _, sbits, _, _ = sv(wv, state, zero, zero, idx, u)
        out[dev] = (w1.cpu(), bits.cpu(), wv.cpu(), sbits.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_experiment_cnn_step_card_matches_cpu(card):
    """One CNN step on the card against the CPU in float32 (TF32 off): with
    the dense passthrough, Adam's first moment (the workers' averaged
    gradient) within rtol 1e-4, atol 1e-7; with gspar (every leaf
    compressed through kernels 7, 2 and 5; the two devices draw different
    uniforms) the kernels launched and the density near rho."""
    from repro_torch.core.api import CompressionConfig
    from repro_torch.data.synthetic import image_data
    from repro_torch.experiments import cnn
    from repro_torch.optim.optimizers import adam
    torch.backends.cudnn.allow_tf32 = False
    moments = {}
    for name in ("none", "gspar"):
        comp = CompressionConfig(name=name, rho=0.1, min_leaf_size=(
            1 << 30 if name == "none" else 0))
        for dev in ("cuda", "cpu"):
            x, y = image_data(0, n=64, device=dev)
            params = {k: v.to(dev) for k, v in cnn.init_cnn(
                torch.Generator().manual_seed(0), 8).items()}
            opt = adam(0.02)
            state = opt.init(list(params.values()))
            idx = torch.arange(16, device=dev).reshape(4, 4)
            K.reset_launches()
            state, _, density = cnn.make_cnn_step(x, y, comp, opt)(
                params, state, idx, torch.Generator(device=dev).manual_seed(1))
            moments[name, dev] = [m.cpu() for m in state["m"]]
            if name == "gspar" and dev == "cuda":
                for kern in ("stats", "tail_stats", "sparsify"):
                    assert K.LAUNCHES[kern] > 0, kern
                assert 0.0 < float(density) <= 0.15
    for a, b in zip(moments["none", "cuda"], moments["none", "cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


def test_backend_parity_on_the_card(card):
    """The conflict model's backend check at the benchmark's size: the
    kernels' lambda (kernels 1 and 2) against the pure solver, p within
    1e-6; and pass 1 (kernel 3) under that lambda and the Monte Carlo
    windows' uniforms, equal to its plain version and keeping exactly the
    kernel side's Monte Carlo writes."""
    from repro_torch.data.synthetic import svm_data
    from repro_torch.experiments import conflicts
    x, y, _ = svm_data(3, n=4096, d=256, device="cuda")
    g = (x[:64].T @ y[:64]) / 64.0
    K.reset_launches()
    out = conflicts.backend_parity(g, 0.05, 32)
    for kern in ("stats_l1max", "tail_stats"):
        assert K.LAUNCHES[kern] > 0, kern
    assert out["p_maxdiff"] <= 1e-6
    lam = ops.gspar_lambda(g, rho=0.05, num_iters=4)
    rows, d = 256 * 32, g.shape[0]
    u = conflicts._mc_uniforms((256, 32, d), 0, "cuda").reshape(rows, d)
    gg = g.reshape(1, d).expand(rows, d).contiguous()
    s1 = lam.reshape(1).expand(rows).contiguous()
    st = K.select_stats(gg, u, s1, d, pkind="lam")
    want = ref.select_stats_ref(gg, u, s1, d, K.TILE, pkind="lam")
    assert torch.equal(st.nnz, want.nnz)
    assert float(st.nnz.sum()) / 256 == out["kernel"]["writes"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_size_options_card_match_cpu(card, dtype):
    """``rescale_feedback`` and ``sgd``/``adam`` with a 0-d float32
    ``var_scale`` and a callable lr on the card against the CPU, bit for
    bit: every division is an IEEE quotient of tensors on both."""
    from repro_torch.optim import optimizers as topt
    gen = torch.Generator().manual_seed(5)
    p0 = [torch.randn(s, generator=gen).to(dtype) for s in ((64, 33), (7,))]
    g0 = [torch.randn(s, generator=gen).to(dtype) for s in ((64, 33), (7,))]
    vs = torch.tensor(2.8199074)
    out = {}
    for dev in ("cuda", "cpu"):
        res = []
        fb = topt.FeedbackState(residual=[p.to(dev, copy=True)
                                          for p in p0])
        topt.rescale_feedback(fb, 1e-4, 3e-4)
        res += fb.residual
        for opt in (topt.sgd(lambda s: 3e-4 * s, momentum=0.9),
                    topt.adam(3e-4)):
            p = [t.to(dev, copy=True) for t in p0]
            state = opt.init(p)
            for _ in range(2):
                _, state = opt.update([t.to(dev) for t in g0], state, p,
                                      var_scale=vs.to(dev))
            res += p
        out[dev] = [t.cpu() for t in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("k_cap,d", [
    (8192, D), (1024, D),                  # the emit tests' capacities
    (1000, 5000),                          # a window from r = 1
    (77, 100_000),                         # a partial warp
    (3 * 2048 + 5, 1 << 20)])              # several blocks, a ragged last
def test_rice_fit_and_fitted_pack_match_plain_versions(card, k_cap, d):
    """``rice_fit`` and the fitted ``rice_pack`` (wire-format v4) against
    their plain versions on rows that are empty, partly full, full,
    overflowing, a clustered front block and a single coordinate at d - 1:
    r, headers, the tile bases and words bit-equal, and the words decode
    at each row's r to the kept coordinates. The first route of both
    (kept as chip_smoke's yardstick) gives the same."""
    from repro_torch.core.coding import rice_fit_window
    window = rice_fit_window(k_cap, d)
    nnz = [0, k_cap // 3, k_cap, k_cap + 50, k_cap // 2, 1]
    idx = torch.zeros((len(nnz), k_cap), dtype=torch.int32, device="cuda")
    for row, n in enumerate(nnz[:4]):
        live = torch.randperm(d, generator=card, device="cuda")[:min(n, k_cap)]
        idx[row, :live.numel()] = live.sort().values.to(torch.int32)
    idx[4, :k_cap // 2] = torch.arange(k_cap // 2, dtype=torch.int32,
                                       device="cuda") + d // 3
    idx[5, 0] = d - 1
    nnz = torch.tensor(nnz, dtype=torch.int32, device="cuda")
    before = (K.LAUNCHES["rice_fit"], K.LAUNCHES.get("rice_pack/fitted", 0))
    r, header = _check_fitted(idx, nnz, d, window)
    assert (K.LAUNCHES["rice_fit"], K.LAUNCHES["rice_pack/fitted"]) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip(
        K.rice_fit(idx, nnz, d=d, window=window), (r, header)))
    before = (K.LAUNCHES["rice_fit"], K.LAUNCHES["rice_pack/fitted"])
    words, header2 = K.rice_fit_pack(idx, nnz, d=d, window=window)
    assert (K.LAUNCHES["rice_fit"], K.LAUNCHES["rice_pack/fitted"]) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(header2, header)
    assert torch.equal(words, ref.rice_pack_fitted_ref(idx, nnz, r, d,
                                                       window)[0])
    assert all(torch.equal(a, b) for a, b in zip(
        K.rice_fit_legacy(idx, nnz, d=d, window=window), (r, header)))
    assert all(torch.equal(a, b) for a, b in zip(
        K.rice_pack_fitted_legacy(idx, nnz, r, d=d, window=window),
        (words, header)))


def _check_fitted(idx, nnz, d, window, r_rows=None):
    """The fit (at ``r_rows`` when given) and the fitted packing from its
    bases, bit-equal to the plain versions (r, header, tile bases, words
    with their padding, the packing's header), the words decoding at each
    row's r to the kept coordinates. Returns (r, header)."""
    from repro_torch.comm.compaction import rice_decode_fitted
    k_cap = idx.shape[1]
    fit = K.rice_fit_tiles(idx, nnz, d=d, window=window, r_rows=r_rows)
    want_r, want_h, want_b = ref.rice_fit_tiles_ref(
        idx, nnz, d, window, K.RICE_TILE, r_rows=r_rows)
    assert torch.equal(fit.r, want_r) and torch.equal(fit.header, want_h)
    assert torch.equal(fit.bases, want_b)
    words, header = K.rice_pack_fitted(idx, nnz, fit.r, d=d, window=window,
                                       bases=fit.bases)
    want_w, want_h2 = ref.rice_pack_fitted_ref(idx, nnz, want_r, d, window)
    assert torch.equal(header, want_h2) and torch.equal(header, fit.header)
    assert torch.equal(words, want_w)
    dec = rice_decode_fitted(words, k_cap, d, window, header)
    for row in range(idx.shape[0]):
        n = min(int(nnz[row]), k_cap)
        assert torch.equal(dec[row, :n], idx[row, :n])
    return fit.r, fit.header


def _fitted_rows(gen, k_cap, d, counts):
    idx = torch.zeros((len(counts), k_cap), dtype=torch.int32, device="cuda")
    for row, n in enumerate(counts):
        live = torch.randperm(d, generator=gen, device="cuda")[:min(n, k_cap)]
        idx[row, :live.numel()] = live.sort().values.to(torch.int32)
    return idx, torch.tensor(counts, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("k_cap", [3 * 4096 + 8, 3 * 4096 + 7])
def test_fitted_rows_ending_on_a_tile_edge(card, k_cap):
    """Live codes that end exactly on a tile's last code (the next tile
    dead), one short of it and one past it, with 16-byte idx loads and
    (k_cap % 4 != 0) scalar ones, beside a full and an empty row."""
    t = K.RICE_TILE
    d = 1 << 18
    from repro_torch.core.coding import rice_fit_window
    idx, nnz = _fitted_rows(card, k_cap, d,
                            [t, 2 * t, 2 * t - 1, t + 1, k_cap, 0])
    _check_fitted(idx, nnz, d, rice_fit_window(k_cap, d))


@pytest.mark.parametrize("window", [(0,), (0, 1, 2), (30,), (28, 29, 30)])
def test_fitted_windows_at_r_0_and_30(card, window):
    """Windows that hold r = 0 (no remainder field) and r = 30 (a lane's
    four remainders span 120 bits, its unary runs are single bits), on
    rows of several tiles: full, overflowing, half full, empty."""
    k_cap, d = 3 * K.RICE_TILE + 5, 1 << 20
    idx, nnz = _fitted_rows(card, k_cap, d,
                            [k_cap, k_cap + 99, k_cap // 2, 0])
    _check_fitted(idx, nnz, d, window)


@pytest.mark.parametrize("window", [(0,), (0, 1), (3, 4, 5)])
def test_fitted_unary_runs_longer_than_a_warp_stores(card, window):
    """Gaps near d: runs that span far more words than a lane stores alone
    (the whole warp stores them), at a block's first code and at its last,
    and rows of a few far-apart codes, a single one at d - 1."""
    tile = K.RICE_TILE
    k_cap, d = 3 * tile + 1, 1 << 22
    gap = torch.full((k_cap,), 20, dtype=torch.int64, device="cuda")
    gap[tile] += 300_000
    gap[2 * tile - 1] += 500_000
    idx = (torch.cumsum(gap, 0) - 20).to(torch.int32)[None].repeat(2, 1)
    _check_fitted(idx, torch.tensor([k_cap, 2 * tile + 1], dtype=torch.int32,
                                    device="cuda"), d, window)
    sparse = torch.zeros((2, 1000), dtype=torch.int32, device="cuda")
    sparse[0, 0] = d - 1
    sparse[1, :6] = torch.tensor([5, 6, 100_000, 1_000_001, 3_000_000,
                                  d - 1], device="cuda")
    _check_fitted(sparse, torch.tensor([1, 6], dtype=torch.int32,
                                       device="cuda"), d, window)


def test_fitted_rows_far_wider_than_the_card(card):
    """Rows of the embedding row's shape class, k_cap >= 2^20 codes: each
    spans 513 tiles, three rows 1539, far more blocks than the card holds
    at once, so a row's last fit block may be any of them and the packing's
    blocks run in any order. Full, half-full and overflowing rows."""
    from repro_torch.core.coding import rice_fit_window
    k_cap, d = 512 * K.RICE_TILE + 3, 1 << 25
    idx, nnz = _fitted_rows(card, k_cap, d,
                            [k_cap, k_cap // 2 + 7, k_cap + 1000])
    _check_fitted(idx, nnz, d, rice_fit_window(k_cap, d))


def test_rice_pack_fitted_at_another_r(card):
    """``rice_pack_fitted`` at an ``r_rows`` that is not the fit's choice:
    with no bases it forms them with the fit's kernel at those r (a
    ``rice_fit/at_r`` launch), and with the bases of ``rice_fit_tiles`` at
    those r; both bit-equal to the plain version."""
    from repro_torch.core.coding import rice_fit_window
    k_cap, d = 2 * K.RICE_TILE + 333, 1 << 19
    window = rice_fit_window(k_cap, d)
    idx, nnz = _fitted_rows(card, k_cap, d, [k_cap, k_cap // 3, 0, k_cap + 9])
    r_fit, _ = K.rice_fit(idx, nnz, d=d, window=window)
    other = torch.tensor(window, dtype=torch.int32, device="cuda")
    other = other[(torch.arange(4, device="cuda") + 1) % len(window)]
    assert not torch.equal(other, r_fit)
    _check_fitted(idx, nnz, d, window, r_rows=other)
    at_r = K.LAUNCHES.get("rice_fit/at_r", 0)
    words, header = K.rice_pack_fitted(idx, nnz, other, d=d, window=window)
    assert K.LAUNCHES["rice_fit/at_r"] == at_r + 1
    want_w, want_h = ref.rice_pack_fitted_ref(idx, nnz, other, d, window)
    assert torch.equal(words, want_w) and torch.equal(header, want_h)


def test_adaptive_step_card_matches_cpu(card):
    """One adaptive ``sync_tree`` (deterministic top-k, EF, a mixed
    skip/send step) on the card against the same step on the CPU, on the
    gather wire's fitted RICE layout and on the dense wire: synced leaves,
    residuals, ``last_sent``, wire bytes and ``skipped`` bit-equal, the
    new bounds within rtol 1e-6 (float64 sums of the squares, taken in
    another order)."""
    import socket
    import torch.distributed as dist
    from repro_torch.comm import sync
    from repro_torch.core.api import CompressionConfig
    from repro_torch.optim.optimizers import ControlState, FeedbackState
    gen = torch.Generator().manual_seed(9)
    shapes = [(4, 5000), (20_000,), (64,)]
    stacked = [True, False, False]
    g, r, s, la = ([torch.randn(sh, generator=gen) * sc for sh in shapes]
                   for sc in (1.0, 0.1, 0.5, 0.5))
    bounds = (1e30, 0.0, 0.0)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        cpu_group = dist.new_group([0], backend="gloo")
        for wire in ({"wire": "gather", "wire_layout": "rice",
                      "rice_fitted": True}, {"wire": "dense"}):
            cfg = CompressionConfig(
                name="topk", rho=0.05, min_leaf_size=128, error_feedback=True,
                adaptive=True, skip_tau=0.7, **wire)
            out = {}
            for dev, grp in (("cuda", None), ("cpu", cpu_group)):
                def on(ts):
                    return [t.to(dev, copy=True) for t in ts]
                ctl = ControlState(
                    last_sent=on(s), last_avg=on(la),
                    bound=[torch.tensor(b, device=dev) for b in bounds],
                    step=1)
                synced, fb, nctl, st = sync.sync_tree(
                    cfg, torch.Generator(device=dev), on(g), group=grp,
                    stacked=stacked, feedback=FeedbackState(on(r)),
                    control=ctl)
                out[dev] = ([t.cpu() for t in synced + fb.residual
                             + nctl.last_sent],
                            [t.cpu() for t in nctl.bound],
                            (float(st.wire_bytes), float(st.skipped)))
            for a, b in zip(out["cuda"][0], out["cpu"][0]):
                assert torch.equal(a, b)
            for a, b in zip(out["cuda"][1], out["cpu"][1]):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
            assert out["cuda"][2] == out["cpu"][2]
            assert out["cuda"][2][1] == 1.0
    finally:
        dist.destroy_process_group()


def _det_rows(gen) -> torch.Tensor:
    """bf16 rows of heavy-tailed values with the deterministic rounding's
    ties: a row of norm 2 whose |v| = 1 gives qsgd4 the fraction 0.5
    exactly, and a row whose ternary ratios are 0.5 and just below it."""
    g, _ = _group(gen, torch.bfloat16, 40_003)
    g[0].zero_()
    g[0, [5, 9000, 17_000, 40_002]] = torch.tensor(
        [1.0, -1.0, 1.0, -1.0], dtype=torch.bfloat16, device="cuda")
    g[1].zero_()
    g[1, [3, 4, 5, 6]] = torch.tensor([4.0, 2.0, -2.0, 1.9921875],
                                      dtype=torch.bfloat16, device="cuda")
    return g


@pytest.mark.parametrize("codec", ["qsgd4", "qsgd8", "ternary"])
@pytest.mark.parametrize("pkind", ["topk", "lam"])
def test_compact_emit_det_round_matches_plain_version(card, codec, pkind):
    """Pass 2's deterministic rounding (the pod stage's integer codecs:
    the uniform ``DET_U`` for every survivor, no codec uniforms read):
    values and idx bit-equal to the plain version on the same scalars, at a
    capacity that cuts and one that does not; on the tie rows qsgd4 rounds
    7.5 up to 8 and ternary keeps ratio 0.5 and drops the one below."""
    g = _det_rows(card)
    u = torch.rand(g.shape, generator=card, device="cuda")
    cdc = codecs.get(codec)
    for k_cap in (1500, 40_003):
        if pkind == "topk":
            s1, budget = K.topk_threshold(g, k_cap)
            kw = dict(pkind="topk", budget=budget)
            uu = None
        else:
            l1, _ = K.stats_l1max(g)
            s1, kw, uu = RHO * g.shape[1] / l1, {}, u
        sel = K.select_stats(g, uu, s1, k_cap, **kw)
        scale = codecs.finalize_scale(cdc, sel.sum_sq, sel.max_abs)
        got = K.compact_emit(g, uu, s1, sel, k_cap=k_cap, codec=cdc,
                             ef=False, scale=scale, det_round=True, **kw)
        want = ref.compact_emit_ref(g, uu, s1, k_cap, cdc, False,
                                    scale=scale, det_round=True, **kw)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b)
        if pkind == "topk" and k_cap == 40_003:
            if codec == "qsgd4":
                assert got[0][0, :4].tolist() == [8, -8, 8, -8]
            if codec == "ternary":
                assert got[0][1, :4].tolist() == [1, 1, -1, 0]


def test_magnitude_compact_on_the_card(card):
    """``compaction.compact`` and the pod stage's compaction on the card:
    bit-equal to the plain versions (the f32 and bf16 codecs through the
    whole chain; an integer codec's live prefix from ``live_prefix``), its
    kept magnitudes those of ``torch.topk`` with ties by lowest index."""
    from repro_torch.comm import compaction
    g = _det_rows(card)
    g[2, 100:400] = 0.5           # ties at the cut
    for k_cap in (256, 1024):
        for codec in (FloatCodec(), FloatCodec(16, True)):
            c = ops.magnitude_compact(g, k_cap=k_cap, codec=codec)
            t, budget = ref.topk_threshold_ref(g, k_cap, K.TOPK_BITS[
                g.dtype])
            st = ref.select_stats_ref(g, None, t, k_cap, K.TILE,
                                      pkind="topk", budget=budget)
            vals, idx, _ = ref.compact_emit_ref(g, None, t, k_cap, codec,
                                                False, pkind="topk",
                                                budget=budget)
            assert torch.equal(c.values, vals) and torch.equal(c.idx, idx)
            assert torch.equal(c.nnz, st.nonzeros)
        v, i, n = compaction.compact(g, k_cap)
        top = torch.topk(g.float().abs(), k_cap).values
        kept = torch.sort(v.float().abs(), descending=True).values
        assert torch.equal(kept[n >= k_cap], top[n >= k_cap])
    c = ops.magnitude_compact(g, k_cap=1024, codec=codecs.get("qsgd4"))
    live = (c.values != 0).sum(-1, dtype=torch.int32)
    assert torch.equal(c.live, live)


def _tie_rows(gen, d: int) -> torch.Tensor:
    """bf16 rows for the compaction's order: row 0 a run of ties at 0.5
    every 997 coordinates (across many tiles) under larger values, row 1
    600 ties inside one tile, row 2 at most 300 nonzeros (the pod-average
    case: fewer than the capacities), row 3 all zeros."""
    g, _ = _group(gen, torch.bfloat16, d)
    g = torch.cat([g, torch.zeros((1, d), dtype=g.dtype, device="cuda")])
    g[0] = torch.where(g[0].abs() > 2, g[0], torch.zeros_like(g[0]))
    g[0, ::997] = 0.5
    g[1, 20_000:20_600] = -0.5
    keep = torch.zeros(d, dtype=torch.bool, device="cuda")
    keep[torch.randint(0, d, (300,), generator=gen, device="cuda")] = True
    g[2] = torch.where(keep, g[2], torch.zeros_like(g[2]))
    return g


def _compact_vs_plain(g, k_cap, codec):
    """``ops.magnitude_compact`` on the card (``compact_bins``, then
    ``compact_select``) against the plain versions on the CPU: the row
    scalars equal (sum v^2 within rtol 1e-6), values and idx bit-equal at
    the card's scale, and the whole op's values, idx, nnz and live."""
    K.reset_launches()
    c = ops.magnitude_compact(g, k_cap=k_cap, codec=codec)
    assert K.LAUNCHES["compact_bins"] == K.LAUNCHES["compact_select"] == 1
    assert K.LAUNCHES["topk_threshold"] == K.LAUNCHES["select_stats"] == 0
    bins = K.compact_bins(g, k_cap)
    want = ref.compact_bins_ref(g.cpu(), k_cap)
    for f in ("t", "budget", "nonzeros", "kept", "max_abs"):
        assert torch.equal(getattr(bins, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(bins.sum_sq.cpu(), want.sum_sq, rtol=1e-6,
                               atol=0)
    vals, idx = K.compact_select(g, bins, k_cap=k_cap, codec=codec,
                                 scale=c.scale)
    rv, ri = K.compact_select(g.cpu(), want, k_cap=k_cap, codec=codec,
                              scale=c.scale.cpu())
    assert torch.equal(vals.cpu(), rv) and torch.equal(idx.cpu(), ri)
    assert torch.equal(c.nnz.cpu(), want.nonzeros)
    if not codec.integer_coded:
        assert torch.equal(c.values, vals) and torch.equal(c.idx, idx)
        assert torch.equal(c.live.cpu(), want.kept)
    return bins


@pytest.mark.parametrize("codec", ["f32", "bf16", "qsgd4", "qsgd8",
                                   "ternary"])
@pytest.mark.parametrize("d", [D, 65_536])
def test_compact_bins_and_select_match_plain(card, d, codec):
    """The bf16 compaction's two kernels on ties across tiles and inside
    one, rows with fewer nonzeros than k_cap, an all-zero row, ragged rows
    that take scalar loads (d = 100,003) and aligned ones, at a capacity
    that cuts and one that keeps the sparse rows whole."""
    g = _tie_rows(card, d)
    cdc = codecs.get(codec)
    for k_cap in (2048, 150):
        bins = _compact_vs_plain(g, k_cap, cdc)
        assert int(bins.t[3]) == 0 and int(bins.kept[3]) == 0
        assert float(bins.t[2]) == 0.0 or k_cap < 300


def test_compact_select_tie_budgets(card):
    """``compact_select`` on given scalars: a tie budget of 0 (no tie kept),
    part of the ties (the lowest coordinates win, across tiles) and all of
    them, against the plain version."""
    g = _tie_rows(card, D)[:2]
    t = torch.full((2,), 0.5, device="cuda")
    n_gt = (g.float().abs() > 0.5).sum(-1).to(torch.int32)
    ties = (g.float().abs() == 0.5).sum(-1)
    for budget in (torch.zeros(2, dtype=torch.int64, device="cuda"),
                   ties // 3, ties):
        kept = (n_gt + budget).to(torch.int32)
        k_cap = int(kept.max()) + 64
        bins = ref.CompactBins(t, budget, kept, kept, t, t)
        got = K.compact_select(g, bins, k_cap=k_cap, codec=FloatCodec())
        want = ref.compact_emit_ref(g.cpu(), None, t.cpu(), k_cap,
                                    FloatCodec(), False, pkind="topk",
                                    budget=budget.cpu())
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_compaction_past_2_24_coordinates(card):
    """A row of 2^24 + 12,345 coordinates (1,025 tiles, a ragged last one,
    ranks past 2^24) with ties at the cut, and a narrow second group."""
    d = (1 << 24) + 12_345
    g = (torch.randn((1, d), generator=card, device="cuda")
         * 1e-3).to(torch.bfloat16)
    g[0, 1_000_000::4099] = 0.25
    n_big = int((g.float().abs() > 0.25).sum())
    k_cap = n_big + int((g.float().abs() == 0.25).sum()) // 2
    _compact_vs_plain(g, k_cap, FloatCodec())
    _compact_vs_plain(g, 1 << 22, codecs.get("qsgd8"))


@pytest.mark.parametrize("eps", [1.0, 40.0, 0.0, -1.0])
def test_closed_lambda_kernel_matches_bin_solve(card, eps):
    """``kernel.closed_lambda`` (the bin solve, one block a row) against
    its plain version on the same histogram: the same bin on every row,
    lambda within rtol 1e-6; eps -1 leaves no bin (lambda 0, bin -1) on
    a row with a nonzero, while an all-zero row keeps bin 0."""
    g = torch.cat([_tie_rows(card, D), _group(card, torch.bfloat16)[0]])
    hist = K.magnitude_hist(g)
    K.reset_launches()
    lam, b = K.closed_lambda(hist, eps)
    assert K.LAUNCHES["closed_lambda"] == 1
    want_lam, want_b = ref.closed_lambda_bins_ref(hist.cpu(), eps)
    assert torch.equal(b.cpu(), want_b)
    torch.testing.assert_close(lam.cpu(), want_lam, rtol=1e-6, atol=0)
    if eps < 0:
        assert b.tolist() == [-1, -1, -1, 0, -1, -1, -1]
        assert bool((lam == 0).all())
    K.reset_launches()
    assert torch.equal(ops.closed_lambda(g, eps), lam)
    assert K.LAUNCHES["topk_threshold/hist"] == K.LAUNCHES[
        "closed_lambda"] == 1


@pytest.mark.parametrize("name", ["agspar", "gspar+bf16", "identity+qsgd4",
                                  "topk"])
def test_reference_backend_on_the_card_is_the_dense_wire(card, name):
    """On the card the reference backend's buffers scatter to the dense
    wire's Q on the same target and uniforms, and its residual is the
    dense wire's (kernel 6), bit for bit."""
    from repro_torch.core.api import CompressionConfig
    from repro_torch.core.sparse import ReferenceBackend, dense_group
    g, u = _group(card, torch.bfloat16, 65_536)
    cfg = CompressionConfig(name=name, rho=RHO, wire="gather",
                            backend="reference", error_feedback=True)
    scheme = cfg.scheme()
    u_cod = (torch.rand(g.shape, generator=card, device="cuda")
             if scheme.codec.stochastic else None)
    uu = u if scheme.selector.samples else None
    sg, res = ReferenceBackend().compress_sparse_ef(
        cfg, uu, g, cfg.capacity(g.shape[1]), u_cod)
    r = dense_group(scheme, uu, g, True, u_cod=u_cod)
    assert torch.equal(res, r.residual)
    for row in range(g.shape[0]):
        n = int(min(int(sg.n_valid[row]), sg.k_cap))
        q = torch.zeros(g.shape[1], device="cuda")
        q[sg.idx[row, :n].long()] = sg.decode_values()[row, :n]
        assert torch.equal(q.to(r.q.dtype), r.q[row])


@contextlib.contextmanager
def _host_uniforms(seed: int):
    """``torch.rand`` drawn on the CPU from one seeded generator and moved
    to the requested device, so that the card and the CPU compress with
    the same uniforms (their generators' streams differ)."""
    real = torch.rand
    host = torch.Generator().manual_seed(seed)

    def rand(*size, generator=None, device=None, dtype=None, **kw):
        out = real(*size, generator=host, dtype=dtype, **kw)
        return out.to(device) if device is not None else out

    torch.rand = rand
    try:
        yield
    finally:
        torch.rand = real


@pytest.mark.parametrize("wire", ["dense", "gather"])
def test_tree_stats_and_var_step_size_card_match_cpu(card, wire):
    """``density``, ``var_ratio`` and the step size ``lr / max(var, 1)``
    that ``var_adaptive_lr`` applies, on the card against the CPU on the
    same gradients and uniforms, bit for bit (ROADMAP.md C: they were
    divided by a Python float, which CUDA turns into a product with its
    rounded reciprocal; now by a float32 tensor, the groups summed in the
    JAX order and the rows in float64)."""
    import socket
    import torch.distributed as dist
    from repro_torch.comm import sync
    from repro_torch.core.api import CompressionConfig
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    gen = torch.Generator().manual_seed(12)
    shapes = [(4, 5000), (20_000,), (3, 7777), (64,)]
    stacked = [True, False, True, False]
    g = [torch.randn(s, generator=gen) * torch.randn(s, generator=gen).exp()
         for s in shapes]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        cpu_group = dist.new_group([0], backend="gloo")
        cfg = CompressionConfig(name="gspar", rho=0.05, min_leaf_size=128,
                                error_feedback=True, wire=wire)
        out = {}
        for dev, grp in (("cuda", None), ("cpu", cpu_group)):
            with _host_uniforms(3):
                _, _, st = sync.sync_tree(
                    cfg, torch.Generator(device=dev),
                    [t.to(dev) for t in g], group=grp, stacked=stacked,
                    feedback=topt.init_feedback([t.to(dev) for t in g]))
            scale = tstep._var_scale(st.var_ratio, grp)
            eta = topt._step_size(3e-4, 1, scale, torch.device(dev))
            out[dev] = [t.cpu() for t in (st.density, st.var_ratio, scale,
                                          eta)]
        for name, a, b in zip(("density", "var_ratio", "var_scale", "eta"),
                              out["cuda"], out["cpu"]):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, a, b)
        assert float(out["cpu"][1]) > 1.0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma2-27b",
                                  "starcoder2-7b"])
def test_arch_one_step_loss_card_matches_cpu(card, arch):
    """One compressed step (gspar, the gather wire's ``auto``, EF, Adam) of
    the smoke config in bfloat16 on the card against float32 on the CPU,
    from the same parameters, batch and uniforms: the step's loss and the
    loss after the update agree within bfloat16's rtol 1e-2."""
    import dataclasses
    import socket
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.api import CompressionConfig
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.transformer import Transformer, init_model
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = registry.get(arch).smoke
    params = init_model(cfg32, torch.Generator().manual_seed(0), "cpu")
    batch = token_batch(torch.Generator().manual_seed(1), cfg32.vocab, 4, 32)
    comp = CompressionConfig(name="gspar", rho=0.05, wire="gather",
                             error_feedback=True, min_leaf_size=1024)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        cpu_group = dist.new_group([0], backend="gloo")
        losses = {}
        for dev, dtype, grp in (("cuda", torch.bfloat16, None),
                                ("cpu", torch.float32, cpu_group)):
            cfg = dataclasses.replace(cfg32, dtype=dtype)
            model = Transformer(cfg, {k: v.to(dev, dtype) for k, v in
                                      params.items()})
            opt = topt.adam(3e-4)
            step = tstep.make_compressed_train_step(model, comp, opt,
                                                    group=grp)
            b = {"tokens": batch["tokens"].to(dev)}
            with _host_uniforms(4):
                _, _, m = step(opt.init(model.leaves()),
                               topt.init_feedback(model.leaves()), b,
                               torch.Generator(device=dev))
            with torch.no_grad():
                after = tstep.make_loss_fn(cfg)(dict(model.params), b)
            losses[dev] = (float(m["loss"]), float(after))
        for a, b in zip(losses["cuda"], losses["cpu"]):
            assert abs(a - b) <= 1e-2 * abs(b), losses
        assert losses["cpu"][1] < losses["cpu"][0]
    finally:
        dist.destroy_process_group()
