"""Every selector ∘ codec on the port's dense wire against the JAX package's
``Scheme.apply_dense`` arithmetic (src/repro/core/schemes.py:272), fed the
same numpy uniforms: the dense emit (kernels 5 and 6: plain versions on the
CPU) for each selector kind and codec, the pipelines with the port's own
scalars through ``compress_tree``, the dense and gather wires' kept
coordinates from one generator seed, the exchange at one worker, and one
compressed train step with unisp (EF) and qsgd against a JAX step.

The JAX reference is ``apply_dense`` with its two draws replaced by the
numpy uniforms (``u`` for the selector, ``u_cod`` per coordinate for an
integer codec)::

    p = selector.probabilities(g)      # lam/rho/bern/topk/identity
    v = apply_mask(g, p, u < p)        # topk: g p; identity: g
    scale = codec.scale(v)
    q = codec.decode(codec.encode(v, scale, u_cod), scale).astype(g.dtype)

and the residual ``target - q`` (an integer codec's as the identity-indexed
scatter of ``compress_tree``). For gspar the kernel form ``p = min(lambda
|g|, 1)`` is taken with the JAX package's lambda.

Tolerances, with their reasons:
- the dense emit given the JAX scalars (lambda, rho, max|g|, topk's
  threshold and tie budget, the codec scale): q and the residual bit-equal,
  except the sign of a zero (an unkept coordinate is +0 in the port, as in
  the Pallas kernels; ``apply_mask``'s ``Z * g / p`` gives -0 for a
  negative g); counts exact; sum q^2 and sum g^2 within rtol 1e-6 (float64
  sums rounded once against XLA's float32 sums);
- the codec scale over v rounded to the leaf dtype: within rtol 1e-6;
- the port's own scalars (lambda, agspar's fitted rho, the scale) within
  rtol 1e-6; q and the residual as above except at draws within 1e-5 of
  their keep probability, or of an integer codec's rounding point, which an
  ulp of the scalar may flip; elsewhere values within rtol 1e-6 or one ulp
  of the dtype (an ulp of lambda moves g / p by about as much);
- the two wires: the same kept coordinates, bit for bit, with a float
  codec (an integer codec's draws differ in shape: [rows, d] here, [rows,
  k_cap] on the gather wire);
- the train step: as ``tests/test_torch_dense.py`` states it.
"""
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import gemma_2b as jgemma
from repro.core import codecs as jcodecs
from repro.core import schemes as jschemes
from repro.core import sparsify as jsparsify
from repro.core.api import CompressionConfig as JConfig
from repro.core.grouping import plan_tree as jplan_tree
from repro.kernels.sparsify import ops as jops
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch.comm import sync as tsync
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.core import codecs as tcodecs
from repro_torch.core import sparse as tsparse
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.api import compress_tree, compress_tree_sparse
from repro_torch.kernels.sparsify import kernel as TK
from repro_torch.kernels.sparsify import ops as tops
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Transformer
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ROWS, D, RHO, EPS = 2, 9_000, 0.05, 1.0
SUM_RTOL = 1e-6
NEAR = 1e-5
KINDS = ["lam", "rho", "bern", "topk", "one"]
CODECS = list(tcodecs.CODEC_NAMES)


def _inputs(dtype: str, rows: int = ROWS, d: int = D, seed: int = 31):
    """g with a zero run and a row of ties, and the two draws."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((rows, d))
         * np.exp(rng.standard_normal((rows, d)))).astype(np.float32)
    g[0, : d // 10] = 0.0
    g[-1] = np.round(g[-1] * 2) / 2
    u = rng.random((rows, d), dtype=np.float32)
    u_cod = rng.random((rows, d), dtype=np.float32)
    return g, u, u_cod


def _t(g: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(g).to(getattr(torch, dtype))


def _j(g: np.ndarray, dtype: str):
    return jnp.asarray(g).astype(getattr(jnp, dtype))


def _bits(x) -> np.ndarray:
    """Bit pattern, with -0 read as +0 (see the module docstring)."""
    if isinstance(x, torch.Tensor):
        x = x + 0
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.view(torch.int32).numpy().view(np.uint32)
    a = np.asarray(x + 0)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _np32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, rtol=SUM_RTOL):
    np.testing.assert_allclose(np.asarray(_np32(got), np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


def _jax_lambda(jg):
    """The JAX package's greedy lambda of one row (``ops.greedy_lambda``
    with a jnp tail: the Pallas kernels' arithmetic without the kernels)."""
    a = jnp.abs(jg.astype(jnp.float32))

    def tail(thresh):
        below = a < thresh
        return (jnp.sum(below, dtype=jnp.float32),
                jnp.sum(jnp.where(below, a, 0.0)))
    return jops.greedy_lambda(jnp.sum(a), jnp.max(a), RHO, a.shape[0], 2,
                              tail_fn=tail)


def _jax_selector(kind: str):
    return {"lam": None, "rho": jschemes.UnispSelector(rho=RHO),
            "bern": jschemes.BernoulliSelector(),
            "topk": jschemes.TopkSelector(rho=RHO),
            "one": jschemes.IdentitySelector()}[kind]


def _jax_probabilities(kind: str, jg, lam=None):
    if kind == "lam":
        return jnp.minimum(lam * jnp.abs(jg.astype(jnp.float32)), 1.0)
    return _jax_selector(kind).probabilities(jg)


def jax_apply_dense(kind: str, codec_name: str, jg, u, u_cod, p,
                    scale=None):
    """``Scheme.apply_dense`` of one row with the draws fed in; returns
    ``(q, residual, scale, v)``."""
    if kind in ("lam", "rho", "bern"):
        v = jsparsify.apply_mask(jg, p, (jnp.asarray(u) < p).astype(
            jnp.float32))
    elif kind == "topk":
        v = _jax_selector(kind).sample(None, jg, p)
    else:
        v = jg
    codec = jcodecs.get(codec_name)
    if scale is None:
        scale = codec.scale(v)
    if codec.rounds_values or codec.integer_coded:
        wire = codec.encode(v, scale, jnp.asarray(u_cod)
                            if codec.stochastic else None)
        q = codec.decode(wire, scale).astype(jg.dtype)
    else:
        q = v.astype(jg.dtype)
    if codec.integer_coded:
        flat = jg.reshape(-1)
        res = flat.at[jnp.arange(flat.shape[0])].add(-q.astype(flat.dtype))
    else:
        res = (jg - q).astype(jg.dtype)
    return q, res, scale, v


def _jax_scalars(kind: str, jg):
    """The per-row scalars the JAX package derives for the dense emit."""
    if kind == "lam":
        return dict(lam=_jax_lambda(jg))
    if kind == "bern":
        return dict(mx=jnp.max(jnp.abs(jg.astype(jnp.float32))))
    if kind == "topk":
        k = max(1, round(RHO * jg.shape[0]))
        topv = jax.lax.top_k(jnp.abs(jg.astype(jnp.float32)), k)[0]
        t = topv[-1]
        return dict(t=t, budget=k - int(jnp.count_nonzero(topv > t)))
    return {}


def _port_kind(kind: str, tg: torch.Tensor, scal: list) -> dict:
    """``kernel.sparsify`` keywords from the JAX scalars of each row."""
    rows = tg.shape[0]
    if kind == "one":
        return dict(pkind="one"), None
    if kind == "lam":
        return dict(pkind="lam"), torch.tensor(
            [float(s["lam"]) for s in scal])
    if kind == "rho":
        return dict(pkind="rho"), torch.full((rows,), RHO)
    if kind == "bern":
        return dict(pkind="bern", s2=torch.tensor(
            [float(s["mx"]) for s in scal])), torch.zeros(rows)
    t = torch.tensor([float(s["t"]) for s in scal])
    budget = torch.tensor([s["budget"] for s in scal], dtype=torch.int64)
    st = TK.select_stats(tg, None, t, tg.shape[1], pkind="topk",
                         budget=budget)
    return dict(pkind="topk", budget=budget, tie_base=st.tie_base), t


@functools.lru_cache(maxsize=None)
def _reference(kind: str, codec_name: str, dtype: str):
    g, u, u_cod = _inputs(dtype)
    out = []
    for r in range(ROWS):
        jg = _j(g[r], dtype)
        scal = _jax_scalars(kind, jg)
        p = _jax_probabilities(kind, jg, scal.get("lam"))
        q, res, scale, v = jax_apply_dense(kind, codec_name, jg, u[r],
                                           u_cod[r], p)
        out.append((scal, np.asarray(p), q, res, float(scale), v))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("kind", KINDS)
def test_dense_emit_matches_apply_dense(kind, codec_name, dtype):
    """Kernels 5 and 6 (plain versions) given the JAX scalars and scale:
    q and the residual bit-equal to ``apply_dense``'s; the accounting
    sums of q as the wire carries it."""
    g, u, u_cod = _inputs(dtype)
    tg = _t(g, dtype)
    ref = _reference(kind, codec_name, dtype)
    kw, s1 = _port_kind(kind, tg, [r[0] for r in ref])
    codec = tcodecs.get(codec_name)
    uu = torch.from_numpy(u) if kind in ("lam", "rho", "bern") else None
    out_dtype = tg.dtype if codec.integer_coded else codec.wire_dtype(
        tg.dtype)
    if codec.integer_coded:
        kw.update(codec=codec, u_cod=torch.from_numpy(u_cod),
                  scale=torch.tensor([r[4] for r in ref]))
    got = TK.sparsify_ef(tg, uu, s1, out_dtype, **kw)
    got_noef = TK.sparsify(tg, uu, s1, out_dtype, **kw)
    assert torch.equal(got.q, got_noef.q)
    for r, (_, p, q, res, _, _) in enumerate(ref):
        q_t = got.q[r].to(tg.dtype)
        np.testing.assert_array_equal(_bits(q_t), _bits(q), err_msg=f"q {r}")
        np.testing.assert_array_equal(_bits(got.residual[r]), _bits(res),
                                      err_msg=f"residual {r}")
        qf = np.asarray(q, np.float32)
        assert int(got.nnz[r]) == int(np.count_nonzero(qf))
        assert int(got.n_sure[r]) == int(np.count_nonzero(
            (qf != 0) & (p >= 1.0)))
        _close(got.sum_sq[r], np.sum(qf.astype(np.float64) ** 2))
        _close(got.den[r], np.sum(g[r].astype(
            getattr(np, "float32")).astype(np.float64) ** 2)
            if dtype == "float32" else np.sum(
                np.asarray(_j(g[r], dtype), np.float64) ** 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_emit_reduces_sum_sq_only_when_not_given(dtype):
    """Sum g^2 from an earlier pass (the stats pass) is passed through the
    dense emit and the rest of its result is unchanged; without it the
    emit reduces the same sum (rtol 1e-6); kernel 8 reduces none. The
    pipelines take it from their stats pass (gspar, agspar, bern) or
    pass 1 (topk), and unisp's pass reduces it."""
    g, u, _ = _inputs(dtype)
    tg, tu = _t(g, dtype), torch.from_numpy(u)
    l1, l2, mx = TK.stats(tg)
    lam = tops.greedy_lambda(l1, mx, RHO, D)
    given = TK.sparsify_ef(tg, tu, lam, den=l2)
    own = TK.sparsify_ef(tg, tu, lam)
    assert given.den is l2
    for f in ("q", "residual", "nnz", "n_sure", "sum_sq"):
        assert torch.equal(getattr(given, f), getattr(own, f)), f
    _close(own.den, np.asarray(l2, np.float64))
    assert TK.sparsify_prng(tg, lam, 7).den is None
    for r in (tops.gspar_dense(tg, tu, rho=RHO),
              tops.agspar_dense(tg, tu, rho=RHO),
              tops.bern_dense(tg, tu)):
        assert torch.equal(r.den, l2)
    topk = tops.topk_dense(tg, k_target=int(RHO * D))
    _close(topk.den, np.asarray(l2, np.float64))
    _close(tops.unisp_dense(tg, tu, rho=RHO).den, np.asarray(l2, np.float64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec_name", ["qsgd8", "ternary"])
@pytest.mark.parametrize("kind", ["lam", "rho", "bern", "topk"])
def test_dense_scale_is_over_v_rounded_to_the_leaf(kind, codec_name, dtype):
    """Pass 1 with ``round_v`` at ``k_cap = d``: the codec's scale over v
    in the leaf dtype, ``codec.scale(v)`` of ``apply_dense``."""
    g, u, _ = _inputs(dtype)
    tg = _t(g, dtype)
    ref = _reference(kind, codec_name, dtype)
    kw, s1 = _port_kind(kind, tg, [r[0] for r in ref])
    kw.pop("tie_base", None)
    kw.pop("pkind")
    uu = None if kind == "topk" else torch.from_numpy(u)
    st = TK.select_stats(tg, uu, s1, D, pkind=kind, round_v=True, **kw)
    scale = tcodecs.finalize_scale(tcodecs.get(codec_name), st.sum_sq,
                                   st.max_abs)
    for r in range(ROWS):
        _close(scale[r], ref[r][4])


# --- the pipelines with the port's own scalars ------------------------------

SCHEMES = ["gspar", "gspar+qsgd8", "gspar+bf16", "agspar", "agspar+ternary",
           "unisp", "unisp+qsgd4", "bernoulli+bf16", "terngrad", "topk",
           "topk+ternary", "qsgd", "identity+ternary", "identity+bf16",
           "none", "closed", "closed+qsgd8"]


def _config(name: str, ef: bool, wire: str = "dense",
            rho: float = RHO) -> TConfig:
    """The port's config of a test scheme name (``closed``: gspar with
    Algorithm 2 at EPS); error feedback where the JAX config takes it
    (not on identity with a lossless codec)."""
    ef = ef and name not in ("none", "identity", "identity+f32")
    kw = dict(rho=rho, error_feedback=ef, wire=wire, min_leaf_size=256)
    if name.startswith("closed"):
        kw.update(algo="closed", eps=EPS)
        name = "gspar" + name[len("closed"):]
    return TConfig(name=name, **kw)


def _jax_row_reference(name: str, jg, u, u_cod):
    """The JAX package's own scalars and ``apply_dense`` for one row:
    ``(p, q, residual, scale, lam)``."""
    sel_name = name.split("+")[0]
    codec = name.split("+")[1] if "+" in name else {
        "terngrad": "ternary", "qsgd": "qsgd4"}.get(name, "f32")
    if sel_name in ("gspar", "agspar", "closed"):
        if sel_name == "gspar":
            lam = _jax_lambda(jg)
        elif sel_name == "closed":
            lam = jsparsify.closed_form_lambda(jg, EPS)[0]
        else:
            a = jnp.abs(jg.astype(jnp.float32))
            rho = jschemes.AdaptiveGsparSelector(rho=RHO).rho_fitted(jg)

            def tail(thresh):
                below = a < thresh
                return (jnp.sum(below, dtype=jnp.float32),
                        jnp.sum(jnp.where(below, a, 0.0)))
            lam = jops.greedy_lambda(jnp.sum(a), jnp.max(a), rho,
                                     a.shape[0], 2, tail_fn=tail)
        kind = "lam"
    else:
        lam = None
        kind = {"unisp": "rho", "bernoulli": "bern", "terngrad": "bern",
                "topk": "topk", "qsgd": "one", "identity": "one",
                "none": "one"}[sel_name]
    p = _jax_probabilities(kind, jg, lam)
    q, res, scale, _ = jax_apply_dense(kind, codec, jg, u, u_cod, p)
    return np.asarray(p), q, res, float(scale), lam, codec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SCHEMES)
def test_compress_tree_matches_apply_dense(name, dtype):
    """``compress_tree`` on one stacked leaf with the port's own scalars
    against ``apply_dense`` with the JAX package's, the draws re-made from
    the same generator seed: lambda and the scale within rtol 1e-6, q and
    the residual equal away from the exempt draws."""
    cfg = _config(name, ef=True)
    ef = cfg.error_feedback
    scheme = cfg.scheme()
    g, _, _ = _inputs(dtype, seed=41)
    tg = _t(g, dtype)
    q, res, stats = compress_tree(cfg, torch.Generator().manual_seed(5),
                                  [tg], [True],
                                  [torch.zeros_like(tg)] if ef else None)
    gen = torch.Generator().manual_seed(5)
    u = (torch.rand(tg.shape, generator=gen) if scheme.selector.samples
         else torch.zeros(tg.shape))
    u_cod = (torch.rand(tg.shape, generator=gen)
             if scheme.codec.stochastic else torch.zeros(tg.shape))
    r_port = tsparse.dense_group(scheme, u if scheme.selector.samples
                                 else None, tg.clone(), True,
                                 u_cod=u_cod if scheme.codec.stochastic
                                 else None)
    codec = scheme.codec
    for r in range(ROWS):
        jg = _j(g[r], dtype)
        p, jq, jres, jscale, jlam, _ = _jax_row_reference(
            name, jg, u[r].numpy(), u_cod[r].numpy())
        if jlam is not None:
            _close(r_port.lam[r], jlam)
        if codec.integer_coded:
            _close(r_port.scale[r], jscale)
        exempt = np.zeros(D, bool)
        if scheme.selector.samples:
            exempt |= np.abs(u[r].numpy() - p) < NEAR
        if codec.integer_coded:
            v = np.abs(np.asarray(jax_apply_dense(
                "one", "f32", jg, None, None, None)[3], np.float32))
            frac = v / max(jscale, 1e-30)
            if codec.name.startswith("qsgd"):
                frac = frac * codec.levels
                frac = frac - np.floor(frac)
            exempt |= np.abs(u_cod[r].numpy() - frac) < NEAR
        keep = ~exempt
        assert keep.mean() > 0.99
        got_q = _np32(q[0][r])[keep]
        want_q = np.asarray(jq, np.float32)[keep]
        np.testing.assert_array_equal(got_q != 0, want_q != 0)
        ulp = np.spacing(np.abs(want_q).astype(
            np.float32 if dtype == "float32" else np.float32)) * (
                1 if dtype == "float32" else 65536)
        np.testing.assert_array_less(
            np.abs(got_q - want_q), np.maximum(1e-6 * np.abs(want_q),
                                               ulp) + 1e-30)
        if ef:
            got_r = _np32(res[0][r])[keep]
            want_r = np.asarray(jres, np.float32)[keep]
            np.testing.assert_array_less(
                np.abs(got_r - want_r),
                np.maximum(1e-6 * np.abs(want_q), ulp) + 1e-30)
    assert np.isfinite(float(stats.bits)) and float(stats.density) > 0.0


@pytest.mark.parametrize("codec_name", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["gspar", "closed", "unisp", "topk",
                                  "bernoulli"])
def test_dense_and_gather_wires_keep_the_same_coordinates(name, codec_name):
    """One generator seed, one group: the dense wire's nonzeros are the
    gather wire's kept coordinates and values, bit for bit (Algorithm 2's
    capacity sized for its density at EPS, rho 0.6)."""
    cfg_name = name if codec_name == "f32" else f"{name}+{codec_name}"
    rho = 0.6 if name == "closed" else RHO
    g, _, _ = _inputs("bfloat16", seed=43)
    tg = _t(g, "bfloat16")
    dense = compress_tree(_config(cfg_name, False, rho=rho),
                          torch.Generator().manual_seed(9), [tg], [True])[0]
    items = compress_tree_sparse(_config(cfg_name, False, "gather", rho),
                                 torch.Generator().manual_seed(9), [tg],
                                 [True])[0]
    (_, sg, _), = items
    assert int(sg.overflow().sum()) == 0
    for r in range(ROWS):
        n = int(sg.nnz[r])
        idx = sg.idx[r, :n].long()
        want = torch.zeros(D, dtype=dense[0].dtype)
        want[idx] = sg.values[r, :n].to(want.dtype)
        np.testing.assert_array_equal(_bits(dense[0][r]), _bits(want))


def test_one_worker_exchange_issues_no_collective(monkeypatch):
    """At one worker the dense exchange leaves Q as it is: no collective,
    no division."""
    def refuse(*a, **k):
        raise AssertionError("a collective at one worker")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    for fn in ("all_to_all_single", "all_gather_into_tensor", "all_reduce"):
        monkeypatch.setattr(dist, fn, refuse)
    q = [torch.randn(3, 5), torch.randn(7).to(torch.bfloat16)]
    want = [t.clone() for t in q]
    synced, wire = tsync._sync_leaves_dense(q, None)
    for a, b in zip(synced, want):
        assert torch.equal(a, b)
    assert wire == 3 * 5 * 4 + 7 * 2


# --- one compressed train step against a JAX step ---------------------------

LR, SEED, MIN_LEAF = 1e-3, 13, 1024


@functools.lru_cache(maxsize=None)
def _model_and_grads():
    params = jax.jit(lambda k: split_params(
        jtf.init_model(k, jgemma.SMOKE))[0])(jax.random.key(4))
    tokens = np.random.default_rng(6).integers(0, jgemma.SMOKE.vocab,
                                               (4, 32))
    grads = jax.jit(jax.grad(jstep.make_loss_fn(jgemma.SMOKE)))(
        params, {"tokens": jnp.asarray(tokens)})
    return params, tokens, grads


def _jax_step(name: str, ef: bool, stacked):
    """One Algorithm-1 step at one worker on the dense wire from the JAX
    package's pieces: per sparse group and row ``apply_dense`` with the
    JAX package's scalars, fed the port's draws (re-made from an
    identically seeded generator), the pmean of one worker, ``adam``.
    Returns (new params leaves, residual leaves, exempt masks)."""
    params, _, grads = _model_and_grads()
    leaves, tdef = jax.tree_util.tree_flatten(grads)
    leaves = [np.asarray(g) for g in leaves]
    cfg = _config(name, ef)
    scheme = cfg.scheme()
    plan = jplan_tree(JConfig(name="gspar", rho=RHO, min_leaf_size=MIN_LEAF),
                      leaves, stacked)
    gen = torch.Generator().manual_seed(SEED)
    synced, res, exempt = ([None] * len(leaves) for _ in range(3))
    for grp in plan.groups:
        if grp.kind == "dense":
            for i, _ in grp.members:
                synced[i] = leaves[i]
                res[i] = np.zeros_like(leaves[i])
                exempt[i] = np.zeros(leaves[i].shape, bool)
            continue
        stack = np.concatenate([leaves[i].reshape(rows, grp.d)
                                for i, rows in grp.members])
        shape = (grp.rows, grp.d)
        u = (torch.rand(shape, generator=gen).numpy()
             if scheme.selector.samples else np.zeros(shape, np.float32))
        u_cod = (torch.rand(shape, generator=gen).numpy()
                 if scheme.codec.stochastic else np.zeros(shape, np.float32))
        qs, rs, ex = [], [], []
        for r in range(grp.rows):
            jg = jnp.asarray(stack[r])
            p, q, rr, scale, _, _ = _jax_row_reference(name, jg, u[r],
                                                       u_cod[r])
            near = np.abs(u[r] - p) < NEAR
            if scheme.codec.integer_coded:
                frac = np.abs(stack[r]) / max(scale, 1e-30) * \
                    scheme.codec.levels
                near |= np.abs(u_cod[r] - (frac - np.floor(frac))) < NEAR
            qs.append(np.asarray(q))
            rs.append(np.asarray(rr))
            ex.append(near)
        q, rr, near = np.stack(qs), np.stack(rs), np.stack(ex)
        r0 = 0
        for i, rows in grp.members:
            shp = leaves[i].shape
            synced[i] = q[r0:r0 + rows].reshape(shp)
            res[i] = rr[r0:r0 + rows].reshape(shp)
            exempt[i] = near[r0:r0 + rows].reshape(shp)
            r0 += rows
    opt = jopt.adam(LR)
    new, _ = opt.update(jax.tree_util.tree_unflatten(tdef, synced),
                        opt.init(params), params)
    return [np.asarray(x) for x in jax.tree.leaves(new)], res, exempt


@pytest.fixture
def one_worker_group():
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name,ef", [("unisp", True), ("qsgd", False)])
def test_dense_step_matches_jax_step(one_worker_group, name, ef):
    """The port's step on the dense wire (gemma-2b smoke, float32, Adam)
    against the JAX step of ``_jax_step``: new parameters (and the EF
    residual) to atol 1e-6 away from the exempt draws (at most 0.1 % of
    them); the wire carries 4 B per parameter."""
    params, tokens, _ = _model_and_grads()
    model = Transformer(tgemma.SMOKE, params_from_numpy(
        jax.tree.map(np.asarray, params)))
    want_p, want_r, exempt = _jax_step(name, ef, model.stacked)
    comp = TConfig(name=name, rho=RHO, error_feedback=ef,
                   min_leaf_size=MIN_LEAF)
    opt = topt.adam(LR)
    step = tstep.make_compressed_train_step(model, comp, opt)
    state = opt.init(model.leaves())
    batch = {"tokens": torch.from_numpy(tokens)}
    gen = torch.Generator().manual_seed(SEED)
    if ef:
        _, fb, metrics = step(state, topt.init_feedback(model.leaves()),
                              batch, gen)
        got_r = fb.residual
    else:
        _, metrics = step(state, batch, gen)
        got_r = [None] * len(want_r)
    n_exempt = sum(int(e.sum()) for e in exempt)
    assert n_exempt <= 1e-3 * sum(e.size for e in exempt)
    for nm, p, r, wp, wr, ex in zip(model.leaf_names, model.leaves(), got_r,
                                    want_p, want_r, exempt):
        keep = ~ex
        np.testing.assert_allclose(p.detach().numpy()[keep], wp[keep],
                                   rtol=0, atol=1e-6, err_msg=nm)
        if r is not None:
            np.testing.assert_allclose(r.numpy()[keep], wr[keep],
                                       rtol=1e-5, atol=1e-6, err_msg=nm)
    n_params = sum(p.numel() for p in model.leaves())
    assert float(metrics["wire_bytes"]) == 4.0 * n_params
    assert float(metrics["overflow"]) == 0.0
