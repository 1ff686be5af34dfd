"""The paper's section-5 experiments on the port (``repro_torch.
experiments``, ``repro_torch.data.synthetic``) against the JAX package's
(``repro.experiments``) at a small size (n, d <= 256, a few epochs).

- The data generators are numpy-seeded: bit-equal.
- ``logreg_loss``, ``svm_loss`` and their gradients (the port's closed
  forms against ``jax.grad``): rtol 1e-5; ``solve_reference``'s f*: rtol
  1e-5; ``cnn_forward`` (weights carried across by ``cnn_params_from_jax``):
  rtol 1e-4, atol 1e-5 on the logits, ``cnn_loss`` rtol 1e-5 and its
  gradients rtol 1e-3, atol 1e-5 (float32 convolutions in two frameworks).
- One step of ``run_sgd``, ``run_svrg``, ``run_cnn`` and ``run_async_svm``
  fed the same indices and uniforms, against a JAX step assembled from the
  JAX package's pieces (its zoo's probabilities, ``apply_mask`` and codecs
  with the uniforms in place of its draws): new weights rtol 1e-5 (atol
  1e-7), except at coordinates where a worker's uniform lies within 1e-5 of
  its keep probability (the port's kernel lambda and the pure solver's p
  differ in the last bits there); bits exact, the variance sums rtol 1e-5.
  The CNN step compares Adam's first moment (the averaged compressed
  gradient, rtol 1e-4, atol 1e-7) and the new weights (atol 1e-6) where
  that moment is above 1e-4 of the largest over all leaves (below, Adam's
  normalisation amplifies float32 noise into a full step, e.g. on the conv
  biases, whose gradient is 0 but for rounding under batch norm).
- ``conflict_stats``' analytic numbers: rtol 1e-6 against JAX on each
  package's p, and rtol 1e-5 against the committed
  ``results/experiments/conflicts.json`` rows; its Monte Carlo counts
  within 6 standard errors of the analytic ones.
- Whole runs: the port's seed-0 run must lie in the band of the JAX runs
  over seeds 0, 1, 2: their [min, max] widened on each side by three times
  their spread (max - min). Measured on the CPU at n = d = 256 (c1 0.6, c2
  0.25, rho 0.05, 4 epochs; SVRG rho 0.2, 2 outer loops): JAX gspar SGD
  final suboptimality 0.4900-0.4951, var 8.53-9.50; JAX gspar SVRG
  0.3585-0.3624; the port's 0.4933, 8.79 and 0.3639.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schemes as jschemes
from repro.core import sparsify as jsparsify
from repro.data import synthetic as jdata
from repro.experiments import cnn as jcnn
from repro.experiments import conflicts as jconf
from repro.experiments import convex as jconvex
from repro.optim import optimizers as jopt
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.grouping import plan_tree
from repro_torch.data import synthetic as tdata
from repro_torch.experiments import cnn as tcnn
from repro_torch.experiments import conflicts as tconf
from repro_torch.experiments import convex as tconvex
from repro_torch.models.convert import cnn_params_from_jax
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = D = 256
LAM2 = 1.0 / N
M, B = 4, 8
NEAR = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _logreg(seed=0):
    return jdata.logreg_data(seed, n=N, d=D), tdata.logreg_data(
        seed, n=N, d=D, device="cpu")


# --- data, losses, gradients -------------------------------------------------

@pytest.mark.parametrize("which,kw", [
    ("logreg_data", dict(n=N, d=D)), ("logreg_data", dict(n=64, d=32, c1=0.9,
                                                          c2=1 / 64)),
    ("svm_data", dict(n=512, d=D)), ("image_data", dict(n=16))])
def test_data_is_bit_equal(which, kw):
    want = getattr(jdata, which)(3, **kw)
    got = getattr(tdata, which)(3, device="cpu", **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_token_stream_yields_token_batches():
    gen = torch.Generator().manual_seed(0)
    stream = tdata.token_stream(gen, 64, 2, 8)
    a, b = next(stream), next(stream)
    assert a["tokens"].shape == (2, 8) and not torch.equal(a["tokens"],
                                                           b["tokens"])


@pytest.mark.parametrize("kind", ["logreg", "svm"])
def test_losses_and_gradients_match_jax(kind):
    (jx, jy, _), (tx, ty, _) = _logreg() if kind == "logreg" else (
        jdata.svm_data(1, n=N, d=D),
        tdata.svm_data(1, n=N, d=D, device="cpu"))
    jloss, tloss, tgrad = ((jconvex.logreg_loss, tconvex.logreg_loss,
                            tconvex.logreg_grad) if kind == "logreg" else
                           (jconf.svm_loss, tconf.svm_loss, tconf.svm_grad))
    w = np.random.default_rng(1).standard_normal(D).astype(np.float32) * 0.1
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(w), jx, jy, LAM2)
    np.testing.assert_allclose(float(tloss(_t(w), tx, ty, LAM2)), float(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(tgrad(_t(w), tx, ty, LAM2).numpy(),
                               np.asarray(jg), rtol=1e-5, atol=1e-7)
    # per-worker minibatch gradients, one per index row
    idx = np.random.default_rng(2).integers(0, N, (M, B))
    want = jax.vmap(lambda ix: jax.grad(jloss)(jnp.asarray(w), jx[ix],
                                               jy[ix], LAM2))(idx)
    got = tgrad(_t(w), tx[_t(idx)], ty[_t(idx)], LAM2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@functools.lru_cache(maxsize=None)
def _f_star():
    (jx, jy, _), (tx, ty, _) = _logreg()
    return jconvex.solve_reference(jx, jy, LAM2)[1], \
        tconvex.solve_reference(tx, ty, LAM2)[1]


def test_solve_reference_f_star_matches_jax():
    want, got = _f_star()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --- one step of each experiment against a JAX step ------------------------

def _jax_rows(scheme, g, u, u_cod):
    """JAX's zoo compressor on each row of ``g`` with the given uniforms
    (``Scheme.apply_dense`` and ``message_bits`` with the draws replaced):
    (q, p, bits) per row."""
    sel, codec = scheme.selector, scheme.codec
    qs, ps, bits = [], [], []
    for r in range(g.shape[0]):
        gr = g[r]
        p = sel.probabilities(gr)
        v = (jsparsify.apply_mask(gr, p, (jnp.asarray(u[r]) < p).astype(
            p.dtype)) if sel.name != "identity" else gr)
        if codec.rounds_values or codec.integer_coded:
            scale = codec.scale(v)
            wire = codec.encode(v, scale, jnp.asarray(u_cod[r])
                                if codec.stochastic else None)
            q = codec.decode(wire, scale).astype(gr.dtype)
        else:
            q = v.astype(gr.dtype)
        qs.append(q)
        ps.append(p)
        bits.append(scheme.message_bits(q, p, gr.size))
    return jnp.stack(qs), np.asarray(jnp.stack(ps)), jnp.stack(bits)


def _jscheme(method, rho):
    return {"gspar": lambda: jschemes.make_scheme("gspar", rho=rho),
            "unisp": lambda: jschemes.make_scheme("unisp", rho=rho),
            "qsgd": lambda: jschemes.make_scheme("qsgd", qsgd_bits=4),
            "dense": lambda: jschemes.make_scheme("none")}[method]()


def _step_inputs(seed, d=D, workers=M, batch=B, n=N):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, (workers, batch)),
            rng.random((workers, d), dtype=np.float32),
            rng.random((workers, d), dtype=np.float32))


def _near(p, u):
    return (np.abs(u - p) < NEAR).any(0)


@pytest.mark.parametrize("method", ["gspar", "unisp", "qsgd", "dense"])
def test_sgd_step_matches_jax(method):
    (jx, jy, _), (tx, ty, _) = _logreg()
    rho, lr0, t = 0.05, 0.5, 3
    idx, u, u_cod = _step_inputs(5)
    w = np.random.default_rng(6).standard_normal(D).astype(np.float32) * 0.1
    vn, vd = np.float32(40.0), np.float32(3.0)
    adaptive = method in ("gspar", "unisp")
    # the JAX step (repro.experiments.convex.run_sgd's), uniforms given
    grads = jconvex._worker_grads(jnp.asarray(w), jx, jy, LAM2, idx)
    q, p, bits = _jax_rows(_jscheme(method, rho), grads, u, u_cod)
    jvn = vn + jnp.sum(jnp.sum(q ** 2, axis=-1))
    jvd = vd + jnp.sum(jnp.sum(grads ** 2, axis=-1))
    var = jnp.maximum(jnp.where(jvd > 0, jvn / jvd, 1.0), 1.0)
    tf = jnp.float32(t)
    eta = lr0 / ((tf + 1.0) * var) if adaptive else lr0 / (tf + 1.0)
    want_w = np.asarray(jnp.asarray(w) - eta * jnp.mean(q, axis=0))
    # the port's
    step = tconvex.make_sgd_step(tx, ty, LAM2,
                                 tconvex._compressor(method, rho, 32),
                                 lr0=lr0, adaptive=adaptive)
    got_w, got_bits, got_vn, got_vd = step(
        _t(w), t, _t(vn), _t(vd), _t(idx), _t(u), _t(u_cod))
    keep = ~_near(p, u) if method in ("gspar", "unisp") else slice(None)
    np.testing.assert_allclose(got_w.numpy()[keep], want_w[keep], rtol=1e-5,
                               atol=1e-7)
    assert float(got_bits) == float(jnp.sum(bits))
    np.testing.assert_allclose([float(got_vn), float(got_vd)],
                               [float(jvn), float(jvd)], rtol=1e-5)
    if method in ("gspar", "unisp"):
        assert 0 < int((np.asarray(q) != 0).sum()) < q.size


@pytest.mark.parametrize("method", ["gspar", "dense"])
def test_svrg_step_matches_jax(method):
    (jx, jy, _), (tx, ty, _) = _logreg()
    rho, lr0 = 0.2, 0.2
    idx, u, _ = _step_inputs(7)
    rng = np.random.default_rng(8)
    w = rng.standard_normal(D).astype(np.float32) * 0.1
    w_ref = rng.standard_normal(D).astype(np.float32) * 0.1
    g_ref = np.asarray(jax.grad(jconvex.logreg_loss)(jnp.asarray(w_ref), jx,
                                                     jy, LAM2))
    vn, vd = np.float32(5.0), np.float32(4.0)
    # the JAX step (run_svrg's inner step), uniforms given
    g_w = jconvex._worker_grads(jnp.asarray(w), jx, jy, LAM2, idx)
    g_r = jconvex._worker_grads(jnp.asarray(w_ref), jx, jy, LAM2, idx)
    corr = g_w - g_r
    q, p, bits = _jax_rows(_jscheme(method, rho), corr, u, None)
    vr = jnp.mean(q, axis=0) + g_ref
    jvn = vn + jnp.sum(jnp.sum((q + g_ref) ** 2, axis=-1))
    jvd = vd + jnp.sum(jnp.sum((corr + g_ref) ** 2, axis=-1))
    var = jnp.maximum(jnp.where(jvd > 0, jvn / jvd, 1.0), 1.0)
    want_w = np.asarray(jnp.asarray(w) - (lr0 / var) * vr)
    # the port's, through SVRG(sgd(lr0))
    svrg = topt.SVRG(topt.sgd(lr0))
    tw = _t(w)
    state = svrg.set_reference(svrg.init([tw]), [_t(w_ref)], [_t(g_ref)])
    step = tconvex.make_svrg_step(
        tx, ty, LAM2, tconvex._compressor(
            method if method == "gspar" else "none", rho, 32), svrg)
    got_w, state, got_bits, got_vn, got_vd = step(tw, state, _t(vn), _t(vd),
                                                  _t(idx), _t(u))
    assert got_w is tw and state["opt"]["step"] == 1
    keep = ~_near(p, u) if method == "gspar" else slice(None)
    np.testing.assert_allclose(got_w.numpy()[keep], want_w[keep], rtol=1e-5,
                               atol=1e-7)
    assert float(got_bits) == float(jnp.sum(bits))
    np.testing.assert_allclose([float(got_vn), float(got_vd)],
                               [float(jvn), float(jvd)], rtol=1e-5)


@pytest.mark.parametrize("method", ["gspar", "none"])
def test_svm_step_matches_jax(method):
    jx, jy, _ = jdata.svm_data(0, n=N, d=D)
    tx, ty, _ = tdata.svm_data(0, n=N, d=D, device="cpu")
    rho, lr0, reg, pen, t, workers = 0.1, 0.5, 0.1, 4.0, 2, 16
    idx, u, _ = _step_inputs(9, workers=workers, batch=32)
    w = np.random.default_rng(10).standard_normal(D).astype(np.float32) * 0.1
    g = jax.vmap(lambda ix: jax.grad(jconf.svm_loss)(
        jnp.asarray(w), jx[ix], jy[ix], reg))(idx)
    if method == "none":
        qs, masks, keep = g, jnp.ones_like(g), slice(None)
    else:
        p = jax.vmap(lambda r: jsparsify.greedy_probabilities(r, rho, 2))(g)
        qs = jsparsify.apply_mask(g, p, (jnp.asarray(u) < p).astype(p.dtype))
        masks = (jnp.abs(qs) > 0).astype(jnp.float32)
        keep = ~_near(np.asarray(p), u)
    hits = jnp.sum(masks, axis=0)
    writes = jnp.sum(hits)
    conflicted = jnp.sum(jnp.where(hits >= 2, hits, 0.0))
    want_w = np.asarray(jnp.asarray(w) - lr0 / (jnp.float32(t) + 1.0)
                        * jnp.mean(qs, axis=0))
    step = tconf.make_svm_step(tx, ty, reg, method=("dense" if method ==
                                                     "none" else method),
                               rho=rho, lr0=lr0, conflict_penalty=pen)
    got_w, cost, rate = step(_t(w), t, _t(idx), _t(u))
    np.testing.assert_allclose(got_w.numpy()[keep], want_w[keep], rtol=1e-5,
                               atol=1e-7)
    assert float(cost) == float(writes + pen * conflicted)
    assert float(rate) == float(conflicted / jnp.maximum(writes, 1.0))


@functools.lru_cache(maxsize=None)
def _cnn_setup(channels=4, n=32):
    jparams = jax.jit(jcnn.init_cnn, static_argnums=1)(jax.random.key(0),
                                                        channels)
    jx, jy = jdata.image_data(1, n=n)
    tx, ty = tdata.image_data(1, n=n, device="cpu")
    return jparams, jx, jy, tx, ty


def test_cnn_forward_loss_and_gradients_match_jax():
    jparams, jx, jy, tx, ty = _cnn_setup()
    params = cnn_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert list(params) == sorted(params)
    for name, leaf in zip(params, jax.tree.leaves(jparams)):
        assert tuple(params[name].shape) == leaf.shape
    np.testing.assert_allclose(tcnn.cnn_forward(params, tx).numpy(),
                               np.asarray(jcnn.cnn_forward(jparams, jx)),
                               rtol=1e-4, atol=1e-5)
    jl, jg = jax.jit(jax.value_and_grad(jcnn.cnn_loss))(jparams, jx, jy)
    live = {k: v.requires_grad_() for k, v in params.items()}
    tl = tcnn.cnn_loss(live, tx, ty)
    tg = torch.autograd.grad(tl, list(live.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for name, got, want in zip(params, tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("method", ["gspar", "dense"])
def test_cnn_step_matches_jax(method):
    """One ``run_cnn`` step: each worker's gradient, compressed (gspar:
    every leaf with min_leaf_size 0, the uniforms re-drawn from an
    identically seeded generator in the port's group order; dense: the
    passthrough), averaged, then Adam."""
    jparams, jx, jy, tx, ty = _cnn_setup()
    rho, lr, seed = 0.1, 0.02, 12
    idx = np.random.default_rng(11).integers(0, jx.shape[0], (M, 4))
    comp = TConfig(name="none" if method == "dense" else method, rho=rho,
                   min_leaf_size=0 if method != "dense" else 1 << 30)
    grads = jax.jit(jax.vmap(lambda ix: jax.grad(jcnn.cnn_loss)(
        jparams, jx[ix], jy[ix])))(idx)
    leaves, tdef = jax.tree_util.tree_flatten(grads)
    q = [np.array(g) for g in leaves]
    near = [np.zeros(g.shape[1:], bool) for g in leaves]
    if method == "gspar":
        plan = plan_tree(comp, [torch.empty(g.shape, device="meta")
                                for g in leaves], [True] * len(leaves))
        gen = torch.Generator().manual_seed(seed)
        probs = jax.jit(jax.vmap(lambda r: jsparsify.greedy_probabilities(
            r, rho)))
        for grp in plan.groups:
            u = torch.rand((grp.rows, grp.d), generator=gen).numpy()
            r0 = 0
            for i, rows in grp.members:
                g = np.asarray(leaves[i]).reshape(rows, -1)
                p = np.asarray(probs(jnp.asarray(g)))
                uu = u[r0:r0 + rows]
                # apply_mask's float32 Z g / p (0/0 = 0)
                scaled = np.where(p > 0, g / np.where(p > 0, p, 1), 0)
                q[i] = ((uu < p) * scaled).astype(np.float32).reshape(
                    q[i].shape)
                near[i] = (np.abs(uu - p) < NEAR).any(0).reshape(
                    near[i].shape)
                r0 += rows
    avg = jax.tree_util.tree_unflatten(
        tdef, [jnp.mean(jnp.asarray(x), axis=0) for x in q])
    jo = jopt.adam(lr)
    want, jstate = jo.update(avg, jo.init(jparams), jparams)
    # the port's
    params = cnn_params_from_jax(jax.tree.map(np.asarray, jparams))
    opt = topt.adam(lr)
    state = opt.init(list(params.values()))
    step = tcnn.make_cnn_step(tx, ty, comp, opt)
    state, bits, density = step(params, state, _t(idx),
                                torch.Generator().manual_seed(seed))
    assert state["step"] == 1
    assert (0 < float(density) <= 1.5 * rho) if method == "gspar" \
        else float(density) > 0.3
    top = max(float(jnp.abs(x).max()) for x in jax.tree.leaves(jstate["m"]))
    for name, m, wm, p, wp, ex in zip(
            params, state["m"], jax.tree.leaves(jstate["m"]), params.values(),
            jax.tree.leaves(want), near):
        wm, wp = np.asarray(wm), np.asarray(wp)
        big = (np.abs(wm) > 1e-4 * top) & ~ex
        np.testing.assert_allclose(m.numpy()[~ex], wm[~ex], rtol=1e-4,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(p.numpy()[big], wp[big], rtol=0,
                                   atol=1e-6, err_msg=name)


# --- the conflict model ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _conflict_grad():
    """The benchmark's representative SVM gradient, in numpy."""
    x, y, _ = jdata.svm_data(3, n=4096, d=256)
    return (np.asarray(x[:64]).T @ np.asarray(y[:64])) / 64.0


@pytest.mark.parametrize("rho", [0.05, 0.2])
def test_conflict_stats_analytic_matches_jax_and_the_committed_rows(rho):
    g = _conflict_grad()
    jp = jsparsify.greedy_probabilities(jnp.asarray(g), rho, num_iters=4)
    tp = tconf.sparsify.greedy_probabilities(_t(g), rho, num_iters=4)
    with open(os.path.join(REPO, "results", "experiments",
                           "conflicts.json")) as f:
        rows = json.load(f)
    for workers in (16, 32):
        want = jconf.conflict_stats(jp, workers, trials=16)
        got = tconf.conflict_stats(tp, workers)
        committed = rows[f"conflicts_rho{rho}_w{workers}"]["gspar"]
        for key in ("writes_analytic", "conflicted_analytic"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
            np.testing.assert_allclose(got[key], committed[key], rtol=1e-5)
        for mc, an, se in (("writes", "writes_analytic", "writes_se"),
                           ("conflicted_mc", "conflicted_analytic",
                            "conflicted_se")):
            assert abs(got[mc] - got[an]) <= 6 * got[se]
        dense = tconf.conflict_stats(torch.ones(256), workers, trials=8)
        assert dense["conflicted_mc"] == dense["conflicted_analytic"] \
            == 256 * workers


def test_backend_parity_on_the_plain_path():
    """The kernels' lambda (their plain versions on the CPU) against the
    pure solver: p within 1e-6; and pass 1 (``select_stats``, its plain
    version) under that lambda and the Monte Carlo windows' uniforms keeps
    exactly the kernel side's Monte Carlo writes."""
    from repro_torch.kernels.sparsify import kernel as K, ops
    g = _t(_conflict_grad())
    out = tconf.backend_parity(g, 0.05, 32, trials=64)
    assert out["p_maxdiff"] <= 1e-6
    np.testing.assert_allclose(out["kernel"]["conflicted_analytic"],
                               out["reference"]["conflicted_analytic"],
                               rtol=1e-5)
    lam = ops.gspar_lambda(g, rho=0.05, num_iters=4)
    rows, d = 64 * 32, g.shape[0]
    u = tconf._mc_uniforms((64, 32, d), 0, g.device).reshape(rows, d)
    st = K.select_stats(g.reshape(1, d).expand(rows, d).contiguous(), u,
                        lam.reshape(1).expand(rows).contiguous(), d,
                        pkind="lam")
    assert float(st.nnz.sum()) / 64 == out["kernel"]["writes"]


# --- whole runs --------------------------------------------------------------

def test_paper_claims_at_a_small_size():
    """var(GSpar) < var(UniSp) at equal density in each data cell, GSpar's
    suboptimality falls, and the sparsified SVM conflicts less than the
    dense one."""
    for c1, c2 in ((0.6, 0.25), (0.9, 1.0 / 64)):
        x, y, _ = tdata.logreg_data(0, n=N, d=D, c1=c1, c2=c2, device="cpu")
        runs = {m: tconvex.run_sgd(x, y, LAM2, method=m, rho=0.05, epochs=2,
                                   device="cpu")
                for m in ("gspar", "unisp")}
        assert runs["gspar"].var_ratio < runs["unisp"].var_ratio
        assert runs["gspar"].subopt[-1] < runs["gspar"].subopt[0]
        assert runs["gspar"].bits[-1] < runs["unisp"].bits[-1]
    rates = {m: tconf.run_async_svm(method=m, workers=16, steps=20, n=1024,
                                    device="cpu")[2]
             for m in ("gspar", "dense")}
    assert rates["gspar"] < rates["dense"] == 1.0


def test_run_cnn_trains_on_the_cpu():
    losses, bits, density = tcnn.run_cnn(method="gspar", rho=0.1, channels=4,
                                         steps=12, n_data=128,
                                         record_every=4, device="cpu")
    assert losses.shape == bits.shape == (4,)
    assert losses[-1] < losses[0] and np.all(np.diff(bits) > 0)
    assert 0.0 < density <= 0.15


@functools.lru_cache(maxsize=None)
def _jax_band():
    (jx, jy, _), _ = _logreg()
    f = _f_star()[0]
    sgd = [jconvex.run_sgd(jx, jy, LAM2, method="gspar", rho=0.05, epochs=4,
                           f_star=f, seed=s) for s in range(3)]
    svrg = [jconvex.run_svrg(jx, jy, LAM2, method="gspar", rho=0.2, outer=2,
                             f_star=f, seed=s) for s in range(3)]
    return ([r.subopt[-1] for r in sgd], [r.var_ratio for r in sgd],
            [r.subopt[-1] for r in svrg])


def _in_band(x, runs):
    lo, hi = min(runs), max(runs)
    return lo - 3 * (hi - lo) <= x <= hi + 3 * (hi - lo)


def test_whole_runs_lie_in_the_jax_band():
    sgd_sub, sgd_var, svrg_sub = _jax_band()
    _, (tx, ty, _) = _logreg()
    f = _f_star()[1]
    r = tconvex.run_sgd(tx, ty, LAM2, method="gspar", rho=0.05, epochs=4,
                        f_star=f, seed=0, device="cpu")
    assert _in_band(r.subopt[-1], sgd_sub), (r.subopt[-1], sgd_sub)
    assert _in_band(r.var_ratio, sgd_var), (r.var_ratio, sgd_var)
    assert len(r.passes) == len(r.subopt) == len(r.bits)
    s = tconvex.run_svrg(tx, ty, LAM2, method="gspar", rho=0.2, outer=2,
                         f_star=f, seed=0, device="cpu")
    assert _in_band(s.subopt[-1], svrg_sub), (s.subopt[-1], svrg_sub)


@pytest.mark.parametrize("call", [
    lambda: tconvex.run_sgd(torch.zeros(8, 4), torch.ones(8), 0.1),
    lambda: tconvex.run_svrg(torch.zeros(8, 4), torch.ones(8), 0.1),
    lambda: tcnn.run_cnn(steps=1, n_data=8),
    lambda: tconf.run_async_svm(steps=1, n=64),
    lambda: tdata.logreg_data(0, n=8, d=4),
    lambda: tdata.svm_data(0, n=8, d=4),
    lambda: tdata.image_data(0, n=2)])
def test_experiments_run_on_the_card_unless_asked(call):
    if torch.cuda.is_available():
        assert tconvex.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
