"""The port's optimizers against the JAX package's (``repro.optim.
optimizers``) on the same numpy inputs: ``sgd`` and ``adam`` with a float
and a 0-d float32 ``var_scale``, with and without momentum, with a float
and a callable lr; ``rescale_feedback``; ``SVRG``; ``init_control`` and
``make_optimizer``.

Tolerance: bit-equal for float32 leaves (the JAX functions run eagerly, one
op at a time, as the port does). A bfloat16 leaf under SGD with a float32
step size (a ``var_scale`` tensor or a callable lr) is promoted to float32
by JAX; the port keeps bfloat16 and must equal JAX's float32 result rounded
once to bfloat16, bit for bit."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

LR = 3e-4
# the schedule's values, float32: both packages read the same numbers
TABLE = np.array([0.0, 1e-4, 2e-4, 3e-4, 3e-4], np.float32)
# float32 variance ratios in [1, 4), one a step, where PyTorch's ``LR / t``
# (a product with the reciprocal) is not the IEEE quotient ``full_like(t,
# LR) / t``
VARS = np.array([2.8199074, 3.8052173, 3.1889663], np.float32)


def _jsched(step):
    return jnp.asarray(TABLE)[step]


def _tsched(step):
    return float(TABLE[step])


def _leaves(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype)
            for s in ((4, 64), (3, 128), (32,))]


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_the_var_scale_inputs_tell_the_quotients_apart():
    for v in VARS:
        t = torch.tensor(v)
        assert not torch.equal(LR / t, torch.full_like(t, LR) / t)
        assert (torch.full_like(t, LR) / t).item() == np.float32(LR) / v


def _run(name, momentum, lr_kind, vs_kind, dtype, steps):
    """``steps`` updates in both packages; returns (port, JAX) leaves."""
    mk = {"sgd": lambda lr: dict(momentum=momentum), "adam": lambda lr: {}}
    jlr, tlr = (_jsched, _tsched) if lr_kind == "callable" else (LR, LR)
    jo = getattr(jopt, name)(jlr, **mk[name](jlr))
    to = getattr(topt, name)(tlr, **mk[name](tlr))
    params = _leaves(0, dtype)
    jp = [jnp.asarray(p) for p in params]
    tp = [_t(p) for p in params]
    js, ts = jo.init(jp), to.init(tp)
    for k in range(steps):
        g = _leaves(10 + k, dtype)
        if vs_kind == "tensor":
            jvs, tvs = jnp.float32(VARS[k]), torch.tensor(VARS[k])
        else:
            jvs = tvs = 1.0 if vs_kind == "one" else float(VARS[k])
        jp, js = jo.update([jnp.asarray(x) for x in g], js, jp,
                           var_scale=jvs)
        tp, ts = to.update([_t(x) for x in g], ts, tp, var_scale=tvs)
    return tp, jp


@pytest.mark.parametrize("vs_kind", ["one", "float", "tensor"])
@pytest.mark.parametrize("lr_kind", ["float", "callable"])
@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9),
                                           ("adam", 0.0)])
def test_float32_updates_are_bit_equal_to_jax(name, momentum, lr_kind,
                                              vs_kind):
    tp, jp = _run(name, momentum, lr_kind, vs_kind, np.float32, steps=3)
    for a, b in zip(tp, jp):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("vs_kind", ["one", "float", "tensor"])
@pytest.mark.parametrize("lr_kind", ["float", "callable"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_bf16_sgd_rounds_the_jax_float32_result_once(momentum, lr_kind,
                                                     vs_kind):
    """JAX's float32 promotion happens exactly where its step size is a
    float32 array (a tensor var_scale or a callable lr); the port keeps the
    leaf bfloat16 with JAX's value rounded once. With a float step size
    both packages stay bfloat16 and agree bit for bit."""
    tp, jp = _run("sgd", momentum, lr_kind, vs_kind, ml_dtypes.bfloat16,
                  steps=1)
    promoted = lr_kind == "callable" or vs_kind == "tensor"
    for a, b in zip(tp, jp):
        assert a.dtype == torch.bfloat16
        assert np.asarray(b).dtype == (np.float32 if promoted
                                       else ml_dtypes.bfloat16)
        np.testing.assert_array_equal(
            _np(a).view(np.uint16),
            np.asarray(b).astype(ml_dtypes.bfloat16).view(np.uint16))


def test_bf16_sgd_differs_from_rounding_eta_times_g_first():
    """The port's bfloat16 update is ``round(p - eta g)`` in float32, not
    ``p - round(eta g)``, which rounds twice and, at a step size where
    ``eta g`` is not negligible beside p, gives other bits."""
    p0 = [_t(p) for p in _leaves(0, ml_dtypes.bfloat16)]
    g = [_t(x) for x in _leaves(10, ml_dtypes.bfloat16)]
    vs = torch.tensor(VARS[0])
    p = [t.clone() for t in p0]
    opt = topt.sgd(0.3)
    opt.update(g, opt.init(p), p, var_scale=vs)
    eta = torch.full((), 0.3) / vs
    once = [(a.float() - eta * b.float()).to(torch.bfloat16)
            for a, b in zip(p0, g)]
    twice = [a - (eta * b.float()).to(torch.bfloat16) for a, b in zip(p0, g)]
    assert all(torch.equal(a, b) for a, b in zip(p, once))
    assert any(not torch.equal(a, b) for a, b in zip(p, twice))


def _fb_pair(seed, pod: bool, dtype=np.float32):
    res = _leaves(seed, dtype)
    podr = _leaves(seed + 1, dtype) if pod else None
    jfb = jopt.FeedbackState(residual=[jnp.asarray(r) for r in res],
                             pod_residual=(None if podr is None else
                                           [jnp.asarray(r) for r in podr]))
    tfb = topt.FeedbackState(residual=[_t(r) for r in res],
                             pod_residual=(None if podr is None else
                                           [_t(r) for r in podr]))
    return tfb, jfb


def _leaves_of(fb):
    return list(fb.residual) + list(fb.pod_residual or [])


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("pod", [False, True])
@pytest.mark.parametrize("prev,now", [(3e-4, 3e-4), (0.2, 0.1), (0.1, 0.0),
                                      (1e-4, 2e-4), (2e-4, 3e-4)])
def test_rescale_feedback_is_bit_equal_to_jax(prev, now, pod, dtype):
    """The constant schedule's bit-exact no-op, the x2 rescale, the zero-lr
    guard and the warmup's 0.5 and 2/3, on the residual and the pod
    residual, in place."""
    tfb, jfb = _fb_pair(21, pod, dtype)
    before = [t.clone() for t in _leaves_of(tfb)]
    out = topt.rescale_feedback(tfb, prev, now)
    want = jopt.rescale_feedback(jfb, prev, now)
    assert out is tfb and (out.pod_residual is None) == (not pod)
    for a, b, c in zip(_leaves_of(out), _leaves_of(want), before):
        np.testing.assert_array_equal(_np(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
        if prev == now or now == 0.0:
            assert torch.equal(a, c)
    if (prev, now) == (0.2, 0.1):
        for a, c in zip(_leaves_of(out), before):
            assert torch.equal(a, (c.float() * 2.0).to(c.dtype))


def test_rescale_feedback_takes_tensor_rates():
    tfb, jfb = _fb_pair(23, False)
    topt.rescale_feedback(tfb, torch.tensor(np.float32(1e-4)),
                          torch.tensor(np.float32(3e-4)))
    want = jopt.rescale_feedback(jfb, np.float32(1e-4), np.float32(3e-4))
    for a, b in zip(tfb.residual, want.residual):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_svrg_on_the_quadratic_is_bit_equal_to_jax():
    """The control variate of ``tests/test_substrate.py``'s SVRG test over
    20 steps, with a tensor var_scale, from a random start."""
    w0 = np.random.default_rng(4).standard_normal(4).astype(np.float32)
    jsv, tsv = jopt.SVRG(jopt.sgd(0.05)), topt.SVRG(topt.sgd(0.05))
    jw = {"w": jnp.asarray(w0)}
    tw = [_t(w0)]
    jq = jax.grad(lambda p: jnp.sum((p["w"] - 3.0) ** 2))
    tq = grad(lambda w: torch.sum((w - 3.0) ** 2))
    js, ts = jsv.init(jw), tsv.init(tw)
    js = jsv.set_reference(js, jw, jq(jw))
    ts = tsv.set_reference(ts, tw, [tq(tw[0])])
    for k in range(20):
        jc = jsv.correct(js, jq(jw), jq(js["ref_params"]))
        tc = tsv.correct(ts, [tq(tw[0])], [tq(ts["ref_params"][0])])
        jvr = jax.tree.map(lambda a, b: a + b, jc, js["ref_grad"])
        tvr = [tc[0] + ts["ref_grad"][0]]
        vs = np.float32(1.0 + 0.1 * k)
        jw, js = jsv.update(jvr, js, jw, var_scale=jnp.float32(vs))
        tw, ts = tsv.update(tvr, ts, tw, var_scale=torch.tensor(vs))
        np.testing.assert_array_equal(tw[0].numpy(), np.asarray(jw["w"]))
        if k == 9:      # a new reference point mid-run
            js = jsv.set_reference(js, jw, jq(jw))
            ts = tsv.set_reference(ts, tw, [tq(tw[0])])
    assert ts["opt"]["step"] == 20 and int(js["opt"]["step"]) == 20
    assert not torch.equal(ts["ref_params"][0], tw[0])


def test_init_control_shapes_and_dtypes():
    params = [torch.zeros(4, 8), torch.zeros(3, dtype=torch.bfloat16)]
    ctl = topt.init_control(params)
    jctl = jopt.init_control([jnp.zeros((4, 8)),
                              jnp.zeros(3, jnp.bfloat16)], num_workers=1)
    # the port holds one worker's state: JAX's leading worker axis drops
    pairs = ([(a, b.shape[1:], b.dtype) for a, b in zip(
        ctl.last_sent, jax.tree.leaves(jctl.last_sent))]
        + [(a, b.shape, b.dtype) for a, b in zip(
            ctl.last_avg, jax.tree.leaves(jctl.last_avg))])
    for got, shape, dtype in pairs:
        assert tuple(got.shape) == tuple(shape)
        assert str(got.dtype).removeprefix("torch.") == str(dtype)
        assert not got.any()
    assert [b.shape for b in ctl.bound] == [()] * 2
    assert all(b.dtype == torch.float32 for b in ctl.bound)
    assert ctl.step == 0 and int(jctl.step) == 0


def test_make_optimizer_names_and_errors():
    assert set(topt.OPTIMIZERS) == set(jopt.OPTIMIZERS)
    for name in topt.OPTIMIZERS:
        opt = topt.make_optimizer(name, 0.1)
        assert opt.init([torch.zeros(2)])["step"] == 0
    p = [torch.ones(3)]
    opt = topt.make_optimizer("sgd", 0.5, momentum=0.9)
    opt.update([torch.ones(3)], opt.init(p), p)
    assert torch.allclose(p[0], torch.full((3,), 0.5))
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion", 0.1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        jopt.make_optimizer("lion", 0.1)
