"""The slice as a whole: one compressed train step of the port (Algorithm 1
with Algorithm 3 on the gather wire, COO and the default ``auto`` layout,
error feedback, Adam, one gloo worker) against a JAX step assembled from
the JAX package's own pieces —
``make_loss_fn``, ``ops.gspar_emit`` in interpret mode fed the port's
uniforms (re-drawn from an identically seeded generator), the scatter
decode and ``adam`` — on the gemma-2b smoke config in float32.

Tolerance: new parameters and the EF residual agree to atol 1e-6 (rtol
1e-5 for the residual), except at coordinates whose uniform lies within
1e-5 of its keep probability, where the float32 gradient's last-digit
differences between the frameworks may flip the draw (at most 0.1% of
them). Also: the launcher on the CPU, the import boundary, and the
configuration's refusals of what is not ported."""
import functools
import gc
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.comm import wire_layout as jwire_layout
from repro.configs import gemma_2b as jgemma
from repro.core import coding as jcoding
from repro.core.api import CompressionConfig as JConfig
from repro.core.grouping import plan_tree as jplan_tree
from repro.kernels.sparsify import ops as jops
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.grouping import plan_tree
from repro_torch.devices import resolve_device
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.common import leaf_order
from repro_torch.models.transformer import Transformer, param_shapes
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

# small inputs: one intra-op thread keeps the parallel test run from
# oversubscribing the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RHO, LR, SEED, MIN_LEAF = 0.05, 1e-3, 11, 1024


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


def _jax_step(params, tokens, stacked, gen=None, residual=None, opt=None,
              opt_state=None, var_adaptive=False):
    """One Algorithm-1 step at one worker from the JAX package's pieces:
    with ``residual`` (after any rescale) the EF target is ``g +
    residual``; with ``var_adaptive`` the optimizer's step size is divided
    by ``max(var, 1)``, var the size-weighted mean of the rows' ``sum
    values^2 / sum target^2`` (1 for a nonzero dense-passthrough leaf), as
    ``sync_tree`` accounts it. Returns (new params leaves, new residual
    leaves, exempt masks), and with ``opt`` also the new params tree and
    optimizer state."""
    grads = jax.jit(jax.grad(jstep.make_loss_fn(jgemma.SMOKE)))(
        params, {"tokens": jnp.asarray(tokens)})
    leaves, tdef = jax.tree_util.tree_flatten(grads)
    leaves = [np.asarray(g) for g in leaves]
    if residual is not None:
        leaves = [g + r for g, r in zip(leaves, residual)]
    plan = jplan_tree(JConfig(name="gspar", rho=RHO, wire="gather",
                              min_leaf_size=MIN_LEAF), leaves, stacked)
    gen = gen or torch.Generator().manual_seed(SEED)
    synced, res, exempt = ([None] * len(leaves) for _ in range(3))
    wvar = 0.0
    for grp in plan.groups:
        if grp.kind == "dense":       # float32 passthrough, zero residual
            for i, n in grp.members:
                synced[i] = leaves[i]
                res[i] = np.zeros_like(leaves[i])
                exempt[i] = np.zeros(leaves[i].shape, bool)
                wvar += float(np.sum(leaves[i] ** 2) > 0) * n
            continue
        stack = np.concatenate([leaves[i].reshape(rows, grp.d)
                                for i, rows in grp.members])
        u = torch.rand((grp.rows, grp.d), generator=gen,
                       dtype=torch.float32).numpy()
        er, lam = jax.vmap(functools.partial(
            jops.gspar_emit, u_cod=None, k_cap=grp.k_cap, rho=RHO, ef=True,
            interpret=True))(jnp.asarray(stack), jnp.asarray(u))
        values = np.asarray(er.values, np.float64)
        wvar += float(np.sum((values ** 2).sum(-1) / np.asarray(
            er.den, np.float64))) * grp.d
        dense = np.zeros((grp.rows, grp.d), np.float32)
        for r in range(grp.rows):
            np.add.at(dense[r], np.asarray(er.idx[r]),
                      np.asarray(er.values[r], np.float32))
        p = np.minimum(np.asarray(lam)[:, None] * np.abs(stack), 1.0)
        near = np.abs(u - p) < 1e-5
        r0 = 0
        for i, rows in grp.members:
            shape = leaves[i].shape
            synced[i] = dense[r0:r0 + rows].reshape(shape)
            res[i] = np.asarray(er.residual[r0:r0 + rows]).reshape(shape)
            exempt[i] = near[r0:r0 + rows].reshape(shape)
            r0 += rows
    kw = {}
    if var_adaptive:
        var = wvar / sum(g.size for g in leaves)
        kw["var_scale"] = jnp.float32(max(var, 1.0))
    own = opt is None
    if own:
        opt = jopt.adam(LR)
        opt_state = opt.init(params)
    new, opt_state = opt.update(jax.tree_util.tree_unflatten(tdef, synced),
                                opt_state, params, **kw)
    out = ([np.asarray(x) for x in jax.tree.leaves(new)], res, exempt)
    return out if own else out + (new, opt_state)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """The smoke model's parameters and tokens, and the JAX step's new
    parameters, residual and exempt masks (the wire layout does not enter
    the JAX step: its decode is the scatter of the compact buffers)."""
    params = jax.jit(lambda k: split_params(
        jtf.init_model(k, jgemma.SMOKE))[0])(jax.random.key(3))
    tokens = np.random.default_rng(5).integers(0, jgemma.SMOKE.vocab, (4, 32))
    stacked = Transformer(tgemma.SMOKE, params_from_numpy(
        jax.tree.map(np.asarray, params))).stacked
    return (params, tokens) + _jax_step(params, tokens, stacked)


# the warmup of the scheduled steps, float32, read by both packages: the
# residual is rescaled by 0.5 before step 2
SCHED = np.array([0.0, 1e-4, 2e-4, 3e-4], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_scheduled_reference():
    """Two JAX steps with the variance-adaptive step size and the warmup
    schedule under EF (the residual rescaled by sched(1) / sched(2) before
    step 2), on two token batches, the uniforms drawn in group order from
    one generator: (tokens, new params, residual, exempt masks of either
    step, the step-2 rescale ratio)."""
    params = _jax_reference()[0]
    stacked = Transformer(tgemma.SMOKE, params_from_numpy(
        jax.tree.map(np.asarray, params))).stacked
    tokens = np.random.default_rng(6).integers(0, jgemma.SMOKE.vocab,
                                               (2, 4, 32))
    opt = jopt.adam(lambda s: jnp.asarray(SCHED)[s])
    state = opt.init(params)
    gen = torch.Generator().manual_seed(SEED)
    _, res, ex1, params, state = _jax_step(params, tokens[0], stacked, gen,
                                           opt=opt, opt_state=state,
                                           var_adaptive=True)
    res = jopt.rescale_feedback(jopt.FeedbackState(
        residual=[jnp.asarray(r) for r in res]), SCHED[1], SCHED[2]).residual
    want_p, want_r, ex2, _, _ = _jax_step(
        params, tokens[1], stacked, gen,
        residual=[np.asarray(r) for r in res], opt=opt, opt_state=state,
        var_adaptive=True)
    return tokens, want_p, want_r, [a | b for a, b in zip(ex1, ex2)]


def _check_step_against_jax(layout: str, scheduled: bool = False) -> None:
    """One step of the port against ``_jax_reference``; ``scheduled``: two
    steps with ``var_adaptive_lr=True`` and the warmup ``lr_schedule``
    under EF against ``_jax_scheduled_reference``, with the same
    tolerances (a coordinate exempt in either step is exempt)."""
    params, tokens, want_p, want_r, exempt = _jax_reference()
    model = Transformer(tgemma.SMOKE, params_from_numpy(
        jax.tree.map(np.asarray, params)))
    comp = TConfig(name="gspar", rho=RHO, error_feedback=True,
                   min_leaf_size=MIN_LEAF, wire="gather", wire_layout=layout)
    gen = torch.Generator().manual_seed(SEED)
    if scheduled:
        tokens, want_p, want_r, exempt = _jax_scheduled_reference()
        sched = lambda s: float(SCHED[s])          # noqa: E731
        opt = topt.adam(sched)
        step = tstep.make_compressed_train_step(
            model, comp, opt, var_adaptive_lr=True, lr_schedule=sched)
        state = opt.init(model.leaves())
        fb = topt.init_feedback(model.leaves())
        for batch in tokens:
            state, fb, metrics = step(
                state, fb, {"tokens": torch.from_numpy(batch)}, gen)
            assert float(metrics["var_ratio"]) > 1.0
        assert state["step"] == 2
    else:
        opt = topt.adam(LR)
        step = tstep.make_compressed_train_step(model, comp, opt)
        state, fb, metrics = step(opt.init(model.leaves()),
                                  topt.init_feedback(model.leaves()),
                                  {"tokens": torch.from_numpy(tokens)}, gen)
    n_exempt = sum(int(e.sum()) for e in exempt)
    assert n_exempt <= 1e-3 * sum(e.size for e in exempt)
    for name, p, r, wp, wr, ex in zip(model.leaf_names, model.leaves(),
                                      fb.residual, want_p, want_r, exempt):
        keep = ~ex
        np.testing.assert_allclose(p.detach().numpy()[keep], wp[keep],
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(r.numpy()[keep], wr[keep], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert 0.0 < float(metrics["density"]) <= 1.25 * RHO
    assert float(metrics["overflow"]) == 0.0


def test_compressed_step_matches_jax_step(one_worker_group):
    _check_step_against_jax("coo")


def test_compressed_step_on_the_auto_wire_matches_jax_step(one_worker_group):
    """The same step on the default wire (RICE on every smoke group): the
    Golomb-Rice exchange decodes to the same update as the COO wire."""
    _check_step_against_jax("auto")


@pytest.mark.parametrize("layout", ["coo", "auto"])
def test_var_adaptive_scheduled_steps_match_jax_steps(one_worker_group,
                                                      layout):
    """Two steps with ``var_adaptive_lr=True`` and a warmup ``lr_schedule``
    under error feedback: the step size is sched(t + 1) / max(var, 1) and
    the carried residual is rescaled by 0.5 before step 2, as in the JAX
    step."""
    _check_step_against_jax(layout, scheduled=True)


RANK = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.configs import gemma_2b
from repro_torch.core.api import CompressionConfig
from repro_torch.data.synthetic import token_batch
from repro_torch.models.transformer import Transformer, init_model
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
seen = []
real = tstep._var_scale
def spy(v, group):
    got = real(v, group)
    seen.append((v.clone(), got.clone()))
    return got
tstep._var_scale = spy
cfg = gemma_2b.SMOKE
model = Transformer(cfg, init_model(cfg, torch.Generator().manual_seed(0),
                                    "cpu"))
sched = lambda s: 3e-4 * min(s, 3) / 3
opt = topt.sgd(sched, momentum=0.9)
comp = CompressionConfig(name="gspar", rho=0.05, error_feedback=True,
                         min_leaf_size=1024)
step = tstep.make_compressed_train_step(model, comp, opt,
                                        var_adaptive_lr=True,
                                        lr_schedule=sched)
state, fb = opt.init(model.leaves()), topt.init_feedback(model.leaves())
data = torch.Generator().manual_seed(10 + rank)
comp_gen = torch.Generator().manual_seed(20 + rank)
for _ in range(3):
    state, fb, m = step(state, fb, token_batch(data, cfg.vocab, 2, 32),
                        comp_gen)
torch.save({"params": [p.detach() for p in model.leaves()], "seen": seen,
            "residual": fb.residual}, out)
dist.destroy_process_group()
"""


def test_var_adaptive_replicas_stay_bit_equal_on_two_gloo_ranks(tmp_path):
    """Two workers with different data and uniforms, three scheduled
    variance-adaptive SGD steps with momentum and EF: both apply the same
    step size, max of the float32 mean of the two ratios and 1 (summed in
    worker order, as the JAX step's pmean over the data axis), so their
    parameters stay bit-equal while their residuals differ."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(port), outs[r]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    a, b = (torch.load(o, weights_only=False) for o in outs)
    for pa, pb in zip(a["params"], b["params"]):
        assert torch.equal(pa, pb)
    assert any(not torch.equal(ra, rb)
               for ra, rb in zip(a["residual"], b["residual"]))
    assert len(a["seen"]) == len(b["seen"]) == 3
    for (va, sa), (vb, sb) in zip(a["seen"], b["seen"]):
        assert not torch.equal(va, vb)
        want = np.maximum((va.numpy() + vb.numpy()) / np.float32(2), 1.0)
        assert sa.dtype == torch.float32 and torch.equal(sa, sb)
        assert sa.item() == want and sa.item() > 1.0


@pytest.mark.parametrize("ef", [False, True])
def test_launcher_trains_on_cpu(ef):
    """The launcher end to end on the CPU path: finite losses, the COO
    gather wire's bytes, no overflow; it starts and stops its own group."""
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "2", "--device",
            "cpu", "--rho", str(RHO), "--log-every", "1", "--wire", "gather",
            "--wire-layout", "coo"]
    summary = tlaunch.main(argv + (["--error-feedback"] if ef else []))
    assert not dist.is_initialized()
    shapes = param_shapes(tgemma.SMOKE)
    names = leaf_order(shapes)
    plan = plan_tree(TConfig(rho=RHO, min_leaf_size=MIN_LEAF,
                             wire="gather"),
                     [torch.empty(shapes[n][0], device="meta") for n in names],
                     [shapes[n][1] for n in names])
    wire = sum(g.rows * g.k_cap * (4 + 4) if g.kind == "sparse"
               else g.d * 4 for g in plan.groups)
    for m in summary["metrics"]:
        assert np.isfinite(m["loss"])
        assert m["overflow"] == 0.0
        assert 0.0 < m["density"] <= 1.25 * RHO
        assert m["wire_bytes"] == wire
    assert summary["params"] == sum(
        int(np.prod(s)) for s, _ in shapes.values())


def test_launcher_defaults_to_the_auto_wire(capsys):
    """With the default ``--wire-layout auto`` the launcher stamps and prints
    each smoke group's layout as the JAX chooser picks it (rice on all
    three), and charges the values, the counts vector and the realized
    Golomb-Rice words: between the values alone and the static capacity."""
    summary = tlaunch.main(["--arch", "gemma-2b", "--smoke", "--steps", "2",
                            "--device", "cpu", "--rho", str(RHO),
                            "--wire", "gather", "--error-feedback"])
    out = capsys.readouterr().out
    jcfg = JConfig(name="gspar", rho=RHO, wire="gather",
                   min_leaf_size=MIN_LEAF)
    shapes = param_shapes(tgemma.SMOKE)
    names = leaf_order(shapes)
    plan = plan_tree(TConfig(rho=RHO, min_leaf_size=MIN_LEAF,
                             wire="gather"),
                     [torch.empty(shapes[n][0], device="meta") for n in names],
                     [shapes[n][1] for n in names])
    sparse = [g for g in plan.groups if g.kind == "sparse"]
    want = [(g.rows, g.d, g.k_cap,
             jwire_layout.choose(g.k_cap, g.d, 32.0, jcfg.wire_layout))
            for g in sparse]
    assert summary["layouts"] == want
    assert {w[3] for w in want} == {"rice"}
    for rows, d, k_cap, layout in want:
        assert f"group [{rows}, {d}] k_cap {k_cap}: layout {layout}" in out
    values = sum(g.rows * g.k_cap * 4 for g in sparse) + sum(
        g.d * 4 for g in plan.groups if g.kind == "dense")
    counts = sum(g.rows * 4 for g in sparse)
    cap = sum(g.rows * 4 * jcoding.rice_wire_words(g.k_cap, g.d)
              for g in sparse)
    for m in summary["metrics"]:
        assert np.isfinite(m["loss"]) and m["overflow"] == 0.0
        assert values + counts < m["wire_bytes"] <= values + counts + cap
        assert (m["wire_bytes"] - values - counts) % 4 == 0


def test_launcher_run_frees_its_model():
    """A run leaves none of its model alive by reference counts alone (no
    reference cycle through the train step), so runs in one process, as in
    chip_smoke.py, do not stack their device memory."""
    gc.collect()
    gc.disable()
    try:
        tlaunch.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                      "--device", "cpu", "--rho", str(RHO),
                      "--error-feedback"])
        alive = [o for o in gc.get_objects() if isinstance(o, Transformer)]
    finally:
        gc.enable()
    assert not alive


def test_import_loads_no_jax():
    """No module of the port imports JAX or the JAX package: the walk
    reaches the checkpoints, the example and the dense-attention configs
    too."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "need = {'repro_torch.checkpoint.checkpoint', "
        "'repro_torch.examples.train_lm', 'repro_torch.configs.gemma2_9b', "
        "'repro_torch.configs.gemma2_27b', "
        "'repro_torch.configs.starcoder2_7b'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_run_on_the_card_unless_asked():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


# the JAX config's fields the port refuses at any value but the default,
# and the queue-A item each refusal names
_REFUSED_ITEM = {"xla_preset": "item 13", "kernel_interpret": "item 4"}
# values the port refused until the adaptive control loop and wire-format
# v4 (queue A items 8 and 9), then the rest of the exchange and the
# reference backend (items 9 and 4) were ported: each constructs now
_PORTED_SINCE = [
    dict(rice_fitted=True), dict(rice_fitted=True, wire_layout="rice"),
    dict(adaptive=True, error_feedback=True), dict(delta_beta=0.5),
    dict(skip_tau=0.1), dict(bound_decay=0.5),
    dict(name="identity", wire="gather"), dict(name="qsgd", wire="gather"),
    dict(name="none", wire="gather"), dict(name="agspar", wire="gather"),
    dict(wire="packed"), dict(exchange="overlap"),
    dict(name="identity+bf16", wire="gather"),
    dict(name="identity+ternary", wire="gather", error_feedback=True),
    dict(name="agspar+qsgd8", wire="gather"),
    dict(name="qsgd", wire="gather", qsgd_bits=8),
    dict(name="agspar", wire="gather", density_gain=0.5),
    dict(backend="reference"), dict(kernel_interpret=False),
    dict(resparsify_pods=True), dict(overlap_bucket_bytes=4096),
    dict(name="agspar+bf16", wire="gather", error_feedback=True),
    dict(name="identity+qsgd4", wire="gather", wire_layout="coo"),
    dict(adaptive=True, error_feedback=True, wire="packed"),
    dict(adaptive=True, error_feedback=True, exchange="overlap"),
    dict(rice_fitted=True, wire="packed")]


@pytest.mark.parametrize("kw", [
    dict(name="identity", wire="gather"), dict(name="qsgd", wire="gather"),
    dict(name="none", wire="gather"), dict(name="agspar", wire="gather"),
    dict(wire="packed"), dict(rice_fitted=True),
    dict(rice_fitted=True, wire_layout="rice"), dict(exchange="overlap"),
    dict(name="identity+bf16", wire="gather"),
    dict(name="identity+ternary", wire="gather", error_feedback=True),
    dict(name="agspar+qsgd8", wire="gather"),
    dict(name="qsgd", wire="gather", qsgd_bits=8),
    dict(name="agspar", wire="gather", density_gain=0.5),
    dict(backend="reference"),
    dict(kernel_interpret=True), dict(kernel_interpret=False),
    dict(resparsify_pods=True), dict(overlap_bucket_bytes=4096),
    dict(adaptive=True, error_feedback=True), dict(delta_beta=0.5),
    dict(skip_tau=0.1), dict(bound_decay=0.5), dict(xla_preset="async"),
    dict(xla_preset="latency_hiding"), dict(xla_preset="overlap"),
    dict(name="agspar+bf16", wire="gather", error_feedback=True),
    dict(name="identity+qsgd4", wire="gather", wire_layout="coo"),
    dict(adaptive=True, error_feedback=True, wire="packed"),
    dict(adaptive=True, error_feedback=True, exchange="overlap"),
    dict(rice_fitted=True, wire="packed")])
def test_config_refuses_what_is_not_ported(kw):
    """Each value the JAX config takes but the port does not run raises
    NotImplementedError naming its ROADMAP.md item: ``xla_preset`` (item
    13), the one field the port carries only at its default, and
    ``kernel_interpret=True`` (item 4), refused by design: the port has no
    route from the card to the plain versions. The values ported since
    (the adaptive loop's fields, ``rice_fitted``; the packed wire, the
    overlap exchange, the pod stage's fields, the reference backend,
    ``kernel_interpret=False``, agspar and identity with the qsgd and none
    aliases on the gather wire) construct, as in JAX."""
    JConfig(**kw)                                  # valid in the JAX package
    if kw in _PORTED_SINCE:
        cfg = TConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
        return
    item = _REFUSED_ITEM.get(next(iter(kw)), "")
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue A {item}" if item
                       else "ROADMAP.md"):
        TConfig(**kw)


def test_config_takes_every_jax_default_by_name():
    """The port's config has the JAX config's fields in its order, and
    takes each at the JAX default by name, alone and all together; the
    backends the JAX package names for its kernels select the port's."""
    import dataclasses
    jax_cfg = JConfig()
    names = [f.name for f in dataclasses.fields(JConfig)]
    assert [f.name for f in dataclasses.fields(TConfig)] == names
    for name in names:
        cfg = TConfig(**{name: getattr(jax_cfg, name)})
        assert getattr(cfg, name) == getattr(jax_cfg, name)
    cfg = TConfig(**{n: getattr(jax_cfg, n) for n in names})
    assert cfg == TConfig()
    for backend in ("auto", "pallas"):
        assert TConfig(backend=backend).scheme() == TConfig().scheme()
    assert TConfig(eps=1.0).scheme().selector.eps == 1.0


@pytest.mark.parametrize("kw", [
    dict(backend="tpu"), dict(overlap_bucket_bytes=2),
    dict(xla_preset="fast"), dict(delta_beta=1.5), dict(skip_tau=-1.0),
    dict(bound_decay=1.0), dict(density_gain=1.5), dict(density_floor=-0.1),
    dict(adaptive=True),
    dict(adaptive=True, error_feedback=True, resparsify_pods=True)])
def test_config_rejects_what_the_jax_config_rejects(kw):
    """An invalid value of a refused field raises ValueError, as in the
    JAX package (which rejects an unknown backend when it resolves it)."""
    if "backend" not in kw:
        with pytest.raises(ValueError):
            JConfig(**kw)
    with pytest.raises(ValueError):
        TConfig(**kw)


@pytest.mark.parametrize("layout", ["coo", "bitmap", "dense", "rice"])
def test_config_takes_every_static_layout(layout):
    cfg = TConfig(wire="gather", wire_layout=layout)
    assert f"layout={layout}" in cfg.describe()
    assert TConfig().wire_layout == "auto"
    with pytest.raises(ValueError):
        TConfig(wire_layout="csr")
