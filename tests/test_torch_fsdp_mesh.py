"""The port's fsdp mode at a data x model mesh (``FsdpLayout``,
``dist/fsdp.py``, ``core.api.compress_tree_sharded``, the launcher's
``--mode fsdp --mesh DxM`` and ``PxDxM``) against the JAX package's fsdp
step (``repro/train/step.py:398-448``) under ``FSDP_RULES``, on the CPU.

One JAX subprocess on four fake CPU devices runs ``make_fsdp_train_step``
on a (2, 2) mesh under ``FSDP_RULES`` and the arch's overrides, with its
``compress_tree`` swapped for Algorithm 3 per shape group on whole-row
uniforms handed in as the key (``test_torch_fsdp._group_compress_tree``),
and gives each mesh's ``NamedSharding.devices_indices_map``; one spawn of
four gloo ranks runs the port. The tests share those two runs:

- (a) the port at ``--mesh 2x2``, ``1x4`` and ``4x1`` (the step the
  launcher builds: ``launch.train.fsdp_layout``, a split model past one
  model worker) against JAX on deepseek-v2 and gemma2-9b smoke in float32
  over two steps: with gspar and EF, each shard taking its slice of the
  whole-row numpy uniforms, each rank's parameter and residual shards
  within the tolerances of ``tests/test_torch_fsdp.py`` (parameters atol
  4e-6 for deepseek-v2, 1e-6 for gemma2-9b; residual rtol 1e-5 with that
  atol; density and var_ratio as JAX's, var_ratio rtol 1e-4; the loss
  rtol 1e-5; coordinates whose uniform lies within 1e-5 of JAX's keep
  probability exempt, at most 0.1 %), and the ranks of a block bit-equal;
  with ``none`` each step's averaged gradient (an optimizer that records
  it) within rtol 1e-5 (that atol x the leaf's largest);
- (b) the sharded ``compress_tree_sharded`` at 2x2 against the same call
  on the gathered tree in one process: each row's lambda within rtol
  1e-6, and each shard's Q and residual bit-equal to the plain dense pass
  (``ops.lam_dense``) on its slice of the gathered rows at the shard's
  lambda and uniforms (bit-equal to the gathered call's slice where the
  lambdas agree to the bit);
- (c) every rank's parameters, Adam moments and residual have exactly its
  block's shape, its block is the one ``devices_indices_map`` gives its
  device, and the blocks tile each leaf;
- (d) a checkpoint at 2x2 has the keys, shapes and dtypes of the JAX
  launcher's fsdp file, its parameters the ranks' blocks put together,
  and a resume is bit-equal to an unbroken run; the launcher's
  ``--checkpoint`` writes the same global layout;
- (e) the 2 pods x 1 data x 2 model mesh ``2x1x2`` against JAX as in (a);
- the launcher at ``--mode fsdp --mesh 2x2`` on every arch's smoke
  config.
"""
import contextlib
import dataclasses
import io
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
import test_torch_fsdp as base
from repro.checkpoint import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.optim import optimizers as jopt
from repro_torch.configs import registry as tregistry
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.grouping import plan_tree as tplan_tree
from repro_torch.dist import sharding as tshd
from repro_torch.models.common import leaf_order
from repro_torch.models.transformer import param_axes, param_shapes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("deepseek-v2-236b", "gemma2-9b")
OPT = {"deepseek-v2-236b": "sgd", "gemma2-9b": "adam"}
RHO, LR, MIN_LEAF, NEAR = base.RHO, base.LR, base.MIN_LEAF, base.NEAR
ATOL = {"deepseek-v2-236b": base.ATOL["deepseek-v2-236b"],
        "gemma2-9b": 1e-6}
MESHES = {"2x2": (None, 2, 2), "1x4": (None, 1, 4), "4x1": (None, 4, 1),
          "2x1x2": (2, 1, 2)}
# (arch, compressor, mesh)
CASES = [(a, n, m) for a in ARCHS for n in ("gspar", "none")
         for m in ("2x2", "1x4", "4x1")]
CASES += [("deepseek-v2-236b", "gspar", "2x1x2"),
          ("gemma2-9b", "none", "2x1x2")]
STEPS, B, S, SEED = 2, 4, 16, 11


def tokens() -> np.ndarray:
    """The global batch of each step."""
    return np.random.default_rng(5).integers(0, 512, (STEPS, B, S))


def group_uniforms(groups: list, t: int) -> list:
    """Step ``t``'s whole-row uniforms, one float32 ``[rows, d]`` array a
    sparse group (``groups``: their ``(rows, d)``, in plan order)."""
    return [np.random.default_rng([SEED, t, k]).random((rows, d),
                                                       dtype=np.float32)
            for k, (rows, d) in enumerate(groups)]


# ---------------------------------------------------------------------------
# the JAX side: one subprocess on four fake CPU devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[2])
import numpy as np
import repro                                # jax API shims first
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
import test_torch_fsdp as base
import test_torch_fsdp_mesh as T
from repro.configs import registry
from repro.core.api import CompressionConfig
from repro.core.grouping import plan_tree
from repro.dist import sharding as shd
from repro.models import transformer as tf
from repro.models.common import split_params
from repro.optim import optimizers
from repro.train import step as step_lib

out = {}
tokens = T.tokens()
for arch in T.ARCHS:
    spec = registry.get(arch)
    cfg = spec.smoke
    params = base._jax_params(arch)
    leaves = jax.tree.leaves(params)
    plan = plan_tree(CompressionConfig(name="gspar", rho=T.RHO,
                                       min_leaf_size=T.MIN_LEAF), leaves,
                     base._stacked(arch))
    groups = [(g.rows, g.d) for g in plan.groups if g.kind == "sparse"]
    out[f"{arch}/groups"] = np.asarray(groups)
    fake = base._group_compress_tree(plan)
    step_lib.compress_tree = fake
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    rules = dict(shd.FSDP_RULES, **spec.rules_overrides)
    for name in ("gspar", "none"):
        comp = CompressionConfig(name=name, rho=T.RHO,
                                 error_feedback=name != "none",
                                 min_leaf_size=T.MIN_LEAF)
        opt = (optimizers.make_optimizer(T.OPT[arch], T.LR)
               if name != "none" else base._recorder(optimizers))
        p, state = params, opt.init(params)
        ef = optimizers.init_feedback(params) if name != "none" else None
        with jax.set_mesh(mesh):
            step = jax.jit(step_lib.make_fsdp_train_step(cfg, comp, opt,
                                                         mesh, rules))
            for t in range(T.STEPS):
                b = {"tokens": jnp.asarray(tokens[t])}
                key = f"{arch}/{name}/{t}"
                if ef is not None:
                    us = T.group_uniforms(groups, t)
                    p, state, ef, m = step(p, state, ef, b,
                                           [jnp.asarray(u) for u in us])
                    jax.effects_barrier()
                    near = base._near(plan, us, fake.probs, leaves)
                    for i, x in enumerate(near):
                        out[f"{key}/near/{i}"] = x
                else:
                    grads, state, m = step(p, state, b, jax.random.key(1))
                    for i, x in enumerate(jax.tree.leaves(grads)):
                        out[f"{key}/grad/{i}"] = np.asarray(x)
                for k, v in m.items():
                    out[f"{key}/m/{k}"] = np.asarray(v)
        if ef is not None:
            for i, x in enumerate(jax.tree.leaves(p)):
                out[f"{arch}/{name}/param/{i}"] = np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(ef.residual)):
                out[f"{arch}/{name}/residual/{i}"] = np.asarray(x)
    # each mesh's blocks: [device, leaf dim] starts and stops
    _, axes = split_params(jax.eval_shape(lambda k: tf.init_model(k, cfg),
                                          jax.random.key(0)))
    ax = jax.tree.leaves(axes, is_leaf=lambda t: isinstance(t, tuple) and
                         all(isinstance(e, (str, type(None))) for e in t))
    for tag, (pods, d, m) in T.MESHES.items():
        shape = (d, m) if pods is None else (pods, d, m)
        names = ("data", "model") if pods is None else ("pod", "data",
                                                         "model")
        msh = jax.make_mesh(shape, names)
        r = dict(shd.FSDP_RULES, **spec.rules_overrides)
        if pods is not None:
            r = shd.with_pod(r)
        for i, (x, a) in enumerate(zip(leaves, ax)):
            idx = NamedSharding(msh, shd.resolve_spec(
                x.shape, a, r, msh)).devices_indices_map(x.shape)
            out[f"{arch}/blocks/{tag}/{i}"] = np.asarray(
                [[(sl.start or 0, x.shape[j] if sl.stop is None else sl.stop)
                  for j, sl in enumerate(idx[dev])]
                 for dev in msh.devices.flat])
np.savez(sys.argv[1], **out)
"""


# ---------------------------------------------------------------------------
# the port's side: four gloo ranks
# ---------------------------------------------------------------------------

def _whole(arch: str) -> dict:
    from repro_torch.models.convert import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray,
                                          base._jax_params(arch)))


def port_groups(cfg, stacked: list, min_leaf: int = MIN_LEAF):
    """The port's plan of ``cfg``'s whole leaves: its sparse groups and
    their ``(rows, d)`` (JAX's ``plan_tree`` groups them alike)."""
    shapes = param_shapes(cfg)
    meta = [torch.empty(shapes[n][0], device="meta")
            for n in leaf_order(shapes)]
    plan = tplan_tree(TConfig(name="gspar", rho=RHO,
                              min_leaf_size=min_leaf), meta, stacked)
    sparse = [g for g in plan.groups if g.kind == "sparse"]
    return sparse, [(g.rows, g.d) for g in sparse], meta


def _leaf_uniforms(cfg, stacked: list, t: int, min_leaf: int) -> dict:
    """Step ``t``'s whole uniforms of each sparse leaf (index -> an array
    of the leaf's shape): its rows of its group's array."""
    sparse, groups, meta = port_groups(cfg, stacked, min_leaf)
    out = {}
    for g, u in zip(sparse, group_uniforms(groups, t)):
        r0 = 0
        for i, rows in g.members:
            out[i] = u[r0:r0 + rows].reshape(meta[i].shape)
            r0 += rows
    return out


def injector(cfg, stacked, min_leaf: int = MIN_LEAF):
    """``make_fsdp_train_step``'s ``uniforms``: step t's shard rows take
    their slices of the whole-row arrays."""
    def at(t):
        whole = _leaf_uniforms(cfg, stacked, t, min_leaf)

        def draw(leaf, row, block, n):
            u = whole[leaf]
            piece = u[row][block[1:]] if stacked[leaf] and u.shape[0] > 1 \
                else u[block]
            assert piece.size == n
            return torch.from_numpy(np.ascontiguousarray(piece).reshape(-1))
        return draw
    return at


_GROUPS: dict = {}


def _mesh_groups(mesh):
    """The launcher's groups for ``mesh``, made once per mesh on every
    rank in one order."""
    from repro_torch.launch import train as tlaunch
    if mesh not in _GROUPS:
        data_group, _, _ = tlaunch.mesh_groups(mesh)
        _GROUPS[mesh] = (data_group,) + tuple(tlaunch.model_groups(mesh))
    return _GROUPS[mesh]


def build(arch: str, mesh, whole: dict):
    """The launcher's layout and model for ``arch``'s smoke config on
    ``mesh`` (``fsdp_layout``, ``plan_split`` past one model worker), the
    parameters this rank's blocks of ``whole``."""
    from repro_torch.dist import tensor_parallel
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.transformer import Transformer
    spec = tregistry.get(arch)
    cfg = spec.smoke
    names = leaf_order(param_shapes(cfg))
    data_group, model_group, m, ranks, worker_group = _mesh_groups(mesh)
    ma = tshd.ModelAxis(size=mesh[2], index=m, group=model_group,
                        ranks=ranks, specs=tlaunch.leaf_specs(
                            cfg, names, spec.rules_overrides, mesh))
    layout = tlaunch.fsdp_layout(cfg, names, spec.rules_overrides, mesh,
                                 data_group, worker_group, ma)
    tp = None
    if mesh[2] > 1:
        tp = tensor_parallel.plan_split(cfg, names, layout.model)
        layout = dataclasses.replace(layout, model=tp.axis)
    model = Transformer(cfg, {n: layout.keep(n, whole[n].clone())
                              for n in names}, tp=tp)
    return layout, model


def _blocks(layout) -> list:
    return [[(s.start, s.stop) for s in layout.block(i)]
            for i in range(len(layout.names))]


def run_case(arch, name, tag, rank, toks) -> dict:
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    mesh = MESHES[tag]
    layout, model = build(arch, mesh, _whole(arch))
    comp = TConfig(name=name, rho=RHO, error_feedback=name != "none",
                   min_leaf_size=MIN_LEAF)
    if name == "none":
        opt, seen = base._recorder(topt)
    else:
        opt = topt.make_optimizer(OPT[arch], LR)
    stacked = model.stacked
    step = tstep.make_fsdp_train_step(
        model, comp, opt, layout=layout,
        uniforms=injector(model.cfg, stacked))
    state = opt.init(model.leaves())
    fb = topt.init_feedback(model.leaves()) if name != "none" else None
    per = B // layout.data.size
    d = layout.data.index
    metrics = []
    gen = torch.Generator().manual_seed(0)
    for t in range(STEPS):
        batch = {"tokens": torch.from_numpy(toks[t][d * per:(d + 1) * per])}
        if fb is not None:
            state, fb, m = step(state, fb, batch, gen)
        else:
            state, m = step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"blocks": _blocks(layout), "metrics": metrics}
    if name == "none":
        out["grads"] = [[g.numpy().copy() for g in s] for s in seen]
    else:
        out["params"] = [p.detach().numpy().copy() for p in model.leaves()]
        out["residual"] = [r.numpy().copy() for r in fb.residual]
    out["shapes"] = {"params": [tuple(p.shape) for p in model.leaves()],
                     "opt": {k: [tuple(x.shape) for x in v]
                             for k, v in state.items() if k != "step"},
                     "residual": None if fb is None else
                     [tuple(x.shape) for x in fb.residual]}
    return out


def _tree(arch: str, seed: int) -> list:
    """A heavy-tailed float32 tree of ``arch``'s smoke leaves (some rows
    saturate under gspar)."""
    cfg = tregistry.get(arch).smoke
    shapes = param_shapes(cfg)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(shapes[n][0]) * np.exp(
        2 * rng.standard_normal(shapes[n][0]))).astype(np.float32))
        for n in leaf_order(shapes)]


SHARDED = dict(name="gspar", rho=RHO, error_feedback=True, min_leaf_size=128)


def lambdas_of(fn):
    """``fn()`` with ``ops.gspar_dense_lambda`` recording each call's
    per-row lambda and the leaves of its rows."""
    from repro_torch.kernels.sparsify import ops
    real, seen = ops.gspar_dense_lambda, []

    def spy(g2d, rho=0.1, num_iters=2, shards=None):
        lam, l2 = real(g2d, rho, num_iters, shards)
        seen.append((list(shards.rows), lam.clone()))
        return lam, l2
    ops.gspar_dense_lambda = spy
    try:
        return fn(), seen
    finally:
        ops.gspar_dense_lambda = real


def sharded_compress(rank: int) -> dict:
    """(b): ``compress_tree_sharded`` at 2x2 on this rank's blocks of a
    fixed tree and residual, whole-row uniforms sliced."""
    from repro_torch.core.api import compress_tree_sharded
    arch = "deepseek-v2-236b"
    layout, model = build(arch, MESHES["2x2"], _whole(arch))
    g, r = _tree(arch, 1), _tree(arch, 2)
    (q, res, stats), lams = lambdas_of(lambda: compress_tree_sharded(
        TConfig(**SHARDED), [layout.shard(x, i).contiguous()
                             for i, x in enumerate(g)], layout,
        model.stacked, [layout.shard(x, i).contiguous()
                        for i, x in enumerate(r)],
        injector(model.cfg, model.stacked, SHARDED["min_leaf_size"])(0)))
    return {"q": [x.numpy().copy() for x in q],
            "res": [x.numpy().copy() for x in res],
            "lams": [(rows, lam.numpy()) for rows, lam in lams],
            "stats": [float(stats.bits), float(stats.density),
                      float(stats.var_ratio)],
            "blocks": _blocks(layout)}


def resume(rank: int, tmp: str) -> dict:
    """(d): gemma2-9b gspar with EF and Adam at 2x2, the stream keyed
    (``KeyedUniforms``): two steps unbroken, and one, a save, a restore
    into perturbed fresh state and one more."""
    from repro_torch.checkpoint import checkpoint as tckpt
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    arch, mesh = "gemma2-9b", MESHES["2x2"]
    toks = tokens()
    comp = TConfig(name="gspar", rho=RHO, error_feedback=True,
                   min_leaf_size=MIN_LEAF)
    out = {}
    for run in ("unbroken", "resumed"):
        layout, model = build(arch, mesh, _whole(arch))
        opt = topt.adam(LR)
        step = tstep.make_fsdp_train_step(model, comp, opt, layout=layout)
        state = opt.init(model.leaves())
        fb = topt.init_feedback(model.leaves())
        d = layout.data.index
        for t in range(STEPS):
            if run == "resumed" and t == 1:
                ck = os.path.join(tmp, "fsdp_ck")
                tckpt.save(ck, model, state, fb, mesh=mesh, mode="fsdp",
                           model_axis=layout)
                out["saved"] = [p.detach().numpy().copy()
                                for p in model.leaves()]
                with torch.no_grad():
                    for p in model.leaves():
                        p.add_(1.0)
                state = opt.init(model.leaves())
                fb = topt.init_feedback(model.leaves())
                state, fb, _ = tckpt.restore(ck, model, state, fb,
                                             mesh=mesh, mode="fsdp",
                                             model_axis=layout)
            batch = {"tokens": torch.from_numpy(toks[t][d * 2:d * 2 + 2])}
            state, fb, _ = step(state, fb, batch,
                                torch.Generator().manual_seed(77))
        out[run] = {"params": [p.detach().numpy().copy()
                               for p in model.leaves()],
                    "m": [x.numpy().copy() for x in state["m"]],
                    "v": [x.numpy().copy() for x in state["v"]],
                    "residual": [x.numpy().copy() for x in fb.residual],
                    "step": state["step"]}
    out["blocks"] = _blocks(layout)
    return out


def launcher_runs(tmp: str) -> dict:
    """The launcher at ``--mode fsdp --mesh 2x2`` on every arch's smoke
    config, one step with EF; deepseek-v2's with ``--checkpoint``."""
    from repro_torch.launch import train as tlaunch
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for arch in tregistry.ID_TO_MODULE:
            argv = ["--arch", arch, "--smoke", "--steps", "1", "--device",
                    "cpu", "--mode", "fsdp", "--mesh", "2x2",
                    "--error-feedback"]
            if arch == "deepseek-v2-236b":
                argv += ["--checkpoint", os.path.join(tmp, "launcher_ck")]
            out[arch] = tlaunch.main(argv)
    out["printed"] = buf.getvalue()
    return out


def four_ranks(rank: int, tmp: str) -> dict:
    toks = tokens()
    res = {"cases": {c: run_case(*c, rank, toks) for c in CASES}}
    res["sharded"] = sharded_compress(rank)
    res["resume"] = resume(rank, tmp)
    res["launcher"] = launcher_runs(tmp)
    return res


WORKER = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import test_torch_fsdp_mesh as t

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
torch.save(t.four_ranks(rank, sys.argv[5]), out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX subprocess and the four ranks, side by side. Returns
    (JAX's arrays, the four ranks' records, tmp)."""
    tmp = tmp_path_factory.mktemp("fsdp_mesh")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "jax.npz"), tests],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [str(tmp / f"rank{r}.pt") for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), outs[r], tests,
         str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    log = jax_proc.communicate(timeout=400)[0]
    assert jax_proc.returncode == 0, log
    return (dict(np.load(tmp / "jax.npz")),
            [torch.load(o, weights_only=False) for o in outs], tmp)


def _cut(x: np.ndarray, block) -> np.ndarray:
    return x[tuple(slice(a, b) for a, b in block)]


def _check_case(results, case) -> None:
    want, ranks, _ = results
    arch, name, tag = case
    atol = ATOL[arch]
    cfg = tregistry.get(arch).smoke
    stacked = [param_shapes(cfg)[n][1] for n in leaf_order(
        param_shapes(cfg))]
    # both sides draw their uniforms by the same groups
    assert port_groups(cfg, stacked)[1] == [
        tuple(x) for x in want[f"{arch}/groups"]]
    n = len(leaf_order(param_shapes(tregistry.get(arch).smoke)))
    for r, rec in enumerate(ranks):
        got = rec["cases"][case]
        for t, m in enumerate(got["metrics"]):
            w = {k.rsplit("/", 1)[1]: float(v) for k, v in want.items()
                 if k.startswith(f"{arch}/{name}/{t}/m/")}
            assert set(m) == set(w)
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
            if name != "none":
                assert 0.0 < m["density"] <= 1.25 * RHO
                np.testing.assert_allclose(m["var_ratio"], w["var_ratio"],
                                           rtol=1e-4)
        if name == "none":
            for t, grads in enumerate(got["grads"]):
                for i in range(n):
                    w = _cut(want[f"{arch}/none/{t}/grad/{i}"],
                             got["blocks"][i])
                    np.testing.assert_allclose(
                        grads[i], w, rtol=1e-5,
                        atol=atol * max(1.0, float(np.abs(w).max())),
                        err_msg=f"{case} rank {r} step {t} leaf {i}")
            continue
        exempt = [np.zeros(want[f"{arch}/gspar/param/{i}"].shape, bool)
                  for i in range(n)]
        for t in range(STEPS):
            for i in range(n):
                key = f"{arch}/gspar/{t}/near/{i}"
                if key in want:
                    exempt[i] |= want[key]
        n_ex = sum(int(e.sum()) for e in exempt)
        assert n_ex <= 1e-3 * sum(e.size for e in exempt)
        for t, m in enumerate(got["metrics"]):
            w = float(want[f"{arch}/gspar/{t}/m/density"])
            assert abs(m["density"] - w) <= n_ex / sum(
                e.size for e in exempt) + 1e-7
        for i in range(n):
            blk = got["blocks"][i]
            keep = ~_cut(exempt[i], blk)
            wp = _cut(want[f"{arch}/gspar/param/{i}"], blk)
            wr = _cut(want[f"{arch}/gspar/residual/{i}"], blk)
            np.testing.assert_allclose(got["params"][i][keep], wp[keep],
                                       rtol=0, atol=atol,
                                       err_msg=f"{case} rank {r} leaf {i}")
            np.testing.assert_allclose(got["residual"][i][keep], wr[keep],
                                       rtol=1e-5, atol=atol,
                                       err_msg=f"{case} rank {r} leaf {i}")
    # the ranks holding one block hold the same bits
    for i in range(n):
        by_block: dict = {}
        for rec in ranks:
            got = rec["cases"][case]
            key = tuple(got["blocks"][i])
            for field in ("params", "residual", "grads"):
                if field in got:
                    x = got[field] if field != "grads" else got[field][-1]
                    prev = by_block.setdefault((key, field), x[i])
                    np.testing.assert_array_equal(prev, x[i])
    for rec in ranks[1:]:
        assert rec["cases"][case]["metrics"] == ranks[0]["cases"][case][
            "metrics"]


@pytest.mark.parametrize("case", [c for c in CASES if c[2] != "2x1x2"],
                         ids=lambda c: "-".join(c))
def test_fsdp_at_a_mesh_matches_jax(results, case):
    """(a) the port at 2x2, 1x4 and 4x1 against JAX's fsdp step."""
    _check_case(results, case)


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "2x1x2"],
                         ids=lambda c: "-".join(c))
def test_fsdp_with_pods_matches_jax(results, case):
    """(e) the 2 pods x 1 data x 2 model mesh against JAX."""
    _check_case(results, case)


def test_sharded_lambda_and_q_match_the_gathered_tree(results):
    """(b) each row's lambda within rtol 1e-6 of the gathered call's; each
    shard's Q and residual bit-equal to the plain dense pass on its slice
    of the gathered rows at its lambda, and to the gathered call's where
    the lambdas agree to the bit."""
    from repro_torch.core.api import compress_tree_sharded
    from repro_torch.kernels.sparsify import ops
    _, ranks, tmp = results
    arch = "deepseek-v2-236b"
    cfg = tregistry.get(arch).smoke
    shapes = param_shapes(cfg)
    names = leaf_order(shapes)
    stacked = [shapes[n][1] for n in names]
    one = tshd.fsdp_layout(
        [shapes[n][0] for n in names], [param_axes(cfg)[n] for n in names],
        names, tregistry.get(arch).rules_overrides, (None, 1, 1),
        {"data": 0, "model": 0}, tshd.DataAxis(("data",), 1, 0),
        tshd.ModelAxis(size=1, index=0, specs=()))
    g, r = _tree(arch, 1), _tree(arch, 2)
    draw = injector(cfg, stacked, SHARDED["min_leaf_size"])(0)
    (q, res, stats), lams = lambdas_of(lambda: compress_tree_sharded(
        TConfig(**SHARDED), g, one, stacked, r, draw))
    whole_lam = {}                       # (leaf, row) -> lambda
    for rows, lam in lams:
        for k, (i, row) in enumerate(_rows(rows)):
            whole_lam[(i, row)] = lam[k]
    same = 0
    for rec in ranks:
        got = rec["sharded"]
        np.testing.assert_allclose(got["stats"], [float(stats.bits),
                                                  float(stats.density),
                                                  float(stats.var_ratio)],
                                   rtol=1e-5)
        shard_lam = {}
        for rows, lam in got["lams"]:
            for k, key in enumerate(_rows(rows)):
                shard_lam[key] = lam[k]
        assert set(shard_lam) == set(whole_lam)
        for key, lam in shard_lam.items():
            np.testing.assert_allclose(lam, whole_lam[key].numpy(),
                                       rtol=1e-6, err_msg=str(key))
        for i, blk in enumerate(got["blocks"]):
            target = (g[i] + r[i]).numpy()
            if (i, 0) not in shard_lam:         # dense: passed through
                np.testing.assert_array_equal(got["q"][i], _cut(target, blk))
                assert not got["res"][i].any()
                continue
            n_rows = got["q"][i].shape[0] if stacked[i] and \
                shapes[names[i]][0][0] > 1 else 1
            qs = got["q"][i].reshape(n_rows, -1)
            rs = got["res"][i].reshape(n_rows, -1)
            for row in range(n_rows):
                lam = torch.tensor([shard_lam[(i, row)]])
                part = _cut(target, blk)
                part = part[row] if n_rows > 1 else part
                g2d = torch.from_numpy(np.ascontiguousarray(part)).reshape(
                    1, -1)
                u = draw(i, row, tuple(slice(a, b) for a, b in blk),
                         g2d.shape[1])[None]
                plain = ops.lam_dense(g2d, u, lam, (g2d * g2d).sum(1),
                                      ef=True)
                np.testing.assert_array_equal(qs[row], plain.q[0].numpy())
                np.testing.assert_array_equal(rs[row],
                                              plain.residual[0].numpy())
                if lam.item() == whole_lam[(i, row)].item():
                    same += 1
                    wq = _cut(q[i].numpy(), blk)
                    wr = _cut(res[i].numpy(), blk)
                    np.testing.assert_array_equal(
                        qs[row], (wq[row] if n_rows > 1 else wq).reshape(-1))
                    np.testing.assert_array_equal(
                        rs[row], (wr[row] if n_rows > 1 else wr).reshape(-1))
    assert same > 0


def _rows(leaf_of_row: list) -> list:
    """``(leaf, row within the leaf)`` of each row of a group."""
    out, seen = [], {}
    for i in leaf_of_row:
        out.append((i, seen.get(i, 0)))
        seen[i] = seen.get(i, 0) + 1
    return out


def test_every_rank_holds_exactly_its_blocks(results):
    """(c) each rank's parameters, Adam moments and residual are shaped as
    its block, which is the one JAX's ``devices_indices_map`` gives its
    device (rank = its place in the mesh), and the blocks tile every
    leaf."""
    want, ranks, _ = results
    for case in CASES:
        arch, name, tag = case
        shapes = param_shapes(tregistry.get(arch).smoke)
        names = leaf_order(shapes)
        cover = [np.zeros(shapes[n][0], np.int32) for n in names]
        for r, rec in enumerate(ranks):
            got = rec["cases"][case]
            for i, blk in enumerate(got["blocks"]):
                assert [list(x) for x in want[
                    f"{arch}/blocks/{tag}/{i}"][r]] == [list(x)
                                                        for x in blk], \
                    (case, r, names[i])
                shape = tuple(b - a for a, b in blk)
                sh = got["shapes"]
                assert sh["params"][i] == shape
                if sh["residual"] is not None:
                    assert sh["residual"][i] == shape
                for field in sh["opt"].values():
                    assert field[i] == shape
                cover[i][tuple(slice(a, b) for a, b in blk)] += 1
        for i, c in enumerate(cover):
            # every coordinate held by as many ranks as the leaf's replicas
            assert c.min() == c.max() >= 1, (case, names[i])
        if name == "gspar" and OPT[arch] == "adam":
            assert ranks[0]["cases"][case]["shapes"]["opt"]


def test_checkpoint_at_2x2_is_global_and_resumes(results, tmp_path):
    """(d) the file has the JAX fsdp launcher's keys, shapes and dtypes,
    its parameters the ranks' blocks put together; a resume is bit-equal
    to an unbroken run; the launcher's ``--checkpoint`` writes the same
    global layout."""
    _, ranks, tmp = results
    arch = "gemma2-9b"
    params = base._jax_params(arch)
    jpath = str(tmp_path / "jax")
    jckpt.save(jpath, {"params": params, "opt": jopt.adam(LR).init(params),
                       "ef": jopt.init_feedback(params)})
    names = leaf_order(param_shapes(tregistry.get(arch).smoke))
    with np.load(jpath + ".npz") as w, np.load(tmp / "fsdp_ck.npz") as got:
        assert list(got.keys()) == list(w.keys())
        for key in w.keys():
            assert (got[key].dtype, got[key].shape) == (w[key].dtype,
                                                        w[key].shape), key
        for rec in ranks:
            res = rec["resume"]
            for i, n in enumerate(names):
                np.testing.assert_array_equal(
                    _cut(got[f"params/{n}"], res["blocks"][i]),
                    res["saved"][i])
    for rec in ranks:
        a, b = rec["resume"]["unbroken"], rec["resume"]["resumed"]
        assert a["step"] == b["step"] == STEPS
        for field in ("params", "m", "v", "residual"):
            for x, y in zip(a[field], b[field]):
                np.testing.assert_array_equal(x, y, err_msg=field)
    dparams = base._jax_params("deepseek-v2-236b")
    jpath = str(tmp_path / "jax_ds")
    jckpt.save(jpath, {"params": dparams, "opt": jopt.adam(LR).init(dparams),
                       "ef": jopt.init_feedback(dparams)})
    with np.load(jpath + ".npz") as w, \
            np.load(tmp / "launcher_ck.npz") as got:
        assert list(got.keys()) == list(w.keys())
        for key in w.keys():
            assert (got[key].dtype, got[key].shape) == (w[key].dtype,
                                                        w[key].shape), key


def test_launcher_trains_every_arch_at_mesh_2x2(results):
    """``--mode fsdp --mesh 2x2`` on every arch's smoke config: finite
    losses and densities equal on the four ranks, each rank's parameter
    bytes its blocks' (a quarter to a half of the model's)."""
    _, ranks, _ = results
    printed = ranks[0]["launcher"]["printed"]
    assert "NotImplementedError" not in printed
    for arch in tregistry.ID_TO_MODULE:
        outs = [rec["launcher"][arch] for rec in ranks]
        assert all(o["mode"] == "fsdp" for o in outs)
        for o in outs:
            assert o["metrics"] == outs[0]["metrics"]
            m = o["metrics"][0]
            assert np.isfinite(m["loss"]) and 0.0 < m["density"] <= \
                1.25 * RHO
            whole = sum(int(np.prod(s)) for s, _ in param_shapes(
                tregistry.get(arch).smoke).values()) * 4
            assert whole / 4 <= o["param_bytes"] < whole / 2
