"""The port's FSDP step (``repro_torch.train.step.make_fsdp_train_step``)
against the JAX package's (``repro/train/step.py:398-448``) on the CPU:

- one worker, gemma-2b and deepseek-v2 smoke in float32, two steps: with
  gspar and EF (Q applied once to the gradient, the residual
  params-shaped) and with ``none``. The JAX side is ``make_fsdp_train_step``
  itself on a one-device mesh, with its ``compress_tree`` swapped for the
  JAX package's Algorithm 3 (``greedy_probabilities``, ``apply_mask``) per
  shape group on the port's uniforms (handed in as the step's key, redrawn
  from an identically seeded generator in group order), so both sides keep
  the same coordinates. With gspar: new parameters within atol 1e-6
  (deepseek-v2 at 4e-6, its float32 gradient noise:
  ``tests/test_torch_archs.py``), the residual within rtol 1e-5 and that
  atol, density and var_ratio (rtol 1e-4) as JAX's, all away from the
  coordinates whose uniform lies within 1e-5 of its probability (at most
  0.1 %); with ``none`` each step's gradient, handed to an optimizer that
  records it, within rtol 1e-5 (that atol x the leaf's largest); the loss
  within rtol 1e-5;
- two gloo ranks against JAX's fsdp step on two fake CPU devices (one
  subprocess), phi3.5-moe smoke, ``none``, SGD at lr 1: each rank's
  parameter change, the averaged gradient, and the loss equal JAX's over
  the global batch within rtol 1e-5 (atol 2e-6 x the leaf's largest
  change; the logits near 100 carry float32 noise). The MoE load-balance
  term spans the global batch, so this fails if ``ce`` is left per rank.
"""
import functools
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

import repro  # noqa: F401  (jax API shims first)
from repro.configs import registry as jregistry
from repro.core import api as japi
from repro.core import sparsify as jsparsify
from repro.core.api import CompressionConfig as JConfig
from repro.core.grouping import plan_tree as jplan_tree
from repro.dist import sharding as shd
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch.configs import registry as tregistry
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RHO, LR, SEED, MIN_LEAF, NEAR = 0.05, 1e-3, 11, 1024, 1e-5
ATOL = {"gemma-2b": 1e-6, "deepseek-v2-236b": 4e-6}


OPTIMIZER = {"gemma-2b": "adam", "deepseek-v2-236b": "sgd"}   # the card's


def _recorder(pkg):
    """An optimizer that keeps the parameters and hands back the gradient
    it is given: the JAX one as its new parameters, the port's appended to
    its ``seen`` list."""
    if pkg is jopt:
        return jopt.Optimizer(init=lambda p: {},
                              update=lambda g, s, p, **kw: (g, s))
    seen = []

    def update(grads, state, params, var_scale=1.0):
        seen.append([g.detach().clone() for g in grads])
        return params, state
    opt = topt.Optimizer(init=lambda p: {}, update=update)
    return opt, seen


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    cfg = jregistry.get(arch).smoke
    return jax.jit(lambda k: split_params(jtf.init_model(k, cfg))[0])(
        jax.random.key(0))


def _stacked(arch: str) -> list:
    shapes = ttf.param_shapes(tregistry.get(arch).smoke)
    return [shapes[k][1] for k in ttf.leaf_order(shapes)]


@functools.lru_cache(maxsize=None)
def _gspar_rows(rows: int, d: int):
    def row(g, u):
        p = jsparsify.greedy_probabilities(g, RHO)
        return jsparsify.apply_mask(g, p, (u < p).astype(p.dtype)), p
    return jax.jit(jax.vmap(row))


def _group_compress_tree(plan):
    """A stand-in for the JAX ``compress_tree`` in ``make_fsdp_train_step``:
    Algorithm 3 per shape group of ``plan`` on the uniforms handed in as
    the key (one ``[rows, d]`` array a sparse group), tiny leaves passed
    through with a zero residual; TreeStats' density and var_ratio as JAX
    forms them (bits 0: not compared here). The last call's keep
    probabilities, a ``[rows, d]`` array a sparse group, are left in
    ``compress_tree.probs``."""
    def keep(*ps):
        compress_tree.probs = [np.asarray(p) for p in ps]

    def compress_tree(cfg, key, grads, residual=None, stacked=None):
        leaves, tdef = jax.tree_util.tree_flatten(grads)
        targets = leaves
        if cfg.error_feedback:
            targets = [g + r for g, r in zip(
                leaves, jax.tree_util.tree_flatten(residual)[0])]
        q, res = [None] * len(leaves), [None] * len(leaves)
        nnz, wvar, probs = [], [], []
        uniforms = iter(key)
        for grp in plan.groups:
            if grp.kind == "dense":
                for i, _ in grp.members:
                    q[i] = targets[i]
                    res[i] = jnp.zeros_like(targets[i])
                    wvar.append(jnp.float32(targets[i].size))
                    nnz.append(jnp.count_nonzero(q[i]).astype(jnp.float32))
                continue
            stack = jnp.concatenate([targets[i].reshape(rows, grp.d)
                                     for i, rows in grp.members])
            qg, p = _gspar_rows(grp.rows, grp.d)(stack, next(uniforms))
            probs.append(p)
            ratio = jnp.sum(qg * qg, 1) / jnp.sum(stack * stack, 1)
            r0 = 0
            for i, rows in grp.members:
                shape = targets[i].shape
                q[i] = qg[r0:r0 + rows].reshape(shape)
                res[i] = (stack[r0:r0 + rows] - qg[r0:r0 + rows]).reshape(
                    shape)
                wvar.append(jnp.mean(ratio[r0:r0 + rows]) * targets[i].size)
                nnz.append(jnp.count_nonzero(q[i]).astype(jnp.float32))
                r0 += rows
        tot = float(sum(x.size for x in leaves))
        stats = japi.TreeStats(bits=jnp.float32(0.0),
                               dense_bits=jnp.float32(0.0),
                               density=sum(nnz) / tot,
                               var_ratio=sum(wvar) / tot)
        jax.debug.callback(keep, *probs)
        return (jax.tree_util.tree_unflatten(tdef, q),
                jax.tree_util.tree_unflatten(tdef, res)
                if cfg.error_feedback else None, stats)
    return compress_tree


def _jax_fsdp_steps(arch: str, name: str, tokens: np.ndarray,
                    monkeypatch):
    """``make_fsdp_train_step`` of the JAX package on a one-device mesh,
    ``len(tokens)`` steps. Returns the new parameter leaves, the residual
    leaves, each step's metrics and the exempt masks; with ``none`` (the
    recorder optimizer) each step's gradient leaves in place of the
    parameters, and None for the residual and the masks."""
    spec = jregistry.get(arch)
    cfg = spec.smoke
    params = _jax_params(arch)
    leaves = jax.tree.leaves(params)
    stacked = _stacked(arch)
    plan = jplan_tree(JConfig(name="gspar", rho=RHO,
                              min_leaf_size=MIN_LEAF), leaves, stacked)
    fake = _group_compress_tree(plan)
    monkeypatch.setattr(jstep, "compress_tree", fake)
    comp = JConfig(name=name, rho=RHO, error_feedback=name != "none",
                   min_leaf_size=MIN_LEAF)
    opt = (jopt.make_optimizer(OPTIMIZER[arch], LR) if name != "none"
           else _recorder(jopt))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rules = dict(shd.FSDP_RULES, **spec.rules_overrides)
    gen = torch.Generator().manual_seed(SEED)
    state = opt.init(params)
    ef = jopt.init_feedback(params) if name != "none" else None
    metrics, exempt, seen = [], None, []
    with jax.set_mesh(mesh):
        step = jax.jit(jstep.make_fsdp_train_step(cfg, comp, opt, mesh,
                                                  rules))
        for batch in tokens:
            us = [torch.rand((g.rows, g.d), generator=gen).numpy()
                  for g in plan.groups if g.kind == "sparse"] \
                if name != "none" else []
            b = {"tokens": jnp.asarray(batch)}
            if ef is not None:
                params, state, ef, m = step(params, state, ef, b,
                                            [jnp.asarray(u) for u in us])
                near = _near(plan, us, fake.probs, leaves)
                exempt = near if exempt is None else [
                    a | c for a, c in zip(exempt, near)]
            else:       # the recorder: the averaged gradient, params kept
                grads, state, m = step(params, state, b, jax.random.key(1))
                seen.append([np.asarray(x) for x in jax.tree.leaves(grads)])
            metrics.append({k: float(v) for k, v in m.items()})
    if ef is None:
        return seen, None, metrics, None
    return ([np.asarray(x) for x in jax.tree.leaves(params)],
            [np.asarray(x) for x in jax.tree.leaves(ef.residual)], metrics,
            exempt)


def _near(plan, us, probs, leaves) -> list:
    """Per leaf, the coordinates whose uniform lies within NEAR of its keep
    probability (either side may keep them)."""
    out = [np.zeros(x.shape, bool) for x in leaves]
    for grp, u, p in zip([g for g in plan.groups if g.kind == "sparse"], us,
                         probs):
        close = np.abs(u - np.asarray(p)) < NEAR
        r0 = 0
        for i, rows in grp.members:
            out[i] = close[r0:r0 + rows].reshape(leaves[i].shape)
            r0 += rows
    return out


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


@pytest.mark.parametrize("name", ["gspar", "none"])
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b"])
def test_fsdp_step_matches_jax_at_one_worker(arch, name, one_worker_group,
                                             monkeypatch):
    tokens = np.random.default_rng(5).integers(0, 512, (2, 2, 16))
    want_p, want_r, want_m, exempt = _jax_fsdp_steps(arch, name, tokens,
                                                     monkeypatch)
    cfg = tregistry.get(arch).smoke
    model = ttf.Transformer(cfg, params_from_numpy(
        jax.tree.map(np.asarray, _jax_params(arch))))
    comp = TConfig(name=name, rho=RHO, error_feedback=name != "none",
                   min_leaf_size=MIN_LEAF)
    if name == "none":
        opt, seen = _recorder(topt)
    else:
        opt = topt.make_optimizer(OPTIMIZER[arch], LR)
    step = tstep.make_fsdp_train_step(model, comp, opt)
    state = opt.init(model.leaves())
    fb = topt.init_feedback(model.leaves()) if name != "none" else None
    gen = torch.Generator().manual_seed(SEED)
    got_m = []
    for batch in tokens:
        b = {"tokens": torch.from_numpy(batch)}
        if fb is not None:
            state, fb, m = step(state, fb, b, gen)
        else:
            state, m = step(state, b, gen)
        got_m.append({k: float(v) for k, v in m.items()})
    for g, w in zip(got_m, want_m):
        assert set(g) == set(w) == ({"loss"} if name == "none" else
                                    {"loss", "bits", "density",
                                     "var_ratio"})
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
    atol = ATOL[arch]
    if name == "none":
        # each step's gradient, unsparsified: rtol, atol x its largest
        for got, want in zip(seen, want_p):
            for name_i, a, w in zip(model.leaf_names, got, want):
                np.testing.assert_allclose(
                    a.numpy(), w, rtol=1e-5,
                    atol=atol * max(1.0, float(np.abs(w).max())),
                    err_msg=name_i)
        return
    n_exempt = sum(int(e.sum()) for e in exempt)
    assert n_exempt <= 1e-3 * sum(e.size for e in exempt)
    for name_i, p, r, wp, wr, ex in zip(model.leaf_names, model.leaves(),
                                        fb.residual, want_p, want_r, exempt):
        keep = ~ex
        assert r.shape == p.shape
        np.testing.assert_allclose(p.detach().numpy()[keep], wp[keep],
                                   rtol=0, atol=atol, err_msg=name_i)
        np.testing.assert_allclose(r.numpy()[keep], wr[keep], rtol=1e-5,
                                   atol=atol, err_msg=name_i)
    for g, w in zip(got_m, want_m):
        assert abs(g["density"] - w["density"]) <= n_exempt / sum(
            e.size for e in exempt) + 1e-7
        assert 0.0 < g["density"] <= 1.25 * RHO
        np.testing.assert_allclose(g["var_ratio"], w["var_ratio"],
                                   rtol=1e-4)


# --- two gloo ranks against JAX's fsdp step on two fake devices -----------

ARCH2, B2, S2 = "phi3.5-moe-42b-a6.6b", 4, 16

JAX_TWO = r"""
import sys
import numpy as np
import repro                               # jax API shims first
import jax
import jax.numpy as jnp
from repro.configs import registry
from repro.core.api import CompressionConfig
from repro.dist import sharding as shd
from repro.optim import optimizers
from repro.train import step as step_lib

data = np.load(sys.argv[1])
names = [k[2:] for k in data.files if k.startswith("p/")]
tree = {}
for n in names:
    node = tree
    *path, leaf = n.split("/")
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(data["p/" + n])
spec = registry.get(sys.argv[3])
mesh = jax.make_mesh((2, 1), ("data", "model"))
rules = dict(shd.FSDP_RULES, **spec.rules_overrides)
opt = optimizers.sgd(1.0)
with jax.set_mesh(mesh):
    step = jax.jit(step_lib.make_fsdp_train_step(
        spec.smoke, CompressionConfig(name="none"), opt, mesh, rules))
    new, _, m = step(tree, opt.init(tree),
                     {"tokens": jnp.asarray(data["tokens"])},
                     jax.random.key(0))
out = {"loss": np.asarray(m["loss"])}
for path, x in jax.tree_util.tree_flatten_with_path(new)[0]:
    out["p/" + "/".join(k.key for k in path)] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""

PORT_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import registry
from repro_torch.core.api import CompressionConfig
from repro_torch.models.transformer import Transformer
from repro_torch.optim import optimizers
from repro_torch.train import step as step_lib

torch.set_num_threads(1)
rank, port, arch = int(sys.argv[1]), sys.argv[2], sys.argv[5]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
data = np.load(sys.argv[3])
params = {k[2:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("p/")}
tokens = torch.from_numpy(data["tokens"])
half = tokens.shape[0] // 2
model = Transformer(registry.get(arch).smoke, params)
opt = optimizers.sgd(1.0)
step = step_lib.make_fsdp_train_step(model, CompressionConfig(name="none"),
                                     opt)
_, m = step(opt.init(model.leaves()),
            {"tokens": tokens[rank * half:(rank + 1) * half]},
            torch.Generator())
out = {"loss": np.asarray(float(m["loss"]))}
out.update({"p/" + n: p.detach().numpy()
            for n, p in zip(model.leaf_names, model.leaves())})
np.savez(sys.argv[4], **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both gloo ranks and the JAX subprocess, run side by side: the
    params, the global batch and every side's new parameters and loss."""
    tmp = tmp_path_factory.mktemp("fsdp_two")
    params = {"p/" + k: v.numpy() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, _jax_params(ARCH2))).items()}
    tokens = np.random.default_rng(9).integers(0, 512, (B2, S2))
    np.savez(tmp / "in.npz", tokens=tokens, **params)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(REPO, "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_TWO, str(tmp / "in.npz"),
         str(tmp / "jax.npz"), ARCH2], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", PORT_RANK, str(r), str(port),
         str(tmp / "in.npz"), str(tmp / f"rank{r}.npz"), ARCH2], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return (np.load(tmp / "in.npz"), np.load(tmp / "jax.npz"),
            [np.load(tmp / f"rank{r}.npz") for r in range(2)])


def test_two_ranks_average_the_gradient_as_jax(two_ranks):
    """Each rank's change of every parameter (SGD at lr 1: the averaged
    gradient) equals JAX's over the global batch; the ranks agree bit for
    bit (the mean in worker order, the same update on each)."""
    inp, want, ranks = two_ranks
    names = [k for k in want.files if k.startswith("p/")]
    assert sorted(names) == sorted(k for k in ranks[0].files
                                   if k.startswith("p/"))
    for n in names:
        w = inp[n] - want[n]
        for r in ranks:
            np.testing.assert_allclose(
                inp[n] - r[n], w, rtol=1e-5,
                atol=2e-6 * max(1.0, float(np.abs(w).max())), err_msg=n)
        np.testing.assert_array_equal(ranks[0][n], ranks[1][n])
    assert any(np.abs(inp[n] - want[n]).max() > 0 for n in names
               if "router" in n)


def test_two_ranks_loss_is_the_global_batch_loss(two_ranks):
    """The mean of the ranks' losses (each with the load-balance term's
    ``ce`` over the global batch) is JAX's global loss."""
    _, want, ranks = two_ranks
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(want["loss"]),
                                   rtol=1e-5)
