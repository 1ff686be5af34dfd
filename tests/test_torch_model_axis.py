"""The model axis of the port's compressed step (``dist/sharding.py``,
``train.step``'s ``ModelAxis``, the launcher's ``--mesh DxM`` and
``PxDxM``) against the JAX package, on the CPU:

- ``param_axes`` equals the JAX ``split_params`` axes of every arch's
  smoke config, and ``resolve_spec`` equals the JAX one on an
  ``AbstractMesh`` for every leaf of every arch's full config, on the
  meshes (16, 16), (2, 16, 16), (4, 2), (2, 2) and (2, 1, 2), under the
  DP and FSDP rules with the arch's overrides, with ``with_pod`` on the
  pod meshes and with the manual axes stripped;
- a worker's slices tile every leaf once and ``place_slices`` puts them
  back (a property over random shapes and specs), and they are the
  blocks ``NamedSharding.devices_indices_map`` gives each device of a
  ``jax.make_mesh`` mesh, rank = the device's place in the mesh;
- JAX's real compressed step (``make_compressed_train_step``, one
  subprocess on four fake CPU devices, the reference backend) against the
  port's on four gloo ranks (one spawn), the weights carried across, on
  the gemma2-9b smoke config in float32 (heads, kv_heads, MLP and vocab
  split over the model axis, the norms whole), SGD 0.05: on (2
  data x 2 model) (i) top-k with EF on the gather wire, two steps; (ii)
  compression off on the dense wire; (iii) top-k adaptive with skipping
  and EF, three steps; on (2 pod x 1 data x 2 model) (iv) top-k with
  ``resparsify_pods`` and EF, two steps, and the same on (2 pod x 2 data x
  2 model) (eight gloo ranks), where the pod stage drops coordinates and
  its residual is not zero; the pod stage's streams one per (pod, model)
  index;
- gspar with EF on the gather wire on (2 x 2), one step, with the norms
  (the leaves left whole) compressed too, against a JAX
  step assembled from the JAX pieces as ``tests/test_torch_step.py``
  assembles it: ``ops.gspar_emit`` in interpret mode on each worker's
  shard, fed that worker's uniforms (re-drawn from an identically seeded
  generator), the scatter, the mean over the data workers per shard, and
  model index 0's synced value for a leaf left whole;
- the launcher at ``--mesh 2x2`` on the four ranks; a ``--mesh 1x2``
  checkpoint (two gloo ranks, a second spawn) with the global shapes of a
  JAX-written file, its resume bit-equal to an unbroken run where every
  whole leaf goes dense, and, where the norms are compressed, its restore
  handing both model workers model index 0's state of a whole leaf; at ``--mesh
  2x1`` the step bit-equal to the step without a mesh; the fsdp mode at a
  model axis running (``--mesh 1x2``, the two ranks; held to JAX in
  ``tests/test_torch_fsdp_mesh.py``) and ``impl="seq_parallel"``
  refused, naming item 10d.

Tolerances: parameters and residuals within atol 1e-6 of JAX (the two
frameworks' float32 gradients differ in the last digits; JAX's GSPMD and
the port's whole-gradient compute agree only up to the order of float
sums); wire bytes, bits and overflow exact; density and the skipped count
within 1e-6 relative. In the gspar case coordinates whose uniform lies
within 1e-5 of its keep probability are exempt (at most 0.1 % of them),
as in ``tests/test_torch_step.py``; in the top-k cases a pair of
coordinates whose target magnitudes tie within 1e-5 relative may swap
places in the last step's selection (``_near_ties``: at most 0.1 % of a
shard, and nothing else may differ).
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

import repro  # noqa: F401  (jax API shims first)
from repro.configs import registry as jregistry
from repro.core.api import CompressionConfig as JConfig
from repro.core.grouping import plan_tree as jplan_tree
from repro.dist import sharding as jshd
from repro.kernels.sparsify import ops as jops
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.train import step as jstep
from repro_torch.configs import registry as tregistry
from repro_torch.dist import sharding as tshd
from repro_torch.launch import train as tlaunch
from repro_torch.models.common import leaf_order
from repro_torch.models.transformer import param_axes, param_shapes

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # the container has no hypothesis
    given = None

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(tregistry.ID_TO_MODULE)
ARCH = "gemma2-9b"                # the step cases' smoke config (float32)
LR, MIN_LEAF, RHO = 0.05, 1024, 0.1
TOKENS = (3, 4, 16)               # steps x global batch x sequence
TOPK = dict(name="topk", rho=RHO, wire="gather", error_feedback=True,
            min_leaf_size=MIN_LEAF)
# name: (config, mesh (pods, data, model), steps)
CASES = {
    "topk_ef": (TOPK, (None, 2, 2), 2),
    "off": (dict(name="none", wire="dense", min_leaf_size=MIN_LEAF),
            (None, 2, 2), 1),
    "adaptive": (dict(TOPK, adaptive=True, skip_tau=1.5), (None, 2, 2), 2),
    "pods": (dict(TOPK, resparsify_pods=True), (2, 1, 2), 2),
    "pods_2x2x2": (dict(TOPK, resparsify_pods=True), (2, 2, 2), 2),
}
# under 256, the norms' size: the leaves left whole are compressed too,
# each model worker with its own stream
GSPAR = dict(name="gspar", rho=0.05, wire="gather", error_feedback=True,
             min_leaf_size=128)
ATOL = 1e-6


# ---------------------------------------------------------------------------
# the rules, the axes and the slices
# ---------------------------------------------------------------------------

def _jax_axes(cfg) -> dict:
    """Path -> axes of the JAX ``init_model``'s ``split_params``."""
    tree = jax.eval_shape(lambda k: jtf.init_model(k, cfg), jax.random.key(0))
    _, axes = split_params(tree)
    leaves = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda t: isinstance(t, tuple) and all(
            isinstance(e, (str, type(None))) for e in t))[0]
    return {"/".join(k.key for k in path): tuple(ax) for path, ax in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax(arch):
    cfg = tregistry.get(arch).smoke
    assert param_axes(cfg) == _jax_axes(jregistry.get(arch).smoke)


MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 1, 2), ("pod", "data", "model"))]


def _rule_sets(overrides: dict, pod: bool):
    """(name, port rules, JAX rules) of every set the test holds."""
    for mode in ("compressed", "fsdp"):
        base = dict(jshd.DP_RULES if mode == "compressed"
                    else jshd.FSDP_RULES, **overrides)
        jrules = jshd.with_pod(base) if pod else base
        trules = tshd.launcher_rules(mode, overrides, pod)
        yield mode, trules, jrules
        manual = ("pod", "data") if pod else ("data",)
        yield (mode + "/stripped", tshd.strip_manual(trules, manual),
               jstep._strip_manual(jrules, manual))


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_matches_jax(arch):
    spec = tregistry.get(arch)
    assert spec.rules_overrides == jregistry.get(arch).rules_overrides
    shapes, axes = param_shapes(spec.model), param_axes(spec.model)
    n = 0
    for sizes, names in MESHES:
        jmesh = jax.sharding.AbstractMesh(sizes, names)
        tsizes = dict(zip(names, sizes))
        for what, trules, jrules in _rule_sets(spec.rules_overrides,
                                               "pod" in names):
            for path, (shape, _) in shapes.items():
                want = tuple(jshd.resolve_spec(shape, axes[path], jrules,
                                               jmesh))
                got = tshd.resolve_spec(shape, axes[path], trules, tsizes)
                assert got == want, (arch, sizes, what, path)
                n += 1
    assert n == len(shapes) * 20


def _tiling_case(seed: int) -> None:
    """One random mesh, leaf shape and spec: the workers' slices cover each
    coordinate once per replica of the unused axes, and ``place_slices``
    of the blocks in rank order is the leaf."""
    rng = np.random.default_rng(seed)
    names = ("pod", "data", "model")[3 - int(rng.integers(1, 4)):]
    sizes = {a: int(rng.integers(1, 4)) for a in names}
    ndim = int(rng.integers(1, 4))
    free = list(names)
    rng.shuffle(free)
    spec, shape = [], []
    for _ in range(ndim):
        take = [a for a in free if rng.random() < 0.4]
        free = [a for a in free if a not in take]
        n = int(np.prod([sizes[a] for a in take])) if take else 1
        shape.append(n * int(rng.integers(1, 4)))
        spec.append(None if not take else take[0] if len(take) == 1
                    else tuple(take))
    spec, shape = tuple(spec), tuple(shape)
    leaf = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    world = int(np.prod([sizes[a] for a in names]))
    used = int(np.prod([sizes[a] for e in spec
                        for a in tshd._as_tuple(e)]))
    count = torch.zeros(shape, dtype=torch.int64)
    parts = []
    for r in range(world):
        sl = tshd.worker_slices(shape, spec, sizes,
                                tshd.mesh_coords(r, names, sizes))
        count[sl] += 1
        parts.append(leaf[sl].clone())
    assert torch.equal(count, torch.full(shape, world // used)), (spec,
                                                                   sizes)
    assert torch.equal(tshd.place_slices(parts, spec, sizes, names), leaf)


if given is not None:
    @settings(max_examples=60, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1))
    def test_worker_slices_tile_every_leaf(seed):
        _tiling_case(seed)
else:
    @pytest.mark.parametrize("seed", range(40))
    def test_worker_slices_tile_every_leaf(seed):
        _tiling_case(seed)


def _world(mesh) -> int:
    return int(np.prod([n or 1 for n in mesh]))


@pytest.mark.parametrize("mesh", [(2, 2, 2), (3, 2, 2), (2, 3, 1),
                                  (1, 4, 2), (None, 2, 2)])
def test_pod_streams_are_per_pod_and_model_shard(mesh):
    """The launcher's pod-stage generators (``pod_stream_seed``) draw the
    same uniforms on a pod's data workers and other ones on each (pod,
    model shard), as the JAX package's ``_pod_key``."""
    _, data, model = mesh
    draws: dict = {}
    for rank in range(_world(mesh)):
        gen = torch.Generator().manual_seed(
            tlaunch.pod_stream_seed(0, mesh, rank))
        draws.setdefault((rank // (data * model), rank % model), []).append(
            torch.rand(16, generator=gen))
    for us in draws.values():
        assert len(us) == data and all(torch.equal(us[0], u) for u in us)
    firsts = [us[0] for us in draws.values()]
    assert len(firsts) == _world(mesh) // data
    for i, a in enumerate(firsts):
        assert not any(torch.equal(a, b) for b in firsts[:i])


# ---------------------------------------------------------------------------
# the JAX side: one subprocess on eight fake CPU devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import sys
import numpy as np
import repro                               # jax API shims first
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.core.api import CompressionConfig
from repro.dist import sharding as shd
from repro.launch.mesh import make_mesh
from repro.models.common import split_params
from repro.models import transformer as tf
from repro.optim.optimizers import sgd
from repro.train import step as step_lib

inp = np.load(sys.argv[1])
cases, arch, lr = eval(sys.argv[3]), sys.argv[4], float(sys.argv[5])
spec = registry.get(arch)
cfg = spec.smoke
tmpl = jax.eval_shape(lambda k: split_params(tf.init_model(k, cfg))[0],
                      jax.random.key(0))
leaves, tdef = jax.tree_util.tree_flatten(tmpl)
params = jax.tree_util.tree_unflatten(
    tdef, [jnp.asarray(inp[f"p{i}"]) for i in range(len(leaves))])
tokens = inp["tokens"]
out = {}
for name, (kw, (pods, data, model), steps) in cases.items():
    multi_pod = pods is not None
    shape = (pods, data, model) if multi_pod else (data, model)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = make_mesh(shape, names)
    rules = dict(shd.DP_RULES, **spec.rules_overrides)
    if multi_pod:
        rules = shd.with_pod(rules)
    comp = CompressionConfig(backend="reference", **kw)
    opt = sgd(lr)
    with jax.set_mesh(mesh):
        ts = jax.jit(step_lib.make_compressed_train_step(
            cfg, comp, opt, mesh, rules, multi_pod=multi_pod))
        p, s = params, opt.init(params)
        ef = (step_lib.init_compressed_feedback(cfg, comp, mesh, multi_pod)
              if comp.error_feedback else None)
        ctl = (step_lib.init_compressed_control(cfg, comp, mesh, multi_pod)
               if comp.adaptive else None)
        for t in range(steps):
            batch = {"tokens": jnp.asarray(tokens[t])}
            key = jax.random.key(t)
            if ctl is not None:
                p, s, ef, ctl, m = ts(p, s, ef, ctl, batch, key)
            elif ef is not None:
                p, s, ef, m = ts(p, s, ef, batch, key)
            else:
                p, s, m = ts(p, s, batch, key)
            for k, v in m.items():
                out[f"{name}/m{t}/{k}"] = np.asarray(v, np.float64)
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{name}/params/{i}"] = np.asarray(x)
    if ef is not None:
        for i, x in enumerate(jax.tree.leaves(ef.residual)):
            out[f"{name}/residual/{i}"] = np.asarray(x)
        if ef.pod_residual is not None:
            for i, x in enumerate(jax.tree.leaves(ef.pod_residual)):
                out[f"{name}/pod_residual/{i}"] = np.asarray(x)
    if ctl is not None:
        for field in ("last_sent", "last_avg", "bound"):
            for i, x in enumerate(jax.tree.leaves(getattr(ctl, field))):
                out[f"{name}/{field}/{i}"] = np.asarray(x)
        out[f"{name}/step"] = np.asarray(ctl.step)
# each device's block of a leaf under a few specs, devices in mesh order
for shape, names in (((2, 2), ("data", "model")),
                     ((2, 1, 2), ("pod", "data", "model"))):
    mesh = make_mesh(shape, names)
    tag = "x".join(map(str, shape))
    for j, spec_ in enumerate(eval(sys.argv[6])):
        if any(a not in names for e in spec_ if e is not None
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        idx = NamedSharding(mesh, P(*spec_)).devices_indices_map((8, 12, 4))
        out[f"blocks/{tag}/{j}"] = np.asarray(
            [[(sl.start or 0) for sl in idx[d]] for d in mesh.devices.flat])
np.savez(sys.argv[2], **out)
"""

SPECS = [(None, "model", None), ("data", "model", None),
         (("data", "model"), None, None), (None, None, "model"),
         (("pod", "data"), "model", None), ("model", ("pod", "data"), None)]


# ---------------------------------------------------------------------------
# the port's side: four gloo ranks, eight, and two
# ---------------------------------------------------------------------------

def _groups(mesh):
    data_group, pod_group, pod = tlaunch.mesh_groups(mesh)
    model_group, m, ranks, worker_group = tlaunch.model_groups(mesh)
    return dict(group=data_group, pod_group=pod_group, pod=pod,
                model_group=model_group, m=m, ranks=ranks,
                worker_group=worker_group)


def _model(params: dict):
    from repro_torch.models.transformer import Transformer
    cfg = tregistry.get(ARCH).smoke
    return Transformer(cfg, {k: v.clone() for k, v in params.items()})


def _axis(model, mesh, g):
    return tshd.ModelAxis(
        size=mesh[2], index=g["m"], group=g["model_group"], ranks=g["ranks"],
        specs=tlaunch.leaf_specs(model.cfg, model.leaf_names,
                                 tregistry.get(ARCH).rules_overrides, mesh))


def run_case(kw: dict, mesh, g: dict, rank: int, params: dict,
             tokens: np.ndarray, steps: int, opt_name: str = "sgd",
             gen_seed=None) -> dict:
    """``steps`` steps of the port's compressed step on this rank: the
    batch rows of its data worker, its generator seeded from its rank.
    Returns its parameters (whole), its states (shards) and the metrics;
    under ``adaptive`` each step's unreduced skip flags. ``mesh`` None:
    the step without a model axis, every rank a data worker."""
    import torch.distributed as dist
    from repro_torch.comm import sync
    from repro_torch.core.api import CompressionConfig
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    pods, data, n_model = mesh or (None, dist.get_world_size(), 1)
    model = _model(params)
    ma = tshd.WHOLE if mesh is None else _axis(model, mesh, g)
    comp = CompressionConfig(**kw)
    opt = topt.sgd(LR) if opt_name == "sgd" else topt.adam(1e-3)
    leaves = tstep.worker_leaves(model, ma)
    state = opt.init(leaves)
    hier = comp.resparsify_pods and g["pod_group"] is not None
    fb = topt.init_feedback(leaves, pod=hier) if comp.error_feedback else None
    ctl = (tstep.init_compressed_control(model, comp, ma)
           if comp.adaptive else None)
    pod_gen = (torch.Generator().manual_seed(
        tlaunch.pod_stream_seed(0, mesh, rank)) if hier else None)
    step = tstep.make_compressed_train_step(
        model, comp, opt, group=g["group"], pod_group=g["pod_group"],
        pod_generator=pod_gen, model_axis=ma,
        worker_group=g["worker_group"])
    gen = torch.Generator().manual_seed(
        1000 + rank if gen_seed is None else gen_seed)
    w, b = rank // n_model, tokens.shape[1] // ((pods or 1) * data)
    flags, real = [], sync._delta_and_skips

    def spy(*a, **k):
        send, fl, bounds = real(*a, **k)
        flags.append([bool(f) for f in fl])
        return send, fl, bounds

    sync._delta_and_skips = spy
    metrics = []
    try:
        for t in range(steps):
            batch = {"tokens": torch.from_numpy(
                tokens[t][w * b:(w + 1) * b].copy())}
            if ctl is not None:
                state, fb, ctl, m = step(state, fb, ctl, batch, gen)
            elif fb is not None:
                state, fb, m = step(state, fb, batch, gen)
            else:
                state, m = step(state, batch, gen)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        sync._delta_and_skips = real
    out = {"params": [p.detach().numpy().copy() for p in model.leaves()],
           "metrics": metrics, "flags": flags,
           "specs": list(ma.specs)}
    if fb is not None:
        out["residual"] = [r.numpy().copy() for r in fb.residual]
        if fb.pod_residual is not None:
            out["pod_residual"] = [r.numpy().copy() for r in fb.pod_residual]
    if ctl is not None:
        for field in ("last_sent", "last_avg", "bound"):
            out[field] = [x.numpy().copy() for x in getattr(ctl, field)]
        out["step"] = ctl.step
    return out


def _inputs(path: str):
    inp = np.load(path)
    names = leaf_order(param_shapes(tregistry.get(ARCH).smoke))
    params = {n: torch.from_numpy(inp[f"p{i}"].copy())
              for i, n in enumerate(names)}
    return params, inp["tokens"]


def four_ranks(rank: int, path: str) -> dict:
    """Every four-rank case on this rank of a running gloo group."""
    import contextlib
    import io
    params, tokens = _inputs(path)
    groups = {mesh: _groups(mesh) for mesh in ((None, 2, 2), (2, 1, 2))}
    res = {name: run_case(kw, mesh, groups[mesh], rank, params, tokens,
                          steps)
           for name, (kw, mesh, steps) in CASES.items()
           if _world(mesh) == 4}
    res["gspar"] = run_case(GSPAR, (None, 2, 2), groups[(None, 2, 2)], rank,
                            params, tokens, 1)
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--device", "cpu",
            "--wire", "gather", "--error-feedback", "--mesh", "2x2",
            "--log-every", "1"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res["launcher"] = tlaunch.main(argv)
        res["launcher_overlap"] = tlaunch.main(argv + ["--exchange",
                                                       "overlap"])
    res["launcher_out"] = buf.getvalue()
    return res


def eight_ranks(rank: int, path: str) -> dict:
    """The eight-rank cases on this rank of a running gloo group."""
    params, tokens = _inputs(path)
    return {name: run_case(kw, mesh, _groups(mesh), rank, params, tokens,
                           steps)
            for name, (kw, mesh, steps) in CASES.items()
            if _world(mesh) == 8}


def two_ranks(rank: int, path: str, tmp: str) -> dict:
    """The two-rank cases: the step at ``--mesh 2x1`` against the step
    without a mesh, and the ``--mesh 1x2`` checkpoint and its resume."""
    import contextlib
    import io
    from repro_torch.checkpoint import checkpoint as tckpt
    from repro_torch.core.api import CompressionConfig
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    params, tokens = _inputs(path)
    res = {}
    nomesh = dict(group=None, pod_group=None, pod=0, model_group=None, m=0,
                  ranks=(rank,), worker_group=None)
    g21 = _groups((None, 2, 1))
    kw = dict(GSPAR, adaptive=True, skip_tau=0.7)
    res["mesh_2x1"] = run_case(kw, (None, 2, 1), g21, rank, params, tokens,
                               3, "adam")
    res["no_mesh"] = run_case(kw, None, nomesh, rank, params, tokens, 3,
                              "adam")
    # --mesh 1x2: three steps unbroken; one, a save, a restore into fresh
    # state (zero moments, residual and control, other weights) and two;
    # every whole leaf dense (MIN_LEAF over the norms' size). "whole": the
    # norms compressed too, one step, a save and a restore
    mesh = (None, 1, 2)
    g12 = _groups(mesh)
    runs = {}

    def held(model, state, fb, ctl):
        return {
            "params": [p.detach().numpy().copy() for p in model.leaves()],
            "m": [x.numpy().copy() for x in state["m"]],
            "v": [x.numpy().copy() for x in state["v"]],
            "residual": [x.numpy().copy() for x in fb.residual],
            "last_sent": [x.numpy().copy() for x in ctl.last_sent],
            "last_avg": [x.numpy().copy() for x in ctl.last_avg],
            "bound": [x.numpy().copy() for x in ctl.bound],
            "steps": (state["step"], ctl.step)}

    for name in ("unbroken", "resumed", "whole"):
        comp = CompressionConfig(**(kw if name == "whole" else
                                    dict(kw, min_leaf_size=MIN_LEAF)))
        model = _model(params)
        ma = _axis(model, mesh, g12)
        opt = topt.adam(1e-3)
        make = functools.partial(
            tstep.make_compressed_train_step, comp=comp, opt=opt,
            group=g12["group"], model_axis=ma)

        def fresh(model):
            leaves = tstep.worker_leaves(model, ma)
            return (opt.init(leaves), topt.init_feedback(leaves),
                    tstep.init_compressed_control(model, comp, ma),
                    make(model))

        state, fb, ctl, step = fresh(model)
        for t in range(1 if name == "whole" else 3):
            if name == "resumed" and t == 1:
                ck = os.path.join(tmp, "ck12")
                tckpt.save(ck, model, state, fb, ctl, mesh=mesh,
                           model_axis=ma, extra={"steps": 1})
                with torch.no_grad():
                    for p in model.leaves():
                        p.add_(1.0)
                state, fb, ctl, step = fresh(model)
                state, fb, ctl = tckpt.restore(ck, model, state, fb, ctl,
                                               mesh=mesh, model_axis=ma)
            batch = {"tokens": torch.from_numpy(tokens[t][:4].copy())}
            gen = torch.Generator().manual_seed(200 + 7 * t + rank)
            state, fb, ctl, _ = step(state, fb, ctl, batch, gen)
        runs[name] = held(model, state, fb, ctl)
        if name == "whole":
            ck = os.path.join(tmp, "ck12_whole")
            tckpt.save(ck, model, state, fb, ctl, mesh=mesh, model_axis=ma)
            with torch.no_grad():
                for p in model.leaves():
                    p.add_(1.0)
            state, fb, ctl, _ = fresh(model)
            state, fb, ctl = tckpt.restore(ck, model, state, fb, ctl,
                                           mesh=mesh, model_axis=ma)
            runs["whole_restored"] = held(model, state, fb, ctl)
            runs["whole_specs"] = list(ma.specs)
    res.update(runs)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res["fsdp_1x2"] = tlaunch.main(
            ["--arch", "gemma-2b", "--smoke", "--steps", "1", "--device",
             "cpu", "--mode", "fsdp", "--mesh", "1x2", "--error-feedback"])
    return res


WORKER = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_model_axis as t

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
res = (t.two_ranks(rank, sys.argv[6], sys.argv[7]) if world == 2
       else {4: t.four_ranks, 8: t.eight_ranks}[world](rank, sys.argv[6]))
torch.save(res, out)
dist.destroy_process_group()
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, tmp, inputs: str, env: dict):
    port = _port()
    outs = [str(tmp / f"w{world}_rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         outs[r], os.path.dirname(os.path.abspath(__file__)), inputs,
         str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return procs, outs


def _collect(procs, outs) -> list:
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX steps (one subprocess, eight fake CPU devices), the port's
    four-rank, two-rank and eight-rank spawns, side by side; the inputs:
    the JAX init's weights (key 0) and the tokens of three steps. Returns
    (four ranks, two ranks, JAX, inputs, tmp, eight ranks)."""
    tmp = tmp_path_factory.mktemp("model_axis")
    cfg = jregistry.get(ARCH).smoke
    params = jax.jit(lambda k: split_params(jtf.init_model(k, cfg))[0])(
        jax.random.key(0))
    inputs = {f"p{i}": np.asarray(x)
              for i, x in enumerate(jax.tree.leaves(params))}
    inputs["tokens"] = np.random.default_rng(8).integers(
        0, cfg.vocab, TOKENS).astype(np.int32)
    path = str(tmp / "in.npz")
    np.savez(path, **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, path, str(tmp / "jax.npz"),
         repr(CASES), ARCH, repr(LR), repr(SPECS)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    four = _spawn(4, tmp, path, env)
    two = _spawn(2, tmp, path, env)
    ranks4, ranks2 = _collect(*four), _collect(*two)
    ranks8 = _collect(*_spawn(8, tmp, path, env))
    log = jax_proc.communicate(timeout=400)[0]
    assert jax_proc.returncode == 0, log
    return (ranks4, ranks2, dict(np.load(tmp / "jax.npz")), inputs, str(tmp),
            ranks8)


def test_rank_order_is_the_jax_device_order(results):
    """``worker_slices`` at rank r's coordinates (``mesh_coords``, the last
    axis minor) is the block ``NamedSharding.devices_indices_map`` gives
    the r-th device of ``jax.make_mesh``'s mesh."""
    jx = results[2]
    n = 0
    for sizes, names in (((2, 2), ("data", "model")),
                         ((2, 1, 2), ("pod", "data", "model"))):
        tag = "x".join(map(str, sizes))
        size = dict(zip(names, sizes))
        for j, spec in enumerate(SPECS):
            key = f"blocks/{tag}/{j}"
            if key not in jx:
                continue
            for r, starts in enumerate(jx[key]):
                sl = tshd.worker_slices((8, 12, 4), spec, size,
                                        tshd.mesh_coords(r, names, size))
                assert [s.start for s in sl] == list(starts), (tag, spec, r)
            n += 1
    assert n == 10


def _block(full: np.ndarray, spec: tuple, m: int) -> np.ndarray:
    return full[tshd.worker_slices(full.shape, spec, {"model": 2},
                                   {"model": m})]


def _ranks(results, name: str) -> list:
    """The port's ranks that ran case ``name``."""
    return results[5] if _world(CASES[name][1]) == 8 else results[0]


def _near_ties(results, name: str) -> dict:
    """Per (leaf, model index), the coordinates where the two sides' last
    top-k choice differs on a near-tie: a worker's residuals differ past
    ATOL only in pairs of coordinates whose target magnitudes (the
    residual of the side that kept it) agree within 1e-5 relative, at most
    0.1 % of the shard. Such a swap follows from the frameworks'
    last-digit gradient differences; the test fails on any other
    mismatch."""
    ranks, jx = _ranks(results, name), results[2]
    n_model = CASES[name][1][2]
    out = {}
    for rank in range(len(ranks)):
        got = ranks[rank][name]
        w, m = divmod(rank, n_model)
        for i, spec in enumerate(got["specs"]):
            a = got["residual"][i]
            b = _block(jx[f"{name}/residual/{i}"][w], spec, m)
            bad = np.abs(a - b) > ATOL
            if bad.any():
                tie = np.maximum(np.abs(a), np.abs(b))[bad]
                assert bad.sum() % 2 == 0 and bad.sum() <= 1e-3 * a.size, \
                    (name, rank, i, int(bad.sum()))
                assert tie.max() - tie.min() <= 1e-5 * tie.max(), \
                    (name, rank, i, tie)
            out[i, m] = out.get((i, m), False) | bad
    return out


def _check_case(results, name: str) -> None:
    ranks, jx = _ranks(results, name), results[2]
    kw, (pods, data, n_model), steps = CASES[name]
    n_leaves = len(ranks[0][name]["params"])
    ties = _near_ties(results, name) if kw.get("error_feedback") else {}
    for rank in range(len(ranks)):
        got = ranks[rank][name]
        w, m = divmod(rank, n_model)
        for i in range(n_leaves):
            spec = got["specs"][i]
            keep = ~ties.get((i, m), np.zeros(_block(
                got["params"][i], spec, m).shape, bool))
            np.testing.assert_allclose(
                _block(got["params"][i], spec, m)[keep],
                _block(jx[f"{name}/params/{i}"], spec, m)[keep], rtol=0,
                atol=ATOL, err_msg=f"{name} {i}")
            for field, row in (("residual", w), ("last_sent", w),
                               ("pod_residual", w // data)):
                if field in got:
                    np.testing.assert_allclose(
                        got[field][i][keep],
                        _block(jx[f"{name}/{field}/{i}"][row], spec,
                               m)[keep],
                        rtol=0, atol=ATOL, err_msg=f"{name} {field} {i}")
            if "last_avg" in got:
                np.testing.assert_allclose(
                    got["last_avg"][i][keep],
                    _block(jx[f"{name}/last_avg/{i}"], spec, m)[keep],
                    rtol=0, atol=ATOL, err_msg=f"{name} last_avg {i}")
                np.testing.assert_allclose(
                    got["bound"][i], jx[f"{name}/bound/{i}"][w], rtol=1e-5,
                    err_msg=f"{name} bound {i}")
        for t in range(steps):
            mt = got["metrics"][t]
            for key in ("wire_bytes", "wire_bytes_intra", "wire_bytes_inter",
                        "bits", "overflow"):
                assert mt[key] == float(jx[f"{name}/m{t}/{key}"]), \
                    (name, rank, t, key)
            for key in ("density", "skipped", "loss"):
                np.testing.assert_allclose(
                    mt[key], float(jx[f"{name}/m{t}/{key}"]), rtol=1e-6,
                    err_msg=f"{name} {t} {key}")


def test_topk_with_ef_matches_the_jax_step(results):
    _check_case(results, "topk_ef")
    got = results[0][0]["topk_ef"]
    assert any(s != (None,) * len(s) for s in got["specs"])
    assert any(np.abs(r).sum() > 0 for r in got["residual"])


def test_compression_off_matches_the_jax_step(results):
    _check_case(results, "off")


def test_adaptive_skips_are_uniform_over_shards_and_match_jax(results):
    """(iii): the control state and residual as JAX's, and each leaf's skip
    flag the same on both model workers of a data worker, some leaves
    skipped and some sent."""
    _check_case(results, "adaptive")
    ranks = results[0]
    for w in range(2):
        a, b = ranks[2 * w]["adaptive"], ranks[2 * w + 1]["adaptive"]
        assert a["flags"] == b["flags"] and len(a["flags"]) == 2
    skipped = [f for r in ranks for step in r["adaptive"]["flags"]
               for f in step]
    assert any(skipped) and not all(skipped)
    assert ranks[0]["adaptive"]["step"] == int(results[2]["adaptive/step"])


def test_pod_stage_per_shard_matches_the_jax_step(results):
    _check_case(results, "pods")
    # at one data worker a pod's average is that worker's top k, which the
    # pod stage keeps whole: its residual stays exactly zero, as JAX's
    got = results[0][0]["pods"]
    assert all(np.abs(r).sum() == 0 for r in got["pod_residual"])
    assert all(m["wire_bytes_inter"] > 0 for m in got["metrics"])


def test_pod_stage_drops_and_matches_the_jax_step_on_2x2x2(results):
    """(iv) on (2 pod x 2 data x 2 model), eight gloo ranks against eight
    fake devices: a pod's average of its two data workers' top k holds
    more than the pod stage keeps, so each shard's pod residual is not
    zero; it, the worker residual, the parameters and the bytes are
    JAX's. A pod's two data workers carry the same pod residual."""
    _check_case(results, "pods_2x2x2")
    ranks = results[5]
    for rank in range(8):
        got = ranks[rank]["pods_2x2x2"]
        assert any(np.abs(r).sum() > 0 for r in got["pod_residual"]), rank
        twin = ranks[rank ^ 2]["pods_2x2x2"]     # the pod's other data worker
        for a, b in zip(got["pod_residual"], twin["pod_residual"]):
            np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _emit(k_cap: int, rho: float):
    return jax.jit(jax.vmap(functools.partial(
        jops.gspar_emit, u_cod=None, k_cap=k_cap, rho=rho, ef=True,
        interpret=True)))


def test_gspar_matches_the_assembled_jax_step(results):
    """One gspar step with EF on (2 x 2) against the JAX pieces: each
    worker's JAX gradient of its batch rows, its shard of every leaf,
    Algorithm 3's emit on each sparse group with the uniforms its port
    generator drew (seeded 1000 + rank, one [rows, d] draw a group in plan
    order), the scatter, the float32 mean over the two data workers, model
    index 0's synced value for a leaf left whole, and SGD."""
    ranks, inputs = results[0], results[3]
    cfg = jregistry.get(ARCH).smoke
    leaves0 = [inputs[f"p{i}"] for i in range(len(ranks[0]["gspar"]
                                                    ["params"]))]
    tdef = jax.tree_util.tree_structure(jax.eval_shape(
        lambda k: split_params(jtf.init_model(k, cfg))[0], jax.random.key(0)))
    params = jax.tree_util.tree_unflatten(tdef, [jnp.asarray(x)
                                                 for x in leaves0])
    stacked = [s[1] for s in (param_shapes(tregistry.get(ARCH).smoke)[n]
                              for n in leaf_order(param_shapes(
                                  tregistry.get(ARCH).smoke)))]
    grad_fn = jax.jit(jax.grad(jstep.make_loss_fn(cfg)))
    specs = ranks[0]["gspar"]["specs"]
    synced, res, exempt = {}, {}, {}
    for rank in range(4):
        w, m = divmod(rank, 2)
        toks = inputs["tokens"][0][2 * w:2 * w + 2]
        grads = [np.asarray(g) for g in jax.tree.leaves(
            grad_fn(params, {"tokens": jnp.asarray(toks)}))]
        shards = [_block(g, s, m) for g, s in zip(grads, specs)]
        plan = jplan_tree(JConfig(**GSPAR), shards, stacked)
        gen = torch.Generator().manual_seed(1000 + rank)
        out = [None] * len(shards)
        r_out = [np.zeros_like(s) for s in shards]
        ex = [np.zeros(s.shape, bool) for s in shards]
        for grp in plan.groups:
            if grp.kind == "dense":
                for i, _ in grp.members:
                    out[i] = shards[i]
                continue
            stack = np.concatenate([shards[i].reshape(rows, grp.d)
                                    for i, rows in grp.members])
            u = torch.rand((grp.rows, grp.d), generator=gen,
                           dtype=torch.float32).numpy()
            er, lam = _emit(grp.k_cap, GSPAR["rho"])(jnp.asarray(stack),
                                                     jnp.asarray(u))
            dense = np.zeros((grp.rows, grp.d), np.float32)
            for r in range(grp.rows):
                np.add.at(dense[r], np.asarray(er.idx[r]),
                          np.asarray(er.values[r], np.float32))
            near = np.abs(u - np.minimum(np.asarray(lam)[:, None]
                                         * np.abs(stack), 1.0)) < 1e-5
            r0 = 0
            for i, rows in grp.members:
                sl = slice(r0, r0 + rows)
                out[i] = dense[sl].reshape(shards[i].shape)
                r_out[i] = np.asarray(er.residual[sl]).reshape(
                    shards[i].shape)
                ex[i] = near[sl].reshape(shards[i].shape)
                r0 += rows
        synced[rank], res[rank], exempt[rank] = out, r_out, ex
    n_ex = n_all = 0
    for i, spec in enumerate(specs):
        for m in range(2):
            src = m if tshd.is_split(spec) else 0
            mean = (synced[src][i] + synced[2 + src][i]) / np.float32(2)
            want_p = _block(leaves0[i], spec, m) - np.float32(LR) * mean
            ex_p = exempt[src][i] | exempt[2 + src][i]
            for w in range(2):
                rank = 2 * w + m
                got = ranks[rank]["gspar"]
                keep = ~ex_p
                np.testing.assert_allclose(
                    _block(got["params"][i], spec, m)[keep], want_p[keep],
                    rtol=0, atol=ATOL, err_msg=f"params {i} rank {rank}")
                keep_r = ~exempt[rank][i]
                np.testing.assert_allclose(
                    got["residual"][i][keep_r], res[rank][i][keep_r],
                    rtol=1e-5, atol=ATOL, err_msg=f"residual {i} {rank}")
                n_ex += int(exempt[rank][i].sum())
                n_all += exempt[rank][i].size
    assert n_ex <= 1e-3 * n_all
    # the norms were compressed, each model worker's own way: the broadcast
    # of model index 0's value is what makes the two model workers agree
    whole = [i for i, spec in enumerate(specs) if not tshd.is_split(spec)]
    assert whole and all(np.asarray(res[0][i]).any() for i in whole)
    assert any(not np.array_equal(synced[w][i], synced[w + 1][i])
               for i in whole for w in (0, 2))
    for rank in range(4):
        mt = ranks[rank]["gspar"]["metrics"][0]
        assert mt["overflow"] == 0 and 0 < mt["density"] <= 1.25 * 0.05


def test_launcher_trains_at_mesh_2x2(results):
    """``--mesh 2x2`` on four gloo ranks trains and prints the mesh; with
    ``--exchange overlap`` its metrics are the sync exchange's."""
    ranks = results[0]
    out = ranks[0]["launcher_out"]
    assert "mesh=(data=2, model=2)" in out and "workers=4" in out
    ms = ranks[0]["launcher"]["metrics"]
    assert len(ms) == 2 and all(np.isfinite(m["loss"]) and m["wire_bytes"]
                                > 0 for m in ms)
    for r in range(1, 4):            # every worker reports the same means
        assert ranks[r]["launcher"]["metrics"] == ms
    # a group's rows are the shard's: gemma2-9b's mlp (512) split in two
    assert any(d == 256 * 256 for _, d, _, _ in ranks[0]["launcher"]
               ["layouts"])
    # the overlapped exchange of the shards is the sync one's, bit for bit
    assert ranks[0]["launcher_overlap"]["metrics"] == ms


def test_mesh_2x1_is_the_step_without_a_mesh(results):
    """At a model axis of one the model-axis path (its groups, the shards
    that are the leaves, the reductions over one worker) gives the same
    bits as the step without a mesh: adaptive gspar with EF, Adam, three
    steps, on two gloo ranks."""
    for r in results[1]:
        a, b = r["mesh_2x1"], r["no_mesh"]
        assert a["metrics"] == b["metrics"] and a["flags"] == b["flags"]
        for field in ("params", "residual", "last_sent", "last_avg",
                      "bound"):
            for x, y in zip(a[field], b[field]):
                np.testing.assert_array_equal(x, y, err_msg=field)


def test_checkpoint_at_mesh_1x2_is_global_and_resumes(results):
    """The ``--mesh 1x2`` file holds the global arrays of a JAX-written file
    of the same state (keys, order, shapes, dtypes: the moments and
    last_avg whole, the residual and last_sent stacked over one worker,
    the bound over one), and the run resumed from it is bit-equal to the
    unbroken one on both ranks."""
    from repro.checkpoint import checkpoint as jckpt
    from repro.optim import optimizers as jopt
    ranks2, tmp = results[1], results[4]
    cfg = jregistry.get(ARCH).smoke
    params = jax.eval_shape(lambda k: split_params(jtf.init_model(k, cfg))[0],
                            jax.random.key(0))
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), params)
    tree = {"params": zeros, "opt": jopt.adam(1e-3).init(zeros),
            "ef": jopt.init_feedback(zeros, num_workers=1),
            "ctl": jopt.init_control(zeros, 1)}
    jpath = os.path.join(tmp, "jax_ck")
    jckpt.save(jpath, tree)
    with np.load(jpath + ".npz") as want, \
            np.load(os.path.join(tmp, "ck12.npz")) as got:
        assert list(got.keys()) == list(want.keys())
        for key in want.keys():
            assert (got[key].dtype, got[key].shape) == \
                (want[key].dtype, want[key].shape), key
    back = jckpt.restore(os.path.join(tmp, "ck12"), tree)
    assert int(back["opt"]["step"]) == 1 and int(back["ctl"].step) == 1
    for r in ranks2:
        a, b = r["unbroken"], r["resumed"]
        assert a["steps"] == b["steps"] == (3, 3)
        for field in ("params", "m", "v", "residual", "last_sent",
                      "last_avg", "bound"):
            for x, y in zip(a[field], b[field]):
                np.testing.assert_array_equal(x, y, err_msg=field)


def test_checkpoint_at_mesh_1x2_keeps_model_index_0s_whole_leaves(results):
    """With the norms compressed, each of the two model workers holds its
    own residual and ``last_sent`` of a whole leaf, and the JAX file holds
    one replica: a restore hands both model workers model index 0's state
    of a whole leaf, and each its own shard of a split one (ROADMAP.md
    queue C). The whole leaves' parameters agree on both workers."""
    before = [r["whole"] for r in results[1]]
    after = [r["whole_restored"] for r in results[1]]
    specs = results[1][0]["whole_specs"]
    whole = [i for i, spec in enumerate(specs) if not tshd.is_split(spec)]
    assert whole and len(whole) < len(specs)
    assert any(not np.array_equal(before[0]["residual"][i],
                                  before[1]["residual"][i]) for i in whole)
    for i in whole:
        np.testing.assert_array_equal(before[0]["params"][i],
                                      before[1]["params"][i])
    for rank in range(2):
        assert after[rank]["steps"] == before[rank]["steps"] == (1, 1)
        for field in ("params", "m", "v", "residual", "last_sent",
                      "last_avg", "bound"):
            for i, (x, y) in enumerate(zip(after[rank][field],
                                           before[rank][field])):
                want = y if tshd.is_split(specs[i]) or field == "params" \
                    else before[0][field][i]
                np.testing.assert_array_equal(x, want,
                                              err_msg=f"{field} {i} {rank}")


def test_fsdp_runs_at_mesh_1x2(results):
    """The fsdp mode at a model axis (``--mode fsdp --mesh 1x2``) runs on
    the two ranks: the split step on each rank's blocks, the metrics equal
    on both, each rank holding under the whole model's parameter bytes."""
    ranks = results[1]
    outs = [r["fsdp_1x2"] for r in ranks]
    whole = sum(int(np.prod(s)) for s, _ in param_shapes(
        tregistry.get("gemma-2b").smoke).values()) * 4
    for o in outs:
        assert o["mode"] == "fsdp" and o["step"] == "split"
        assert o["metrics"] == outs[0]["metrics"]
        assert all(np.isfinite(m["loss"]) for m in o["metrics"])
        assert whole / 2 <= o["param_bytes"] < whole


def test_seq_parallel_is_refused():
    from repro_torch.models.attention import AttnConfig
    with pytest.raises(NotImplementedError, match="item 10d"):
        AttnConfig(d_model=8, num_heads=2, num_kv_heads=1, head_dim=4,
                   impl="seq_parallel")


def test_stats_reduce_over_the_model_axis():
    """``reduce_over_model``: the totals summed in rank order, the ratios'
    mean an IEEE quotient, each in its field's dtype, the layouts kept."""
    from repro_torch.comm.sync import SyncStats
    from repro_torch.train.step import (MODEL_SUMS, reduce_over_model,
                                        stats_vector)
    rng = np.random.default_rng(0)

    def stats(seed):
        r = np.random.default_rng(seed)
        vals = {f: torch.tensor(float(r.integers(0, 10**6)) if f in
                                MODEL_SUMS else float(r.random()),
                                dtype=torch.float64 if f.startswith("wire")
                                else torch.float32)
                for f in SyncStats.FIELDS}
        return SyncStats(**vals, layouts=((4, 8, 2, "coo"),))

    shards = [stats(int(s)) for s in rng.integers(0, 100, 3)]
    got = reduce_over_model(torch.stack([stats_vector(s) for s in shards]),
                            shards[0])
    assert got.layouts == shards[0].layouts
    for f in SyncStats.FIELDS:
        x = [getattr(s, f) for s in shards]
        want = (x[0] + x[1]) + x[2]
        if f not in MODEL_SUMS:
            want = want / torch.full((), 3, dtype=want.dtype)
        assert getattr(got, f).dtype == x[0].dtype
        assert torch.equal(getattr(got, f), want), f
