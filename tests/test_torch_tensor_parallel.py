"""The model axis's compute split for the dense decoders
(``dist/tensor_parallel.py``, the split step of ``train.step``) against the
JAX package, on the CPU:

- JAX's real compressed step (``make_compressed_train_step`` under GSPMD,
  one subprocess on four fake CPU devices, the reference backend) against
  the port's split step on gloo ranks (a two-rank and a four-rank spawn),
  the weights carried across (``convert.shards_from_numpy``), float32
  smoke configs, top-k with EF on the gather wire, SGD 0.05, two steps:
  gemma2-9b at ``1x2`` (heads and kv heads split) and ``1x4`` (its 2 kv
  heads stay whole: each worker's share of ``wk``/``wv``'s gradient,
  summed over the model workers), gemma-2b at ``1x2`` and ``2x2`` (the
  head_dim rules, MQA: the attention leaves gathered), starcoder2-7b at
  ``1x2`` (head_dim 42, the biases, ``bo`` and ``down_b`` added once,
  LayerNorm, the plain MLP). Each rank's parameters and residual shards
  and the metrics against JAX's; its step-1 gradient shards against the
  gathered step's (a whole model, the same ranks and batch); its
  parameter bytes equal to the sum of its shards' bytes;
- the autograd functions in float64 on two ranks against the whole
  computation: the split gated and plain MLPs, the attention split over
  heads (kv heads split, and whole: MQA) and gathered over head_dim, each
  forward and the gradient of every input and leaf; the vocab-parallel
  embedding bit-equal and its table gradient; the vocab-parallel cross
  entropy and its logits gradient;
- the launcher's step by arch (split for every arch past one model
  worker, whole at one; ``plan_split`` plans every full config at 2 and 4
  model workers) and its ``step=`` line on two ranks;
- a split run's ``--mesh 1x2`` checkpoint: the file the gathered step
  writes for the same parameters and states, entry for entry, and a
  resume from it bit-equal to an unbroken run.

Tolerances: parameters and residuals within atol 1e-6 of JAX
(starcoder2 4e-6: ``tests/test_torch_archs.py``'s ``STEP_ATOL`` for its
two-step residual, whose float32 gradient differs from JAX's by that
much with the whole model too), with
``tests/test_torch_model_axis.py``'s only exemption (a pair of
coordinates whose target magnitudes tie within 1e-5 relative may swap
places in the last step's top-k choice: at most 0.1 % of a shard); wire
bytes, bits and overflow exact; density and loss within 1e-6 relative;
the split step's gradient shards within 1e-6 of the gathered step's (the
same function, the float sums in another order); the float64 functions
within 1e-12.
"""
import contextlib
import functools
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
from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro_torch.configs import registry as tregistry
from repro_torch.dist import sharding as tshd
from repro_torch.dist import tensor_parallel as ttp
from repro_torch.launch import train as tlaunch
from repro_torch.models.common import leaf_order
from repro_torch.models.transformer import param_shapes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, MIN_LEAF, RHO, ATOL = 0.05, 1024, 0.1, 1e-6
TOKENS = (2, 4, 16)               # steps x global batch x sequence
TOPK = dict(name="topk", rho=RHO, wire="gather", error_feedback=True,
            min_leaf_size=MIN_LEAF)
# name: (arch, mesh (pods, data, model), steps)
CASES = {"g9_1x2": ("gemma2-9b", (None, 1, 2), 2),
         "g9_1x4": ("gemma2-9b", (None, 1, 4), 2),
         "g2_1x2": ("gemma-2b", (None, 1, 2), 2),
         "g2_2x2": ("gemma-2b", (None, 2, 2), 2),
         "sc_1x2": ("starcoder2-7b", (None, 1, 2), 2)}
ARCHS = sorted({a for a, _, _ in CASES.values()})
# atol against JAX (``tests/test_torch_archs.py``'s ``STEP_ATOL``)
JAX_ATOL = {"gemma2-9b": ATOL, "gemma-2b": ATOL, "starcoder2-7b": 4e-6}


def _world(mesh) -> int:
    return int(np.prod([n or 1 for n in mesh]))


# ---------------------------------------------------------------------------
# the JAX side: one subprocess on four fake CPU devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import sys
import numpy as np
import repro                               # jax API shims first
import jax
import jax.numpy as jnp
from repro.configs import registry
from repro.core.api import CompressionConfig
from repro.dist import sharding as shd
from repro.launch.mesh import make_mesh
from repro.models.common import split_params
from repro.models import transformer as tf
from repro.optim.optimizers import sgd
from repro.train import step as step_lib

cases, kw, lr = eval(sys.argv[3]), eval(sys.argv[4]), float(sys.argv[5])
out = {}
for name, (arch, (_, data, model), steps) in cases.items():
    inp = np.load(f"{sys.argv[1]}/{arch}.npz")
    spec = registry.get(arch)
    cfg = spec.smoke
    tmpl = jax.eval_shape(lambda k: split_params(tf.init_model(k, cfg))[0],
                          jax.random.key(0))
    leaves, tdef = jax.tree_util.tree_flatten(tmpl)
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(inp[f"p{i}"]) for i in range(len(leaves))])
    mesh = make_mesh((data, model), ("data", "model"))
    rules = dict(shd.DP_RULES, **spec.rules_overrides)
    comp = CompressionConfig(backend="reference", **kw)
    opt = sgd(lr)
    with jax.set_mesh(mesh):
        ts = jax.jit(step_lib.make_compressed_train_step(
            cfg, comp, opt, mesh, rules, multi_pod=False))
        p, s = params, opt.init(params)
        ef = step_lib.init_compressed_feedback(cfg, comp, mesh, False)
        for t in range(steps):
            batch = {"tokens": jnp.asarray(inp["tokens"][t])}
            p, s, ef, m = ts(p, s, ef, batch, jax.random.key(t))
            for k, v in m.items():
                out[f"{name}/m{t}/{k}"] = np.asarray(v, np.float64)
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{name}/params/{i}"] = np.asarray(x)
    for i, x in enumerate(jax.tree.leaves(ef.residual)):
        out[f"{name}/residual/{i}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""


# ---------------------------------------------------------------------------
# the port's side: gloo ranks
# ---------------------------------------------------------------------------

def _inputs(tmp: str, arch: str):
    inp = np.load(os.path.join(tmp, f"{arch}.npz"))
    names = leaf_order(param_shapes(tregistry.get(arch).smoke))
    return ({n: inp[f"p{i}"] for i, n in enumerate(names)}, inp["tokens"])


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, x in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = x
    return out


def _groups(mesh) -> dict:
    data_group, pod_group, _ = tlaunch.mesh_groups(mesh)
    model_group, m, ranks, worker_group = tlaunch.model_groups(mesh)
    return dict(group=data_group, pod_group=pod_group,
                model_group=model_group, m=m, ranks=ranks,
                worker_group=worker_group)


def _axis(cfg, arch: str, mesh, g) -> tshd.ModelAxis:
    names = leaf_order(param_shapes(cfg))
    return tshd.ModelAxis(
        size=mesh[2], index=g["m"], group=g["model_group"], ranks=g["ranks"],
        specs=tlaunch.leaf_specs(cfg, names,
                                 tregistry.get(arch).rules_overrides, mesh))


def _models(arch: str, mesh, g, params: dict):
    """The split model (this worker's shards, from the JAX weights) and a
    whole one with the plain model axis of the gathered step."""
    from repro_torch.models.convert import shards_from_numpy
    from repro_torch.models.transformer import Transformer
    cfg = tregistry.get(arch).smoke
    ma = _axis(cfg, arch, mesh, g)
    tp = ttp.plan_split(cfg, leaf_order(params), ma)
    split = Transformer(cfg, shards_from_numpy(_nest(params), tp.axis),
                        tp=tp)
    whole = Transformer(cfg, {n: torch.from_numpy(x.copy())
                              for n, x in params.items()})
    return split, whole, ma


def run_case(name: str, g: dict, rank: int, tmp: str) -> dict:
    """CASES[name] on this rank: the split step for its steps, and first
    the step-1 gradient shards of the split and the gathered step on its
    batch."""
    from repro_torch.core.api import CompressionConfig
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    arch, mesh, steps = CASES[name]
    params, tokens = _inputs(tmp, arch)
    split, whole, ma = _models(arch, mesh, g, params)
    w, b = rank // mesh[2], tokens.shape[1] // mesh[1]
    batches = [{"tokens": torch.from_numpy(tokens[t][w * b:(w + 1) * b]
                                           .copy())} for t in range(steps)]
    cfg = split.cfg
    _, g_split = tstep.worker_grads(split, ma, tstep.make_loss_fn(
        cfg, tp=split.tp), batches[0])
    _, g_whole = tstep.worker_grads(whole, ma, tstep.make_loss_fn(cfg),
                                    batches[0])
    comp = CompressionConfig(**TOPK)
    opt = topt.sgd(LR)
    leaves = tstep.worker_leaves(split)
    state, fb = opt.init(leaves), topt.init_feedback(leaves)
    step = tstep.make_compressed_train_step(
        split, comp, opt, group=g["group"], model_axis=ma,
        worker_group=g["worker_group"])
    gen = torch.Generator().manual_seed(1000 + rank)
    metrics = []
    for batch in batches:
        state, fb, m = step(state, fb, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": [p.detach().numpy().copy() for p in split.leaves()],
            "residual": [r.numpy().copy() for r in fb.residual],
            "metrics": metrics, "specs": list(ma.specs),
            "kinds": list(split.tp.axis.grads),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in split.leaves()),
            "grad_split": [x.numpy().copy() for x in g_split],
            "grad_gathered": [x.numpy().copy() for x in g_whole]}


def _f64_case(seed: int, *shapes):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen, dtype=torch.float64)
            for s in shapes]


def _against_whole(fn_split, fn_whole, inputs: list, blocks: list,
                   seed: int, partial=()) -> float:
    """The largest difference between the split computation on this
    worker's blocks of ``inputs`` (``blocks[i]``: a slice tuple, or None
    for an input every worker holds whole) and the whole one: the output,
    then the gradient of each input under a fixed random cotangent (but
    those in ``partial``, whose gradient is this worker's share)."""
    whole = [x.clone().requires_grad_() for x in inputs]
    mine = [(x if b is None else x[b]).clone().requires_grad_()
            for x, b in zip(inputs, blocks)]
    y_w, y_s = fn_whole(*whole), fn_split(*mine)
    cot = _f64_case(seed, y_w.shape)[0]
    (y_w * cot).sum().backward()
    (y_s * cot).sum().backward()
    err = float((y_w - y_s).abs().max())
    for j, (x, xs, b) in enumerate(zip(whole, mine, blocks)):
        if j in partial:
            continue
        want = x.grad if b is None else x.grad[b]
        got = xs.grad if xs.grad is not None else torch.zeros_like(xs)
        err = max(err, float((want - got).abs().max()))
    return err


def unit_checks(rank: int, g: dict) -> dict:
    """The autograd functions in float64 on two model workers against the
    whole computation; the vocab-parallel embedding's forward bit-equal."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import layers
    from repro_torch.train.loss import lm_loss
    ma = tshd.ModelAxis(size=2, index=rank, specs=(), group=g["model_group"],
                        ranks=g["ranks"])
    cols = slice(3 * rank, 3 * rank + 3)
    out = {}
    x, gate, up, down = _f64_case(1, (2, 3, 8), (8, 6), (8, 6), (6, 8))
    out["gated_mlp"] = _against_whole(
        lambda *a: layers.gated_mlp(*a[1:], a[0], model_axis=ma),
        lambda *a: layers.gated_mlp(*a[1:], a[0]),
        [x, gate, up, down], [None, (slice(None), cols), (slice(None), cols),
                              (cols,)], 2)
    up_b, down_b = _f64_case(3, (6,), (8,))
    out["dense_mlp"] = _against_whole(
        lambda x, u, ub, d, db: layers.dense_mlp(u, ub, d, db, x,
                                                 model_axis=ma),
        lambda x, u, ub, d, db: layers.dense_mlp(u, ub, d, db, x),
        [x, up, up_b, down, down_b],
        [None, (slice(None), cols), (cols,), (cols,), None], 4)
    # attention: 4 q heads, kv heads 2 (split) or 1 (MQA: whole, read by
    # both workers), and head_dim over the workers (gathered)
    names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
    for case, kv in (("heads_kv_split", 2), ("heads_kv_whole", 1)):
        acfg = tattn.AttnConfig(d_model=8, num_heads=4, num_kv_heads=kv,
                                head_dim=4, use_bias=True, window=3)
        shapes = ((8, 4, 4), (8, kv, 4), (8, kv, 4), (4, 4, 8), (4, 4),
                  (kv, 4), (kv, 4), (8,))
        leaves = _f64_case(5 + kv, (2, 5, 8), *shapes)
        q = slice(2 * rank, 2 * rank + 2)
        kvs = slice(rank, rank + 1) if kv == 2 else None
        asplit = ttp.AttnSplit("heads", q=(q.start, q.stop),
                               kv=(kvs.start, kvs.stop) if kvs else (0, 1),
                               kv_split=kv == 2)
        kv_b = None if kvs is None else (slice(None), kvs)
        blocks = [None, (slice(None), q), kv_b, kv_b, (q,), (q,),
                  None if kvs is None else (kvs,),
                  None if kvs is None else (kvs,), None]

        def fn(x, *ps, split=None, acfg=acfg):
            return tattn.attention_train(dict(zip(names, ps)), acfg, x,
                                         split=split, model_axis=ma)
        err = _against_whole(functools.partial(fn, split=asplit), fn, leaves,
                             blocks, 9, () if kvs else (2, 3, 6, 7))
        if kvs is None:   # a whole kv leaf's gradient: this worker's share
            err = max(err, _partial_kv(fn, asplit, leaves, blocks, ma))
        out[case] = err
    acfg = tattn.AttnConfig(d_model=8, num_heads=2, num_kv_heads=1,
                            head_dim=6, use_bias=True)
    shapes = ((8, 2, 6), (8, 1, 6), (8, 1, 6), (2, 6, 8), (2, 6), (1, 6),
              (1, 6), (8,))
    leaves = _f64_case(11, (2, 5, 8), *shapes)
    hd = slice(3 * rank, 3 * rank + 3)
    specs = {"wq": (None, None, "model"), "wk": (None, None, "model"),
             "wv": (None, None, "model"), "wo": (None, "model", None),
             "bq": (None, "model"), "bk": (None, "model"),
             "bv": (None, "model")}
    gsplit = ttp.AttnSplit("gather", gather=specs)
    blocks = [None] + [(slice(None),) * specs[n].index("model") + (hd,)
                       if n in specs else None for n in names]
    out["head_dim_gathered"] = _against_whole(
        lambda x, *ps: tattn.attention_train(dict(zip(names, ps)), acfg, x,
                                             split=gsplit, model_axis=ma),
        lambda x, *ps: tattn.attention_train(dict(zip(names, ps)), acfg, x),
        leaves, blocks, 12)
    # the vocab-parallel embedding: forward bit-equal, and its gradient
    table = _f64_case(13, (10, 4))[0]
    tokens = torch.tensor([[0, 4, 5, 9, 5], [7, 1, 2, 3, 8]])
    rows = slice(5 * rank, 5 * rank + 5)
    mine = table[rows].clone().requires_grad_()
    emb = layers.embed(mine, tokens, scale=True, vocab=(ma, 5 * rank))
    out["embed_bit_equal"] = bool(torch.equal(
        emb, layers.embed(table, tokens, scale=True)))
    out["embed"] = _against_whole(
        lambda t: layers.embed(t, tokens, True, (ma, 5 * rank)),
        lambda t: layers.embed(t, tokens, True), [table], [(rows,)], 14)
    # the vocab-parallel cross entropy, float32 as the loss computes it
    logits = _f64_case(15, (2, 5, 10))[0].float() * 3
    targets = torch.tensor([[0, 4, 5, 9, 5], [7, 1, 2, 3, 8]])
    mask = torch.ones(2, 5)
    mask[:, -1] = 0
    whole = logits.clone().requires_grad_()
    mine = logits[..., rows].clone().requires_grad_()
    lw = lm_loss(whole, targets, mask)
    ls = lm_loss(mine, targets, mask, vocab=(ma, 5 * rank))
    lw.backward()
    ls.backward()
    out["loss"] = (float(lw), float(ls),
                   float((whole.grad[..., rows] - mine.grad).abs().max()))
    return out


def _partial_kv(fn, asplit, leaves, blocks, ma) -> float:
    """With the kv heads whole, the sum over the model workers of each
    worker's ``wk``/``wv``/``bk``/``bv`` gradient is the whole one."""
    whole = [x.clone().requires_grad_() for x in leaves]
    mine = [(x if b is None else x[b]).clone().requires_grad_()
            for x, b in zip(leaves, blocks)]
    cot = _f64_case(9, (2, 5, 8))[0]
    (fn(*whole) * cot).sum().backward()
    (fn(*mine, split=asplit) * cot).sum().backward()
    err = 0.0
    for j in (2, 3, 6, 7):               # wk, wv, bk, bv
        got = ma.sum_in_rank_order(mine[j].grad.contiguous())
        err = max(err, float((got - whole[j].grad).abs().max()))
    return err


def launcher_runs(rank: int) -> dict:
    """The launcher at ``--mesh 1x2``: gemma-2b and rwkv6-1.6b (both
    split), one step each, their output and summaries."""
    out = {}
    for arch in ("gemma-2b", "rwkv6-1.6b"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out[arch] = tlaunch.main(
                ["--arch", arch, "--smoke", "--steps", "1", "--device",
                 "cpu", "--wire", "gather", "--error-feedback", "--mesh",
                 "1x2"])
        out[arch]["out"] = buf.getvalue()
    return out


def checkpoint_runs(rank: int, g: dict, tmp: str) -> dict:
    """gemma2-9b's split step at ``--mesh 1x2`` (adaptive gspar with EF,
    Adam): three steps unbroken; one, a save, a restore into fresh state
    and other weights, and two; and after one step the same parameters
    and states saved from a whole model by the gathered step's rules."""
    from repro_torch.checkpoint import checkpoint as tckpt
    from repro_torch.core.api import CompressionConfig
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    arch, mesh = "gemma2-9b", (None, 1, 2)
    params, tokens = _inputs(tmp, arch)
    comp = CompressionConfig(name="gspar", rho=0.05, wire="gather",
                             error_feedback=True, min_leaf_size=MIN_LEAF,
                             adaptive=True, skip_tau=0.7)
    opt = topt.adam(1e-3)
    runs = {}

    def fresh(model):
        leaves = tstep.worker_leaves(model)
        return (opt.init(leaves), topt.init_feedback(leaves),
                tstep.init_compressed_control(model, comp),
                tstep.make_compressed_train_step(model, comp, opt,
                                                 group=g["group"]))

    for name in ("unbroken", "resumed"):
        model, whole, ma = _models(arch, mesh, g, params)
        state, fb, ctl, step = fresh(model)
        for t in range(3):
            if name == "resumed" and t == 1:
                ck = os.path.join(tmp, "split12")
                tckpt.save(ck, model, state, fb, ctl, mesh=mesh)
                # the gathered step's file of the same parameters and states
                for i, (p, w) in enumerate(zip(model.leaves(),
                                               whole.leaves())):
                    with torch.no_grad():
                        ma.shard(w, i).copy_(p)
                    ma.gather(w.data, i)
                tckpt.save(os.path.join(tmp, "gathered12"), whole, state,
                           fb, ctl, mesh=mesh, model_axis=ma)
                with torch.no_grad():
                    for p in model.leaves():
                        p.add_(1.0)
                state, fb, ctl, step = fresh(model)
                state, fb, ctl = tckpt.restore(ck, model, state, fb, ctl,
                                               mesh=mesh)
            batch = {"tokens": torch.from_numpy(tokens[t % 2].copy())}
            gen = torch.Generator().manual_seed(200 + 7 * t + rank)
            state, fb, ctl, _ = step(state, fb, ctl, batch, gen)
        runs[name] = {
            "params": [p.detach().numpy().copy() for p in model.leaves()],
            "m": [x.numpy().copy() for x in state["m"]],
            "v": [x.numpy().copy() for x in state["v"]],
            "residual": [x.numpy().copy() for x in fb.residual],
            "last_sent": [x.numpy().copy() for x in ctl.last_sent],
            "bound": [x.numpy().copy() for x in ctl.bound],
            "steps": (state["step"], ctl.step)}
    return runs


def two_ranks(rank: int, tmp: str) -> dict:
    g12 = _groups((None, 1, 2))
    res = {name: run_case(name, g12, rank, tmp)
           for name, (_, mesh, _) in CASES.items() if _world(mesh) == 2}
    res["units"] = unit_checks(rank, g12)
    res["ckpt"] = checkpoint_runs(rank, g12, tmp)
    res["launcher"] = launcher_runs(rank)
    return res


def four_ranks(rank: int, tmp: str) -> dict:
    groups = {mesh: _groups(mesh) for mesh in
              sorted({m for _, m, _ in CASES.values() if _world(m) == 4},
                     key=str)}
    return {name: run_case(name, groups[mesh], rank, tmp)
            for name, (_, mesh, _) in CASES.items() if _world(mesh) == 4}


WORKER = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_tensor_parallel as t

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
res = {2: t.two_ranks, 4: t.four_ranks}[world](rank, sys.argv[6])
torch.save(res, out)
dist.destroy_process_group()
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, tmp, env: dict):
    port = _port()
    outs = [str(tmp / f"tp{world}_rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         outs[r], os.path.dirname(os.path.abspath(__file__)), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return procs, outs


def _collect(procs, outs) -> list:
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX steps (one subprocess, four fake CPU devices) and the
    port's two-rank and four-rank spawns, side by side; the inputs: each
    arch's JAX init (key 0) and the tokens of two steps. Returns (two
    ranks, four ranks, JAX, tmp)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    for k, arch in enumerate(ARCHS):
        cfg = jregistry.get(arch).smoke
        params = jax.jit(lambda key: split_params(jtf.init_model(key, cfg))
                         [0])(jax.random.key(0))
        inputs = {f"p{i}": np.asarray(x)
                  for i, x in enumerate(jax.tree.leaves(params))}
        inputs["tokens"] = np.random.default_rng(k).integers(
            0, cfg.vocab, TOKENS).astype(np.int32)
        np.savez(tmp / f"{arch}.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp), str(tmp / "jax.npz"),
         repr(CASES), repr(TOPK), repr(LR)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    two, four = _spawn(2, tmp, env), _spawn(4, tmp, env)
    ranks2, ranks4 = _collect(*two), _collect(*four)
    log = jax_proc.communicate(timeout=400)[0]
    assert jax_proc.returncode == 0, log
    return ranks2, ranks4, dict(np.load(tmp / "jax.npz")), str(tmp)


def _ranks(results, name: str) -> list:
    """Each rank's record of case ``name``."""
    ranks = results[0] if _world(CASES[name][1]) == 2 else results[1]
    return [r[name] for r in ranks]


def _block(full: np.ndarray, spec: tuple, n_model: int, m: int):
    return full[tshd.worker_slices(full.shape, spec, {"model": n_model},
                                   {"model": m})]


def _near_ties(a: np.ndarray, b: np.ndarray, atol: float,
               what) -> np.ndarray:
    """The coordinates where the two sides' last top-k choice differs on a
    near-tie (see the module docstring); fails on any other mismatch."""
    bad = np.abs(a - b) > atol
    if bad.any():
        tie = np.maximum(np.abs(a), np.abs(b))[bad]
        assert bad.sum() % 2 == 0 and bad.sum() <= 1e-3 * a.size, \
            (what, int(bad.sum()))
        assert tie.max() - tie.min() <= 1e-5 * tie.max(), (what, tie)
    return bad


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_matches_the_jax_step(results, name):
    """Each rank's shards of the parameters and the residual, and the
    metrics of each step, against JAX's step on the same mesh."""
    arch, (_, data, n_model), steps = CASES[name]
    ranks, jx = _ranks(results, name), results[2]
    ties = {}
    for rank, got in enumerate(ranks):
        w, m = divmod(rank, n_model)
        for i, spec in enumerate(got["specs"]):
            ties[rank, i] = _near_ties(
                got["residual"][i],
                _block(jx[f"{name}/residual/{i}"][w], spec, n_model, m),
                JAX_ATOL[arch], (name, rank, i))
    for rank, got in enumerate(ranks):
        w, m = divmod(rank, n_model)
        for i, spec in enumerate(got["specs"]):
            keep = ~ties[rank, i]
            for other in range(m, len(ranks), n_model):   # a shard's twins
                keep &= ~ties[other, i]
            np.testing.assert_allclose(
                got["params"][i][keep],
                _block(jx[f"{name}/params/{i}"], spec, n_model, m)[keep],
                rtol=0, atol=JAX_ATOL[arch],
                err_msg=f"{name} params {i} rank {rank}")
        for t in range(steps):
            mt = got["metrics"][t]
            for key in ("wire_bytes", "bits", "overflow"):
                assert mt[key] == float(jx[f"{name}/m{t}/{key}"]), \
                    (name, rank, t, key)
            for key in ("density", "loss"):
                np.testing.assert_allclose(
                    mt[key], float(jx[f"{name}/m{t}/{key}"]), rtol=1e-6,
                    err_msg=f"{name} {t} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_split_gradients_match_the_gathered_step(results, name):
    """Each rank's step-1 gradient shards (what it hands to the sync: a
    whole kv leaf's share summed over the model workers) against the
    gathered step's on the same rank and batch."""
    for rank, got in enumerate(_ranks(results, name)):
        for i, (a, b) in enumerate(zip(got["grad_split"],
                                       got["grad_gathered"])):
            assert a.shape == b.shape, (name, rank, i)
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                       err_msg=f"{name} grad {i} {rank}")


@pytest.mark.parametrize("name", list(CASES))
def test_a_worker_holds_its_shards_only(results, name):
    """Each rank's parameter bytes are the sum of its shards' bytes under
    the launcher's specs (float32: 4 a coordinate), below the whole
    model's; the leaves' gradient kinds are the arch's."""
    arch, (_, _, n_model), _ = CASES[name]
    shapes = param_shapes(tregistry.get(arch).smoke)
    names = leaf_order(shapes)
    whole = 4 * sum(int(np.prod(shapes[n][0])) for n in names)
    for rank, got in enumerate(_ranks(results, name)):
        want = 4 * sum(
            int(np.prod([s.stop - s.start for s in tshd.worker_slices(
                shapes[n][0], spec, {"model": n_model},
                {"model": rank % n_model})]))
            for n, spec in zip(names, got["specs"]))
        assert got["param_bytes"] == want < whole, (name, rank)
        kinds = dict(zip(names, got["kinds"]))
        partial = {n for n, k in kinds.items() if k == tshd.PARTIAL}
        if name == "g9_1x4":         # 2 kv heads over 4 workers: whole
            assert partial == {n for n in names
                               if n.endswith(("/attn/wk", "/attn/wv"))}
        else:
            assert not partial
        assert all(k == tshd.SPLIT for n, k in kinds.items()
                   if n.endswith(("/ffn/down", "embed/table")))


def test_autograd_functions_against_the_whole_computation(results):
    for rank in results[0]:
        u = rank["units"]
        for case in ("gated_mlp", "dense_mlp", "heads_kv_split",
                     "heads_kv_whole", "head_dim_gathered", "embed"):
            assert u[case] <= 1e-12, (case, u[case])
        assert u["embed_bit_equal"]
        lw, ls, grad_err = u["loss"]
        np.testing.assert_allclose(ls, lw, rtol=1e-6)
        assert grad_err <= 1e-7


@pytest.mark.parametrize("arch", list(tregistry.ID_TO_MODULE))
def test_launcher_takes_the_split_step_for_the_dense_decoders(arch):
    """The split step past one model worker for every arch: the dense
    decoders, phi3.5-moe, deepseek-v2, seamless and the SSM and hybrid
    rwkv6 and zamba2, each of whose full configs ``plan_split`` plans at
    ``--mesh 1x2`` and ``1x4``, splitting some leaves."""
    cfg = tregistry.get(arch).model
    assert tlaunch.step_kind(2) == "split"
    assert tlaunch.step_kind(1) == "whole"
    names = leaf_order(param_shapes(cfg))
    for m in (2, 4):
        specs = tlaunch.leaf_specs(cfg, names,
                                   tregistry.get(arch).rules_overrides,
                                   (None, 1, m))
        tp = ttp.plan_split(cfg, names, tshd.ModelAxis(size=m, index=0,
                                                       specs=specs))
        assert tshd.SPLIT in tp.axis.grads, (arch, m)


def test_launcher_names_its_step(results):
    """On two gloo ranks at ``--mesh 1x2`` the launcher prints
    ``step=split`` for gemma-2b and for rwkv6, each holding less than its
    whole bytes."""
    for rank in results[0]:
        run = rank["launcher"]
        g2, rw = run["gemma-2b"], run["rwkv6-1.6b"]
        assert g2["step"] == rw["step"] == "split"
        assert g2["param_bytes"] < 4 * g2["params"]
        assert rw["param_bytes"] < 4 * rw["params"]
        for m in g2["metrics"] + rw["metrics"]:
            assert np.isfinite(m["loss"]) and m["wire_bytes"] > 0
    out = results[0][0]["launcher"]
    for arch in ("gemma-2b", "rwkv6-1.6b"):
        assert "mesh=(data=1, model=2) step=split" in out[arch]["out"]


def test_split_checkpoint_is_the_gathered_file_and_resumes(results):
    """The split run's ``--mesh 1x2`` file holds the entries, in order, of
    the file the gathered step writes for the same parameters and states,
    bit for bit; the run resumed from it is bit-equal to the unbroken one
    on both ranks."""
    tmp = results[3]
    with np.load(os.path.join(tmp, "split12.npz")) as a, \
            np.load(os.path.join(tmp, "gathered12.npz")) as b:
        assert list(a.keys()) == list(b.keys())
        assert any(k.startswith("params/") for k in a.keys())
        for key in a.keys():
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for rank in results[0]:
        x, y = rank["ckpt"]["unbroken"], rank["ckpt"]["resumed"]
        assert x["steps"] == y["steps"] == (3, 3)
        for field in ("params", "m", "v", "residual", "last_sent", "bound"):
            for i, (p, q) in enumerate(zip(x[field], y[field])):
                np.testing.assert_array_equal(p, q, err_msg=f"{field} {i}")
