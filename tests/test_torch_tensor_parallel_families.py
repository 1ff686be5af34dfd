"""The model axis's compute split for MoE, MLA and the encoder-decoder
(``dist/tensor_parallel.py``'s plan over every block path, ``models/moe.py``
``moe_ffn``'s expert split, ``models/attention.py``'s MLA and
cross-attention splits) against the JAX package, on the CPU:

- JAX's real compressed step (``make_compressed_train_step`` under GSPMD,
  three subprocesses on four fake CPU devices, two cases each, the
  reference backend) against the port's split step on gloo ranks (a
  two-rank and a four-rank spawn), the weights carried across
  (``convert.shards_from_numpy``), float32 smoke configs, top-k with EF on
  the gather wire, SGD 0.05, two steps, unbroken but where a step's top-k
  choice swapped a pair at a near-tie on some rank (the exemption below;
  such as phi3.5-moe's ``attn/wq`` at ``1x2`` with gradient magnitudes
  0.07418521 and 0.07418505, which would send the two runs apart for the
  rest of the run): there the port's next step starts from JAX's
  parameters and residual after that step:
  phi3.5-moe at ``1x2`` and ``1x4`` (its 2 kv heads stay whole there: each
  worker's share of ``wk``/``wv``'s gradient, summed over the model
  workers), deepseek-v2 at ``1x2`` and ``2x2`` in the compressed mode (MLA
  over heads, the prelude's dense FFN, routed and shared experts),
  seamless-m4t-large-v2 at ``1x2`` (the encoder, the cross attention and
  the table split) and at ``1x4`` with the vocabulary set to 510 in both
  packages, so that the table stays whole, as the full model's 256,206 rows
  do at M = 4. Each rank's parameters and residual shards and the metrics
  against JAX's; its step-1 gradient shards against the gathered step's
  (a whole model, the same ranks and batch); its parameter bytes equal to
  the sum of its shards' bytes; the leaves' gradient kinds; the router's
  top-k margins (a choice at a near-tie would flip between the packages);
- the autograd functions in float64 on two ranks against the whole
  computation: MoE's split experts (routed and shared; the router's and
  the input's gradients whole and equal on both ranks), MLA over heads and
  the cross attention over heads, each forward and the gradient of every
  input and leaf;
- the launcher's ``step=split`` line for deepseek-v2 at ``--mesh 1x2
  --mode compressed``;
- phi3.5-moe's split ``--mesh 1x2`` checkpoint: the file the gathered step
  writes for the same parameters and states, entry for entry, and a resume
  from it bit-equal to an unbroken run (but the whole router's per-worker
  states, of which the file holds model index 0's).

Tolerances: parameters and residuals within ``tests/test_torch_archs.py``'s
``STEP_ATOL`` of JAX (4e-6 for these three archs: their float32 gradients
differ from JAX's by that much with the whole model too), with
``tests/test_torch_tensor_parallel.py``'s only exemption (a pair of
coordinates whose target magnitudes tie within 1e-5 relative may swap
places in a step's top-k choice); wire bytes, bits and overflow exact;
loss within 1e-6 relative; density within 1e-6 relative and, for
seamless, the share of the cross attention's key-bias coordinates
(``_zero_grads``: their gradient is float noise on both sides, and at
``1x4`` one of them is exactly 0 on one side only, which moves a count of
nonzeros by one); the split step's gradient shards
within ``tests/test_torch_archs.py``'s ``GRAD_ATOL`` of the gathered step's
(the same function, the float sums in another order: up to 2.7e-6 on
deepseek-v2's ``kv_down``, whose gradient reaches 4.2, 6e-7 relative);
every router margin above 1e-4; the float64 functions within 1e-12.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax API shims first)
import test_torch_tensor_parallel as base
from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro_torch.configs import registry as tregistry
from repro_torch.dist import sharding as tshd
from repro_torch.dist import tensor_parallel as ttp
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models.common import leaf_order
from repro_torch.models.transformer import param_shapes

torch.set_num_threads(1)

REPO = base.REPO
LR = base.LR
TOPK = base.TOPK
TOKENS = base.TOKENS              # steps x global batch x sequence
PHI, DS, SM = "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", \
    "seamless-m4t-large-v2"
# name: (arch, mesh (pods, data, model), steps, vocab (None: the smoke's))
CASES = {"phi_1x2": (PHI, (None, 1, 2), 2, None),
         "phi_1x4": (PHI, (None, 1, 4), 2, None),
         "ds_1x2": (DS, (None, 1, 2), 2, None),
         "ds_2x2": (DS, (None, 2, 2), 2, None),
         "sm_1x2": (SM, (None, 1, 2), 2, None),
         "sm_1x4": (SM, (None, 1, 4), 2, 510)}
# atol against JAX and against the gathered step:
# ``tests/test_torch_archs.py``'s ``STEP_ATOL`` and ``GRAD_ATOL``
JAX_ATOL = {PHI: 4e-6, DS: 4e-6, SM: 4e-6}
GRAD_ATOL = {PHI: 2e-6, DS: 4e-6, SM: 2e-6}
JAX_PROCS = (("phi_1x2", "ds_2x2"), ("ds_1x2", "sm_1x4"),
             ("phi_1x4", "sm_1x2"))       # a JAX subprocess's cases
WAIT = 400                 # seconds a rank waits for JAX's results
MARGIN = 1e-4              # a router's k-th probability over its (k+1)-th


def _input(case: str) -> str:
    """The inputs file of a case: one per (arch, vocab)."""
    arch, _, _, vocab = CASES[case]
    return f"{arch}-{vocab or 'smoke'}"


def _cfg(arch: str, vocab):
    cfg = tregistry.get(arch).smoke
    return cfg if vocab is None else dataclasses.replace(cfg, vocab=vocab)


# ---------------------------------------------------------------------------
# the JAX side: subprocesses on four fake CPU devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import dataclasses
import os
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

cases, inputs = eval(sys.argv[3]), eval(sys.argv[6])
kw, lr = eval(sys.argv[4]), float(sys.argv[5])
for name, (arch, (_, data, model), steps, vocab) in cases.items():
    out = {}
    inp = np.load(f"{sys.argv[1]}/{inputs[name]}.npz")
    spec = registry.get(arch)
    cfg = spec.smoke if vocab is None else dataclasses.replace(
        spec.smoke, vocab=vocab)
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
            if "enc_embeds" in inp:
                batch["enc_embeds"] = jnp.asarray(inp["enc_embeds"][t],
                                                  jnp.bfloat16)
            p, s, ef, m = ts(p, s, ef, batch, jax.random.key(t))
            for k, v in m.items():
                out[f"m{t}/{k}"] = np.asarray(v, np.float64)
            for i, x in enumerate(jax.tree.leaves(p)):
                out[f"s{t}/params/{i}"] = np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(ef.residual)):
                out[f"s{t}/residual/{i}"] = np.asarray(x)
    np.savez(f"{sys.argv[2]}/part_{name}.npz", **out)
    os.replace(f"{sys.argv[2]}/part_{name}.npz",
               f"{sys.argv[2]}/jax_{name}.npz")
"""


# ---------------------------------------------------------------------------
# the port's side: gloo ranks
# ---------------------------------------------------------------------------

def _inputs(tmp: str, case: str, cfg):
    inp = np.load(os.path.join(tmp, f"{_input(case)}.npz"))
    names = leaf_order(param_shapes(cfg))
    return ({n: inp[f"p{i}"] for i, n in enumerate(names)}, inp)


def _batch(inp, t: int, rows: slice) -> dict:
    out = {"tokens": torch.from_numpy(inp["tokens"][t][rows].copy())}
    if "enc_embeds" in inp:
        out["enc_embeds"] = torch.from_numpy(
            inp["enc_embeds"][t][rows].copy()).to(torch.bfloat16)
    return out


def _models(cfg, arch: str, mesh, g, params: dict):
    """The split model (this worker's shards, from the JAX weights) and a
    whole one with the plain model axis of the gathered step."""
    from repro_torch.models.convert import shards_from_numpy
    from repro_torch.models.transformer import Transformer
    names = leaf_order(params)
    ma = tshd.ModelAxis(
        size=mesh[2], index=g["m"], group=g["model_group"], ranks=g["ranks"],
        specs=tlaunch.leaf_specs(cfg, names,
                                 tregistry.get(arch).rules_overrides, mesh))
    tp = ttp.plan_split(cfg, names, ma)
    split = Transformer(cfg, shards_from_numpy(base._nest(params), tp.axis),
                        tp=tp)
    whole = Transformer(cfg, {n: torch.from_numpy(x.copy())
                              for n, x in params.items()})
    return split, whole, ma


@contextlib.contextmanager
def _router_margins(out: list):
    """Record, at each call of the router, the smallest gap between a
    token's k-th and (k+1)-th probability."""
    from repro_torch.models import moe
    real = moe.route

    def spy(p, cfg, x):
        logits, probs, weights, ids = real(p, cfg, x)
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        out.append(float((top[..., cfg.top_k - 1] - top[..., cfg.top_k])
                         .min()))
        return logits, probs, weights, ids
    moe.route = spy
    try:
        yield
    finally:
        moe.route = real


def _jax_results(tmp: str, name: str) -> dict:
    """JAX's metrics and states of case ``name``, once its subprocess has
    written them (it fails the rank when a JAX subprocess failed)."""
    path = os.path.join(tmp, f"jax_{name}.npz")
    deadline = time.monotonic() + WAIT
    while not os.path.exists(path):
        assert not os.path.exists(os.path.join(tmp, "jax_failed")) and \
            time.monotonic() < deadline, f"no JAX results for {name}"
        time.sleep(0.2)
    return dict(np.load(path))


def _swapped(residual: list, jx: dict, t: int, specs, mesh, w: int,
             m: int, atol: float) -> bool:
    """Whether any rank's residual after step ``t`` is farther than
    ``atol`` from JAX's anywhere: the coordinates ``_near_ties`` then
    names (a top-k choice swapped at a near-tie, or a fault the test
    reports)."""
    far = any(np.abs(r.numpy() - base._block(
        jx[f"s{t}/residual/{i}"][w], spec, mesh[2], m)).max() > atol
        for i, (r, spec) in enumerate(zip(residual, specs)))
    flag = torch.tensor([float(far)])
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
    return bool(flag.item())


def run_case(name: str, g: dict, rank: int, tmp: str) -> dict:
    """CASES[name] on this rank: the step-1 gradient shards of the split
    and the gathered step on its batch, then the split step from the init,
    unbroken but after a step where some rank's residual left JAX's
    (``_swapped``): the next step then starts from JAX's state after it
    (its parameters and this rank's residual shard), and is marked
    ``restarted``."""
    from repro_torch.core.api import CompressionConfig
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    arch, mesh, steps, vocab = CASES[name]
    cfg = _cfg(arch, vocab)
    params, inp = _inputs(tmp, name, cfg)
    split, whole, ma = _models(cfg, arch, mesh, g, params)
    w, b = rank // mesh[2], inp["tokens"].shape[1] // mesh[1]
    batches = [_batch(inp, t, slice(w * b, (w + 1) * b))
               for t in range(steps)]
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
    jx = _jax_results(tmp, name)
    steps_out, margins, restart = [], [], False
    with _router_margins(margins):
        for t, batch in enumerate(batches):
            if restart:
                with torch.no_grad():
                    for i, spec in enumerate(ma.specs):
                        split.leaves()[i].copy_(torch.from_numpy(base._block(
                            jx[f"s{t - 1}/params/{i}"], spec, mesh[2],
                            g["m"])))
                        fb.residual[i].copy_(torch.from_numpy(base._block(
                            jx[f"s{t - 1}/residual/{i}"][w], spec, mesh[2],
                            g["m"])))
            state, fb, m = step(state, fb, batch, gen)
            steps_out.append({
                "params": [p.detach().numpy().copy()
                           for p in split.leaves()],
                "residual": [r.numpy().copy() for r in fb.residual],
                "metrics": {k: float(v) for k, v in m.items()},
                "restarted": restart})
            restart = t + 1 < steps and _swapped(
                fb.residual, jx, t, ma.specs, mesh, w, g["m"],
                JAX_ATOL[arch])
    return {"steps": steps_out, "specs": list(ma.specs),
            "kinds": list(split.tp.axis.grads), "margins": margins,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in split.leaves()),
            "grad_split": [x.numpy().copy() for x in g_split],
            "grad_gathered": [x.numpy().copy() for x in g_whole]}


def unit_checks(rank: int, g: dict) -> dict:
    """The autograd functions in float64 on two model workers against the
    whole computation: MoE's experts, MLA and the cross attention."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import moe
    ma = tshd.ModelAxis(size=2, index=rank, specs=(), group=g["model_group"],
                        ranks=g["ranks"])
    f64, against = base._f64_case, base._against_whole
    out = {}
    # MoE: 4 experts of width 6 (3 a worker), top-2, one shared expert; 16
    # tokens a row at capacity factor 1 (capacity 12) drop some choices
    mcfg = moe.MoEConfig(d_model=8, d_expert=6, num_experts=4, top_k=2,
                         num_shared=1, capacity_factor=1.0)
    names = ("router", "w_gate", "w_up", "w_down", "shared/gate",
             "shared/up", "shared/down")
    leaves = f64(21, (2, 16, 8), *moe.moe_shapes(mcfg).values())
    cols = slice(3 * rank, 3 * rank + 3)
    blocks = [None, None, (slice(None), slice(None), cols),
              (slice(None), slice(None), cols), (slice(None), cols),
              (slice(None), cols), (slice(None), cols), (cols,)]

    def moe_fn(x, *ps, axis=None):
        y, aux = moe.moe_ffn(dict(zip(names, ps)), mcfg, x,
                             experts_axis=axis, shared_axis=axis)
        return y + aux
    out["moe"] = against(lambda *a: moe_fn(*a, axis=ma), moe_fn, leaves,
                         blocks, 22)
    mine = [(x if b is None else x[b]).clone().requires_grad_()
            for x, b in zip(leaves, blocks)]
    (moe_fn(*mine, axis=ma) * f64(22, (2, 16, 8))[0]).sum().backward()
    out["moe_whole_grads"] = [mine[0].grad.numpy().copy(),
                              mine[1].grad.numpy().copy()]
    # MLA over heads: 4 heads, 2 a worker
    mla = tattn.MLAConfig(d_model=8, num_heads=4, kv_lora=6, q_lora=5,
                          qk_nope=4, qk_rope=2, v_dim=3)
    names = tuple(tattn.mla_shapes(mla))
    leaves = f64(23, (2, 5, 8), *tattn.mla_shapes(mla).values())
    q = slice(2 * rank, 2 * rank + 2)
    heads = {"q_up": (slice(None), q), "k_up": (slice(None), q),
             "v_up": (slice(None), q), "wo": (q,)}
    split = ttp.AttnSplit("mla", q=(q.start, q.stop))
    out["mla"] = against(
        lambda x, *ps: tattn.mla_train(dict(zip(names, ps)), mla, x, split,
                                       ma),
        lambda x, *ps: tattn.mla_train(dict(zip(names, ps)), mla, x),
        leaves, [None] + [heads.get(n) for n in names], 24)
    # the cross attention over heads: 4 heads and 4 kv heads, the biases
    acfg = tattn.AttnConfig(d_model=8, num_heads=4, num_kv_heads=4,
                            head_dim=4, use_bias=True)
    names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
    shapes = ((8, 4, 4), (8, 4, 4), (8, 4, 4), (4, 4, 8), (4, 4), (4, 4),
              (4, 4), (8,))
    leaves = f64(25, (2, 5, 8), (2, 7, 8), *shapes)
    hb = (slice(None), q)
    blocks = [None, None, hb, hb, hb, (q,), (q,), (q,), (q,), None]
    split = ttp.AttnSplit("heads", q=(q.start, q.stop), kv=(q.start, q.stop),
                          kv_split=True)
    out["cross"] = against(
        lambda x, e, *ps: tattn.attention_train(
            dict(zip(names, ps)), acfg, x, kv_x=e, causal=False, split=split,
            model_axis=ma),
        lambda x, e, *ps: tattn.attention_train(
            dict(zip(names, ps)), acfg, x, kv_x=e, causal=False),
        leaves, blocks, 26)
    return out


def launcher_run(rank: int) -> dict:
    """The launcher at ``--mesh 1x2 --mode compressed`` on deepseek-v2,
    one step: its output and summary."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tlaunch.main(["--arch", DS, "--smoke", "--steps", "1",
                            "--device", "cpu", "--wire", "gather",
                            "--error-feedback", "--mesh", "1x2", "--mode",
                            "compressed", "--optimizer", "sgd"])
    out["out"] = buf.getvalue()
    return out


def checkpoint_runs(rank: int, g: dict, tmp: str) -> dict:
    """phi3.5-moe's split step at ``--mesh 1x2`` (adaptive gspar with EF,
    Adam): three steps unbroken; one, a save, a restore into fresh state
    and other weights, and two; and after one step the same parameters
    and states saved from a whole model by the gathered step's rules.
    ``own_states``: the leaves the rules leave whole that gspar compresses
    (the router), whose per-worker states each model worker draws with
    its own stream."""
    from repro_torch.checkpoint import checkpoint as tckpt
    from repro_torch.core.api import CompressionConfig
    from repro_torch.core.grouping import plan_tree
    from repro_torch.optim import optimizers as topt
    from repro_torch.train import step as tstep
    mesh, cfg = (None, 1, 2), _cfg(PHI, None)
    params, inp = _inputs(tmp, "phi_1x2", cfg)
    comp = CompressionConfig(name="gspar", rho=0.05, wire="gather",
                             error_feedback=True, min_leaf_size=base.MIN_LEAF,
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
        model, whole, ma = _models(cfg, PHI, mesh, g, params)
        state, fb, ctl, step = fresh(model)
        for t in range(3):
            if name == "resumed" and t == 1:
                ck = os.path.join(tmp, "moe_split12")
                tckpt.save(ck, model, state, fb, ctl, mesh=mesh)
                for i, (p, w) in enumerate(zip(model.leaves(),
                                               whole.leaves())):
                    with torch.no_grad():
                        ma.shard(w, i).copy_(p)
                    ma.gather(w.data, i)
                tckpt.save(os.path.join(tmp, "moe_gathered12"), whole,
                           state, fb, ctl, mesh=mesh, model_axis=ma)
                with torch.no_grad():
                    for p in model.leaves():
                        p.add_(1.0)
                state, fb, ctl, step = fresh(model)
                state, fb, ctl = tckpt.restore(ck, model, state, fb, ctl,
                                               mesh=mesh)
            gen = torch.Generator().manual_seed(200 + 7 * t + rank)
            state, fb, ctl, _ = step(state, fb, ctl,
                                     _batch(inp, t % 2, slice(None)), gen)
        runs[name] = {
            "params": [p.detach().numpy().copy() for p in model.leaves()],
            "m": [x.numpy().copy() for x in state["m"]],
            "v": [x.numpy().copy() for x in state["v"]],
            "residual": [x.numpy().copy() for x in fb.residual],
            "last_sent": [x.numpy().copy() for x in ctl.last_sent],
            "bound": [x.numpy().copy() for x in ctl.bound],
            "steps": (state["step"], ctl.step)}
    plan = plan_tree(comp, tstep.worker_leaves(model), model.stacked)
    runs["own_states"] = sorted(
        i for grp in plan.groups if grp.kind == "sparse"
        for i, _ in grp.members if model.tp.axis.grads[i] == tshd.SAME)
    return runs


def two_ranks(rank: int, tmp: str) -> dict:
    g12 = base._groups((None, 1, 2))
    res = {name: run_case(name, g12, rank, tmp)
           for name, (_, mesh, _, _) in CASES.items()
           if base._world(mesh) == 2}
    res["units"] = unit_checks(rank, g12)
    res["ckpt"] = checkpoint_runs(rank, g12, tmp)
    res["launcher"] = launcher_run(rank)
    return res


def four_ranks(rank: int, tmp: str) -> dict:
    groups = {mesh: base._groups(mesh) for mesh in
              sorted({m for _, m, _, _ in CASES.values()
                      if base._world(m) == 4}, key=str)}
    return {name: run_case(name, groups[mesh], rank, tmp)
            for name, (_, mesh, _, _) in CASES.items()
            if base._world(mesh) == 4}


WORKER = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_tensor_parallel_families as t

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
res = {2: t.two_ranks, 4: t.four_ranks}[world](rank, sys.argv[6])
torch.save(res, out)
dist.destroy_process_group()
"""


def _spawn(world: int, tmp, env: dict):
    port = base._port()
    outs = [str(tmp / f"tpf{world}_rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         outs[r], os.path.dirname(os.path.abspath(__file__)), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return procs, outs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX steps (one subprocess, four fake CPU devices) and the
    port's two-rank and four-rank spawns, side by side; the inputs: each
    (arch, vocab)'s JAX init (key 0), the tokens of two steps and the
    encoder-decoder's stub frames (bfloat16 values from a numpy seed).
    Returns (two ranks, four ranks, JAX, tmp)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel_families")
    for k, key in enumerate(sorted({_input(c) for c in CASES})):
        arch, _, _, vocab = CASES[next(c for c in CASES if _input(c) == key)]
        cfg = jregistry.get(arch).smoke
        if vocab is not None:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        params = jax.jit(lambda key: split_params(jtf.init_model(key, cfg))
                         [0])(jax.random.key(0))
        inputs = {f"p{i}": np.asarray(x)
                  for i, x in enumerate(jax.tree.leaves(params))}
        rng = np.random.default_rng(k)
        inputs["tokens"] = rng.integers(0, cfg.vocab, TOKENS).astype(
            np.int32)
        for name, (shape, dtype) in tspecs.stub_inputs(
                _cfg(arch, vocab), TOKENS[1]).items():
            inputs[name] = torch.from_numpy(rng.standard_normal(
                (TOKENS[0],) + tuple(shape)).astype(np.float32)).to(
                dtype).float().numpy()
        np.savez(tmp / f"{key}.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp), str(tmp),
         repr({c: CASES[c] for c in cases}), repr(TOPK), repr(LR),
         repr({c: _input(c) for c in CASES})],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cases in JAX_PROCS]
    two, four = _spawn(2, tmp, env), _spawn(4, tmp, env)
    logs = [p.communicate(timeout=WAIT)[0] for p in jax_procs]
    if any(p.returncode for p in jax_procs):
        (tmp / "jax_failed").touch()
    ranks2, ranks4 = base._collect(*two), base._collect(*four)
    for p, log in zip(jax_procs, logs):
        assert p.returncode == 0, log
    jx = {f"{c}/{k}": v for c in CASES
          for k, v in np.load(tmp / f"jax_{c}.npz").items()}
    return ranks2, ranks4, jx, str(tmp)


def _ranks(results, name: str) -> list:
    """Each rank's record of case ``name``."""
    ranks = results[0] if base._world(CASES[name][1]) == 2 else results[1]
    return [r[name] for r in ranks]


def _zero_grads(name: str, got: dict) -> float:
    """The density a worker's count of nonzeros may move by on the
    leaves whose gradient is zero in exact arithmetic: a cross attention's
    key bias (no RoPE there, so it shifts a query's scores alike and the
    softmax cancels it), float noise near 1e-8 on both sides, of which a
    coordinate may be exactly 0 on one side only. Its coordinates on the
    model workers, as a share of the density's mean over them."""
    arch, (_, _, n_model), _, vocab = CASES[name]
    shapes = param_shapes(_cfg(arch, vocab))
    zero = sum(int(np.prod(s)) for n, (s, _) in shapes.items()
               if n.startswith("cross/") and n.endswith("/attn/bk"))
    return zero / (n_model * got["param_bytes"] / 4)


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_matches_the_jax_step(results, name):
    """Each rank's shards of the parameters and the residual, and the
    metrics, after each step against JAX's step on the same mesh; a step
    starts from JAX's state after the step before exactly where that step
    swapped a near-tie on some rank."""
    arch, (_, data, n_model), steps, _ = CASES[name]
    ranks, jx = _ranks(results, name), results[2]
    block, atol = base._block, JAX_ATOL[arch]
    swapped = False
    for t in range(steps):
        assert all(got["steps"][t]["restarted"] == swapped
                   for got in ranks), (name, t, swapped)
        ties = {}
        for rank, got in enumerate(ranks):
            w, m = divmod(rank, n_model)
            for i, spec in enumerate(got["specs"]):
                ties[rank, i] = base._near_ties(
                    got["steps"][t]["residual"][i],
                    block(jx[f"{name}/s{t}/residual/{i}"][w], spec, n_model,
                          m), atol, (name, t, rank, i))
        swapped = any(x.any() for x in ties.values())
        for rank, got in enumerate(ranks):
            w, m = divmod(rank, n_model)
            for i, spec in enumerate(got["specs"]):
                keep = ~ties[rank, i]
                for other in range(m, len(ranks), n_model):   # its twins
                    keep &= ~ties[other, i]
                np.testing.assert_allclose(
                    got["steps"][t]["params"][i][keep],
                    block(jx[f"{name}/s{t}/params/{i}"], spec, n_model,
                          m)[keep], rtol=0, atol=atol,
                    err_msg=f"{name} step {t} params {i} rank {rank}")
            mt = got["steps"][t]["metrics"]
            for key in ("wire_bytes", "bits", "overflow"):
                assert mt[key] == float(jx[f"{name}/m{t}/{key}"]), \
                    (name, rank, t, key)
            np.testing.assert_allclose(
                mt["loss"], float(jx[f"{name}/m{t}/loss"]), rtol=1e-6,
                err_msg=f"{name} {t} loss")
            np.testing.assert_allclose(
                mt["density"], float(jx[f"{name}/m{t}/density"]),
                rtol=1e-6, atol=_zero_grads(name, got),
                err_msg=f"{name} {t} density")


@pytest.mark.parametrize("name", [c for c in CASES if not c.startswith("sm")])
def test_no_router_choice_sits_at_a_near_tie(results, name):
    """Every token's k-th router probability stands at least MARGIN above
    its (k+1)-th in every forward of the split step: a choice at a
    near-tie could flip between the packages' float orders, and this check
    names it where the comparison with JAX would only show its effects."""
    for rank, got in enumerate(_ranks(results, name)):
        assert got["margins"] and min(got["margins"]) > MARGIN, \
            (name, rank, min(got["margins"]))


@pytest.mark.parametrize("name", list(CASES))
def test_split_gradients_match_the_gathered_step(results, name):
    """Each rank's step-1 gradient shards (what it hands to the sync: a
    whole kv leaf's share summed over the model workers) against the
    gathered step's on the same rank and batch."""
    for rank, got in enumerate(_ranks(results, name)):
        for i, (a, b) in enumerate(zip(got["grad_split"],
                                       got["grad_gathered"])):
            assert a.shape == b.shape, (name, rank, i)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=GRAD_ATOL[CASES[name][0]],
                                       err_msg=f"{name} grad {i} {rank}")


def _kind_want(name: str, n: str) -> str:
    """A leaf's gradient kind: SPLIT where the specs split it, PARTIAL for
    phi3.5-moe's whole kv leaves at ``1x4``, SAME for the rest (the
    norms, the biases added once, the router, MLA's down projections, the
    table where it stays whole)."""
    if name == "phi_1x4" and n.endswith(("/attn/wk", "/attn/wv")):
        return tshd.PARTIAL
    whole = (n.endswith(("/scale", "/bias", "/bo", "/down_b", "/router",
                         "/q_down", "/kv_down", "/k_rope"))
             or (name == "sm_1x4" and n == "embed/table"))
    return tshd.SAME if whole else tshd.SPLIT


@pytest.mark.parametrize("name", list(CASES))
def test_a_worker_holds_its_shards_only(results, name):
    """Each rank's parameter bytes are the sum of its shards' bytes under
    the launcher's specs (float32: 4 a coordinate), below the whole
    model's; the leaves' gradient kinds are the arch's."""
    arch, (_, _, n_model), _, vocab = CASES[name]
    shapes = param_shapes(_cfg(arch, vocab))
    names = leaf_order(shapes)
    whole = 4 * sum(int(np.prod(shapes[n][0])) for n in names)
    for rank, got in enumerate(_ranks(results, name)):
        want = 4 * sum(
            int(np.prod([s.stop - s.start for s in tshd.worker_slices(
                shapes[n][0], spec, {"model": n_model},
                {"model": rank % n_model})]))
            for n, spec in zip(names, got["specs"]))
        assert got["param_bytes"] == want < whole, (name, rank)
        assert dict(zip(names, got["kinds"])) == {
            n: _kind_want(name, n) for n in names}, (name, rank)


def test_autograd_functions_against_the_whole_computation(results):
    ranks = [r["units"] for r in results[0]]
    for u in ranks:
        for case in ("moe", "mla", "cross"):
            assert u[case] <= 1e-12, (case, u[case])
    # the router's and the input's gradients: whole, so equal on both ranks
    for a, b in zip(*(u["moe_whole_grads"] for u in ranks)):
        np.testing.assert_array_equal(a, b)


def test_launcher_splits_deepseek_in_the_compressed_mode(results):
    """On two gloo ranks at ``--mesh 1x2 --mode compressed`` the launcher
    prints ``step=split`` for deepseek-v2 and holds part of its leaves."""
    for rank in results[0]:
        run = rank["launcher"]
        assert run["step"] == "split" and run["mode"] == "compressed"
        assert run["param_bytes"] < 4 * run["params"]
        assert all(np.isfinite(m["loss"]) and m["wire_bytes"] > 0
                   for m in run["metrics"])
    assert "mesh=(data=1, model=2) step=split mode=compressed" in \
        results[0][0]["launcher"]["out"]


def test_moe_split_checkpoint_is_the_gathered_file_and_resumes(results):
    """phi3.5-moe's split ``--mesh 1x2`` file holds the entries, in order,
    of the file the gathered step writes for the same parameters and
    states, bit for bit, the expert leaves among them; the run resumed from
    it is bit-equal to the unbroken one on both ranks: the parameters, the
    moments and every state of the leaves the rules split. The router is
    whole and compressed by each model worker on its own stream; the file
    holds one copy of its residual, ``last_sent`` and bound (model index
    0's, as a JAX global array holds one replica), so model index 1
    resumes from model index 0's, and the bounds the model workers then
    reduce together move on both (ROADMAP.md queue C): its states are held
    to the rule only where the split ones are."""
    tmp = results[3]
    with np.load(os.path.join(tmp, "moe_split12.npz")) as a, \
            np.load(os.path.join(tmp, "moe_gathered12.npz")) as b:
        assert list(a.keys()) == list(b.keys())
        assert "params/blocks/b0_attn_full/ffn/w_gate" in a.keys()
        for key in a.keys():
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    names = leaf_order(param_shapes(_cfg(PHI, None)))
    for rank in results[0]:
        x, y = rank["ckpt"]["unbroken"], rank["ckpt"]["resumed"]
        own = rank["ckpt"]["own_states"]
        assert [names[i] for i in own] == ["blocks/b0_attn_full/ffn/router"]
        assert x["steps"] == y["steps"] == (3, 3)
        for field in ("params", "m", "v", "residual", "last_sent", "bound"):
            for i, (p, q) in enumerate(zip(x[field], y[field])):
                if field in ("params", "m", "v") or i not in own:
                    np.testing.assert_array_equal(p, q,
                                                  err_msg=f"{field} {i}")
