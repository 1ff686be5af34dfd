"""The architectures of the port past gemma-2b (gemma2-9b, gemma2-27b,
starcoder2-7b: sliding windows, logit softcaps, sandwich norms, a query
scale, LayerNorm, biases and the plain GELU MLP; phi3.5-moe-42b-a6.6b: MoE
FFNs; deepseek-v2-236b: MLA, a prelude, shared experts and the first dense
FFN; rwkv6-1.6b: RWKV-6 blocks; zamba2-2.7b: Mamba-2 blocks and the
shared attention block with its per-site LoRA; paligemma-3b: a prefix of
stub patch embeddings; seamless-m4t-large-v2: the encoder over stub frame
embeddings and the decoder's cross-attention) against the JAX package,
on their smoke configs in float32 with the JAX weights carried across by
``repro_torch.models.convert``, each batch carrying the arch's stub inputs
(``prefix`` or ``enc_embeds``, bfloat16, from a numpy seed; ``_stubs``):

- loss (the MoE auxiliary loss included) and every gradient, taken as the
  train step takes them (``step._local_grads`` on ``make_loss_fn``),
  within rtol 1e-5 / atol 1e-6 (float32 products summed in other orders;
  starcoder2, phi3.5-moe, deepseek-v2, rwkv6 and zamba2 at the atol of
  ``GRAD_ATOL``), and with a ``loss_mask``; zamba2's
  ``blocks/b0_shared_attn/ln1/scale``, which no site reads, gets exact
  zeros on both sides;
- the leaf order and shapes (full width, JAX's ``eval_shape``) and the
  compression plan (``plan_tree``) equal JAX's, zamba2's dense
  passthrough group included;
- the wire bytes of ``sync_tree`` on gspar's gather wire, ``auto`` layout,
  one worker, equal JAX's, on gradients whose every nonzero gspar keeps
  (so both packages keep the same coordinates whatever their uniforms);
- two compressed train steps with EF and Adam against a JAX step assembled
  from the JAX package's pieces (``make_loss_fn``, Algorithm 3's
  ``greedy_probabilities`` and ``apply_mask`` fed the port's uniforms,
  the optimizer: Adam, SGD for starcoder2, see ``OPTIMIZER``), the
  tolerances of ``tests/test_torch_step.py``;
- the window mask biting at sequence 16 > window 8, units for
  ``layernorm``, ``dense_mlp`` and ``softcap``, and the bfloat16 cases of
  the query scale (rounded to bfloat16 before the product, as JAX's weak
  type does) and the final softcap, bit for bit;
- the launcher on the new archs (deepseek-v2 in its fsdp mode),
  ``--xla-preset``, and the refusals.
"""
import dataclasses
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import repro  # noqa: F401  (jax API shims first)
from repro.comm.sync import sync_tree as jsync_tree
from repro.configs import registry as jregistry
from repro.core.api import CompressionConfig as JConfig
from repro.core.grouping import plan_tree as jplan_tree
from repro.core import sparsify as jsparsify
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro_torch.comm import sync as tsync
from repro_torch.configs import registry as tregistry
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.grouping import plan_tree as tplan_tree
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = ["gemma2-9b", "gemma2-27b", "starcoder2-7b", "phi3.5-moe-42b-a6.6b",
         "deepseek-v2-236b", "rwkv6-1.6b", "zamba2-2.7b", "paligemma-3b",
         "seamless-m4t-large-v2"]
# the depth each arch is cut to on one 80 GB card (widths as published;
# rwkv6, zamba2, paligemma and seamless fit at full depth)
CUTS = {"gemma2-9b": 4, "gemma2-27b": 1, "starcoder2-7b": 10,
        "phi3.5-moe-42b-a6.6b": 2, "deepseek-v2-236b": 1, "rwkv6-1.6b": 24,
        "zamba2-2.7b": 9, "paligemma-3b": 18, "seamless-m4t-large-v2": 24}
UNREAD = {"zamba2-2.7b": "blocks/b0_shared_attn/ln1/scale"}
RHO, LR, SEED = 0.05, 1e-3, 11
# starcoder2's JAX init puts its logits near 100 (loss 100.8 against
# ln 512 = 6.2: LayerNorm scale 1, an N(0, 1) tied embedding, no embed
# scaling), where float32's softmax carries a relative error of eps x
# |logit|, about 1e-5, on both sides; at atol 1e-6, 3 of the 42,336
# coordinates of ``attn/wv``'s gradient, near zero, differ by up to 1.5e-6.
# The two new smoke configs init the same way (phi3.5-moe: LayerNorm, loss
# 141; deepseek-v2: RMSNorm without embed scaling, loss 76): phi3.5-moe's
# ``attn/wk`` gradient differs by up to 1.5e-6 on 5 of 32,768 coordinates,
# deepseek-v2's ``prelude/.../attn/kv_down`` by up to 2.0e-6 on 16 of 4,096.
# rwkv6 (LayerNorm, loss 76.6) and zamba2 (loss 55.1) likewise: rwkv6's
# ``tm/wr``, ``tm/wv`` and ``cm/wv`` by up to 1.6e-6 on 4 coordinates,
# zamba2's ``shared/in_proj`` (9 sites' sum) and ``conv_w`` by up to 1.5e-6
# on 7. seamless (LayerNorm, loss 41.7): its encoder's ``ln1/bias``, whose
# gradient sums 24 block inputs' worth of the stub frames' N(0, 1) scale,
# by 1.5e-6 (relative 4.6e-5) on 1 of 256 coordinates; paligemma (loss
# 260.4, gemma-2b's init) holds 1e-6
GRAD_ATOL = {"gemma2-9b": 1e-6, "gemma2-27b": 1e-6, "starcoder2-7b": 2e-6,
             "phi3.5-moe-42b-a6.6b": 2e-6, "deepseek-v2-236b": 4e-6,
             "rwkv6-1.6b": 2e-6, "zamba2-2.7b": 2e-6, "paligemma-3b": 1e-6,
             "seamless-m4t-large-v2": 2e-6}
# the optimizer of the two-step test: Adam, as the launcher, except for
# starcoder2, whose bias gradients are mostly that noise (``bk``'s would be
# 0 but for RoPE: a key bias shifts every score of a query alike), which
# Adam's first step normalizes to +-lr (13 of ``bk``'s 168 coordinates
# then differ by up to 9.1e-5); plain SGD keeps the noise at lr x 1e-6.
# seamless likewise: its cross-attention's ``bk`` gradient is exactly 0 but
# for that noise (no RoPE there), so Adam's first step puts 255 of its 256
# coordinates at a random +-lr on each side
OPTIMIZER = {"gemma2-9b": "adam", "gemma2-27b": "adam",
             "starcoder2-7b": "sgd", "phi3.5-moe-42b-a6.6b": "adam",
             "deepseek-v2-236b": "adam", "rwkv6-1.6b": "adam",
             "zamba2-2.7b": "adam", "paligemma-3b": "adam",
             "seamless-m4t-large-v2": "sgd"}
# the two-step test's atol: the residual after two steps carries two
# gradients, so starcoder2's noise twice (up to 3.5e-6 measured; phi3.5-moe
# 3.5e-6 on one ``attn/wv`` coordinate, deepseek-v2 1.6e-6 on ``kv_down``,
# seamless 1.7e-6 on 10 of ``cross/x0/attn/wv``'s 32,768)
STEP_ATOL = {"gemma2-9b": 1e-6, "gemma2-27b": 1e-6, "starcoder2-7b": 4e-6,
             "phi3.5-moe-42b-a6.6b": 4e-6, "deepseek-v2-236b": 4e-6,
             "rwkv6-1.6b": 4e-6, "zamba2-2.7b": 4e-6, "paligemma-3b": 1e-6,
             "seamless-m4t-large-v2": 4e-6}


def _cfgs(arch: str):
    return jregistry.get(arch).smoke, tregistry.get(arch).smoke


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    jcfg = _cfgs(arch)[0]
    return jax.jit(lambda k: split_params(jtf.init_model(k, jcfg))[0])(
        jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch: str):
    """JAX's loss and gradients, the batch always carrying a ``loss_mask``
    (all ones where a test means none: multiplying by 1 is exact), so that
    the tests of one arch share one compile."""
    return jax.jit(jax.value_and_grad(jstep.make_loss_fn(_cfgs(arch)[0])))


def _stubs(arch: str, batch: int, seed: int) -> dict[str, np.ndarray]:
    """The smoke config's stub inputs past the tokens (``prefix`` or
    ``enc_embeds``; none for a text model), shaped as the launcher's
    (``launch.specs.stub_inputs``): standard normals from a numpy seed,
    rounded to bfloat16 and kept as float32 arrays of those values."""
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dtype).float().numpy()
            for name, (shape, dtype) in tspecs.stub_inputs(
                _cfgs(arch)[1], batch).items()}


def _tbatch(tokens, stubs: dict, **extra) -> dict[str, torch.Tensor]:
    """The port's batch: the tokens, the stub inputs in bfloat16 (as the
    launcher draws them) and any ``extra`` arrays."""
    out = {"tokens": torch.from_numpy(tokens)}
    out.update({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in stubs.items()})
    out.update({k: torch.from_numpy(v) for k, v in extra.items()})
    return out


def _jax_loss(arch, params, tokens, mask=None, stubs=None):
    mask = np.ones(tokens.shape, np.float32) if mask is None else mask
    batch = {"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)}
    batch.update({k: jnp.asarray(v, jnp.bfloat16)
                  for k, v in (stubs or {}).items()})
    return _jax_value_and_grad(arch)(params, batch)


def _paths(tree) -> list[str]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(k.key for k in path) for path, _ in flat]


def _model(arch: str) -> ttf.Transformer:
    return ttf.Transformer(_cfgs(arch)[1], params_from_numpy(
        jax.tree.map(np.asarray, _jax_params(arch))))


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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    params = _jax_params(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16))
    stubs = _stubs(arch, 2, 10)
    loss, grads = _jax_loss(arch, params, tokens, stubs=stubs)
    model = _model(arch)
    tloss, tgrads = tstep._local_grads(model, model.leaves(),
                                       tstep.make_loss_fn(tcfg),
                                       _tbatch(tokens, stubs))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5,
                               atol=1e-6)
    assert _paths(grads) == model.leaf_names
    for name, g, tg in zip(_paths(grads), jax.tree.leaves(grads), tgrads):
        assert tg.shape == g.shape and tg.dtype == tcfg.dtype
        if name == UNREAD.get(arch):       # no site reads it: exact zeros
            assert not np.asarray(g).any() and not tg.any()
            continue
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=GRAD_ATOL[arch], err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_mask_is_honoured(arch):
    """``batch["loss_mask"]`` multiplies the next-token mask: the loss
    equals JAX's and the mean of the kept positions' losses, plus the MoE
    auxiliary loss (0.0 without MoE)."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (2, 16))
    mask = (rng.random((2, 16)) < 0.5).astype(np.float32)
    stubs = _stubs(arch, 2, 11)
    want = _jax_loss(arch, _jax_params(arch), tokens, mask, stubs)[0]
    model = _model(arch)
    batch = _tbatch(tokens, stubs, loss_mask=mask)
    with torch.no_grad():
        got = tstep.make_loss_fn(tcfg)(dict(model.params), batch)
        logits, aux = model(batch["tokens"], prefix=batch.get("prefix"),
                            enc_embeds=batch.get("enc_embeds"))
        logits = logits.double()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    nll = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.roll(torch.from_numpy(tokens), -1, 1)[..., None]
    )[..., 0])[:, :-1]
    keep = torch.from_numpy(mask)[:, :-1].double()
    np.testing.assert_allclose(got.item(),
                               float((nll * keep).sum() / keep.sum() + aux),
                               rtol=1e-5)
    assert (float(aux) > 0.0) == (tcfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_and_plan_match_jax(arch):
    """Leaf paths and shapes at full width and at the cut depth, and the
    plan's groups, members and capacities at the cut (min_leaf_size 1024,
    the launcher's) and at the smoke size (256: starcoder2's biases become
    sparse rows)."""
    spec_j, spec_t = jregistry.get(arch), tregistry.get(arch)
    for n in (None, CUTS[arch]):
        jcfg = spec_j.model if n is None else dataclasses.replace(
            spec_j.model, num_periods=n)
        tcfg = spec_t.model if n is None else dataclasses.replace(
            spec_t.model, num_periods=n)
        shapes = jax.eval_shape(lambda: split_params(jtf.init_model(
            jax.random.key(0), jcfg))[0])
        names = ttf.leaf_order(ttf.param_shapes(tcfg))
        assert names == _paths(shapes)
        tshapes = ttf.param_shapes(tcfg)
        assert [tshapes[k][0] for k in names] == [
            x.shape for x in jax.tree.leaves(shapes)]
    for tcfg, jcfg, min_leaf in ((tcfg, jcfg, 1024),
                                 (spec_t.smoke, spec_j.smoke, 256)):
        leaves = jax.tree.leaves(jax.eval_shape(lambda: split_params(
            jtf.init_model(jax.random.key(0), jcfg))[0]))
        shapes = ttf.param_shapes(tcfg)
        stk = [shapes[k][1] for k in ttf.leaf_order(shapes)]
        kw = dict(name="gspar", rho=RHO, min_leaf_size=min_leaf,
                  wire="gather")
        jplan = jplan_tree(JConfig(**kw), leaves, stk)
        tleaves = [torch.empty(x.shape, dtype=tcfg.dtype, device="meta")
                   for x in leaves]
        tplan = tplan_tree(TConfig(**kw), tleaves, stk)
        assert len(tplan.groups) == len(jplan.groups)
        for tg, jg in zip(tplan.groups, jplan.groups):
            assert (tg.kind, tg.dtype, tg.d, tg.k_cap, tg.members,
                    tg.row_chunks) == (jg.kind, jg.dtype, jg.d, jg.k_cap,
                                       jg.members, jg.row_chunks)
    if arch == "starcoder2-7b":
        bq = ttf.leaf_order(shapes).index("blocks/b0_attn_sw/attn/bq")
        assert any(g.kind == "sparse" and g.d == 252 and (bq, 2) in g.members
                   for g in tplan.groups)


def _kept_support(shape, rng) -> np.ndarray:
    """A gradient gspar keeps whole: each row's nonzeros (a third of rho's
    budget, random signs) of one magnitude, so every one reaches
    probability 1 at the first lambda. A leaf whose rows along axis 0 are
    too short for a third of the budget to reach one coordinate (under 60:
    deepseek-v2's ``k_rope``, [128, 8]) takes its support as one row, as
    the plan compresses an unstacked leaf: one nonzero forced into each
    row of 8 would hold 12.5 %, more than gspar keeps whole."""
    short = len(shape) > 1 and int(RHO * np.prod(shape[1:])) // 3 == 0
    g = np.zeros(shape, np.float32).reshape(shape[0], -1) if (
        len(shape) > 1 and not short) \
        else np.zeros((1, int(np.prod(shape))), np.float32)
    d = g.shape[1]
    k = max(1, int(RHO * d) // 3)
    for row in g:
        idx = rng.choice(d, size=k, replace=False)
        row[idx] = rng.choice([-0.5, 0.5], size=k)
    return g.reshape(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_wire_bytes_match_jax(arch, one_worker_group):
    """gspar on the gather wire's ``auto`` layout at one worker: the layouts
    the plan stamps and ``SyncStats.wire_bytes`` (values, counts and the
    realized Golomb-Rice words) equal the JAX package's byte for byte."""
    jcfg, tcfg = _cfgs(arch)
    params = _jax_params(arch)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: _kept_support(p.shape, rng), params)
    shapes = ttf.param_shapes(tcfg)
    stk = [shapes[k][1] for k in ttf.leaf_order(shapes)]
    kw = dict(name="gspar", rho=RHO, min_leaf_size=256)
    jc = JConfig(wire="gather", backend="reference", **kw)
    stacked_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), stk)

    def one_worker(key, g):
        _, _, stats = jsync_tree(jc, key, g, data_axis="data",
                                 stacked=stacked_tree)
        return stats.wire_bytes, stats.density

    mesh = jax.make_mesh((1,), ("data",))
    with jax.set_mesh(mesh):
        jwire, jdens = jax.jit(jax.shard_map(
            one_worker, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
            axis_names={"data"}, check_vma=False))(
                jax.random.key(0), jax.tree.map(jnp.asarray, grads))
    leaves = [torch.from_numpy(np.asarray(g))
              for g in jax.tree.leaves(grads)]
    _, _, stats = tsync.sync_tree(TConfig(wire="gather", **kw),
                                  torch.Generator(), leaves, stacked=stk)
    nnz = sum(int(np.count_nonzero(g)) for g in jax.tree.leaves(grads))
    assert float(stats.density) == np.float32(nnz) / np.float32(
        sum(g.size for g in jax.tree.leaves(grads))) == float(jdens)
    assert float(stats.wire_bytes) == float(jwire)
    assert {lay for *_, lay in stats.layouts} >= {"rice"}
    assert float(stats.overflow) == 0.0


@functools.lru_cache(maxsize=None)
def _jax_gspar_rows(rows: int, d: int):
    """Algorithm 3 of the JAX package (``core.sparsify``) on each row of a
    ``[rows, d]`` target, the uniforms given: ``(Q, p)``."""
    def row(g, u):
        p = jsparsify.greedy_probabilities(g, RHO)
        return jsparsify.apply_mask(g, p, (u < p).astype(p.dtype)), p
    return jax.jit(jax.vmap(row))


def _jax_ef_steps(arch: str, tokens: np.ndarray, stubs: list):
    """Two Algorithm-1 steps with EF and ``OPTIMIZER[arch]`` at one worker,
    from the JAX package's pieces (its loss, Algorithm 3's probabilities
    and mask, the optimizer), the gspar uniforms drawn in group order from one generator
    as the port's step draws them. Returns the new parameter leaves, the
    residual leaves and the exempt masks (coordinates whose uniform lies
    within 1e-5 of its keep probability in either step)."""
    tcfg = _cfgs(arch)[1]
    params = _jax_params(arch)
    shapes = ttf.param_shapes(tcfg)
    stacked = [shapes[k][1] for k in ttf.leaf_order(shapes)]
    opt = jopt.make_optimizer(OPTIMIZER[arch], LR)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(SEED)
    residual = exempt = None
    for batch, stub in zip(tokens, stubs):
        grads = _jax_loss(arch, params, batch, stubs=stub)[1]
        leaves, tdef = jax.tree_util.tree_flatten(grads)
        leaves = [np.asarray(g) for g in leaves]
        if residual is not None:
            leaves = [g + r for g, r in zip(leaves, residual)]
        plan = jplan_tree(JConfig(name="gspar", rho=RHO, wire="gather",
                                  min_leaf_size=1024), leaves, stacked)
        synced, residual, near = ([None] * len(leaves) for _ in range(3))
        for grp in plan.groups:
            if grp.kind == "dense":
                for i, _ in grp.members:
                    synced[i] = leaves[i]
                    residual[i] = np.zeros_like(leaves[i])
                    near[i] = np.zeros(leaves[i].shape, bool)
                continue
            stack = np.concatenate([leaves[i].reshape(rows, grp.d)
                                    for i, rows in grp.members])
            u = torch.rand((grp.rows, grp.d), generator=gen,
                           dtype=torch.float32).numpy()
            q, p = (np.asarray(a) for a in _jax_gspar_rows(
                grp.rows, grp.d)(jnp.asarray(stack), jnp.asarray(u)))
            close = np.abs(u - p) < 1e-5
            r0 = 0
            for i, rows in grp.members:
                shape = leaves[i].shape
                synced[i] = q[r0:r0 + rows].reshape(shape)
                residual[i] = (stack[r0:r0 + rows] - q[r0:r0 + rows]
                               ).reshape(shape)
                near[i] = close[r0:r0 + rows].reshape(shape)
                r0 += rows
        exempt = near if exempt is None else [
            a | b for a, b in zip(exempt, near)]
        params, state = opt.update(
            jax.tree_util.tree_unflatten(tdef, synced), state, params)
    return ([np.asarray(x) for x in jax.tree.leaves(params)], residual,
            exempt)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ef_train_steps_match_jax(arch, one_worker_group):
    """The port's compressed step (gspar, the gather wire's ``auto``, EF,
    ``OPTIMIZER[arch]``) twice against the JAX pieces: new parameters within atol 1e-6,
    the residual within rtol 1e-5 / atol 1e-6 (starcoder2 at
    ``STEP_ATOL``, for both), except at the exempt coordinates
    (at most 0.1 %)."""
    tokens = np.random.default_rng(5).integers(0, 512, (2, 2, 16))
    stubs = [_stubs(arch, 2, 12 + t) for t in range(2)]
    want_p, want_r, exempt = _jax_ef_steps(arch, tokens, stubs)
    model = _model(arch)
    comp = TConfig(name="gspar", rho=RHO, error_feedback=True,
                   min_leaf_size=1024, wire="gather")
    opt = topt.make_optimizer(OPTIMIZER[arch], LR)
    step = tstep.make_compressed_train_step(model, comp, opt)
    state, fb = opt.init(model.leaves()), topt.init_feedback(model.leaves())
    gen = torch.Generator().manual_seed(SEED)
    for batch, stub in zip(tokens, stubs):
        state, fb, metrics = step(state, fb, _tbatch(batch, stub), gen)
        assert float(metrics["overflow"]) == 0.0
    assert "rice" in {lay for *_, lay in step.layouts}
    n_exempt = sum(int(e.sum()) for e in exempt)
    assert n_exempt <= 1e-3 * sum(e.size for e in exempt)
    atol = STEP_ATOL[arch]
    for name, p, r, wp, wr, ex in zip(model.leaf_names, model.leaves(),
                                      fb.residual, want_p, want_r, exempt):
        keep = ~ex
        np.testing.assert_allclose(p.detach().numpy()[keep], wp[keep],
                                   rtol=0, atol=atol, err_msg=name)
        np.testing.assert_allclose(r.numpy()[keep], wr[keep], rtol=1e-5,
                                   atol=atol, err_msg=name)


def test_window_mask_bites_past_the_window():
    """At sequence 16 > window 8 the sliding window hides keys more than 7
    back: the mask is JAX's, the attention agrees with JAX's with and
    without the window, and the window changes exactly the queries past
    it."""
    jcfg, tcfg = _cfgs("gemma2-9b")
    np.testing.assert_array_equal(
        tattn.causal_mask(16, 16, "cpu", 8).numpy(),
        np.asarray(jattn.causal_mask(16, 16, 8)))
    p = jax.tree.map(np.asarray, _jax_params("gemma2-9b"))
    blk = {k: v[0] for k, v in p["blocks"]["b0_attn_sw"]["attn"].items()}
    x = np.random.default_rng(3).standard_normal((2, 16, 256)).astype(
        np.float32)
    outs = {}
    for kind in ("attn_sw", "attn_full"):
        want = jattn.attention_train(blk, jcfg.attn_cfg(kind), jnp.asarray(x))
        got = tattn.attention_train(
            {k: torch.from_numpy(v) for k, v in blk.items()},
            tcfg.attn_cfg(kind), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        outs[kind] = got.numpy()
    assert tcfg.attn_cfg("attn_sw").window == 8
    assert tcfg.attn_cfg("attn_full").window is None
    np.testing.assert_array_equal(outs["attn_sw"][:, :8],
                                  outs["attn_full"][:, :8])
    assert (np.abs(outs["attn_sw"][:, 8:] - outs["attn_full"][:, 8:])
            .max(-1) > 1e-3).all()


def test_layer_units_match_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 8, 252)) * 3).astype(np.float32)
    sc, b = (rng.standard_normal(252).astype(np.float32) for _ in range(2))
    up = (rng.standard_normal((252, 512)) / 16).astype(np.float32)
    down = (rng.standard_normal((512, 252)) / 22).astype(np.float32)
    up_b, down_b = (rng.standard_normal(n).astype(np.float32)
                    for n in (512, 252))
    t = torch.from_numpy
    np.testing.assert_allclose(
        tlayers.layernorm(t(sc), t(b), t(x)).numpy(),
        np.asarray(jlayers.layernorm({"scale": sc, "bias": b}, x)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlayers.dense_mlp(t(up), t(up_b), t(down), t(down_b), t(x)).numpy(),
        np.asarray(jlayers.dense_mlp({"up": up, "up_b": up_b, "down": down,
                                      "down_b": down_b}, x)),
        rtol=1e-5, atol=1e-5)
    for cap in (30.0, 50.0, None):
        np.testing.assert_allclose(
            tlayers.softcap(t(x * 20), cap).numpy(),
            np.asarray(jlayers.softcap(x * 20, cap)), rtol=1e-6, atol=1e-5)
    # population variance, eps 1e-5; scale 1, bias 0 is the standard form
    ln = tlayers.layernorm(torch.ones(252), torch.zeros(252), t(x)).double()
    np.testing.assert_allclose(ln.mean(-1).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(ln.var(-1, unbiased=False).numpy(), 1.0,
                               rtol=1e-5)


def _bf16(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x))


@pytest.mark.parametrize("hd,scale,bias", [
    (128, (4608 / 32) ** -0.5, False),   # gemma2-27b's 144^-0.5
    (128, None, True),                   # starcoder2's 128^-0.5, biases
    (256, None, False)])                 # gemma2-9b's 256^-0.5 (exact)
def test_bf16_query_scale_matches_jax_bit_for_bit(hd, scale, bias):
    """JAX multiplies a bfloat16 q by the scale as a weakly typed Python
    float, so by the scale rounded to bfloat16; the port does the same (a
    float32 product rounded once differs). One-hot projections make the
    products exact, so only the bias add and the scale are compared."""
    rng = np.random.default_rng(7)
    d, h, kv = 64, 4, 2
    x = jnp.asarray(rng.standard_normal((2, 8, d)), jnp.bfloat16)

    def one_hot(heads):
        w = np.zeros((d, heads, hd), np.float32)
        for j in range(heads):
            w[(j * hd + np.arange(hd)) % d, j, np.arange(hd)] = 1.0
        return jnp.asarray(w, jnp.bfloat16)

    p = {"wq": one_hot(h), "wk": one_hot(kv), "wv": one_hot(kv)}
    p.update({k: jnp.asarray(rng.standard_normal(s) * 0.1, jnp.bfloat16)
              for k, s in (("bq", (h, hd)), ("bk", (kv, hd)),
                           ("bv", (kv, hd)))})
    kw = dict(d_model=d, num_heads=h, num_kv_heads=kv, head_dim=hd,
              query_scale=scale, use_bias=bias)
    want = jax.jit(lambda p, x: jattn._qkv(p, jattn.AttnConfig(**kw), x))(
        p, x)
    cfg = tattn.AttnConfig(**kw)
    got = tattn._qkv({k: _bf16(v) for k, v in p.items()}, cfg, _bf16(x))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), _bf16(b).view(torch.int16))
    q = torch.einsum("bsd,dhk->bshk", _bf16(x), _bf16(p["wq"]))
    if bias:
        q = q + _bf16(p["bq"])
    once = (q.float() * cfg.scale).to(torch.bfloat16)
    assert torch.equal(once, got[0]) == (float(torch.tensor(
        cfg.scale, dtype=torch.bfloat16)) == cfg.scale)


def test_bf16_final_softcap_matches_jax_bit_for_bit():
    """``tanh(x / cap) * cap`` on bfloat16 logits rounds after each op in
    both packages (XLA:CPU does not fuse it into one float32 rounding)."""
    x = jnp.asarray(np.random.default_rng(8).standard_normal((4, 64, 512))
                    * 40, jnp.bfloat16)
    want = jax.jit(lambda x: jlayers.softcap(x, 30.0))(x)
    got = tlayers.softcap(_bf16(x), 30.0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), _bf16(want).view(torch.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_arch_on_cpu(arch):
    """Two steps of gspar with EF in the arch's own mode: the gather wire's
    ``auto`` in the compressed mode (no overflow), Q of the averaged
    gradient in deepseek-v2's fsdp mode (``--wire`` does not act there)."""
    out = tlaunch.main(["--arch", arch, "--smoke", "--steps", "2",
                        "--device", "cpu", "--wire", "gather",
                        "--error-feedback", "--xla-preset", "none"])
    mode = tregistry.get(arch).train_mode
    assert out["mode"] == mode == ("fsdp" if arch == "deepseek-v2-236b"
                                   else "compressed")
    for m in out["metrics"]:
        assert np.isfinite(m["loss"]) and 0.0 < m["density"] <= 1.25 * RHO
        assert m["overflow"] == 0.0 if mode == "compressed" else (
            "wire_bytes" not in m and out["layouts"] == [])
    assert out["params"] == sum(
        int(np.prod(s)) for s, _ in ttf.param_shapes(
            tregistry.get(arch).smoke).values())


@pytest.mark.parametrize("preset", ["async", "latency_hiding", "overlap",
                                    "fast"])
def test_launcher_refuses_the_xla_presets(preset):
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        tlaunch.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                      "--device", "cpu", "--xla-preset", preset])


def test_what_is_not_ported_is_refused():
    """Sequence-parallel attention names queue A item 10d and stays
    refused, and so do untied embeddings, which the JAX package declares
    but never reads; chunked attention, the encoder-decoder and prefix
    fields and the two architectures that use them are now accepted."""
    cfg = tregistry.get("gemma2-9b").smoke
    with pytest.raises(NotImplementedError, match="queue A item 10d"):
        dataclasses.replace(cfg, attn_impl="seq_parallel")
    assert dataclasses.replace(cfg, attn_impl="chunked").attn_cfg(
        "attn_sw").impl == "chunked"
    with pytest.raises(NotImplementedError, match="never reads it"):
        dataclasses.replace(cfg, tie_embeddings=False)
    for kw in (dict(encoder_periods=2), dict(prefix_len=16),
               dict(prefix_len=16, modality="vision")):
        assert dataclasses.replace(cfg, **kw).encoder_periods == kw.get(
            "encoder_periods", 0)
    with pytest.raises(ValueError, match="modality"):
        dataclasses.replace(cfg, modality="video")
    for arch in ("seamless-m4t-large-v2", "paligemma-3b"):
        spec = tregistry.get(arch)
        assert spec.model.modality == jregistry.get(arch).model.modality
