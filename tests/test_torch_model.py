"""The port's gemma model and compression plan against the JAX package, on
the gemma-2b smoke config in float32 with the JAX weights carried across by
``repro_torch.models.convert``: loss and every gradient within rtol 1e-5 /
atol 1e-6 (float32 matrix products summed in another order), the leaf order,
the shape groups and capacities of ``plan_tree``, and the realized wire
bytes of ``sync_tree`` on one worker, exactly."""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.comm import compaction as jcompaction
from repro.comm.sync import sync_tree as jsync_tree
from repro.core import coding as jcoding
from repro.configs import gemma_2b as jgemma
from repro.core.api import CompressionConfig as JConfig
from repro.core.grouping import plan_tree as jplan_tree
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.train import step as jstep
from repro_torch.comm import compaction as tcompaction
from repro_torch.comm import sync as tsync
from repro_torch.core import coding as tcoding
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.core.api import CompressionConfig as TConfig
from repro_torch.core.grouping import plan_tree as tplan_tree
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import step as tstep

# small inputs: one intra-op thread keeps the parallel test run from
# oversubscribing the host's cores
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False


def _jax_params(cfg):
    return jax.jit(lambda k: split_params(jtf.init_model(k, cfg))[0])(
        jax.random.key(0))


def _paths(tree) -> list[str]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(k.key for k in path) for path, _ in flat]


def _stacked(cfg) -> list[bool]:
    shapes = ttf.param_shapes(cfg)
    return [shapes[n][1] for n in ttf.leaf_order(shapes)]


@pytest.fixture
def one_worker_group():
    """A one-rank gloo process group for the port's collectives."""
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_leaf_order_matches_jax_flatten():
    params = jax.eval_shape(lambda: _jax_params(jgemma.FULL))
    names = ttf.leaf_order(ttf.param_shapes(tgemma.FULL))
    assert names == _paths(params)
    for name, leaf in zip(names, jax.tree.leaves(params)):
        assert ttf.param_shapes(tgemma.FULL)[name][0] == leaf.shape


def test_loss_and_grads_match_jax():
    jcfg, tcfg = jgemma.SMOKE, tgemma.SMOKE
    params = _jax_params(jcfg)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16))
    loss, grads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jcfg)))(
        params, {"tokens": jnp.asarray(tokens)})
    model = ttf.Transformer(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params)))
    tloss = tstep.make_loss_fn(tcfg)(dict(model.params),
                                     {"tokens": torch.from_numpy(tokens)})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5,
                               atol=1e-6)
    for name, g in zip(_paths(grads), jax.tree.leaves(grads)):
        np.testing.assert_allclose(model.params[name].grad.numpy(),
                                   np.asarray(g), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("arch,rho,min_leaf,cap", [
    ("full", 0.05, 1024, 2**31 - 1), ("full", 0.1, 256, 600_000_000),
    ("smoke", 0.05, 1024, 2**31 - 1), ("smoke", 0.1, 256, 300_000)])
def test_plan_tree_matches_jax(arch, rho, min_leaf, cap):
    """Groups, members, capacities and row chunks, with and without chunking
    (the full tree's 2.5e9 coordinates split at the int32 cap)."""
    jcfg = {"full": jgemma.FULL, "smoke": jgemma.SMOKE}[arch]
    tcfg = {"full": tgemma.FULL, "smoke": tgemma.SMOKE}[arch]
    leaves = jax.tree.leaves(jax.eval_shape(lambda: _jax_params(jcfg)))
    stk = _stacked(tcfg)
    kw = dict(name="gspar", rho=rho, min_leaf_size=min_leaf,
              bucket_coord_cap=cap, wire_layout="coo")
    jplan = jplan_tree(JConfig(wire="gather", **kw), leaves, stk)
    tleaves = [torch.empty(leaf.shape, dtype=tcfg.dtype, device="meta")
               for leaf in leaves]
    tplan = tplan_tree(TConfig(wire="gather", **kw), tleaves, stk)
    assert len(tplan.groups) == len(jplan.groups)
    for tg, jg in zip(tplan.groups, jplan.groups):
        assert (tg.kind, tg.dtype, tg.d, tg.k_cap, tg.members,
                tg.row_chunks) == (jg.kind, jg.dtype, jg.d, jg.k_cap,
                                   jg.members, jg.row_chunks)
    assert tplan.chunk_count == jplan.chunk_count


@pytest.mark.parametrize("codec", ["f32", "bf16"])
def test_wire_bytes_match_jax(codec, one_worker_group):
    """SyncStats.wire_bytes of the gather wire (COO values and int32
    indices, plus the float32 dense passthrough of the tiny leaves) on one
    worker equals the JAX package's byte for byte."""
    params = _jax_params(jgemma.SMOKE)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    stk = _stacked(tgemma.SMOKE)
    kw = dict(name=f"gspar+{codec}", rho=0.05, min_leaf_size=1024,
              wire_layout="coo")
    jcfg = JConfig(wire="gather", backend="reference", **kw)
    stacked_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), stk)

    def one_worker(key, g):
        _, _, stats = jsync_tree(jcfg, key, g, data_axis="data",
                                 stacked=stacked_tree)
        return stats.wire_bytes

    mesh = jax.make_mesh((1,), ("data",))
    with jax.set_mesh(mesh):
        jwire = jax.jit(jax.shard_map(
            one_worker, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
            axis_names={"data"}, check_vma=False))(
                jax.random.key(0), jax.tree.map(jnp.asarray, grads))
    leaves = [torch.from_numpy(np.asarray(g))
              for g in jax.tree.leaves(grads)]
    _, _, stats = tsync.sync_tree(TConfig(wire="gather", **kw),
                                  torch.Generator(), leaves,
                                  stacked=stk)
    assert float(stats.wire_bytes) == float(jwire)
    assert float(stats.overflow) == 0.0


@pytest.mark.parametrize("d,rho", [(2048, 0.05), (100_003, 0.1),
                                   (524_288_000, 0.05), (300, 0.9)])
def test_capacity_and_bit_accounting_match_jax(d, rho):
    k_cap = tcompaction.capacity_for(d, rho)
    assert k_cap == jcompaction.capacity_for(d, rho)
    for vb in (16.0, 32.0):
        assert (tcoding.realized_wire_bits("coo", k_cap, d, vb)
                == jcoding.realized_wire_bits("coo", k_cap, d, vb))
    assert tcoding.dense_coding_bits(d) == jcoding.dense_coding_bits(d)
    if d < 10**6:
        rng = np.random.default_rng(d)
        idx = np.sort(rng.choice(d, size=k_cap // 2, replace=False))
        idx = np.concatenate([idx, np.zeros(k_cap - idx.size, np.int64)])
        vals = rng.standard_normal(k_cap).astype(np.float32)
        vals[k_cap // 2:] = 0.0                   # padding slots
        got = tcompaction.scatter(torch.from_numpy(vals),
                                  torch.from_numpy(idx.astype(np.int32)), d)
        want = jcompaction.scatter(jnp.asarray(vals),
                                   jnp.asarray(idx, jnp.int32), d)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
