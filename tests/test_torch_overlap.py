"""The overlapped exchange (``comm.sync._overlapped_sync``) and the packed
wire in the port, against the port's sync exchange and the JAX package's
``_overlapped_sync``, on the same numpy inputs: two gloo ranks against two
fake CPU devices (one subprocess). Deterministic top-k at rho 0.05 with
error feedback, with ``bucket_coord_cap`` 1536 (the stacked ``[4, 512]``
leaf goes in spans of three rows and one) and ``overlap_bucket_bytes``
256, so that the spans go in several buckets, each its own all-gathers.
Every wire layout (RICE, COO, BITMAP, dense), bfloat16 values (the
companion stream), an integer codec (ternary: its scales ride the word
stream) and the adaptive loop with the fitted Golomb-Rice parameter (the
fitted header in the counts words, the skip sentinel). The overlapped
exchange is held
bit for bit to the sync exchange (synced leaves, residuals, bytes) and to
the JAX package's overlapped exchange (its bytes, and the synced leaves
and residuals where no codec uniform is drawn). The packed wire is held to
the JAX package's and to the gather wire with ``+bf16``."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.comm import sync
from repro_torch.core.api import CompressionConfig
from repro_torch.optim.optimizers import ControlState, FeedbackState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (4, 512), "b": (1536,), "c": (64,)}   # JAX flatten order
STACKED = {"a": True, "b": False, "c": False}
KEYS = sorted(SHAPES)
BASE = dict(name="topk", rho=0.05, min_leaf_size=128, error_feedback=True,
            wire="gather", bucket_coord_cap=1536, overlap_bucket_bytes=256)
ADAPTIVE = dict(adaptive=True, skip_tau=0.7, rice_fitted=True,
                wire_layout="rice")
BOUNDS = {"a": 1e30, "b": 0.0, "c": 0.0}     # a skipped, b sent
# name: config
CASES = {
    "rice": dict(wire_layout="rice"),
    "coo": dict(wire_layout="coo"),
    "bitmap": dict(wire_layout="bitmap"),
    "dense": dict(wire_layout="dense"),
    "bf16_rice": dict(name="topk+bf16", wire_layout="rice"),
    "ternary_coo": dict(name="topk+ternary", wire_layout="coo"),
    "ternary_rice": dict(name="topk+ternary", wire_layout="rice"),
    "adaptive_fitted": ADAPTIVE,
    "packed": dict(wire="packed"),
}
# the codec draws uniforms: values not held to JAX
UNIFORMS = ("ternary_coo", "ternary_rice")


def make_inputs() -> dict:
    rng = np.random.default_rng(31)
    data = {}
    for k in KEYS:
        shape = SHAPES[k]
        data[f"g_{k}"] = rng.standard_normal((2,) + shape).astype(np.float32)
        data[f"r_{k}"] = (rng.standard_normal((2,) + shape)
                          * 0.1).astype(np.float32)
        data[f"s_{k}"] = (rng.standard_normal((2,) + shape)
                          * 0.5).astype(np.float32)
        data[f"la_{k}"] = (rng.standard_normal(shape) * 0.5).astype(
            np.float32)
    return data


def port_case(data, kw: dict, rank: int) -> dict:
    """One ``sync_tree`` of this rank; the adaptive case with its control
    (step 1, ``BOUNDS``). Returns numpy outputs and the buckets issued."""
    cfg = CompressionConfig(**{**BASE, **kw})

    def leaves(what, worker=True):
        return [torch.from_numpy((data[f"{what}_{k}"][rank] if worker
                                  else data[f"{what}_{k}"]).copy())
                for k in KEYS]

    ctl = None
    if cfg.adaptive:
        ctl = ControlState(
            last_sent=leaves("s"), last_avg=leaves("la", worker=False),
            bound=[torch.tensor(BOUNDS[k]) for k in KEYS], step=1)
    issued = []
    real = sync._issue_gather

    def counted(x, group):
        issued.append(x.dtype)
        return real(x, group)

    sync._issue_gather = counted
    try:
        out = sync.sync_tree(
            cfg, torch.Generator().manual_seed(rank), leaves("g"),
            stacked=[STACKED[k] for k in KEYS],
            feedback=FeedbackState(residual=leaves("r")), control=ctl)
    finally:
        sync._issue_gather = real
    synced, fb, stats = out[0], out[1], out[-1]
    return {"synced": [t.numpy() for t in synced],
            "residual": [t.numpy() for t in fb.residual],
            "wire": float(stats.wire_bytes),
            "word_streams": sum(d == torch.int32 for d in issued),
            "streams": len(issued)}


def port_rank(data, rank: int) -> dict:
    res = {}
    for name, kw in CASES.items():
        for ex in ("sync", "overlap"):
            res[f"{name}_{ex}"] = port_case(data, dict(kw, exchange=ex), rank)
    res["gather_bf16_sync"] = port_case(
        data, dict(name="topk+bf16", exchange="sync"), rank)
    return res


JAX_SCRIPT = r"""
import sys
import numpy as np
import repro                               # jax API shims first
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.api import (CompressionConfig, ControlState, FeedbackState,
                       sync_tree)

data = np.load(sys.argv[1])
cases, base, stacked, bounds = (eval(sys.argv[3]), eval(sys.argv[4]),
                                eval(sys.argv[5]), eval(sys.argv[6]))
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
get = lambda what: {k: jnp.asarray(data[f"{what}_{k}"]) for k in stacked}
la = get("la")
b0 = {k: jnp.full((2,), v, jnp.float32) for k, v in bounds.items()}
out = {}
for name, kw in cases.items():
    cfg = CompressionConfig(backend="reference", exchange="overlap",
                            **{**base, **kw})

    def f(g, r, s, b):
        first = lambda t: jax.tree.map(lambda x: x[0], t)
        ctl = None
        if cfg.adaptive:
            ctl = ControlState(last_sent=first(s), last_avg=la,
                               bound=first(b), step=jnp.int32(1))
        o = sync_tree(cfg, jax.random.key(5), first(g), data_axis="data",
                      stacked=stacked,
                      feedback=FeedbackState(residual=first(r)),
                      control=ctl)
        ex = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[None], t)
        return ex(o[0]), ex(o[1].residual), ex(o[-1].wire_bytes)

    with jax.set_mesh(mesh):
        o = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("data"),) * 4, out_specs=P("data"),
            axis_names={"data"}, check_vma=False))(
                get("g"), get("r"), get("s"), b0)
    for field, tree in zip(("synced", "residual"), o[:2]):
        for k in stacked:
            out[f"{name}_{field}_{k}"] = np.asarray(tree[k]).astype(
                np.float32)
    out[f"{name}_wire"] = np.asarray(o[2])
np.savez(sys.argv[2], **out)
"""

GLOO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import test_torch_overlap as t

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
torch.save(t.port_rank(dict(np.load(sys.argv[5])), rank), out)
dist.destroy_process_group()
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX package's overlapped steps (one subprocess, two fake CPU
    devices) and the port's (two gloo subprocesses), side by side."""
    tmp = tmp_path_factory.mktemp("overlap")
    data = make_inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz"), repr(CASES), repr(BASE), repr(STACKED),
         repr(BOUNDS)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _port()
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(r), str(port), outs[r],
         os.path.dirname(os.path.abspath(__file__)), str(tmp / "in.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(o, weights_only=False) for o in outs]
    log = jax_proc.communicate(timeout=300)[0]
    assert jax_proc.returncode == 0, log
    return ranks, dict(np.load(tmp / "jax.npz"))


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_overlap_is_the_sync_exchange_bit_for_bit(results, name):
    ranks, _ = results
    for rank in range(2):
        ov, sy = ranks[rank][f"{name}_overlap"], ranks[rank][f"{name}_sync"]
        for field in ("synced", "residual"):
            for a, b, k in zip(ov[field], sy[field], KEYS):
                np.testing.assert_array_equal(
                    _bits(a), _bits(b), err_msg=f"{name} {field} {k}")
        assert ov["wire"] == sy["wire"] > 0
        # spans split over buckets: one word stream a bucket
        assert ov["word_streams"] >= 3, ov["word_streams"]


@pytest.mark.parametrize("name", list(CASES))
def test_overlap_matches_jax(results, name):
    ranks, jx = results
    for rank in range(2):
        got = ranks[rank][f"{name}_overlap"]
        assert got["wire"] == float(jx[f"{name}_wire"][rank]), (name, rank)
        if name in UNIFORMS:
            continue
        for field in ("synced", "residual"):
            for i, k in enumerate(KEYS):
                np.testing.assert_array_equal(
                    _bits(got[field][i]),
                    _bits(jx[f"{name}_{field}_{k}"][rank]),
                    err_msg=f"{name} rank {rank} {field} {k}")


def test_sub_word_values_ride_a_companion_stream(results):
    """bfloat16 and int8 values: a companion stream beside each bucket's
    word stream; float32 values ride in the words."""
    ranks, _ = results
    for name in ("bf16_rice", "ternary_coo", "packed"):
        got = ranks[0][f"{name}_overlap"]
        assert got["streams"] == 2 * got["word_streams"], name
    got = ranks[0]["rice_overlap"]
    assert got["streams"] == got["word_streams"]


def test_packed_wire_is_gather_with_bf16(results):
    ranks, _ = results
    for rank in range(2):
        pk, g16 = ranks[rank]["packed_sync"], ranks[rank]["gather_bf16_sync"]
        for field in ("synced", "residual"):
            for a, b in zip(pk[field], g16[field]):
                np.testing.assert_array_equal(_bits(a), _bits(b))
        assert pk["wire"] == g16["wire"] < ranks[rank]["rice_sync"]["wire"]
    assert CompressionConfig(wire="packed").scheme().codec.name == "bf16"
    assert CompressionConfig(wire="packed",
                             name="qsgd").scheme().codec.name == "qsgd4"
    assert CompressionConfig(wire="packed",
                             codec="f32").scheme().codec.name == "f32"
