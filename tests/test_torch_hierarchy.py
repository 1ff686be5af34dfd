"""The pod hierarchy of ``sync_tree`` in the port against the JAX package's,
on the same numpy inputs: 2 pods x 2 data workers, four gloo ranks (ranks
pod-major, ``rank = p * 2 + d``, as ``launch.train.mesh_groups`` lays them
out) against the JAX ``("pod", "data")`` mesh on four fake CPU devices (one
subprocess). Deterministic top-k (the JAX reference backend's
``_topk_fast``, the port's kernel backend and its reference backend), on
the gather wire and the dense wire, with and without ``resparsify_pods``,
with and without error feedback. At rho 0.4 the union of a pod's two
workers' coordinates overflows every group's capacity, so the pod stage's
compaction drops mass (``_compaction_drops``, carried by the worker
residual under EF). Compared bit for bit: the synced leaves, both
residuals, ``wire_bytes_intra``, ``wire_bytes_inter`` and the overflow.
The JAX side runs under ``--xla_disable_hlo_passes=algsimp``: XLA's
algebraic simplifier otherwise moves the add of the pod stage's drop
before the worker stage's scatter-subtract of what it sent (``(t + d) -
q`` for ``(t - q) + d``), which moves about 5 % of the residual's
coordinates by an ulp; without the pass each operation rounds as the JAX
code writes it (as it does eagerly), as the port computes it and as a
float32 numpy replication does
(``test_pod_union_overflows_and_the_drop_is_carried``).
Also ``tests/test_api.py``'s hierarchical specs on the port: lossless
top-k is the dense two-stage mean with both residuals zero, the lossy one
conserves mass exactly, and a missing pod residual or pod generator
raises; and ``models.convert.feedback_from_jax``."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.comm import sync
from repro_torch.core.api import CompressionConfig
from repro_torch.optim.optimizers import FeedbackState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (4, 512), "b": (1536,), "c": (64,)}   # JAX flatten order
STACKED = {"a": True, "b": False, "c": False}
KEYS = sorted(SHAPES)
BASE = dict(name="topk", rho=0.4, min_leaf_size=128)
# name: (config, port backend)
CASES = {
    "gather": (dict(wire="gather"), "auto"),
    "gather_ef": (dict(wire="gather", error_feedback=True), "auto"),
    "gather_ef_ref": (dict(wire="gather", error_feedback=True), "reference"),
    "gather_bf16_ef": (dict(wire="gather", name="topk+bf16",
                            error_feedback=True), "auto"),
    "gather_coo_ef": (dict(wire="gather", wire_layout="coo",
                           error_feedback=True), "auto"),
    "resparsify": (dict(wire="gather", resparsify_pods=True), "auto"),
    "resparsify_ef": (dict(wire="gather", resparsify_pods=True,
                           error_feedback=True), "auto"),
    "dense": (dict(wire="dense"), "auto"),
    "dense_ef": (dict(wire="dense", error_feedback=True), "auto"),
    "dense_resparsify_ef": (dict(wire="dense", resparsify_pods=True,
                                 error_feedback=True), "auto"),
}
# tests/test_api.py's specs: lossless top-k, hierarchical gather against
# the dense two-stage mean
LOSSLESS = dict(name="topk", rho=1.0, min_leaf_size=128,
                resparsify_pods=True)


def make_inputs() -> dict:
    """Per leaf: the four workers' gradients and residuals ``[4, ...]`` and
    the two pods' residuals ``[2, ...]``, float32 from numpy."""
    rng = np.random.default_rng(21)
    data = {}
    for k in KEYS:
        shape = SHAPES[k]
        data[f"g_{k}"] = rng.standard_normal((4,) + shape).astype(np.float32)
        data[f"r_{k}"] = (rng.standard_normal((4,) + shape)
                          * 0.1).astype(np.float32)
        data[f"R_{k}"] = (rng.standard_normal((2,) + shape)
                          * 0.1).astype(np.float32)
    return data


def port_case(data, cfg_kw, backend, rank, data_group, pod_group,
              zero_state: bool = False) -> dict:
    """One hierarchical ``sync_tree`` of this rank (pod ``rank // 2``; with
    ``zero_state`` both residuals start at zero). Returns float32 numpy
    outputs per field, in KEYS order."""
    cfg = CompressionConfig(**{**BASE, **cfg_kw, "backend": backend})
    pod = rank // 2

    def leaves(what, i):
        return [torch.from_numpy(data[f"{what}_{k}"][i].copy()
                                 * (0 if zero_state and what != "g" else 1))
                for k in KEYS]

    fb = None
    if cfg.error_feedback:
        fb = FeedbackState(residual=leaves("r", rank),
                           pod_residual=leaves("R", pod)
                           if cfg.resparsify_pods else None)
    pod_gen = torch.Generator().manual_seed(100 + pod)
    synced, nfb, stats = sync.sync_tree(
        cfg, torch.Generator().manual_seed(rank), leaves("g", rank),
        group=data_group, pod_group=pod_group, pod_generator=pod_gen,
        stacked=[STACKED[k] for k in KEYS], feedback=fb)
    out = {"synced": [t.numpy() for t in synced]}
    if nfb is not None:
        out["residual"] = [t.numpy() for t in nfb.residual]
        if nfb.pod_residual is not None:
            out["pod_residual"] = [t.numpy() for t in nfb.pod_residual]
    out.update(intra=float(stats.wire_bytes_intra),
               inter=float(stats.wire_bytes_inter),
               wire=float(stats.wire_bytes), overflow=float(stats.overflow))
    return out


def port_rank(data, rank: int) -> dict:
    """Every case, and the lossless and recovery specs, on this rank of a
    running four-rank group."""
    from repro_torch.launch.train import mesh_groups
    data_group, pod_group, pod = mesh_groups((2, 2, 1))
    assert pod == rank // 2
    res = {name: port_case(data, kw, be, rank, data_group, pod_group)
           for name, (kw, be) in CASES.items()}
    res["lossless_gather"] = port_case(
        data, dict(LOSSLESS, wire="gather", error_feedback=True), "auto",
        rank, data_group, pod_group, zero_state=True)
    res["lossless_dense"] = port_case(
        data, dict(LOSSLESS, wire="dense", resparsify_pods=False), "auto",
        rank, data_group, pod_group)
    res["recovery"] = port_case(
        data, dict(name="topk", rho=0.05, min_leaf_size=128, wire="gather",
                   resparsify_pods=True, error_feedback=True), "reference",
        rank, data_group, pod_group, zero_state=True)
    return res


JAX_SCRIPT = r"""
import sys
import numpy as np
import repro                               # jax API shims first
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.api import CompressionConfig, FeedbackState, sync_tree

data = np.load(sys.argv[1])
cases, base, stacked = eval(sys.argv[3]), eval(sys.argv[4]), eval(sys.argv[5])
mesh = jax.make_mesh((2, 2), ("pod", "data"))
get = lambda what: {k: jnp.asarray(data[f"{what}_{k}"]) for k in stacked}
out = {}
for name, (kw, _) in cases.items():
    cfg = CompressionConfig(backend="reference", **{**base, **kw})
    hier = cfg.error_feedback and cfg.resparsify_pods

    def f(g, r, R):
        first = lambda t: jax.tree.map(lambda x: x[0], t)
        fb = None
        if cfg.error_feedback:
            fb = FeedbackState(residual=first(r),
                               pod_residual=first(R) if hier else None)
        synced, nfb, st = sync_tree(cfg, jax.random.key(3), first(g),
                                    data_axis="data", pod_axis="pod",
                                    stacked=stacked, feedback=fb)
        ex = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[None], t)
        res = nfb.residual if cfg.error_feedback else first(r)
        pres = nfb.pod_residual if hier else first(R)
        return (ex(synced), ex(res), ex(pres), ex(st.wire_bytes_intra),
                ex(st.wire_bytes_inter), ex(st.overflow))

    w = P(("pod", "data"))
    with jax.set_mesh(mesh):
        o = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(w, w, P("pod")),
            out_specs=(w, w, w, w, w, w), axis_names={"pod", "data"},
            check_vma=False))(get("g"), get("r"), get("R"))
    for field, tree in zip(("synced", "residual", "pod_residual"), o[:3]):
        for k in stacked:
            out[f"{name}_{field}_{k}"] = np.asarray(tree[k]).astype(
                np.float32)
    for field, x in zip(("intra", "inter", "overflow"), o[3:]):
        out[f"{name}_{field}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""

GLOO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import test_torch_hierarchy as t

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
torch.save(t.port_rank(dict(np.load(sys.argv[5])), rank), out)
dist.destroy_process_group()
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX package's steps (one subprocess, four fake CPU devices) and
    the port's (four gloo subprocesses), side by side."""
    tmp = tmp_path_factory.mktemp("hierarchy")
    data = make_inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "jax.npz"), repr(CASES), repr(BASE), repr(STACKED)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                 "--xla_disable_hlo_passes=algsimp", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _port()
    outs = [str(tmp / f"rank{r}.pt") for r in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(r), str(port), outs[r],
         os.path.dirname(os.path.abspath(__file__)), str(tmp / "in.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(o, weights_only=False) for o in outs]
    log = jax_proc.communicate(timeout=300)[0]
    assert jax_proc.returncode == 0, log
    return ranks, dict(np.load(tmp / "jax.npz")), data


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_pod_hierarchy_matches_jax(results, name):
    ranks, jx, _ = results
    kw = {**BASE, **CASES[name][0]}
    fields = ["synced"]
    if kw.get("error_feedback"):
        fields.append("residual")
        if kw.get("resparsify_pods"):
            fields.append("pod_residual")
    for rank in range(4):
        got = ranks[rank][name]
        for field in fields:
            for i, k in enumerate(KEYS):
                np.testing.assert_array_equal(
                    _bits(got[field][i]),
                    _bits(jx[f"{name}_{field}_{k}"][rank]),
                    err_msg=f"{name} rank {rank} {field} {k}")
        for field in ("intra", "inter", "overflow"):
            assert got[field] == float(jx[f"{name}_{field}"][rank]), \
                (name, rank, field)
        assert got["wire"] == got["intra"] + got["inter"]


def _topk_rows(x: np.ndarray, k: int) -> np.ndarray:
    """x with all but each row's k largest magnitudes zeroed (ties by
    lowest index)."""
    out = np.zeros_like(x)
    for r in range(x.shape[0]):
        keep = np.argsort(-np.abs(x[r]), kind="stable")[:k]
        out[r, keep] = x[r, keep]
    return out


def test_pod_union_overflows_and_the_drop_is_carried(results):
    """A host replication of the gather wire's pod stage without
    re-sparsification (``tests/test_distributed.py``'s
    ``test_error_feedback_carries_pod_compaction_drop``): each worker sends
    its top k, a pod averages its two workers, the pod stage keeps the
    k_cap largest of the pod average, and with EF each worker's residual
    is its own error plus its pod's drop (pod average less what the pod
    sent), all in float32, bit for bit; the pod union overflows."""
    from repro_torch.comm.compaction import capacity_for
    ranks, _, data = results
    for i, k in enumerate(KEYS):
        if k == "c":
            continue
        rows = SHAPES[k][0] if STACKED[k] else 1
        d = int(np.prod(SHAPES[k])) // rows
        kt, k_cap = round(0.4 * d), capacity_for(d, 0.4)
        tgt = (data[f"g_{k}"] + data[f"r_{k}"]).reshape(4, rows, d)
        q = np.stack([_topk_rows(tgt[w], kt) for w in range(4)])
        pod_avg = (q[0::2] + q[1::2]) / np.float32(2)
        sent = np.stack([_topk_rows(pod_avg[p], k_cap) for p in range(2)])
        assert all((pod_avg[p] != 0).sum(-1).min() > k_cap
                   for p in range(2))
        synced = (sent[0] + sent[1]) / np.float32(2)
        for w in range(4):
            got = ranks[w]["gather_ef"]
            np.testing.assert_array_equal(
                _bits(got["synced"][i]), _bits(synced.reshape(SHAPES[k])))
            want = (tgt[w] - q[w]) + (pod_avg[w // 2] - sent[w // 2])
            np.testing.assert_array_equal(
                _bits(got["residual"][i]), _bits(want.reshape(SHAPES[k])),
                err_msg=f"{k} worker {w}")
    assert all(ranks[r]["gather_ef"]["overflow"] > 0 for r in range(4))


def test_lossless_hierarchy_is_the_dense_two_stage_mean(results):
    """``test_api.py``: top-k at rho 1 keeps every coordinate in both
    stages, so the hierarchical gather wire with EF equals the dense
    wire's two-stage mean bit for bit and both residuals are exactly
    zero."""
    ranks, _, _ = results
    for rank in range(4):
        h, d = ranks[rank]["lossless_gather"], ranks[rank]["lossless_dense"]
        for a, b in zip(h["synced"], d["synced"]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for t in h["residual"] + h["pod_residual"]:
            assert np.abs(t).max() == 0.0


def test_hierarchical_recovery_identity(results):
    """``test_api.py``: with both residuals carried from zero nothing is
    dropped: ``synced == mean_p[mean_w(g_w - r_new_w) - R_new_p]``."""
    ranks, _, data = results
    for i, k in enumerate(KEYS):
        g = np.stack([data[f"g_{k}"][w] for w in range(4)]).astype(
            np.float64)
        r = np.stack([ranks[w]["recovery"]["residual"][i] for w in range(4)])
        R = np.stack([ranks[2 * p]["recovery"]["pod_residual"][i]
                      for p in range(2)])
        a = (g - r).reshape((2, 2) + g.shape[1:]).mean(axis=1)
        final = (a - R).mean(axis=0)
        np.testing.assert_allclose(ranks[0]["recovery"]["synced"][i], final,
                                   rtol=1e-5, atol=2e-6, err_msg=k)
        if k != "c":
            assert np.abs(r).sum() > 0 and np.abs(R).sum() > 0
        for p in range(2):   # a pod's data workers carry one pod residual
            np.testing.assert_array_equal(
                ranks[2 * p]["recovery"]["pod_residual"][i],
                ranks[2 * p + 1]["recovery"]["pod_residual"][i])


def test_hierarchy_refuses_a_missing_pod_residual_or_generator():
    """Refusals before any collective (a group object is not touched)."""
    leaves = [torch.ones(300)]
    group = object()
    cfg = CompressionConfig(name="topk", rho=0.1, wire="gather",
                            min_leaf_size=8, error_feedback=True,
                            resparsify_pods=True)
    with pytest.raises(ValueError, match="pod stage's residual"):
        sync.sync_tree(cfg, torch.Generator(), leaves, group=group,
                       pod_group=group, pod_generator=torch.Generator(),
                       feedback=FeedbackState(residual=[torch.zeros(300)]))
    with pytest.raises(ValueError, match="pod_generator"):
        sync.sync_tree(cfg, torch.Generator(), leaves, group=group,
                       pod_group=group, feedback=FeedbackState(
                           residual=[torch.zeros(300)],
                           pod_residual=[torch.zeros(300)]))
    with pytest.raises(ValueError, match="resparsify_pods"):
        CompressionConfig(adaptive=True, error_feedback=True,
                          resparsify_pods=True)


def test_feedback_from_jax_takes_one_workers_and_pods_slice():
    from repro.optim.optimizers import init_feedback as jinit
    from repro_torch.models.convert import feedback_from_jax
    rng = np.random.default_rng(4)
    params = {"b": np.zeros(5, np.float32),
              "a": {"w": np.zeros(3, np.float32)}}
    fb = jinit(params, num_workers=4, num_pods=2)
    fb.residual["b"] = rng.standard_normal((4, 5)).astype(np.float32)
    fb.pod_residual["a"]["w"] = rng.standard_normal((2, 3)).astype(
        np.float32)
    got = feedback_from_jax(fb, worker=3, pod=1)
    np.testing.assert_array_equal(got.residual[1].numpy(),
                                  fb.residual["b"][3])
    np.testing.assert_array_equal(got.pod_residual[0].numpy(),
                                  fb.pod_residual["a"]["w"][1])
    assert feedback_from_jax(jinit(params, num_workers=2)).pod_residual \
        is None


def test_launcher_runs_the_pod_stage_on_the_cpu():
    """``launch.train --mesh 1x1x1``: the pod stage over groups of one (at
    one worker the compaction keeps every nonzero, so the pod stage ships
    the worker stage's bytes), with ``--resparsify-pods`` and EF the pod
    residual carried; ``--mode fsdp --adaptive`` (exits, as in JAX) and a
    mesh that does not cover the workers (a model axis of two at one
    worker, ``tests/test_torch_model_axis.py`` runs it on four) are refused
    (``--checkpoint`` is ported: ``tests/test_torch_checkpoint.py``)."""
    from repro_torch.launch import train as tlaunch
    base = ["--arch", "gemma-2b", "--smoke", "--steps", "2", "--device",
            "cpu", "--wire", "gather", "--error-feedback", "--log-every",
            "1"]
    out = tlaunch.main(base + ["--mesh", "1x1x1"])
    for m in out["metrics"]:
        assert m["wire_bytes_inter"] == m["wire_bytes_intra"] > 0
        assert m["wire_bytes"] == 2 * m["wire_bytes_intra"]
    out = tlaunch.main(base + ["--mesh", "1x1x1", "--resparsify-pods"])
    assert all(m["wire_bytes_inter"] > 0 and np.isfinite(m["loss"])
               for m in out["metrics"])
    assert tlaunch.parse_mesh("1x1") == (None, 1, 1)
    assert tlaunch.parse_mesh("2x3x1") == (2, 3, 1)
    for argv, err in ((["--mesh", "1x1x2"], ValueError),
                      (["--mode", "fsdp", "--adaptive"], SystemExit),
                      (["--mesh", "2x1x1"], ValueError)):
        with pytest.raises(err, match="item 10|needs 2|compressed train"):
            tlaunch.main(base + argv)
